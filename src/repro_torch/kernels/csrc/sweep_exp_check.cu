// The sweep kernels' exp, sweep_exp<F> (fastexp.cuh), mapped over a buffer.
//
// A check, not a kernel of any path: no public function of kernels/ops.py
// launches it, and it replaces no TPU kernel.  chip_smoke.py runs it over
// all 2^32 float32 inputs against the plain exps on the card
// (core/fastexp.py: exp_reference for "exact", fastexp_accurate for
// "accurate"), so the exp that every accept test of #1-#5 takes is held
// on every input it can see, built as the sweep kernels build it (the same
// header, the same flags).  One element a thread, a grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastexp.cuh"

namespace {

constexpr int THREADS = 256;

template <int F>
__global__ void __launch_bounds__(THREADS)
    sweep_exp_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                     ExpConsts c) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = sweep_exp<F>(x[i], c);
}

template <int F>
int launch(const float* x, float* out, long long n, const ExpConsts& c, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  sweep_exp_kernel<F><<<(unsigned)(blocks < 65536 ? blocks : 65536), THREADS, 0, stream>>>(
      x, out, n, c);
  return (int)cudaGetLastError();
}

}  // namespace

// out[i] = sweep_exp<flavour>(x[i]) for n >= 1 float32 elements on `stream`,
// the exp's constants as the sweep entries take them.  Returns
// cudaGetLastError().
extern "C" int sweep_exp_check(const float* x, float* out, long long n, int flavour,
                               uint32_t scale_bits, uint32_t centre_bits, uint32_t scale4_bits,
                               uint32_t lo_bits, uint32_t clip_hi_bits, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const ExpConsts c = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
#define EXP_CALL(F) launch<F>(x, out, n, c, (cudaStream_t)stream)
  return SWEEP_EXP_DISPATCH(flavour, EXP_CALL);
#undef EXP_CALL
}
