// Fused colored ("cb") Metropolis multisweep with in-kernel MT19937.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// make_colored_multisweep_kernel (its body _make_colored_body, its RNG
// _draw_sweep_uniforms, its exp core/fastexp.py:EXP_FNS[exp_flavor]).  The
// plain PyTorch version is src/repro_torch/kernels/ref.py:
// colored_multisweep_ref; the two agree bit for bit for every exp flavour
// ("fast", "accurate", "exact": a template parameter of the kernel, picked
// by the entry's flavour code).
//
// Layout.  One CTA per replica of 128 * W threads (W warp groups, the
// wrapper's ops.COLORED_WARP_GROUPS, 8 by default): a class's rows are
// dealt to the CTA's warps, each thread 4 neighbouring lanes of a row; the
// generator's phase runs are dealt to the warps, each thread 4
// neighbouring columns.  Every spin-row, uniform-row and state-row access
// of a warp is 128 or 512 neighbouring bytes: coalesced, the paper's GPU
// lesson.  Here the class coefficients arrive gathered per class entry on
// the host (cls_h, cls_J, cls_tau) and are staged in shared memory once a
// launch with the class tables (colored_sweep.cuh).
//
// What bounds it.  Per launch the function must move
//     4*B*(rows*128 + 2*624*128 + 3*rows*128) bytes
// (spins in; generator state in and out; spins, h_space, h_tau out): 8.3 MB
// at B=8, rows=192, 2.5 us at the HBM rate.  Its operations take longer: 8
// int ops per generator word twisted and 14 int plus 2*sd+10 float ops per
// spin per sweep come to 3.8 us at the card's int32 issue rate (8 sweeps,
// B=8), so operations bound it; with one CTA per replica only B of the 132
// SMs work, and the same operations take at least 62 us.  On an NVIDIA
// H100 80GB HBM3 at 700 W the first design (128 threads walking each class
// row after row, every table read from device memory, the last generator
// block tempered inside the walk) took 1.39-1.42 ms an 8-sweep launch at
// B=8, latency bound; this one takes 0.17-0.19 ms (PERF.md): 21 us
// of fixed cost, then per sweep ~10 us of twist and ~10 us of class walk
// and tempering, bound by instruction issue and barrier latency on the one
// SM, ~3x above the 62 us floor.
//
// Numerics: see colored_sweep.cuh.  The float->int step of the bit-trick
// exps is __float2int_rz, which truncates, saturates and maps NaN to 0, like
// the reference; the bias add wraps modulo 2^32.  The exps' five float
// constants arrive as bit patterns.  The times above are the "fast"
// flavour's.  The twist word, temper and exp device code is shared:
// mt19937.cuh and fastexp.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colored_sweep.cuh"

namespace {

template <int F>
__global__ void __launch_bounds__(CB_LANES * CB_MAX_GROUPS) colored_multisweep_kernel(
    const float* __restrict__ spins_in, const uint32_t* rng_in,
    const float* __restrict__ beta, float* __restrict__ spins_out,
    float* __restrict__ h_space, float* __restrict__ h_tau, uint32_t* rng_out,
    float* u_scratch, ColorTables cls, const float* __restrict__ cls_h,
    const float* __restrict__ cls_J, const float* __restrict__ cls_tau, int rows, int sd,
    int num_sweeps, ExpConsts ec) {
  extern __shared__ __align__(16) unsigned char smem[];
  colored_multisweep_cta<F>(smem, spins_in, rng_in, beta[blockIdx.x], spins_out, h_space, h_tau,
                            rng_out, u_scratch, cls, EntryCoef{}, cls_h, cls_J, cls_tau, rows, sd,
                            num_sweeps, ec);
}

template <int F>
int launch(const float* spins_in, const uint32_t* rng_in, const float* beta, float* spins_out,
           float* h_space, float* h_tau, uint32_t* rng_out, float* u_scratch,
           const ColorTables& cls, const float* cls_h, const float* cls_J, const float* cls_tau,
           int B, int rows, int sd, int num_sweeps, int warp_groups, const ExpConsts& ec,
           cudaStream_t stream) {
  const size_t smem = cb_smem_bytes(rows, sd, cls.C, cb_u_in_smem(u_scratch, num_sweeps));
  const int attr = colored_smem_attr(colored_multisweep_kernel<F>, smem);
  if (attr != 0) return attr;
  colored_multisweep_kernel<F><<<B, CB_LANES * warp_groups, smem, stream>>>(
      spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls, cls_h, cls_J,
      cls_tau, rows, sd, num_sweeps, ec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one CTA of 128 * warp_groups threads per replica on `stream`;
// u_scratch (rows, B*128) is nullptr when the uniforms fit in shared
// memory; `flavour` is the exp (EXP_FAST, EXP_ACCURATE or EXP_EXACT) and
// the five bit patterns are its constants (fastexp.cuh: ExpConsts).
// Returns cudaGetLastError() (or the first check's error).
extern "C" int colored_multisweep(
    const float* spins_in, const uint32_t* rng_in, const float* beta, float* spins_out,
    float* h_space, float* h_tau, uint32_t* rng_out, float* u_scratch, const int* cls_off,
    const int* cls_row, const float* cls_h, const float* cls_J, const int* cls_tgt,
    const float* cls_tau, const int* cls_down, const int* cls_up, const int* cls_roll, int B,
    int rows, int sd, int C, int num_sweeps, int warp_groups, int flavour, uint32_t scale_bits,
    uint32_t centre_bits, uint32_t scale4_bits, uint32_t lo_bits, uint32_t clip_hi_bits,
    void* stream) {
  const int bad =
      cb_check(warp_groups, spins_in, rng_in, spins_out, h_space, h_tau, rng_out, u_scratch);
  if (bad != 0) return bad;
  const ColorTables cls{cls_off, cls_row, cls_tgt, cls_down, cls_up, cls_roll, C};
  const ExpConsts ec = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
#define CB_CALL(F)                                                                             \
  launch<F>(spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls, cls_h, \
            cls_J, cls_tau, B, rows, sd, num_sweeps, warp_groups, ec, (cudaStream_t)stream)
  return SWEEP_EXP_DISPATCH(flavour, CB_CALL);
#undef CB_CALL
}
