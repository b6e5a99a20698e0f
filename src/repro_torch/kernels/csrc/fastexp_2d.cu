// The paper's bit-trick exp, "fast" or "accurate", over any number of
// elements.
//
// Replaces the TPU kernel src/repro/kernels/fastexp_kernel.py:fastexp_2d
// (the elementwise body over (rows, 128k) float32 blocks).  The plain
// PyTorch version is src/repro_torch/kernels/ref.py:fastexp_ref; the two
// agree bit for bit.  The exp bodies are fastexp.cuh's, the same device
// code the sweep kernels run for "fast".
//
// Layout.  The TPU kernel needs its input padded to whole (8, 128) tiles;
// here the wrapper hands over the contiguous elements as they are.  Each
// thread loads one 16-byte vector (4 float32, or 8 float16 / bfloat16
// converted exactly to float32) and stores its 4 or 8 float32 results as
// 16-byte vectors, so a warp reads and writes 512 neighbouring bytes per
// access.  The last n % (elements per vector) elements, or all of them
// when the input is not 16-byte aligned (a view with an offset), go one
// element per thread.
//
// What bounds it.  The function must read each input once and write each
// float32 result once: (input bytes + 4) * n bytes, 0.16 ms for 2^26
// float32 elements at the HBM rate.  "fast" does 5 operations an element,
// far under that, so bytes bound it; the design moves each byte once, in
// full 16-byte accesses (on an H100 at 2^26: 3.06 TB/s, as fast as
// torch.exp).  "accurate" adds the clip and two reciprocal square roots
// in float32 (rsqrt_f32, fastexp.cuh: an approximate rsqrt and about a
// dozen float32 operations each; with float64 square roots and divisions
// it took 1.24x longer): at 2^26 it takes 1.09x the time of "fast".  A grid of two waves with 4 vectors a thread in flight, or 2
// vectors a thread, or evict-first (.cs) loads and stores, were no faster
// on the card (PERF.md), so each thread takes one vector.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastexp.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool ACCURATE>
__device__ __forceinline__ float flavoured_exp(float x, const ExpConsts& c) {
  return ACCURATE ? fastexp_accurate(x, c.scale4, c.centre, c.lo, c.clip_hi)
                  : fastexp_fast(x, c.scale, c.centre);
}

template <typename T, bool ACCURATE>
__global__ void __launch_bounds__(THREADS)
    fastexp_2d_kernel(const T* __restrict__ x, float* __restrict__ out, long long n,
                      long long nvec, ExpConsts c) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t < nvec) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[t];
    const T* e = reinterpret_cast<const T*>(&raw);
    float4* o = reinterpret_cast<float4*>(out + t * PER);
#pragma unroll
    for (int q = 0; q < PER / 4; ++q)
      o[q] = make_float4(flavoured_exp<ACCURATE>(to_f32(e[4 * q]), c),
                         flavoured_exp<ACCURATE>(to_f32(e[4 * q + 1]), c),
                         flavoured_exp<ACCURATE>(to_f32(e[4 * q + 2]), c),
                         flavoured_exp<ACCURATE>(to_f32(e[4 * q + 3]), c));
  }
  const long long i = nvec * PER + t;  // the elements no vector covers
  if (i < n) out[i] = flavoured_exp<ACCURATE>(to_f32(x[i]), c);
}

template <typename T, bool ACCURATE>
int launch(const void* x, float* out, long long n, const ExpConsts& c, cudaStream_t stream) {
  constexpr int PER = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long nvec = aligned ? n / PER : 0;
  const long long rest = n - nvec * PER;
  const long long threads = nvec > rest ? nvec : rest;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fastexp_2d_kernel<T, ACCURATE><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), out, n, nvec, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flavour(const void* x, float* out, long long n, bool accurate, const ExpConsts& c,
                   cudaStream_t stream) {
  return accurate ? launch<T, true>(x, out, n, c, stream) : launch<T, false>(x, out, n, c, stream);
}

}  // namespace

// Launches on `stream` over n >= 1 contiguous elements of type `dtype`
// (0 float32, 1 float16, 2 bfloat16) into n float32 results; `accurate`
// picks the flavour.  Returns cudaGetLastError().
extern "C" int fastexp_2d(const void* x, float* out, long long n, int dtype, int accurate,
                          uint32_t scale_bits, uint32_t centre_bits, uint32_t scale4_bits,
                          uint32_t lo_bits, uint32_t clip_hi_bits, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const ExpConsts c = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_flavour<float>(x, out, n, accurate != 0, c, s);
    case 1: return launch_flavour<__half>(x, out, n, accurate != 0, c, s);
    case 2: return launch_flavour<__nv_bfloat16>(x, out, n, accurate != 0, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
