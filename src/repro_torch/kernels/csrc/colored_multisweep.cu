// Fused colored ("cb") Metropolis multisweep with in-kernel MT19937.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// make_colored_multisweep_kernel (its body _make_colored_body, its RNG
// _draw_sweep_uniforms, its exp core/fastexp.py:fastexp_fast).  The plain
// PyTorch version is src/repro_torch/kernels/ref.py:colored_multisweep_ref;
// the two agree bit for bit.
//
// Layout.  One CTA per replica, 128 threads, thread v owns lane v: the spin
// lattice column v of every lane row, and MT19937 generator column b*128+v
// of the (624, B*128) interlaced state.  Every state-row and spin-row access
// of a warp is 32 neighbouring words — coalesced, the paper's GPU lesson.
//
// What bounds it.  Per launch the function must move
//     4*B*(rows*128 + 2*624*128 + 3*rows*128) bytes
// (spins in; generator state in and out; spins, h_space, h_tau out): 8.3 MB
// at B=8, rows=192, 2.5 us at the HBM rate.  Its operations take longer: 8
// int ops per generator word twisted and 14 int plus 2*sd+10 float ops per
// spin per sweep come to 3.8 us at the card's int32 issue rate (8 sweeps,
// B=8), so operations bound it.  With one CTA per replica only B of the
// 132 SMs work, and the same operations take at least 62 us.  This first
// design is far from both bounds: it is latency bound.  Each thread
// twists its 624-word column sequentially in global memory (the textbook
// loop; the column is re-read from L2 every sweep, a replica's state is
// 312 KiB, more than an SM's shared memory), and the class loop walks rows
// one after another.  What the design does about it: spins live in shared
// memory as int8 (rows*128 bytes, 24 KiB at rows=192), so the C class
// updates and the final dense field pass never touch device memory; the
// twist loads 8 rows ahead (the 227-row distance of the recurrence makes
// that safe) to keep several loads in flight per thread; uniforms are
// tempered on the fly from the freshly twisted column, so the last block of
// a sweep needs no buffer.  With rows > 624 the earlier blocks of a sweep
// are overwritten by the next twist, so their uniforms go to a scratch
// buffer the caller allocates.
//
// Numerics.  Every product here multiplies by a spin (+-1), by a spin sum
// in {-2, 0, 2}, or is the one rounding of ((-2 beta) s) * h_eff and of
// x * 2^23 log2(e); contraction into FMA could not change a bit, but the
// build passes --fmad=false anyway so the compiled code is the written
// expression.  The float->int step of the exp is __float2int_rz, which
// truncates, saturates and maps NaN to 0, like the reference; the bias add
// wraps modulo 2^32.  The two float constants arrive as bit patterns.
//
// The twist, temper and exp device code is shared: mt19937.cuh and
// fastexp.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "fastexp.cuh"
#include "mt19937.cuh"

namespace {

constexpr int LANES = 128;

__global__ void __launch_bounds__(LANES) colored_multisweep_kernel(
    const float* __restrict__ spins_in, const uint32_t* rng_in,
    const float* __restrict__ beta, float* __restrict__ spins_out,
    float* __restrict__ h_space, float* __restrict__ h_tau, uint32_t* rng_out,
    float* u_scratch, const int* __restrict__ cls_off,
    const int* __restrict__ cls_row, const float* __restrict__ cls_h,
    const float* __restrict__ cls_J, const int* __restrict__ cls_tgt,
    const float* __restrict__ cls_tau, const int* __restrict__ cls_down,
    const int* __restrict__ cls_up, const int* __restrict__ cls_roll,
    const float* __restrict__ h, const int* __restrict__ nbr,
    const float* __restrict__ J, const float* __restrict__ tau, int B, int rows,
    int n, int sd, int C, int num_sweeps, float scale, float centre) {
  extern __shared__ int8_t sp[];  // (rows, 128) spins as +-1
  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int vm = (v + LANES - 1) & (LANES - 1);  // lane read by rolled "down"
  const int vp = (v + 1) & (LANES - 1);          // lane read by rolled "up"
  const size_t ld = (size_t)B * LANES;
  const size_t tile = (size_t)b * rows * LANES;

  for (int r = 0; r < rows; ++r) sp[r * LANES + v] = spins_in[tile + r * LANES + v] > 0.0f ? 1 : -1;

  const uint32_t* rsrc = rng_in + (size_t)b * LANES + v;
  uint32_t* rcol = rng_out + (size_t)b * LANES + v;
  float* ucol = u_scratch ? u_scratch + (size_t)b * LANES + v : nullptr;  // blocks > 1 only
  const int blocks = (rows + MT_N - 1) / MT_N;
  const int last0 = (blocks - 1) * MT_N;  // first row drawn from the last block
  const float m2b = -2.0f * beta[b];

  if (num_sweeps == 0)
    for (int i = 0; i < MT_N; ++i) rcol[i * ld] = rsrc[i * ld];
  __syncthreads();

  for (int sweep = 0; sweep < num_sweeps; ++sweep) {
    for (int blk = 0; blk < blocks; ++blk) {
      twist_column(sweep == 0 && blk == 0 ? rsrc : rcol, rcol, ld);
      if (blk + 1 < blocks)
        for (int i = 0; i < MT_N; ++i) ucol[(blk * MT_N + i) * ld] = uniform24(rcol[i * ld]);
    }
    for (int c = 0; c < C; ++c) {
      for (int k = cls_off[c]; k < cls_off[c + 1]; ++k) {
        const int r = cls_row[k];
        const float s = (float)sp[r * LANES + v];
        float hs = cls_h[k];
        for (int d = 0; d < sd; ++d) hs = hs + cls_J[k * sd + d] * (float)sp[cls_tgt[k * sd + d] * LANES + v];
        const int roll = cls_roll[k];
        const float down = (float)sp[cls_down[k] * LANES + ((roll & 1) ? vm : v)];
        const float up = (float)sp[cls_up[k] * LANES + ((roll & 2) ? vp : v)];
        const float ht = cls_tau[k] * (down + up);
        const float p = fastexp_fast((m2b * s) * (hs + ht), scale, centre);
        const float u = r < last0 ? ucol[r * ld] : uniform24(rcol[(r - last0) * ld]);
        if (u < p) sp[r * LANES + v] = (int8_t)(s > 0.0f ? -1 : 1);
      }
      __syncthreads();  // the next class reads this one's rows, other lanes too
    }
  }

  // Dense field refresh of the final spins (metropolis.lane_h_eff).
  const int lpv = rows / n;
  for (int r = 0; r < rows; ++r) {
    const int p = r / n, i = r - p * n;
    float hs = h[i];
    for (int d = 0; d < sd; ++d) hs = hs + J[i * sd + d] * (float)sp[(p * n + nbr[i * sd + d]) * LANES + v];
    const float down = p == 0 ? (float)sp[((lpv - 1) * n + i) * LANES + vm] : (float)sp[(r - n) * LANES + v];
    const float up = p == lpv - 1 ? (float)sp[i * LANES + vp] : (float)sp[(r + n) * LANES + v];
    const size_t o = tile + r * LANES + v;
    spins_out[o] = (float)sp[r * LANES + v];
    h_space[o] = hs;
    h_tau[o] = tau[i] * (down + up);
  }
}

}  // namespace

// Launches one CTA per replica on `stream`; returns cudaGetLastError().
extern "C" int colored_multisweep(
    const float* spins_in, const uint32_t* rng_in, const float* beta, float* spins_out,
    float* h_space, float* h_tau, uint32_t* rng_out, float* u_scratch, const int* cls_off,
    const int* cls_row, const float* cls_h, const float* cls_J, const int* cls_tgt,
    const float* cls_tau, const int* cls_down, const int* cls_up, const int* cls_roll,
    const float* h, const int* nbr, const float* J, const float* tau, int B, int rows, int n,
    int sd, int C, int num_sweeps, uint32_t scale_bits, uint32_t centre_bits, void* stream) {
  const size_t smem = (size_t)rows * LANES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(colored_multisweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float scale, centre;
  memcpy(&scale, &scale_bits, sizeof scale);
  memcpy(&centre, &centre_bits, sizeof centre);
  colored_multisweep_kernel<<<B, LANES, smem, (cudaStream_t)stream>>>(
      spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls_off, cls_row,
      cls_h, cls_J, cls_tgt, cls_tau, cls_down, cls_up, cls_roll, h, nbr, J, tau, B, rows, n, sd,
      C, num_sweeps, scale, centre);
  return (int)cudaGetLastError();
}
