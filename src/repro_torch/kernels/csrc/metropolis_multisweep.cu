// Fused a4 Metropolis multisweep with in-kernel MT19937.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// metropolis_multisweep_kernel (launch _fused_multisweep_call, body
// _make_fused_body, row walk _row_sweep, RNG _draw_sweep_uniforms, exp
// core/fastexp.py:fastexp_fast).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:metropolis_multisweep_ref; the two agree
// bit for bit.
//
// Layout.  One CTA per replica, 128 threads, thread v owns lane v: the
// lattice column v of every lane row, and MT19937 generator column
// b*128+v of the (624, B*128) interlaced state.  Every state-row, spin-row
// and field-row access of a warp is 32 neighbouring words.  The row walk
// and the fused per-replica body are a4_sweep.cuh (the walk shared with
// metropolis_sweep.cu, the body with metropolis_multisweep_multi.cu); the
// twist and temper are mt19937.cuh.
//
// What bounds it.  Per launch the function must move
//     4*B*(6*rows*128 + 2*624*128) bytes
// (spins, h_space, h_tau in and out; generator state in and out): 9.8 MB
// at B=8, rows=192, 2.9 us at the HBM rate.  Its operations take longer:
// 8 int ops per generator word twisted, and per spin per sweep 14 int ops
// (tempering, conversions, the exp's bias add) and 2*sd+16 float ops come
// to 3.8 us at the card's int32 rate (8 sweeps, B=8), so operations bound
// it.  With one CTA per replica only B of the 132 SMs work: the same
// operations take at least 62 us.  This design is far from both: the row
// walk is a serial chain (a row's flip reads fields that the rows before
// it wrote), so the only parallelism is lanes x replicas, and each row is
// a chain of dependent shared-memory read-modify-writes.  What the design
// does about it: the tile lives in shared memory (int8 spins, float32
// fields: 221 KiB at rows=192), so a row step never touches device memory
// except for its uniform; the tables are small and broadcast from L1; the
// generator is twisted once per block, 8 rows of loads ahead of the
// stores, and the last block of a sweep is tempered on the fly, so it
// needs no buffer.  With rows > 624 the earlier blocks of a sweep are
// overwritten by the next twist, so their uniforms go to a scratch buffer
// the caller allocates; with rows > 200 the fields do not fit shared
// memory and stay in the output tensors (each thread its own column).
//
// Fields.  h_space and h_tau come in and go out updated incrementally, as
// in the reference; they are never recomputed densely, which would change
// their bits.
//
// Numerics.  Every field update multiplies by -S_mul in {-1, -0, +0, +1}
// and rounds once; the build passes --fmad=false so the compiled code is
// the written expression.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "a4_sweep.cuh"

namespace {

__global__ void __launch_bounds__(LANES) metropolis_multisweep_kernel(
    const float* __restrict__ spins_in, const float* __restrict__ hs_in,
    const float* __restrict__ ht_in, const uint32_t* rng_in, const int* __restrict__ nbr,
    const float* __restrict__ j2, const float* __restrict__ tau2, const float* __restrict__ beta,
    float* __restrict__ spins_out, float* hs_out, float* ht_out, uint32_t* rng_out,
    float* u_scratch, int rows, int n, int sd, int num_sweeps, bool fields_in_smem, float scale,
    float centre) {
  extern __shared__ __align__(16) unsigned char smem[];
  a4_multisweep_cta(smem, spins_in, hs_in, ht_in, rng_in, nbr, j2, tau2, beta[blockIdx.x],
                    spins_out, hs_out, ht_out, rng_out, u_scratch, rows, n, sd, num_sweeps,
                    fields_in_smem, scale, centre);
}

}  // namespace

// Launches one CTA per replica on `stream`; returns cudaGetLastError().
extern "C" int metropolis_multisweep(const float* spins_in, const float* hs_in, const float* ht_in,
                                     const uint32_t* rng_in, const int* nbr, const float* j2,
                                     const float* tau2, const float* beta, float* spins_out,
                                     float* hs_out, float* ht_out, uint32_t* rng_out,
                                     float* u_scratch, int B, int rows, int n, int sd,
                                     int num_sweeps, int max_smem, uint32_t scale_bits,
                                     uint32_t centre_bits, void* stream) {
  const bool fields_in_smem = a4_smem_bytes(rows, true) <= (size_t)max_smem;
  const size_t smem = a4_smem_bytes(rows, fields_in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(metropolis_multisweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float scale, centre;
  memcpy(&scale, &scale_bits, sizeof scale);
  memcpy(&centre, &centre_bits, sizeof centre);
  metropolis_multisweep_kernel<<<B, LANES, smem, (cudaStream_t)stream>>>(
      spins_in, hs_in, ht_in, rng_in, nbr, j2, tau2, beta, spins_out, hs_out, ht_out, rng_out,
      u_scratch, rows, n, sd, num_sweeps, fields_in_smem, scale, centre);
  return (int)cudaGetLastError();
}
