// Multi-tenant fused a4 Metropolis multisweep with in-kernel MT19937: every
// slot sweeps its own model's doubled couplings on one shared lattice.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// metropolis_multisweep_multi_kernel (launch _fused_multisweep_call with
// multi=True, whose j2/tau2 operands are per-slot blocks of (B, rows, .)
// tables tiled from (B, n, .)).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:metropolis_multisweep_multi_ref; the two
// agree bit for bit.
//
// Layout.  metropolis_multisweep.cu with per-slot tables: one CTA per slot,
// 128 threads, thread v owns lane v and generator column b*128+v; the
// fused body a4_multisweep_cta of a4_sweep.cuh, which both kernels share.
// The row walk reads its couplings by site (row q reads site q % n), so the
// reference's tiling of the tables to (B, rows, .) is the same values read
// through j2_b + b*n*sd and tau2_b + b*n: no tiled copy is made.  The
// neighbour table is topology, shared by every slot.
//
// What bounds it.  metropolis_multisweep.cu's bytes plus the per-slot
// tables, 4*B*n*(sd+1) bytes (22 KB at B=8, n=96, sd=6), and the same
// operations: operations bound it, and one CTA per slot leaves it latency
// bound like the single-model kernel.  A slot's tables (2.7 KiB at n=96)
// stay in L1, as the shared tables do there.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "a4_sweep.cuh"

namespace {

__global__ void __launch_bounds__(LANES) metropolis_multisweep_multi_kernel(
    const float* __restrict__ spins_in, const float* __restrict__ hs_in,
    const float* __restrict__ ht_in, const uint32_t* rng_in, const int* __restrict__ nbr,
    const float* __restrict__ j2_b, const float* __restrict__ tau2_b,
    const float* __restrict__ beta, float* __restrict__ spins_out, float* hs_out, float* ht_out,
    uint32_t* rng_out, float* u_scratch, int rows, int n, int sd, int num_sweeps,
    bool fields_in_smem, float scale, float centre) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  a4_multisweep_cta(smem, spins_in, hs_in, ht_in, rng_in, nbr, j2_b + b * n * sd, tau2_b + b * n,
                    beta[b], spins_out, hs_out, ht_out, rng_out, u_scratch, rows, n, sd,
                    num_sweeps, fields_in_smem, scale, centre);
}

}  // namespace

// Launches one CTA per slot on `stream`; returns cudaGetLastError().
extern "C" int metropolis_multisweep_multi(
    const float* spins_in, const float* hs_in, const float* ht_in, const uint32_t* rng_in,
    const int* nbr, const float* j2_b, const float* tau2_b, const float* beta, float* spins_out,
    float* hs_out, float* ht_out, uint32_t* rng_out, float* u_scratch, int B, int rows, int n,
    int sd, int num_sweeps, int max_smem, uint32_t scale_bits, uint32_t centre_bits,
    void* stream) {
  const bool fields_in_smem = a4_smem_bytes(rows, true) <= (size_t)max_smem;
  const size_t smem = a4_smem_bytes(rows, fields_in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(metropolis_multisweep_multi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float scale, centre;
  memcpy(&scale, &scale_bits, sizeof scale);
  memcpy(&centre, &centre_bits, sizeof centre);
  metropolis_multisweep_multi_kernel<<<B, LANES, smem, (cudaStream_t)stream>>>(
      spins_in, hs_in, ht_in, rng_in, nbr, j2_b, tau2_b, beta, spins_out, hs_out, ht_out,
      rng_out, u_scratch, rows, n, sd, num_sweeps, fields_in_smem, scale, centre);
  return (int)cudaGetLastError();
}
