// Multi-tenant fused a4 Metropolis multisweep with in-kernel MT19937: every
// slot sweeps its own model's doubled couplings on one shared lattice.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// metropolis_multisweep_multi_kernel (launch _fused_multisweep_call with
// multi=True, whose j2/tau2 operands are per-slot blocks of (B, rows, .)
// tables tiled from (B, n, .)).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:metropolis_multisweep_multi_ref; the two
// agree bit for bit for every exp flavour.
//
// Layout.  metropolis_multisweep.cu with per-slot tables, through the same
// body (a4_sweep.cuh: a4_cta with multi set): a CTA stages each of its
// replicas' slot tables (j2_b + b*n*sd, tau2_b + b*n) beside the shared
// neighbour table, so the row walk is the single-model kernel's.  The
// reference's tiling of the tables to (B, rows, .) is the same values read
// by site (row q reads site q % n): no tiled copy is made.
//
// What bounds it.  metropolis_multisweep.cu's bytes plus the per-slot
// tables, 4*B*n*(sd+1) bytes (22 KB at B=8, n=96, sd=6), and the same
// operations: operations bound it, and the serial row walk sets its time
// as in the single-model kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "a4_sweep.cuh"

namespace {

template <bool FIELDS_IN_SMEM, int SDT, int F>
__global__ void __launch_bounds__(A4_MAX_THREADS)
    metropolis_multisweep_multi_kernel(A4_KERNEL_PARAMS) {
  a4_cta<FIELDS_IN_SMEM, SDT, F>(A4_KERNEL_IO, sh);
}

}  // namespace

// As metropolis_multisweep, with (B, n, sd) j2_b and (B, n) tau2_b.
extern "C" int metropolis_multisweep_multi(
    const float* spins_in, const float* hs_in, const float* ht_in, const uint32_t* rng_in,
    const int* nbr, const float* j2_b, const float* tau2_b, const float* beta, float* spins_out,
    float* hs_out, float* ht_out, uint32_t* rng_out, float* u_scratch, int B, int rows, int n,
    int sd, int num_sweeps, int max_smem, int tile, int flavour, uint32_t scale_bits,
    uint32_t centre_bits, uint32_t scale4_bits, uint32_t lo_bits, uint32_t clip_hi_bits,
    void* stream) {
  const A4Io io{spins_in, hs_in, ht_in, rng_in, nbr, j2_b, tau2_b, beta,
                spins_out, hs_out, ht_out, rng_out, u_scratch};
  A4Shape sh{B, rows, n, sd, num_sweeps, tile, true, true};
  sh.ec = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
  return A4_LAUNCH(metropolis_multisweep_multi_kernel, io, sh, flavour, max_smem, stream);
}
