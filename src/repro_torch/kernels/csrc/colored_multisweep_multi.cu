// Multi-tenant fused colored ("cb") multisweep with in-kernel MT19937: every
// slot sweeps its own model's couplings on one shared lattice.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// make_colored_multisweep_multi_kernel (its body _make_colored_multi_body,
// which binds each slot's coupling slices onto the shared color classes with
// metropolis.class_coupling_slices / bind_class_tables).  The plain PyTorch
// version is src/repro_torch/kernels/ref.py:colored_multisweep_multi_ref;
// the two agree bit for bit.
//
// Layout.  As colored_multisweep.cu: one CTA per slot, 128 threads, thread
// v owns lane v and generator column b*128+v; int8 spins in shared memory;
// the class walk and dense refresh of colored_sweep.cuh.  The structural
// class tables are shared by all slots.  Slot b reads its own site tables
// h_b[b] (n), J_b[b] (n, sd) and tau_b[b] (n); class entry k reads them at
// its site cls_site[k] = row % n (the gather class_coupling_slices does), so
// the launch needs no gather step.  With B copies of one model every float
// equals the single-model kernel's.
//
// What bounds it.  The single-model kernel's bytes plus the per-slot site
// tables, 4*B*n*(sd+2) bytes (25 KB at B=8, n=96, sd=6), and the same
// operations: operations bound it, and one CTA per slot leaves it latency
// bound like colored_multisweep.cu.  A slot's site tables (3 KiB at n=96)
// stay in L1; each class entry reads its site before its coefficients, one
// more dependent load than the single-model kernel: 14-15% slower than it
// at B=8 on an NVIDIA H100 80GB HBM3 at 700 W.  Gathering the coefficients
// into shared memory once per launch did not make it reliably faster on
// that card (PERF.md), so the kernel keeps the direct reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "colored_sweep.cuh"

namespace {

__global__ void __launch_bounds__(CB_LANES) colored_multisweep_multi_kernel(
    const float* __restrict__ spins_in, const uint32_t* rng_in,
    const float* __restrict__ beta, float* __restrict__ spins_out,
    float* __restrict__ h_space, float* __restrict__ h_tau, uint32_t* rng_out,
    float* u_scratch, ColorTables cls, const int* __restrict__ cls_site,
    const float* __restrict__ h_b, const int* __restrict__ nbr,
    const float* __restrict__ J_b, const float* __restrict__ tau_b, int rows, int n, int sd,
    int num_sweeps, float scale, float centre) {
  extern __shared__ int8_t sp[];  // (rows, 128) spins as +-1
  const size_t b = blockIdx.x;
  const float* h = h_b + b * n;
  const float* J = J_b + b * n * sd;
  const float* tau = tau_b + b * n;
  colored_multisweep_cta(sp, spins_in, rng_in, beta[b], spins_out, h_space, h_tau, rng_out,
                         u_scratch, cls, SiteCoef{cls_site}, h, J, tau, h, nbr, J, tau, rows, n,
                         sd, num_sweeps, scale, centre);
}

}  // namespace

// Launches one CTA per slot on `stream`; returns cudaGetLastError().
extern "C" int colored_multisweep_multi(
    const float* spins_in, const uint32_t* rng_in, const float* beta, float* spins_out,
    float* h_space, float* h_tau, uint32_t* rng_out, float* u_scratch, const int* cls_off,
    const int* cls_row, const int* cls_site, const int* cls_tgt, const int* cls_down,
    const int* cls_up, const int* cls_roll, const float* h_b, const int* nbr, const float* J_b,
    const float* tau_b, int B, int rows, int n, int sd, int C, int num_sweeps,
    uint32_t scale_bits, uint32_t centre_bits, void* stream) {
  const size_t smem = (size_t)rows * CB_LANES;
  const int attr = colored_smem_attr(colored_multisweep_multi_kernel, smem);
  if (attr != 0) return attr;
  float scale, centre;
  memcpy(&scale, &scale_bits, sizeof scale);
  memcpy(&centre, &centre_bits, sizeof centre);
  const ColorTables cls{cls_off, cls_row, cls_tgt, cls_down, cls_up, cls_roll, C};
  colored_multisweep_multi_kernel<<<B, CB_LANES, smem, (cudaStream_t)stream>>>(
      spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls, cls_site, h_b,
      nbr, J_b, tau_b, rows, n, sd, num_sweeps, scale, centre);
  return (int)cudaGetLastError();
}
