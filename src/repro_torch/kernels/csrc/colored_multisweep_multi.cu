// Multi-tenant fused colored ("cb") multisweep with in-kernel MT19937: every
// slot sweeps its own model's couplings on one shared lattice.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// make_colored_multisweep_multi_kernel (its body _make_colored_multi_body,
// which binds each slot's coupling slices onto the shared color classes with
// metropolis.class_coupling_slices / bind_class_tables).  The plain PyTorch
// version is src/repro_torch/kernels/ref.py:colored_multisweep_multi_ref;
// the two agree bit for bit for every exp flavour, as in
// colored_multisweep.cu.
//
// Layout.  As colored_multisweep.cu: one CTA of 128 * W threads per slot,
// the class walk, generator and dense refresh of colored_sweep.cuh.  The
// structural class tables are shared by all slots.  Slot b reads its own
// site tables h_b[b] (n), J_b[b] (n, sd) and tau_b[b] (n); class entry k
// reads them at its site cls_site[k] = row % n (the gather
// class_coupling_slices does).  That gather happens once a launch, when
// the CTA stages the coefficients per entry in shared memory, so the
// class walk is #1's.  With B copies of one model every float equals the
// single-model kernel's.
//
// What bounds it.  The single-model kernel's bytes plus the per-slot site
// tables, 4*B*n*(sd+2) bytes (25 KB at B=8, n=96, sd=6), and the same
// operations: operations bound it, and one CTA per slot takes at least
// the single-model kernel's 62 us at B=8.  On an NVIDIA H100 80GB HBM3 at
// 700 W the first design, where each class entry read its site from
// device memory before its coefficients inside the walk, was 14-19%
// slower than #1 (1.59-1.61 ms an 8-sweep launch at B=8); staged, the
// gather leaves the walk and #2 takes what #1 takes, 0.17-0.19 ms
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "colored_sweep.cuh"

namespace {

template <int F>
__global__ void __launch_bounds__(CB_LANES * CB_MAX_GROUPS) colored_multisweep_multi_kernel(
    const float* __restrict__ spins_in, const uint32_t* rng_in,
    const float* __restrict__ beta, float* __restrict__ spins_out,
    float* __restrict__ h_space, float* __restrict__ h_tau, uint32_t* rng_out,
    float* u_scratch, ColorTables cls, const int* __restrict__ cls_site,
    const float* __restrict__ h_b, const float* __restrict__ J_b,
    const float* __restrict__ tau_b, int rows, int n, int sd, int num_sweeps, ExpConsts ec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  colored_multisweep_cta<F>(smem, spins_in, rng_in, beta[b], spins_out, h_space, h_tau, rng_out,
                            u_scratch, cls, SiteCoef{cls_site}, h_b + b * n, J_b + b * n * sd,
                            tau_b + b * n, rows, sd, num_sweeps, ec);
}

template <int F>
int launch(const float* spins_in, const uint32_t* rng_in, const float* beta, float* spins_out,
           float* h_space, float* h_tau, uint32_t* rng_out, float* u_scratch,
           const ColorTables& cls, const int* cls_site, const float* h_b, const float* J_b,
           const float* tau_b, int B, int rows, int n, int sd, int num_sweeps, int warp_groups,
           const ExpConsts& ec, cudaStream_t stream) {
  const size_t smem = cb_smem_bytes(rows, sd, cls.C, cb_u_in_smem(u_scratch, num_sweeps));
  const int attr = colored_smem_attr(colored_multisweep_multi_kernel<F>, smem);
  if (attr != 0) return attr;
  colored_multisweep_multi_kernel<F><<<B, CB_LANES * warp_groups, smem, stream>>>(
      spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls, cls_site, h_b,
      J_b, tau_b, rows, n, sd, num_sweeps, ec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one CTA of 128 * warp_groups threads per slot on `stream`;
// u_scratch, flavour and the exp's constants as in colored_multisweep.
// Returns cudaGetLastError() (or the first check's error).
extern "C" int colored_multisweep_multi(
    const float* spins_in, const uint32_t* rng_in, const float* beta, float* spins_out,
    float* h_space, float* h_tau, uint32_t* rng_out, float* u_scratch, const int* cls_off,
    const int* cls_row, const int* cls_site, const int* cls_tgt, const int* cls_down,
    const int* cls_up, const int* cls_roll, const float* h_b, const float* J_b,
    const float* tau_b, int B, int rows, int n, int sd, int C, int num_sweeps, int warp_groups,
    int flavour, uint32_t scale_bits, uint32_t centre_bits, uint32_t scale4_bits,
    uint32_t lo_bits, uint32_t clip_hi_bits, void* stream) {
  const int bad =
      cb_check(warp_groups, spins_in, rng_in, spins_out, h_space, h_tau, rng_out, u_scratch);
  if (bad != 0) return bad;
  const ColorTables cls{cls_off, cls_row, cls_tgt, cls_down, cls_up, cls_roll, C};
  const ExpConsts ec = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
#define CB_CALL(F)                                                                            \
  launch<F>(spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls,       \
            cls_site, h_b, J_b, tau_b, B, rows, n, sd, num_sweeps, warp_groups, ec,           \
            (cudaStream_t)stream)
  return SWEEP_EXP_DISPATCH(flavour, CB_CALL);
#undef CB_CALL
}
