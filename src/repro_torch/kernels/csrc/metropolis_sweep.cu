// One a4 Metropolis sweep per launch, uniforms from the caller.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// metropolis_sweep_kernel (the host-uniform flavour of _make_fused_body,
// row walk _row_sweep).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:metropolis_sweep_ref; the two agree bit
// for bit for every exp flavour.  It is the per-sweep half of the
// launch-structure comparison: a sweep's uniforms come from
// mt_next_block.cu (or any caller) as a (B, rows, 128) float32 buffer, and
// this kernel walks the rows over them.
//
// Layout and row walk: the fused kernels' (a4_sweep.cuh: a4_cta without
// the generator), one replica a CTA; the CTA's other warps only help with
// the tile's load and store.
//
// What bounds it.  Per launch the function must move
//     4*B*7*rows*128 bytes
// (spins, h_space, h_tau, uniforms in; spins, h_space, h_tau out): 5.5 MB
// at B=8, rows=192, 1.6 us at the HBM rate; its operations take 0.2 us at
// B=8, so bytes bound it.  The serial row walk is what sets its time, as
// in the fused kernel; what this launch structure adds is a launch and a
// uniform buffer per sweep, which is what the comparison measures.

#include <cuda_runtime.h>
#include <stdint.h>

#include "a4_sweep.cuh"

namespace {

template <bool FIELDS_IN_SMEM, int SDT, int F>
__global__ void __launch_bounds__(A4_MAX_THREADS) metropolis_sweep_kernel(A4_KERNEL_PARAMS) {
  a4_cta<FIELDS_IN_SMEM, SDT, F>(A4_KERNEL_IO, sh);
}

}  // namespace

// Launches one CTA per replica on `stream`; flavour and the exp's constants
// as in metropolis_multisweep.  Returns a CUDA error code.
extern "C" int metropolis_sweep(const float* spins_in, const float* hs_in, const float* ht_in,
                                const float* u, const int* nbr, const float* j2, const float* tau2,
                                const float* beta, float* spins_out, float* hs_out, float* ht_out,
                                int B, int rows, int n, int sd, int max_smem, int flavour,
                                uint32_t scale_bits, uint32_t centre_bits, uint32_t scale4_bits,
                                uint32_t lo_bits, uint32_t clip_hi_bits, void* stream) {
  const A4Io io{spins_in, hs_in, ht_in, nullptr, nbr, j2, tau2, beta,
                spins_out, hs_out, ht_out, nullptr, const_cast<float*>(u)};
  A4Shape sh{B, rows, n, sd, 1, 1, false, false};
  sh.ec = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
  return A4_LAUNCH(metropolis_sweep_kernel, io, sh, flavour, max_smem, stream);
}
