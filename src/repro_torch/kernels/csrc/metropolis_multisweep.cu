// Fused a4 Metropolis multisweep with in-kernel MT19937.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// metropolis_multisweep_kernel (launch _fused_multisweep_call, body
// _make_fused_body, row walk _row_sweep, RNG _draw_sweep_uniforms, exp
// core/fastexp.py:EXP_FNS[exp_flavor]).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:metropolis_multisweep_ref; the two agree
// bit for bit for every exp flavour ("fast", "accurate", "exact": a
// template parameter of the kernel, picked by the entry's flavour code).
//
// Layout.  A CTA holds `tile` replicas (1 unless the caller asks for a
// replica tile): 4 walker warps each, a lane a thread, and up to 5
// generator warps that twist the replicas' MT19937 columns b*128 ..
// b*128+127 of the (624, B*128) interlaced state and temper each sweep's
// uniforms into the scratch u (B, 2, rows, 128): sweep s+1's while sweep s
// is walked.
// The body is a4_sweep.cuh (shared with metropolis_multisweep_multi.cu and,
// for the walk, metropolis_sweep.cu); the split twist is mt19937.cuh.
//
// What bounds it.  Per launch the function must move
//     4*B*(6*rows*128 + 2*624*128) bytes
// (spins, h_space, h_tau in and out; generator state in and out): 9.8 MB
// at B=8, rows=192, 2.9 us at the HBM rate.  Its operations take longer
// (chip_smoke.py: a4_counts): 3.8 us at the card's int32 rate for 8 sweeps
// at B=8, so operations bound it.  The row walk is a serial chain (a row's
// flip reads fields that the rows before it wrote): a4_sweep.cuh says what
// the design does about it.
//
// Fields.  h_space and h_tau come in and go out updated incrementally, as
// in the reference; they are never recomputed densely, which would change
// their bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "a4_sweep.cuh"

namespace {

template <bool FIELDS_IN_SMEM, int SDT, int F>
__global__ void __launch_bounds__(A4_MAX_THREADS) metropolis_multisweep_kernel(A4_KERNEL_PARAMS) {
  a4_cta<FIELDS_IN_SMEM, SDT, F>(A4_KERNEL_IO, sh);
}

}  // namespace

// Launches B / tile CTAs on `stream`; u_scratch holds (B, 2, rows, 128)
// floats; `flavour` is the exp (EXP_FAST, EXP_ACCURATE or EXP_EXACT) and
// the five bit patterns are its constants (fastexp.cuh: ExpConsts).
// Returns a CUDA error code (0 on success).
extern "C" int metropolis_multisweep(const float* spins_in, const float* hs_in, const float* ht_in,
                                     const uint32_t* rng_in, const int* nbr, const float* j2,
                                     const float* tau2, const float* beta, float* spins_out,
                                     float* hs_out, float* ht_out, uint32_t* rng_out,
                                     float* u_scratch, int B, int rows, int n, int sd,
                                     int num_sweeps, int max_smem, int tile, int flavour,
                                     uint32_t scale_bits, uint32_t centre_bits,
                                     uint32_t scale4_bits, uint32_t lo_bits,
                                     uint32_t clip_hi_bits, void* stream) {
  const A4Io io{spins_in, hs_in, ht_in, rng_in, nbr, j2, tau2, beta,
                spins_out, hs_out, ht_out, rng_out, u_scratch};
  A4Shape sh{B, rows, n, sd, num_sweeps, tile, false, true};
  sh.ec = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
  return A4_LAUNCH(metropolis_multisweep_kernel, io, sh, flavour, max_smem, stream);
}
