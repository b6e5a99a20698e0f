// One a4 Metropolis sweep per launch, uniforms from the caller.
//
// Replaces the TPU kernel src/repro/kernels/metropolis_kernel.py:
// metropolis_sweep_kernel (the host-uniform flavour of _make_fused_body,
// row walk _row_sweep).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:metropolis_sweep_ref; the two agree bit
// for bit.  It is the per-sweep half of the launch-structure comparison:
// a sweep's uniforms come from mt_next_block.cu (or any caller) as a
// (B, rows, 128) float32 buffer, and this kernel walks the rows over them.
//
// Layout and row walk: as metropolis_multisweep.cu, through the same
// device code (a4_sweep.cuh), with no generator.
//
// What bounds it.  Per launch the function must move
//     4*B*7*rows*128 bytes
// (spins, h_space, h_tau, uniforms in; spins, h_space, h_tau out): 5.5 MB
// at B=8, rows=192, 1.6 us at the HBM rate; its operations (per spin, 2
// int ops and 2*sd+15 float ops) take 0.2 us at B=8, so bytes bound it.
// With one CTA per replica, the serial row walk is what sets its time, as
// in the fused kernel; what this launch structure adds is a launch and a
// uniform buffer per sweep, which is what the comparison measures.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "a4_sweep.cuh"

namespace {

__global__ void __launch_bounds__(LANES) metropolis_sweep_kernel(
    const float* __restrict__ spins_in, const float* __restrict__ hs_in,
    const float* __restrict__ ht_in, const float* __restrict__ u, const int* __restrict__ nbr,
    const float* __restrict__ j2, const float* __restrict__ tau2, const float* __restrict__ beta,
    float* __restrict__ spins_out, float* hs_out, float* ht_out, int rows, int n, int sd,
    bool fields_in_smem, float scale, float centre) {
  extern __shared__ __align__(16) unsigned char smem[];
  const A4Tile t = a4_load(smem, spins_in, hs_in, ht_in, hs_out, ht_out, rows, fields_in_smem);
  const BufferUniforms uniform{u + (size_t)blockIdx.x * rows * LANES + threadIdx.x};
  int parity = 0;
  a4_sweep(t, parity, nbr, j2, tau2, rows, n, sd, -2.0f * beta[blockIdx.x], scale, centre,
           uniform);
  a4_store(t, spins_out, hs_out, ht_out, rows, fields_in_smem);
}

}  // namespace

// Launches one CTA per replica on `stream`; returns cudaGetLastError().
extern "C" int metropolis_sweep(const float* spins_in, const float* hs_in, const float* ht_in,
                                const float* u, const int* nbr, const float* j2, const float* tau2,
                                const float* beta, float* spins_out, float* hs_out, float* ht_out,
                                int B, int rows, int n, int sd, int max_smem, uint32_t scale_bits,
                                uint32_t centre_bits, void* stream) {
  const bool fields_in_smem = a4_smem_bytes(rows, true) <= (size_t)max_smem;
  const size_t smem = a4_smem_bytes(rows, fields_in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(metropolis_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float scale, centre;
  memcpy(&scale, &scale_bits, sizeof scale);
  memcpy(&centre, &centre_bits, sizeof centre);
  metropolis_sweep_kernel<<<B, LANES, smem, (cudaStream_t)stream>>>(
      spins_in, hs_in, ht_in, u, nbr, j2, tau2, beta, spins_out, hs_out, ht_out, rows, n, sd,
      fields_in_smem, scale, centre);
  return (int)cudaGetLastError();
}
