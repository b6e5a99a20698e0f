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
// buffer the caller allocates.  The class walk and the dense refresh are
// colored_sweep.cuh, shared with the multi-tenant kernel
// colored_multisweep_multi.cu; here the class coefficients arrive gathered
// per class entry on the host (cls_h, cls_J, cls_tau).
//
// Numerics: see colored_sweep.cuh.  The float->int step of the exp is
// __float2int_rz, which truncates, saturates and maps NaN to 0, like the
// reference; the bias add wraps modulo 2^32.  The two float constants
// arrive as bit patterns.  The twist, temper and exp device code is shared:
// mt19937.cuh and fastexp.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "colored_sweep.cuh"

namespace {

__global__ void __launch_bounds__(CB_LANES) colored_multisweep_kernel(
    const float* __restrict__ spins_in, const uint32_t* rng_in,
    const float* __restrict__ beta, float* __restrict__ spins_out,
    float* __restrict__ h_space, float* __restrict__ h_tau, uint32_t* rng_out,
    float* u_scratch, ColorTables cls, const float* __restrict__ cls_h,
    const float* __restrict__ cls_J, const float* __restrict__ cls_tau,
    const float* __restrict__ h, const int* __restrict__ nbr,
    const float* __restrict__ J, const float* __restrict__ tau, int rows,
    int n, int sd, int num_sweeps, float scale, float centre) {
  extern __shared__ int8_t sp[];  // (rows, 128) spins as +-1
  colored_multisweep_cta(sp, spins_in, rng_in, beta[blockIdx.x], spins_out, h_space, h_tau,
                         rng_out, u_scratch, cls, EntryCoef{}, cls_h, cls_J, cls_tau, h, nbr, J,
                         tau, rows, n, sd, num_sweeps, scale, centre);
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
  const size_t smem = (size_t)rows * CB_LANES;
  const int attr = colored_smem_attr(colored_multisweep_kernel, smem);
  if (attr != 0) return attr;
  float scale, centre;
  memcpy(&scale, &scale_bits, sizeof scale);
  memcpy(&centre, &centre_bits, sizeof centre);
  const ColorTables cls{cls_off, cls_row, cls_tgt, cls_down, cls_up, cls_roll, C};
  colored_multisweep_kernel<<<B, CB_LANES, smem, (cudaStream_t)stream>>>(
      spins_in, rng_in, beta, spins_out, h_space, h_tau, rng_out, u_scratch, cls, cls_h, cls_J,
      cls_tau, h, nbr, J, tau, rows, n, sd, num_sweeps, scale, centre);
  return (int)cudaGetLastError();
}
