// The fused colored ("cb") multisweep of one replica, shared by the
// single-model kernel (colored_multisweep.cu) and the multi-tenant one
// (colored_multisweep_multi.cu), as the reference's two colored bodies
// share colored_flip_spins and lane_h_eff.
//
// One CTA per replica, 128 threads, thread v owns lane v: the spin lattice
// column v of every lane row, and MT19937 generator column b*128+v of the
// (624, B*128) interlaced state.  Spins live in shared memory as int8
// (rows*128 bytes), so the C class updates and the final dense field pass
// never touch device memory.  Per sweep the generator column is twisted in
// device memory (mt19937.cuh); the last block of a sweep is tempered on the
// fly, earlier blocks (rows > 624) go to the caller's scratch buffer.
//
// Class tables.  The structural tables (rows, neighbour targets, tau
// sources, roll masks) are a function of the lattice only, so every slot
// of a multi-tenant engine shares them.  The coefficients (h, J, tau) of
// class entry k are read at index coef(k): the single-model kernel passes
// tables gathered per entry on the host (coef(k) = k), the multi-tenant
// kernel its slot's site tables (coef(k) = the entry's site, row % n: the
// gather the reference's class_coupling_slices does).  The dense refresh
// reads the site tables h (n), J (n, sd), tau (n) of the CTA's model.
//
// Numerics.  Every product multiplies by a spin (+-1), by a spin sum in
// {-2, 0, 2}, or is the one rounding of ((-2 beta) s) * h_eff and of
// x * 2^23 log2(e); the build passes --fmad=false so the compiled code is
// the written expression.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fastexp.cuh"
#include "mt19937.cuh"

namespace {

constexpr int CB_LANES = 128;

// Structural class tables: every class's entries concatenated in visit
// order, class c owning entries off[c] .. off[c+1]-1.
struct ColorTables {
  const int* __restrict__ off;
  const int* __restrict__ row;
  const int* __restrict__ tgt;   // (entries, sd) absolute neighbour rows
  const int* __restrict__ down;  // row holding the previous-layer spins
  const int* __restrict__ up;    // row holding the next-layer spins
  const int* __restrict__ roll;  // bit 0: down is lane-rolled, bit 1: up is
  int C;
};

struct EntryCoef {  // coefficients gathered per class entry
  __device__ int operator()(int k) const { return k; }
};

struct SiteCoef {  // coefficients of site tables, read through the entry's site
  const int* __restrict__ site;
  __device__ int operator()(int k) const { return site[k]; }
};

// Replica blockIdx.x: num_sweeps colored sweeps, then the dense field
// refresh.  ch/cJ/ctau are the class coefficients, read at coef(k);
// h/nbr/J/tau the site tables of the dense refresh.  sp is the CTA's
// (rows, 128) int8 shared-memory tile.
template <class Coef>
__device__ void colored_multisweep_cta(
    int8_t* sp, const float* __restrict__ spins_in, const uint32_t* rng_in, float beta,
    float* __restrict__ spins_out, float* __restrict__ h_space, float* __restrict__ h_tau,
    uint32_t* rng_out, float* u_scratch, ColorTables cls, const Coef& coef,
    const float* __restrict__ ch, const float* __restrict__ cJ, const float* __restrict__ ctau,
    const float* __restrict__ h, const int* __restrict__ nbr, const float* __restrict__ J,
    const float* __restrict__ tau, int rows, int n, int sd, int num_sweeps, float scale,
    float centre) {
  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int vm = (v + CB_LANES - 1) & (CB_LANES - 1);  // lane read by rolled "down"
  const int vp = (v + 1) & (CB_LANES - 1);             // lane read by rolled "up"
  const size_t ld = (size_t)gridDim.x * CB_LANES;
  const size_t tile = (size_t)b * rows * CB_LANES;

  for (int r = 0; r < rows; ++r)
    sp[r * CB_LANES + v] = spins_in[tile + r * CB_LANES + v] > 0.0f ? 1 : -1;

  const uint32_t* rsrc = rng_in + (size_t)b * CB_LANES + v;
  uint32_t* rcol = rng_out + (size_t)b * CB_LANES + v;
  float* ucol = u_scratch ? u_scratch + (size_t)b * CB_LANES + v : nullptr;  // blocks > 1 only
  const int blocks = (rows + MT_N - 1) / MT_N;
  const int last0 = (blocks - 1) * MT_N;  // first row drawn from the last block
  const float m2b = -2.0f * beta;

  if (num_sweeps == 0)
    for (int i = 0; i < MT_N; ++i) rcol[i * ld] = rsrc[i * ld];
  __syncthreads();

  for (int sweep = 0; sweep < num_sweeps; ++sweep) {
    for (int blk = 0; blk < blocks; ++blk) {
      twist_column(sweep == 0 && blk == 0 ? rsrc : rcol, rcol, ld);
      if (blk + 1 < blocks)
        for (int i = 0; i < MT_N; ++i) ucol[(blk * MT_N + i) * ld] = uniform24(rcol[i * ld]);
    }
    for (int c = 0; c < cls.C; ++c) {
      for (int k = cls.off[c]; k < cls.off[c + 1]; ++k) {
        const int r = cls.row[k];
        const int e = coef(k);
        const float s = (float)sp[r * CB_LANES + v];
        float hs = ch[e];
        for (int d = 0; d < sd; ++d)
          hs = hs + cJ[e * sd + d] * (float)sp[cls.tgt[k * sd + d] * CB_LANES + v];
        const int roll = cls.roll[k];
        const float down = (float)sp[cls.down[k] * CB_LANES + ((roll & 1) ? vm : v)];
        const float up = (float)sp[cls.up[k] * CB_LANES + ((roll & 2) ? vp : v)];
        const float ht = ctau[e] * (down + up);
        const float p = fastexp_fast((m2b * s) * (hs + ht), scale, centre);
        const float u = r < last0 ? ucol[r * ld] : uniform24(rcol[(r - last0) * ld]);
        if (u < p) sp[r * CB_LANES + v] = (int8_t)(s > 0.0f ? -1 : 1);
      }
      __syncthreads();  // the next class reads this one's rows, other lanes too
    }
  }

  // Dense field refresh of the final spins (metropolis.lane_h_eff).
  const int lpv = rows / n;
  for (int r = 0; r < rows; ++r) {
    const int p = r / n, i = r - p * n;
    float hs = h[i];
    for (int d = 0; d < sd; ++d)
      hs = hs + J[i * sd + d] * (float)sp[(p * n + nbr[i * sd + d]) * CB_LANES + v];
    const float down = p == 0 ? (float)sp[((lpv - 1) * n + i) * CB_LANES + vm]
                              : (float)sp[(r - n) * CB_LANES + v];
    const float up = p == lpv - 1 ? (float)sp[i * CB_LANES + vp] : (float)sp[(r + n) * CB_LANES + v];
    const size_t o = tile + r * CB_LANES + v;
    spins_out[o] = (float)sp[r * CB_LANES + v];
    h_space[o] = hs;
    h_tau[o] = tau[i] * (down + up);
  }
}

// Opt a kernel in to more than 48 KiB of dynamic shared memory when the
// tile needs it; returns the CUDA error (0 on success).
template <class Kernel>
int colored_smem_attr(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
