// The a4 row walk (core/metropolis.py:sweep_lane) on the card, shared by
// the fused multisweeps (metropolis_multisweep.cu, and its multi-tenant
// twin metropolis_multisweep_multi.cu) and the one-sweep kernel
// (metropolis_sweep.cu), as the reference's kernels share _row_sweep and
// _fused_multisweep_call.
//
// One CTA per replica, 128 threads, thread v owns lane v of every row.
// A row's spins, its space-neighbour rows and its tau rows are all in the
// thread's own lane, except the tau add of a wrap row: in the first layer
// block the down link is rolled by one lane, in the last block the up
// link.  Every field cell is written by its owner thread only ("owner
// computes"): a wrap row publishes its tau contribution tc[v] in a shared
// exchange buffer, one __syncthreads(), and each owner adds tc[v+1] or
// tc[v-1] into its own cell, in the reference's order.  The exchange
// buffer is double buffered, so one barrier a wrap row is enough: a
// thread can only rewrite a buffer after the next wrap row's barrier,
// which every reader of the old contents has passed.
//
// Shared memory of a CTA: the (2, 128) exchange buffers, then h_space and
// h_tau ((rows, 128) float32 each) when they fit, then the spins as int8
// (rows, 128).  Fields that do not fit (rows > 200) stay in the output
// tensors in global memory; each thread then reads and writes its own
// column, so a warp's row access is 32 neighbouring words.  The generic
// pointers in A4Tile serve both placements with one copy of the code.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "fastexp.cuh"
#include "mt19937.cuh"

namespace {

constexpr int LANES = 128;
constexpr size_t XBUF_BYTES = 2 * LANES * sizeof(float);

// Dynamic shared memory of one CTA for a tile of `rows` rows.
inline size_t a4_smem_bytes(int rows, bool fields_in_smem) {
  return XBUF_BYTES + (size_t)rows * LANES * (fields_in_smem ? 1 + 2 * sizeof(float) : 1);
}

struct A4Tile {
  int8_t* sp;   // (rows, LANES) spins, shared memory
  float* hs;    // (rows, LANES) h_space: shared memory or the output tile
  float* ht;    // (rows, LANES) h_tau: likewise
  float* xbuf;  // (2, LANES) tau exchange buffers, shared memory
};

// Bring replica `blockIdx.x`'s tile in: spins to shared memory, fields to
// shared memory or into the output tile.  No barrier is needed after it:
// every cell is read back by the thread that wrote it.
__device__ A4Tile a4_load(unsigned char* smem, const float* spins_in, const float* hs_in,
                          const float* ht_in, float* hs_out, float* ht_out, int rows,
                          bool fields_in_smem) {
  const int v = threadIdx.x;
  const size_t tile = (size_t)blockIdx.x * rows * LANES;
  A4Tile t;
  t.xbuf = reinterpret_cast<float*>(smem);
  float* f = t.xbuf + 2 * LANES;
  if (fields_in_smem) {
    t.hs = f;
    t.ht = f + (size_t)rows * LANES;
    t.sp = reinterpret_cast<int8_t*>(f + 2 * (size_t)rows * LANES);
  } else {
    t.hs = hs_out + tile;
    t.ht = ht_out + tile;
    t.sp = reinterpret_cast<int8_t*>(f);
  }
  for (int r = 0; r < rows; ++r) {
    const size_t o = (size_t)r * LANES + v;
    t.sp[o] = spins_in[tile + o] > 0.0f ? 1 : -1;
    t.hs[o] = hs_in[tile + o];
    t.ht[o] = ht_in[tile + o];
  }
  return t;
}

__device__ void a4_store(const A4Tile& t, float* spins_out, float* hs_out, float* ht_out,
                         int rows, bool fields_in_smem) {
  const int v = threadIdx.x;
  const size_t tile = (size_t)blockIdx.x * rows * LANES;
  for (int r = 0; r < rows; ++r) {
    const size_t o = (size_t)r * LANES + v;
    spins_out[tile + o] = (float)t.sp[o];
    if (fields_in_smem) {
      hs_out[tile + o] = t.hs[o];
      ht_out[tile + o] = t.ht[o];
    }
  }
}

// One a4 sweep of this thread's lane, rows in order.  `uniform(q)` is the
// lane's uniform of row q.  `parity` picks the exchange buffer of the next
// wrap row; it is carried across sweeps.  Tables: nbr/j2 (n, sd), the
// couplings pre-doubled, tau2 (n,).  m2b = -2 beta.
//
// Every float is the reference's expression: x = ((-2 beta) s) (hs + ht);
// S_mul = s * mask; each field add is cell + (-S_mul) * J2, a product with
// -S_mul in {-1, -0, +0, +1} and one rounding of the sum.
template <class Uniform>
__device__ void a4_sweep(const A4Tile& t, int& parity, const int* __restrict__ nbr,
                         const float* __restrict__ j2, const float* __restrict__ tau2, int rows,
                         int n, int sd, float m2b, float scale, float centre,
                         const Uniform& uniform) {
  const int v = threadIdx.x;
  const int lpv = rows / n;
  float u_next = uniform(0);  // loaded a row ahead: its latency overlaps a row step
  for (int p = 0; p < lpv; ++p) {
    const bool first = p == 0, last = p == lpv - 1;
    const int base = p * n;
    for (int i = 0; i < n; ++i) {
      const int q = base + i;
      const float uq = u_next;
      if (q + 1 < rows) u_next = uniform(q + 1);
      const int o = q * LANES + v;
      const float s = (float)t.sp[o];
      const float x = (m2b * s) * (t.hs[o] + t.ht[o]);
      const float mask = uq < fastexp_fast(x, scale, centre) ? 1.0f : 0.0f;
      const float ns = -(s * mask);
      t.sp[o] = (int8_t)(s * (1.0f - 2.0f * mask));
      for (int d = 0; d < sd; ++d) {
        const int k = (base + nbr[i * sd + d]) * LANES + v;
        t.hs[k] = t.hs[k] + ns * j2[i * sd + d];
      }
      const float tc = ns * tau2[i];
      if (first || last) {
        float* xb = t.xbuf + parity * LANES;
        parity ^= 1;
        xb[v] = tc;
        __syncthreads();
        if (first) {  // down link wraps: row rows-n+i gets tc rolled by -1, then row q+n
          const int w = (rows - n + i) * LANES + v;
          t.ht[w] = t.ht[w] + xb[(v + 1) & (LANES - 1)];
          t.ht[o + n * LANES] = t.ht[o + n * LANES] + tc;
        } else {  // up link wraps: row q-n gets tc, then row i gets tc rolled by +1
          const int w = i * LANES + v;
          t.ht[o - n * LANES] = t.ht[o - n * LANES] + tc;
          t.ht[w] = t.ht[w] + xb[(v + LANES - 1) & (LANES - 1)];
        }
      } else {
        t.ht[o - n * LANES] = t.ht[o - n * LANES] + tc;
        t.ht[o + n * LANES] = t.ht[o + n * LANES] + tc;
      }
    }
  }
}

// Uniforms drawn inside the kernel: the sweep's earlier generator blocks
// from the scratch column, the last block tempered on the fly from the
// freshly twisted state column.  Row stride ld words.
struct FusedUniforms {
  const float* ucol;
  const uint32_t* rcol;
  size_t ld;
  int last0;  // first row drawn from the last block
  __device__ float operator()(int r) const {
    return r < last0 ? ucol[r * ld] : uniform24(rcol[(r - last0) * ld]);
  }
};

// Replica blockIdx.x: num_sweeps fused a4 sweeps with the generator twisted
// in the kernel, then the tile's store.  nbr (n, sd), j2 (n, sd) and tau2
// (n) are the tables of the CTA's model (the multi-tenant kernel passes its
// slot's rows of the per-slot tables).  The earlier generator blocks of a
// sweep (rows > 624) go to u_scratch, the last one is tempered on the fly.
__device__ void a4_multisweep_cta(unsigned char* smem, const float* __restrict__ spins_in,
                                  const float* __restrict__ hs_in,
                                  const float* __restrict__ ht_in, const uint32_t* rng_in,
                                  const int* __restrict__ nbr, const float* __restrict__ j2,
                                  const float* __restrict__ tau2, float beta,
                                  float* __restrict__ spins_out, float* hs_out, float* ht_out,
                                  uint32_t* rng_out, float* u_scratch, int rows, int n, int sd,
                                  int num_sweeps, bool fields_in_smem, float scale,
                                  float centre) {
  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const size_t ld = (size_t)gridDim.x * LANES;
  const A4Tile t = a4_load(smem, spins_in, hs_in, ht_in, hs_out, ht_out, rows, fields_in_smem);

  const uint32_t* rsrc = rng_in + (size_t)b * LANES + v;
  uint32_t* rcol = rng_out + (size_t)b * LANES + v;
  float* ucol = u_scratch ? u_scratch + (size_t)b * LANES + v : nullptr;  // blocks > 1 only
  const int blocks = (rows + MT_N - 1) / MT_N;
  const FusedUniforms uniform{ucol, rcol, ld, (blocks - 1) * MT_N};
  const float m2b = -2.0f * beta;

  if (num_sweeps == 0)
    for (int i = 0; i < MT_N; ++i) rcol[i * ld] = rsrc[i * ld];

  int parity = 0;
  for (int sweep = 0; sweep < num_sweeps; ++sweep) {
    for (int blk = 0; blk < blocks; ++blk) {
      twist_column(sweep == 0 && blk == 0 ? rsrc : rcol, rcol, ld);
      if (blk + 1 < blocks)
        for (int i = 0; i < MT_N; ++i) ucol[(blk * MT_N + i) * ld] = uniform24(rcol[i * ld]);
    }
    a4_sweep(t, parity, nbr, j2, tau2, rows, n, sd, m2b, scale, centre, uniform);
  }
  a4_store(t, spins_out, hs_out, ht_out, rows, fields_in_smem);
}

// Uniforms from the caller's (B, rows, 128) buffer; u points at this
// thread's lane of its replica's tile.
struct BufferUniforms {
  const float* u;
  __device__ float operator()(int r) const { return u[(size_t)r * LANES]; }
};

}  // namespace
