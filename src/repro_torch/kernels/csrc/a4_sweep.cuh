// The a4 sweep (core/metropolis.py:sweep_lane) on the card, shared by the
// fused multisweeps (metropolis_multisweep.cu and its multi-tenant twin
// metropolis_multisweep_multi.cu) and the one-sweep kernel
// (metropolis_sweep.cu), as the reference's kernels share _row_sweep and
// _fused_multisweep_call.
//
// What bounds it on Hopper.  A sweep walks its rows in order and every row
// reads fields that the rows before it wrote, so a replica is one chain of
// row steps; only the 128 lanes of a row and the replicas run side by
// side.  The first design (one CTA of 128 threads a replica, a lane a
// thread) spent ~1,800 cycles a row against a ~94-cycle dependence chain:
// a CTA barrier on every wrap row, generic field pointers that the
// compiler could not prove distinct, tables read from device memory inside
// the row, int8 <-> float conversions, uniforms tempered one row ahead and
// a serial generator.  On the card a row step is latency bound (the flip's
// ~15 dependent operations between a load and a store) and issue bound
// (one warp issues its lanes' work in order, integer operations at half
// rate).  This design:
//  1. walks a replica with its own 4 walker warps, a lane a thread.  The
//     lane roll of a wrap row's tau add comes from the neighbouring thread
//     (thread 127 <-> 0 closes the ring) through shared memory and a named
//     barrier of just the replica's walker warps; no CTA barrier sits on
//     the row chain.  Every cell is written only by the thread that owns
//     it, in program order ("owner computes");
//  2. keeps h_space and h_tau in shared memory when they fit (rows <= ~200
//     at the paper's layout) and in the output tensors otherwise, chosen by
//     a template parameter: every access is typed (shared or global), never
//     generic, and every store one instruction.  A row issues all
//     its loads (own cells, the sd neighbour cells, the tau cells) before
//     any store, so the neighbour loads overlap;
//  3. stages the tables once a launch in shared memory: per site, its sd
//     neighbour entries (target row's byte offset, doubled J) sorted by
//     target (stable, so each cell's adds keep the reference's order), a
//     bit mask of the entries that hit the same cell as the entry before
//     them (the self-padded neighbour lists), and tau2.  sd is a template
//     parameter (rounded up to even), so a row's entries unroll into
//     registers; row q+1's entries are loaded during row q;
//  4. builds floats without conversions: a spin is a sign bit, x =
//     ((-2 beta) s) h is -2 beta with that sign times h, -S_mul is built
//     from the sign and the accept bit;
//  5. runs the generator on the CTA's other warps: the split three-phase
//     twist of mt19937.cuh (twist_block) under a named barrier of just
//     those warps, tempering each new word into a device-memory scratch of
//     the sweep's uniforms, which the walker copies (cp.async) 6 rows
//     ahead into a small ring in shared memory.  The generator twists
//     sweep s+1 into one of two buffers while the walker walks sweep s
//     from the other, one CTA barrier a sweep;
//  6. spreads the fixed cost (the tile load and store, the table staging,
//     the 0-sweep state copy) over all the CTA's threads, 16-byte words.
// A CTA holds `tile` replicas (the engine's replica_tile): their walkers
// each, and the generator warps twist every replica's columns in turn.
// PERF.md has the times of the alternatives measured (one warp of 4 lanes
// a thread, two of 2, the twist before the walk) and of this design.
//
// Numerics, for each lane in the reference's order: x = ((-2 beta) s)
// (hs + ht); the accept test u < sweep_exp<F>(x) with the exp flavour F, a
// template parameter ("fast", "accurate" or "exact", fastexp.cuh); S_mul = s * mask; each field add is cell + (-S_mul) * J2, a
// product with -S_mul in {-1, -0, +0, +1} and one rounding of the sum.  At
// two layer blocks both tau adds of a wrap row land in one cell: a
// first-block row adds the rolled tc then its own, a last-block row its
// own then the rolled one.  The build passes --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fastexp.cuh"
#include "mt19937.cuh"

extern __shared__ __align__(16) unsigned char a4_smem[];

namespace {

constexpr int LANES = 128;
constexpr int A4_MAX_SD = 8;          // space neighbours a site may have
constexpr int A4_URING = 8;           // rows of a walker's uniform ring in shared memory
constexpr int A4_UDIST = 6;           // rows a uniform is fetched ahead (< A4_URING)
constexpr int A4_UBUFS = 2;           // uniform buffers a replica: sweep s and s+1
constexpr int A4_WALKER_WARPS = LANES / 32;  // a replica's walker warps, a lane a thread
constexpr int A4_GEN_WARPS = 5;       // generator (or helper) warps a CTA, where they fit
constexpr int A4_MAX_THREADS = 384;   // threads a CTA, so that 168 registers a thread fit
constexpr int A4_GEN_BAR = 1;         // named barrier of the generator warps
constexpr int A4_XCH_BAR = 2;         // + replica: named barrier of its walker warps

__host__ __device__ inline size_t a4_align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Staged tables of one model: per site sd (target offset, J2 bits) and one
// (tau2 bits, same-cell mask) int2.
__host__ __device__ inline size_t a4_table_bytes(int n, int sd) {
  return a4_align16((size_t)n * (sd + 1) * sizeof(int2));
}

// Dynamic shared memory of a CTA of `tile` replicas: their h_space and
// h_tau (when fields_in_smem), their int8 spins, `tables` staged tables
// (one, or one a replica for the multi-tenant kernel), their
// (A4_URING, 128) uniform rings and (2, 128) tau exchange buffers.
// ops.a4_smem_bytes computes the same.
__host__ __device__ inline size_t a4_smem_bytes(int rows, int n, int sd, int tile, int tables,
                                                bool fields_in_smem) {
  const size_t cells = (size_t)tile * rows * LANES;
  return (fields_in_smem ? 2 * cells * sizeof(float) : 0) + cells +
         (size_t)tables * a4_table_bytes(n, sd) +
         (size_t)tile * (A4_URING + 2) * LANES * sizeof(float);
}

// The pointers of a launch.  Replica b's tile is (rows, 128) at b*rows*128
// of spins/fields; u holds its uniforms at (b*A4_UBUFS + buf)*rows*128 (the
// fused kernels' scratch) or b*rows*128 (the caller's, one sweep).
struct A4Io {
  const float* spins_in;
  const float* hs_in;
  const float* ht_in;
  const uint32_t* rng_in;
  const int* nbr;     // (n, sd) neighbour sites
  const float* j2;    // (n, sd) doubled couplings, or (B, n, sd) per slot
  const float* tau2;  // (n,) doubled tau couplings, or (B, n) per slot
  const float* beta;  // (B,)
  float* spins_out;
  float* hs_out;
  float* ht_out;
  uint32_t* rng_out;
  float* u;
};

struct A4Shape {
  int B, rows, n, sd, num_sweeps;
  int tile;       // replicas a CTA
  bool multi;     // per-slot j2/tau2
  bool generate;  // fused: MT19937 in the kernel; else one sweep on io.u
  ExpConsts ec;   // the exp's constants (fastexp.cuh)
  int gen_warps;  // warps besides the walkers: the generator (fused) or helpers (one sweep)
};

// -- the row walk ------------------------------------------------------------

__device__ __forceinline__ float a4_ld(const void* p) { return *reinterpret_cast<const float*>(p); }

// One store of a field cell, in shared (SMEM) or global memory, as one
// instruction and in program order.
template <bool SMEM>
__device__ __forceinline__ void a4_st(void* p, float x) {
  if constexpr (SMEM) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(x) : "memory");
  } else {
    asm volatile("st.global.f32 [%0], %1;" ::"l"(p), "f"(x) : "memory");
  }
}

// The sign bit of int8 spin c (+1 = 0x01, -1 = 0xFF) of a word, at bit 31.
__device__ __forceinline__ uint32_t a4_sign(uint32_t w, int c) {
  return (w << (24 - 8 * c)) & 0x80000000u;
}

// One row's staged entries, in registers: SDT neighbour entries (the
// model's sd rounded up to even; the last is unused when sd is odd).
template <int SDT>
struct A4Row {
  int off[SDT];  // target row's offset from its block's first row, in bytes
  float j[SDT];  // doubled coupling
  float tau;     // doubled tau coupling
  unsigned dup;  // bit d: entry d targets the row of entry d-1
};

template <int SDT>
__device__ __forceinline__ void a4_row_tables(A4Row<SDT>& r, const int2* e, int sd) {
#pragma unroll
  for (int d = 0; d < SDT; ++d)
    if (d < SDT - 1 || sd == SDT) {
      const int2 x = e[d];
      r.off[d] = x.x;
      r.j[d] = __int_as_float(x.y);
    }
  const int2 x = e[sd];
  r.tau = __int_as_float(x.x);
  r.dup = (unsigned)x.y;
}

// The neighbouring walker thread's value for the lane roll of a wrap row:
// thread t + from of the replica's 128 (a ring), through a double-buffered
// (2, 128) exchange buffer and a named barrier of just the replica's
// walker warps.  A thread rewrites a buffer only after the next wrap row's
// barrier, which every reader of its old contents has passed.
struct A4Exchange {
  int t;
  float* xb;
  int bar;
  int parity;
  __device__ __forceinline__ float operator()(float mine, int from) {
    float* b = xb + parity * LANES;
    parity ^= 1;
    b[t] = mine;
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(LANES) : "memory");
    return b[(t + from) & (LANES - 1)];
  }
};

// One row of the thread's lane: row offset o (bytes) in the thread's
// columns hs, ht (fields) and sp (spins, o / 4), hb its layer block's first
// row in hs.  first / last: the row is in the first / last layer block;
// dn = n rows, dw = rows - n rows, in bytes.  `full`: sd == SDT.  The
// accept test takes the exp flavour F (fastexp.cuh: sweep_exp).
template <bool SMEM, int SDT, int F>
__device__ __forceinline__ void a4_row(char* hs, char* ht, char* hb, uint8_t* sp,
                                       const A4Row<SDT>& r, float uq, A4Exchange& xch, int o,
                                       bool first, bool last, int dn, int dw, bool full,
                                       uint32_t m2b, const ExpConsts& ec) {
  const int ta = first ? o + dw : o - dn;  // the first tau add's row
  const int tb = last ? o - dw : o + dn;   // the second's
  const bool same = ta == tb;              // two layer blocks

  // Every load of the row before any store.
  uint8_t* spq = sp + (o >> 2);
  const uint32_t sw = *spq;
  const float a = a4_ld(hs + o), b = a4_ld(ht + o);
  float v[SDT], wa, wb;
#pragma unroll
  for (int d = 0; d < SDT; ++d)
    if (d < SDT - 1 || full) v[d] = a4_ld(hb + r.off[d]);
  wa = a4_ld(ht + ta);
  if (!same) wb = a4_ld(ht + tb);

  const uint32_t sg = a4_sign(sw, 0);
  const float x = __uint_as_float(m2b ^ sg) * (a + b);
  const bool acc = uq < sweep_exp<F>(x, ec);
  const uint32_t nw = sw ^ (acc ? 0xFEu : 0u);  // +1 (0x01) <-> -1 (0xFF)
  if (nw != sw) *spq = (uint8_t)nw;
  // -(s * mask): -s when accepted, else the zero of sign -s.
  const float ns = __uint_as_float(sg ^ (acc ? 0xbf800000u : 0x80000000u));

  // Space adds in entry order; an entry on the previous entry's row adds
  // to that entry's new sum.
#pragma unroll
  for (int d = 0; d < SDT; ++d)
    if (d < SDT - 1 || full) {
      if (d > 0 && ((r.dup >> d) & 1u)) v[d] = v[d > 0 ? d - 1 : 0];
      v[d] = v[d] + ns * r.j[d];
      a4_st<SMEM>(hb + r.off[d], v[d]);
    }

  // Tau adds of tc; where the link wraps, the row gets the neighbouring
  // thread's tc (the lane roll).
  const float tc = ns * r.tau;
  if (first) {  // row ta gets tc[v + 1] (before tb's tc)
    const float rolled = xch(tc, 1);
    if (same) wa = (wa + rolled) + tc;
    else wa = wa + rolled, wb = wb + tc;
  } else if (last) {  // row tb gets tc[v - 1] (after ta's tc)
    const float rolled = xch(tc, -1);
    if (same) wa = (wa + tc) + rolled;
    else wa = wa + tc, wb = wb + rolled;
  } else {
    wa = wa + tc, wb = wb + tc;
  }
  a4_st<SMEM>(ht + ta, wa);
  if (!same) a4_st<SMEM>(ht + tb, wb);
}

// Copy the thread's uniform of one row from device memory into its ring
// slot, asynchronously (cp.async: no register waits on it).
__device__ __forceinline__ void a4_fetch_u(float* slot, const float* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(slot);
  const size_t gsrc = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gsrc) : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One sweep of the thread's lane t over rows 0..rows-1.  u: the replica's
// (rows, 128) uniforms in device memory, fetched A4_UDIST rows ahead into
// ring, its (A4_URING, 128) slots in shared memory: each thread copies and
// reads back only its own lane, so no barrier is needed.  Unrolled by two,
// so row q+1's table entries load into registers during row q.
template <bool SMEM, int SDT, int F>
__device__ __forceinline__ void a4_walk(float* hs, float* ht, uint8_t* sp, const int2* tab,
                                        const float* u, float* ring, A4Exchange& xch, int t,
                                        int rows, int n, int sd, float m2b, const ExpConsts& ec) {
  hs += t, ht += t, sp += t, u += t, ring += t;
  char* hsb = reinterpret_cast<char*>(hs);
  char* htb = reinterpret_cast<char*>(ht);
  const int lpv = rows / n, E = sd + 1;
  const bool full = sd == SDT;
  for (int k = 0; k < A4_UDIST; ++k)  // a commit group a row, empty past the last
    if (k < rows) a4_fetch_u(ring + k * LANES, u + k * LANES);
    else asm volatile("cp.async.commit_group;" ::: "memory");
  constexpr int ROW = LANES * sizeof(float);  // bytes of a field row
  const int dn = n * ROW, dw = (rows - n) * ROW;
  const uint32_t m2bits = __float_as_uint(m2b);
  A4Row<SDT> cur, nxt;
  a4_row_tables(cur, tab, sd);
  const int2* te = tab;  // row q's staged entries
  char* hb = hsb;        // row q's layer block in hs
  int p = 0, i = 0;      // layer block and site of row q
  const float* uf = u + A4_UDIST * LANES;  // row q + A4_UDIST's uniforms
#pragma unroll 2
  for (int q = 0; q < rows; ++q, uf += LANES) {
    const int f = q + A4_UDIST;
    if (f < rows) a4_fetch_u(ring + (f % A4_URING) * LANES, uf);
    else asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group %0;" ::"n"(A4_UDIST) : "memory");  // row q's is in
    const float uq = ring[(q % A4_URING) * LANES];
    const bool wrap = i + 1 == n;
    const int2* tn = wrap ? tab : te + E;
    a4_row_tables(nxt, tn, sd);
    a4_row<SMEM, SDT, F>(hsb, htb, hb, sp, cur, uq, xch, q * ROW, p == 0, p == lpv - 1, dn, dw,
                         full, m2bits, ec);
    cur = nxt;
    te = tn;
    if (wrap) hb += dn, i = 0, ++p;
    else ++i;
  }
}

// -- the fixed cost: tile in and out, tables, state copy -------------------------

constexpr int A4_INFLIGHT = 8;  // 16-byte loads a thread keeps in flight

// Stage the tables: site i of table r (replica r's slot on the
// multi-tenant kernel, else the one model) at tab + (r*n + i)*(sd+1).  A
// site's entries are sorted by target, stably, so each cell's adds keep
// their order; entries on one cell are neighbours and flagged.
__device__ void a4_stage_tables(int2* tab, const A4Io& io, const A4Shape& sh, int b0) {
  const int n = sh.n, sd = sh.sd, tables = sh.multi ? sh.tile : 1;
  for (int k = threadIdx.x; k < tables * n; k += blockDim.x) {
    const int r = k / n, i = k - r * n;
    const size_t slot = sh.multi ? (size_t)(b0 + r) : 0;
    const float* j2 = io.j2 + slot * n * sd + (size_t)i * sd;
    int tg[A4_MAX_SD];
    float jj[A4_MAX_SD];
    for (int d = 0; d < sd; ++d) {
      int e = d;
      const int x = io.nbr[i * sd + d];
      for (; e > 0 && tg[e - 1] > x; --e) tg[e] = tg[e - 1], jj[e] = jj[e - 1];
      tg[e] = x, jj[e] = j2[d];
    }
    int2* out = tab + (size_t)k * (sd + 1);
    unsigned dup = 0;
    for (int d = 0; d < sd; ++d) {
      out[d] = make_int2(tg[d] * LANES * (int)sizeof(float), __float_as_int(jj[d]));
      if (d > 0 && tg[d] == tg[d - 1]) dup |= 1u << d;
    }
    out[sd] = make_int2(__float_as_int(io.tau2[slot * n + i]), (int)dup);
  }
}

// The tile's spins in as int8, and its fields into shared memory
// (FIELDS_IN_SMEM) or copied into the output tile, where the walk then
// updates them.  The tile's replicas are neighbours in memory.
template <bool FIELDS_IN_SMEM>
__device__ void a4_load_tile(uint8_t* sp, float* hs, float* ht, const A4Io& io, const A4Shape& sh,
                             int b0) {
  const size_t at = (size_t)b0 * sh.rows * LANES / 4;  // in 16-byte words
  const int words = sh.tile * sh.rows * LANES / 4, nt = blockDim.x;
  const float4* sin = reinterpret_cast<const float4*>(io.spins_in) + at;
  const float4* hin = reinterpret_cast<const float4*>(io.hs_in) + at;
  const float4* tin = reinterpret_cast<const float4*>(io.ht_in) + at;
  float4* hdst = FIELDS_IN_SMEM ? reinterpret_cast<float4*>(hs)
                                : reinterpret_cast<float4*>(io.hs_out) + at;
  float4* tdst = FIELDS_IN_SMEM ? reinterpret_cast<float4*>(ht)
                                : reinterpret_cast<float4*>(io.ht_out) + at;
  for (int q0 = threadIdx.x; q0 < words; q0 += nt * A4_INFLIGHT) {
    float4 f[A4_INFLIGHT], h[A4_INFLIGHT], g[A4_INFLIGHT];
#pragma unroll
    for (int j = 0; j < A4_INFLIGHT; ++j)
      if (q0 + j * nt < words) f[j] = sin[q0 + j * nt], h[j] = hin[q0 + j * nt], g[j] = tin[q0 + j * nt];
#pragma unroll
    for (int j = 0; j < A4_INFLIGHT; ++j)
      if (q0 + j * nt < words) {
        reinterpret_cast<char4*>(sp)[q0 + j * nt] =
            make_char4(f[j].x > 0.0f ? 1 : -1, f[j].y > 0.0f ? 1 : -1, f[j].z > 0.0f ? 1 : -1,
                       f[j].w > 0.0f ? 1 : -1);
        hdst[q0 + j * nt] = h[j];
        tdst[q0 + j * nt] = g[j];
      }
  }
}

// +-1.0f from an int8 spin's sign bit.
__device__ __forceinline__ float a4_spin(uint32_t w, int c) {
  return __uint_as_float(0x3f800000u | a4_sign(w, c));
}

template <bool FIELDS_IN_SMEM>
__device__ void a4_store_tile(const uint8_t* sp, const float* hs, const float* ht,
                              const A4Io& io, const A4Shape& sh, int b0) {
  const size_t at = (size_t)b0 * sh.rows * LANES / 4;
  const int words = sh.tile * sh.rows * LANES / 4;
  float4* sout = reinterpret_cast<float4*>(io.spins_out) + at;
  for (int q = threadIdx.x; q < words; q += blockDim.x) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(sp)[q];
    sout[q] = make_float4(a4_spin(w, 0), a4_spin(w, 1), a4_spin(w, 2), a4_spin(w, 3));
    if (FIELDS_IN_SMEM) {
      reinterpret_cast<float4*>(io.hs_out)[at + q] = reinterpret_cast<const float4*>(hs)[q];
      reinterpret_cast<float4*>(io.ht_out)[at + q] = reinterpret_cast<const float4*>(ht)[q];
    }
  }
}

// The state passes through a 0-sweep launch unchanged.
__device__ void a4_copy_state(const A4Io& io, const A4Shape& sh, int b0) {
  const unsigned ld4 = (unsigned)sh.B * LANES / 4, cols4 = sh.tile * LANES / 4;
  const uint4* src = reinterpret_cast<const uint4*>(io.rng_in + (size_t)b0 * LANES);
  uint4* dst = reinterpret_cast<uint4*>(io.rng_out + (size_t)b0 * LANES);
  for (unsigned k = threadIdx.x; k < MT_N * cols4; k += blockDim.x) {
    const unsigned row = k / cols4, col = k - row * cols4;
    dst[row * ld4 + col] = src[row * ld4 + col];
  }
}

// -- the generator warps -------------------------------------------------------

struct A4GenBarrier {
  int threads;
  __device__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"n"(A4_GEN_BAR), "r"(threads) : "memory");
  }
};

// Every generator block of one sweep for the tile's replicas, by generator
// warp gw of G, each new word tempered into buffer `buf` of the replica's
// uniforms.  The first block of the launch's first sweep reads rng_in.
__device__ void a4_twist_sweep(const A4Io& io, const A4Shape& sh, int b0, bool from_in, int buf,
                               int gw) {
  const int l = threadIdx.x & 31, G = sh.gen_warps, rows = sh.rows;
  const unsigned ld4 = (unsigned)sh.B * LANES / 4;
  const int blocks = (rows + MT_N - 1) / MT_N;
  for (int blk = 0; blk < blocks; ++blk)
    for (int r = 0; r < sh.tile; ++r) {
      const size_t b = b0 + r;
      const uint32_t* src = (from_in && blk == 0 ? io.rng_in : io.rng_out) + b * LANES;
      float4* u = reinterpret_cast<float4*>(io.u + (b * A4_UBUFS + buf) * rows * LANES) + l;
      twist_block(reinterpret_cast<const uint4*>(src) + l,
                  reinterpret_cast<uint4*>(io.rng_out + b * LANES) + l, ld4, gw, G,
                  EmitUniform{u, LANES / 4, blk * MT_N, rows}, A4GenBarrier{32 * G});
    }
}

// -- one CTA -----------------------------------------------------------------------

// Replicas b0 .. b0+tile-1 of a launch: load, stage, then either
// num_sweeps fused sweeps (generate) or one sweep on io.u, then store.
// Warps 0 .. 4*tile-1 walk (replica r: warps 4r .. 4r+3), the other
// gen_warps twist (generate) or only help with the fixed cost.  The
// generator twists sweep s+1 into one buffer while the walkers walk sweep
// s from the other.  F is the exp flavour of the accept tests.
template <bool FIELDS_IN_SMEM, int SDT, int F>
__device__ void a4_cta(const A4Io& io, const A4Shape& sh) {
  const int b0 = blockIdx.x * sh.tile, rows = sh.rows, n = sh.n, sd = sh.sd;
  const int warp = threadIdx.x >> 5, walkers = sh.tile * A4_WALKER_WARPS;
  const size_t cells = (size_t)sh.tile * rows * LANES;
  float* hs_s = reinterpret_cast<float*>(a4_smem);
  float* ht_s = hs_s + cells;
  uint8_t* sp = a4_smem + (FIELDS_IN_SMEM ? 2 * cells * sizeof(float) : 0);
  int2* tab = reinterpret_cast<int2*>(sp + cells);
  float* rings = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tab) +
                                          (sh.multi ? sh.tile : 1) * a4_table_bytes(n, sd));
  float* xbuf = rings + sh.tile * A4_URING * LANES;

  a4_load_tile<FIELDS_IN_SMEM>(sp, hs_s, ht_s, io, sh, b0);
  a4_stage_tables(tab, io, sh, b0);
  if (sh.generate && sh.num_sweeps == 0) a4_copy_state(io, sh, b0);
  __syncthreads();

  // This warp's role: walker of replica r (thread t of its walker), or
  // generator warp gw.
  const bool walker = warp < walkers;
  const int r = warp / A4_WALKER_WARPS, t = threadIdx.x - r * LANES, gw = warp - walkers;
  const size_t rb = (size_t)(b0 + r) * rows * LANES;
  float* hs = FIELDS_IN_SMEM ? hs_s + (size_t)r * rows * LANES : io.hs_out + rb;
  float* ht = FIELDS_IN_SMEM ? ht_s + (size_t)r * rows * LANES : io.ht_out + rb;
  uint8_t* spr = sp + (size_t)r * rows * LANES;
  const int2* tabr = tab + (sh.multi ? (size_t)r * n * (sd + 1) : 0);
  float* ring = rings + r * A4_URING * LANES;
  const float m2b = walker ? -2.0f * io.beta[b0 + r] : 0.0f;
  A4Exchange xch{t, xbuf + r * 2 * LANES, A4_XCH_BAR + r, 0};
  auto walk = [&](const float* u) {
    a4_walk<FIELDS_IN_SMEM, SDT, F>(hs, ht, spr, tabr, u, ring, xch, t, rows, n, sd, m2b, sh.ec);
  };

  if (!sh.generate) {
    if (walker) walk(io.u + rb);
  } else {
    const int S = sh.num_sweeps;
    if (!walker && S > 0) a4_twist_sweep(io, sh, b0, true, 0, gw);
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      if (walker) walk(io.u + ((size_t)(b0 + r) * A4_UBUFS + (s & 1)) * rows * LANES);
      else if (s + 1 < S) a4_twist_sweep(io, sh, b0, false, (s + 1) & 1, gw);
      __syncthreads();
    }
  }
  __syncthreads();
  a4_store_tile<FIELDS_IN_SMEM>(sp, hs_s, ht_s, io, sh, b0);
}

// -- the launch ------------------------------------------------------------------

// Check a launch and lay it out: its generator (or helper) warps, its
// shared memory, where the fields live and its threads.  Returns a CUDA
// error code (0 when it can launch).
inline int a4_plan(const A4Io& io, A4Shape& sh, int max_smem, bool* fields_in_smem, size_t* smem,
                   int* threads) {
  const int tables = sh.multi ? sh.tile : 1;
  if (sh.tile < 1 || sh.B % sh.tile || sh.sd < 1 || sh.sd > A4_MAX_SD || sh.n < 1 ||
      sh.rows % sh.n || sh.rows / sh.n < 2 || sh.num_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const int walkers = sh.tile * A4_WALKER_WARPS;
  sh.gen_warps = A4_MAX_THREADS / 32 - walkers;
  if (sh.gen_warps > A4_GEN_WARPS) sh.gen_warps = A4_GEN_WARPS;
  if (sh.gen_warps < 1 || A4_XCH_BAR + sh.tile > 16) return (int)cudaErrorInvalidValue;
  *threads = 32 * (walkers + sh.gen_warps);
  *fields_in_smem = a4_smem_bytes(sh.rows, sh.n, sh.sd, sh.tile, tables, true) <= (size_t)max_smem;
  if (!*fields_in_smem && sh.tile > 1) return (int)cudaErrorInvalidValue;
  *smem = a4_smem_bytes(sh.rows, sh.n, sh.sd, sh.tile, tables, *fields_in_smem);
  if (*smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(io.spins_in) | reinterpret_cast<uintptr_t>(io.hs_in) |
      reinterpret_cast<uintptr_t>(io.ht_in) | reinterpret_cast<uintptr_t>(io.rng_in) |
      reinterpret_cast<uintptr_t>(io.spins_out) | reinterpret_cast<uintptr_t>(io.hs_out) |
      reinterpret_cast<uintptr_t>(io.ht_out) | reinterpret_cast<uintptr_t>(io.rng_out) |
      reinterpret_cast<uintptr_t>(io.u);
  return (any & 15) ? (int)cudaErrorMisalignedAddress : 0;
}

template <class Kernel>
int a4_start(Kernel kernel, const A4Io& io, const A4Shape& sh, int threads, size_t smem,
             void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<sh.B / sh.tile, threads, smem, (cudaStream_t)stream>>>(
      io.spins_in, io.hs_in, io.ht_in, io.rng_in, io.nbr, io.j2, io.tau2, io.beta, io.spins_out,
      io.hs_out, io.ht_out, io.rng_out, io.u, sh);
  return (int)cudaGetLastError();
}

// The instantiations of a kernel template K<FIELDS_IN_SMEM, SDT, F>,
// picked by the plan and the caller's exp flavour code: SDT is sd rounded
// up to even; 2 x 4 x 3 = 24 instantiations a library.
#define A4_LAUNCH_SD(K, F, FL, sdt, io, sh, threads, smem, stream)  \
  (sdt == 2   ? a4_start(K<F, 2, FL>, io, sh, threads, smem, stream) \
   : sdt == 4 ? a4_start(K<F, 4, FL>, io, sh, threads, smem, stream) \
   : sdt == 6 ? a4_start(K<F, 6, FL>, io, sh, threads, smem, stream) \
              : a4_start(K<F, 8, FL>, io, sh, threads, smem, stream))
#define A4_LAUNCH_FIELDS(K, FL, fields, sdt, io, sh, threads, smem, stream)    \
  (fields ? A4_LAUNCH_SD(K, true, FL, sdt, io, sh, threads, smem, stream)      \
          : A4_LAUNCH_SD(K, false, FL, sdt, io, sh, threads, smem, stream))
#define A4_LAUNCH(K, io, sh, flavour, max_smem, stream)                                       \
  [&]() -> int {                                                                              \
    bool fields_;                                                                             \
    size_t smem_;                                                                             \
    int threads_;                                                                             \
    const int err_ = a4_plan(io, sh, max_smem, &fields_, &smem_, &threads_);                  \
    if (err_) return err_;                                                                    \
    const int sdt_ = (sh.sd + 1) & ~1;                                                        \
    switch (flavour) {                                                                        \
      case EXP_FAST:                                                                          \
        return A4_LAUNCH_FIELDS(K, EXP_FAST, fields_, sdt_, io, sh, threads_, smem_, stream); \
      case EXP_ACCURATE:                                                                      \
        return A4_LAUNCH_FIELDS(K, EXP_ACCURATE, fields_, sdt_, io, sh, threads_, smem_,      \
                                stream);                                                      \
      case EXP_EXACT:                                                                         \
        return A4_LAUNCH_FIELDS(K, EXP_EXACT, fields_, sdt_, io, sh, threads_, smem_, stream); \
      default:                                                                                \
        return (int)cudaErrorInvalidValue;                                                    \
    }                                                                                         \
  }()

// The kernel parameters: every pointer its own, so the compiler knows they
// are global memory, then the shape.
#define A4_KERNEL_PARAMS                                                                    \
  const float *__restrict__ spins_in, const float *__restrict__ hs_in,                      \
      const float *__restrict__ ht_in, const uint32_t *rng_in, const int *__restrict__ nbr, \
      const float *__restrict__ j2, const float *__restrict__ tau2,                         \
      const float *__restrict__ beta, float *__restrict__ spins_out,                        \
      float *__restrict__ hs_out, float *__restrict__ ht_out, uint32_t *rng_out, float *u,  \
      const A4Shape sh
#define A4_KERNEL_IO \
  A4Io { spins_in, hs_in, ht_in, rng_in, nbr, j2, tau2, beta, spins_out, hs_out, ht_out, rng_out, u }

}  // namespace
