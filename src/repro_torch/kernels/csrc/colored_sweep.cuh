// The fused colored ("cb") multisweep of one replica, shared by the
// single-model kernel (colored_multisweep.cu) and the multi-tenant one
// (colored_multisweep_multi.cu), as the reference's two colored bodies
// (src/repro/kernels/metropolis_kernel.py: _make_colored_body and
// _make_colored_multi_body) share colored_flip_spins and lane_h_eff.
//
// One CTA per replica of 128 * W threads: W warp groups of 4 warps, each
// warp 32 threads of 4 neighbouring lanes.  The CTA owns the replica's 128
// lanes and MT19937 generator columns b*128 .. b*128+127 of the
// (624, B*128) interlaced state.
//
// What bounds it on Hopper.  A colored sweep is C = 2-5 dependent steps,
// one per color class; the rows of a class are conflict-free (no row of a
// class reads another row of it: reorder.py's coloring), so every row of
// a class can be updated at once.  The first design (one warp group
// walking a class row after row, tables read from device memory) was
// latency bound: 0.74 us a row, 0.142 ms of each 0.160 ms sweep at B=8,
// rows=192 on an NVIDIA H100 80GB HBM3 at 700 W.  This design takes
// ~0.021 ms a sweep there (0.17-0.19 ms an 8-sweep launch, PERF.md):
//  1. spreads a class over the CTA: its rows are dealt to the 4W warps,
//     one barrier per class; a warp updates all 128 lanes of its row,
//     4 neighbouring lanes a thread (one 32-bit word of int8 spins, one
//     16-byte word of uniforms).  Each row's uniform is fixed by its row
//     id, so the visiting order does not change a bit
//     (tests/test_torch_colored_layout.py holds that);
//  2. stages the class tables once a launch into shared memory, packed
//     per entry: (row, down row, up row) as byte offsets into the spin
//     tile with the roll mask, (h, tau), and sd (target offset, J) pairs;
//     the coefficients are gathered per entry at coef(k) (the entry itself
//     for the single-model kernel, the entry's site for the multi-tenant
//     one), so a row's update reads no device memory and #2's walk is #1's;
//  3. draws a sweep's uniforms before its walk: the twist tempers each
//     new word straight into a (rows, 128) float buffer, in shared memory
//     when it fits (rows <= ~300 at sd=6), else in the caller's scratch
//     buffer in device memory; the walk never tempers;
//  4. twists across all warps in MT19937's three dependence phases: rows
//     [0, 227) read only old words, [227, 454) old words and new words
//     0-226, [454, 624) old words, new words 227-396 and new word 0.  Each
//     warp owns a contiguous run of a phase's rows, all 128 columns of
//     them (4 a thread, 16-byte loads and stores).  In place, row i reads
//     old row i+1, which the next run rewrites in the same phase: every
//     run's first row past its end is loaded before a barrier that
//     precedes every store, and inside its own run a warp reads a row
//     before it rewrites it;
//  5. spreads the fixed cost over all threads, several 16-byte loads in
//     flight a thread: the spin tile load, the 0-sweep state copy, and the
//     dense refresh (by entries, from the staged tables: an entry's
//     targets, tau rows and coefficients are those of lane_h_eff's row).
// Spins live in shared memory as int8 (rows * 128 bytes, 24 KiB at
// rows=192); shared memory is cb_smem_bytes (ops.colored_smem_bytes
// computes the same, and ops.colored_smem_plan refuses a layout that does
// not fit).
//
// Numerics.  A product by a spin (+-1) is exact, so it is computed as a
// sign flip (times_spin); spins become floats by bit operations (spin_of),
// since int->float conversions issue at a quarter of the integer rate.
// The other products multiply by a spin sum in {-2, 0, 2} or are the one
// rounding of ((-2 beta) s) * h_eff and of the exp's own expression
// (sweep_exp<F>: "fast", "accurate" or "exact", fastexp.cuh); the build
// passes --fmad=false so the compiled code is the written expression, in
// the reference's order, for each lane.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fastexp.cuh"
#include "mt19937.cuh"

namespace {

constexpr int CB_LANES = 128;
constexpr int CB_MAX_GROUPS = 8;  // warp groups a CTA (1024 threads)
constexpr int CB_INFLIGHT = 8;  // 16-byte loads a thread keeps in flight in the fixed cost

// Structural class tables: every class's entries concatenated in visit
// order, class c owning entries off[c] .. off[c+1]-1; entry k updates row
// row[k] (every row is one entry).
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

__host__ __device__ inline size_t cb_align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Staged tables: per entry an int4 (row, down, up offsets, roll), a float2
// (h, tau) and sd int2 (target offset, J bits); then the C+1 offsets.
__host__ __device__ inline size_t cb_table_bytes(int rows, int sd, int C) {
  return cb_align16(4 * ((size_t)(C + 1) + (size_t)rows * (4 + sd) + (size_t)rows * (2 + sd)));
}

// The CTA's dynamic shared memory: int8 spins, staged tables and, when
// u_in_smem, a sweep's (rows, 128) float32 uniforms.
__host__ __device__ inline size_t cb_smem_bytes(int rows, int sd, int C, bool u_in_smem) {
  return cb_align16((size_t)rows * CB_LANES) + cb_table_bytes(rows, sd, C) +
         (u_in_smem ? (size_t)rows * CB_LANES * 4 : 0);
}

// Whether a launch keeps its uniforms in shared memory (the host and the
// kernel both decide it from the scratch pointer).
__host__ __device__ inline bool cb_u_in_smem(const float* u_scratch, int num_sweeps) {
  return u_scratch == nullptr && num_sweeps > 0;
}

struct CbShared {
  int8_t* sp;   // (rows, 128) spins as +-1
  int4* ent;    // (row, down, up) byte offsets into sp, roll mask
  float2* hta;  // (h, tau)
  int2* tj;     // (entries, sd): (target byte offset, J bits)
  int* off;     // C+1 class offsets
  float* u;     // (rows, 128) uniforms, or nullptr (device-memory scratch)
};

__device__ CbShared cb_carve(unsigned char* base, int rows, int sd, int C, bool u_in_smem) {
  CbShared s;
  const size_t tile = cb_align16((size_t)rows * CB_LANES);
  s.sp = reinterpret_cast<int8_t*>(base);
  s.ent = reinterpret_cast<int4*>(base + tile);
  s.hta = reinterpret_cast<float2*>(s.ent + rows);
  s.tj = reinterpret_cast<int2*>(s.hta + rows);
  s.off = reinterpret_cast<int*>(s.tj + (size_t)rows * sd);
  s.u = u_in_smem ? reinterpret_cast<float*>(base + tile + cb_table_bytes(rows, sd, C)) : nullptr;
  return s;
}

// Spins are int8 +1 (0x01) or -1 (0xFF), 4 lanes to a 32-bit word.  The
// sign bit of spin q (0-3) of word w, at bit 31:
__device__ __forceinline__ uint32_t sign_of(uint32_t w, int q) {
  return (w << (24 - 8 * q)) & 0x80000000u;
}

// Spin q as float, +-1.0f, without an int->float conversion.
__device__ __forceinline__ float spin_of(uint32_t w, int q) {
  return __uint_as_float(0x3f800000u | sign_of(w, q));
}

// x times spin q: x with its sign flipped where the spin is -1, which is
// the float product for every x but a NaN (couplings and betas are not).
__device__ __forceinline__ float times_spin(float x, uint32_t w, int q) {
  return __uint_as_float(__float_as_uint(x) ^ sign_of(w, q));
}

// The fields of lanes 4l .. 4l+3 of entry e's row (lane_h_eff's
// expression, per lane): hs = h + sum_d J_d s_d in d order, ht = tau *
// (down + up), with the rolled tau rows read one lane over.  Returns the
// row's own spin word.
__device__ __forceinline__ uint32_t entry_fields(const CbShared& s, int k, int sd, int l,
                                                 float hs[4], float ht[4]) {
  const int4 e = s.ent[k];
  const float2 c = s.hta[k];
  const uint32_t* words = reinterpret_cast<const uint32_t*>(s.sp);
  const uint32_t sw = words[(e.x >> 2) + l];
#pragma unroll
  for (int q = 0; q < 4; ++q) hs[q] = c.x;
  const int2* tj = s.tj + (size_t)k * sd;
  for (int d = 0; d < sd; ++d) {
    const int2 t = tj[d];
    const float Jd = __int_as_float(t.y);
    const uint32_t w = words[(t.x >> 2) + l];
#pragma unroll
    for (int q = 0; q < 4; ++q) hs[q] = hs[q] + times_spin(Jd, w, q);
  }
  const uint32_t* drow = words + (e.y >> 2);
  const uint32_t* urow = words + (e.z >> 2);
  uint32_t dw = drow[l], uw = urow[l];
  if (e.w & 1) dw = __byte_perm(drow[(l + 31) & 31], dw, 0x6543);  // lanes 4l-1 .. 4l+2
  if (e.w & 2) uw = __byte_perm(uw, urow[(l + 1) & 31], 0x4321);   // lanes 4l+1 .. 4l+4
#pragma unroll
  for (int q = 0; q < 4; ++q) ht[q] = c.y * (spin_of(dw, q) + spin_of(uw, q));
  return sw;
}

// Where the class walk reads a sweep's uniforms: row r, lanes 4l .. 4l+3.
struct SharedUniforms {  // in shared memory, (rows, 128)
  const float* u;
  __device__ float4 operator()(int r, int l) const {
    return reinterpret_cast<const float4*>(u + r * CB_LANES)[l];
  }
};

struct ScratchUniforms {  // the replica's columns of the (rows, B*128) scratch
  const float* u;
  unsigned ld;
  __device__ float4 operator()(int r, int l) const {
    return reinterpret_cast<const float4*>(u + (unsigned)r * ld)[l];
  }
};

// The class walk of class c: its rows dealt to the warps, each spin's
// accept test on the exp flavour F.  The caller puts a barrier after it
// (the next class reads this one's rows).
template <int F, class Uniforms>
__device__ void walk_class(const CbShared& s, const Uniforms& uni, int c, int sd, int warp,
                           int warps, int l, float m2b, const ExpConsts& ec) {
  uint32_t* spw = reinterpret_cast<uint32_t*>(s.sp);
  for (int k = s.off[c] + warp; k < s.off[c + 1]; k += warps) {
    float hs[4], ht[4];
    const uint32_t sw = entry_fields(s, k, sd, l, hs, ht);
    const int ro = s.ent[k].x;  // byte offset of the row
    const float4 u4 = uni(ro >> 7, l);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    uint32_t nw = sw;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float p = sweep_exp<F>(times_spin(m2b, sw, q) * (hs[q] + ht[q]), ec);
      if (u[q] < p) nw ^= 0xFEu << (8 * q);  // +1 (0x01) <-> -1 (0xFF)
    }
    if (nw != sw) spw[(ro >> 2) + l] = nw;
  }
}

// Replica blockIdx.x: num_sweeps colored sweeps on the exp flavour F, then
// the dense field refresh.  ch/cJ/ctau are the class coefficients, read at
// coef(k) when staged.  u_scratch (rows, B*128) holds the uniforms when they do not
// fit in shared memory, else it is nullptr; with num_sweeps == 0 there are
// no uniforms.  Every pointer the kernel reads or writes in 16-byte words
// is 16-byte aligned (the C entries check it).
template <int F, class Coef>
__device__ void colored_multisweep_cta(
    unsigned char* smem, const float* __restrict__ spins_in, const uint32_t* rng_in, float beta,
    float* __restrict__ spins_out, float* __restrict__ h_space, float* __restrict__ h_tau,
    uint32_t* rng_out, float* u_scratch, ColorTables cls, const Coef& coef,
    const float* __restrict__ ch, const float* __restrict__ cJ, const float* __restrict__ ctau,
    int rows, int sd, int num_sweeps, const ExpConsts& ec) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, l = tid & 31, warps = nt >> 5;
  const int C = cls.C;
  const unsigned ld = gridDim.x * CB_LANES;  // words a state row
  const size_t tile = (size_t)b * rows * CB_LANES;
  const CbShared s = cb_carve(smem, rows, sd, C, cb_u_in_smem(u_scratch, num_sweeps));

  // Stage the class tables and coefficients.
  for (int i = tid; i <= C; i += nt) s.off[i] = cls.off[i];
  for (int k = tid; k < rows; k += nt) {
    const int e = coef(k);
    s.ent[k] = make_int4(cls.row[k] * CB_LANES, cls.down[k] * CB_LANES, cls.up[k] * CB_LANES,
                         cls.roll[k]);
    s.hta[k] = make_float2(ch[e], ctau[e]);
  }
  for (int q = tid; q < rows * sd; q += nt) {
    const int k = q / sd;
    s.tj[q] = make_int2(cls.tgt[q] * CB_LANES, __float_as_int(cJ[coef(k) * sd + (q - k * sd)]));
  }
  // Load the spin tile, CB_INFLIGHT 16-byte words a thread at a time.
  const float4* tin = reinterpret_cast<const float4*>(spins_in + tile);
  const int words = rows * (CB_LANES / 4);
  for (int q0 = tid; q0 < words; q0 += nt * CB_INFLIGHT) {
    float4 f[CB_INFLIGHT];
#pragma unroll
    for (int j = 0; j < CB_INFLIGHT; ++j)
      if (q0 + j * nt < words) f[j] = tin[q0 + j * nt];
#pragma unroll
    for (int j = 0; j < CB_INFLIGHT; ++j)
      if (q0 + j * nt < words)
        reinterpret_cast<char4*>(s.sp)[q0 + j * nt] =
            make_char4(f[j].x > 0.0f ? 1 : -1, f[j].y > 0.0f ? 1 : -1, f[j].z > 0.0f ? 1 : -1,
                       f[j].w > 0.0f ? 1 : -1);
  }

  // The thread's 4 generator columns, as 16-byte words (ld4 a state row).
  const unsigned ld4 = ld / 4;
  const uint4* rin = reinterpret_cast<const uint4*>(rng_in + (size_t)b * CB_LANES) + l;
  uint4* rout = reinterpret_cast<uint4*>(rng_out + (size_t)b * CB_LANES) + l;
  if (num_sweeps == 0) {  // the state passes through unchanged
    for (int i0 = warp; i0 < MT_N; i0 += warps * CB_INFLIGHT) {
      uint4 w[CB_INFLIGHT];
#pragma unroll
      for (int j = 0; j < CB_INFLIGHT; ++j)
        if (i0 + j * warps < MT_N) w[j] = rin[(unsigned)(i0 + j * warps) * ld4];
#pragma unroll
      for (int j = 0; j < CB_INFLIGHT; ++j)
        if (i0 + j * warps < MT_N) rout[(unsigned)(i0 + j * warps) * ld4] = w[j];
    }
  }
  __syncthreads();

  // A sweep's uniforms: shared memory (stride 128) or the scratch (ld).
  float* ub = s.u ? s.u : u_scratch ? u_scratch + (size_t)b * CB_LANES : nullptr;
  const unsigned ustride4 = (s.u ? CB_LANES : ld) / 4;
  const int blocks = (rows + MT_N - 1) / MT_N;
  const float m2b = -2.0f * beta;

  float4* ub4 = ub ? reinterpret_cast<float4*>(ub) + l : nullptr;
  for (int sweep = 0; sweep < num_sweeps; ++sweep) {
    for (int blk = 0; blk < blocks; ++blk)
      twist_block(sweep == 0 && blk == 0 ? rin : rout, rout, ld4, warp, warps,
                  EmitUniform{ub4, ustride4, blk * MT_N, rows});
    for (int c = 0; c < C; ++c) {
      if (s.u)
        walk_class<F>(s, SharedUniforms{s.u}, c, sd, warp, warps, l, m2b, ec);
      else
        walk_class<F>(s, ScratchUniforms{ub, ld}, c, sd, warp, warps, l, m2b, ec);
      __syncthreads();  // the next class reads this one's rows
    }
  }

  // Dense field refresh of the final spins (metropolis.lane_h_eff): entry
  // k's tables are those of its row, so each warp refreshes whole rows.
  for (int k = warp; k < rows; k += warps) {
    float hs[4], ht[4];
    const uint32_t sw = entry_fields(s, k, sd, l, hs, ht);
    const size_t o = tile + (size_t)s.ent[k].x + 4 * l;
    *reinterpret_cast<float4*>(spins_out + o) =
        make_float4(spin_of(sw, 0), spin_of(sw, 1), spin_of(sw, 2), spin_of(sw, 3));
    *reinterpret_cast<float4*>(h_space + o) = make_float4(hs[0], hs[1], hs[2], hs[3]);
    *reinterpret_cast<float4*>(h_tau + o) = make_float4(ht[0], ht[1], ht[2], ht[3]);
  }
}

// Checks shared by the C entries: the warp-group count, and the 16-byte
// alignment of every array the kernel reads or writes in 16-byte words
// (the wrappers copy a misaligned input).
inline int cb_check(int warp_groups, const void* spins_in, const void* rng_in,
                    const void* spins_out, const void* h_space, const void* h_tau,
                    const void* rng_out, const void* u_scratch) {
  if (warp_groups < 1 || warp_groups > CB_MAX_GROUPS) return (int)cudaErrorInvalidValue;
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(spins_in) | reinterpret_cast<uintptr_t>(rng_in) |
      reinterpret_cast<uintptr_t>(spins_out) | reinterpret_cast<uintptr_t>(h_space) |
      reinterpret_cast<uintptr_t>(h_tau) | reinterpret_cast<uintptr_t>(rng_out) |
      reinterpret_cast<uintptr_t>(u_scratch);
  return (any & 15) ? (int)cudaErrorMisalignedAddress : 0;
}

// Opt a kernel in to more than 48 KiB of dynamic shared memory when it
// needs it; returns the CUDA error (0 on success).
template <class Kernel>
int colored_smem_attr(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
