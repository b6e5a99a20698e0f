// Interlaced MT19937 on the card.
//
// The state is (624, V) words, row-major, one generator per column
// (core/mt19937.py).  Every kernel here advances it with the split twist
// (twist_block below): each warp, or group of threads, owns a run of
// rows in each of MT19937's three dependence phases, 4 neighbouring
// columns a thread in 16-byte words.  Shared by every kernel that draws
// uniforms: colored_multisweep.cu (colored_sweep.cuh),
// metropolis_multisweep.cu (a4_sweep.cuh) and mt_next_block.cu.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MT_N = 624;
constexpr int MT_M = 397;
constexpr uint32_t MATRIX_A = 0x9908B0DFu;
constexpr uint32_t UPPER_MASK = 0x80000000u;
constexpr uint32_t LOWER_MASK = 0x7FFFFFFFu;
constexpr uint32_t TEMPER_B = 0x9D2C5680u;
constexpr uint32_t TEMPER_C = 0xEFC60000u;

__device__ __forceinline__ uint32_t twist_word(uint32_t u, uint32_t v, uint32_t m) {
  uint32_t y = (u & UPPER_MASK) | (v & LOWER_MASK);
  return m ^ (y >> 1) ^ ((y & 1u) * MATRIX_A);
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & TEMPER_B;
  y ^= (y << 15) & TEMPER_C;
  y ^= y >> 18;
  return y;
}

// The split twist: one block advance of 128 columns spread over several
// warps in MT19937's three dependence phases (rows [0, 227) read only old
// words, [227, 454) old words and new words 0-226, [454, 624) old words,
// new words 227-396 and new word 0).  Each warp owns a contiguous run of a
// phase's rows, all 128 columns of them (4 a thread, 16-byte loads and
// stores).  In place, row i reads old row i+1, which the next run rewrites
// in the same phase: every run's first row past its end is loaded before a
// barrier that precedes every store, and inside its own run a warp reads a
// row before it rewrites it.  Used by the colored sweeps
// (colored_sweep.cuh), the a4 sweeps' generator warps (a4_sweep.cuh) and
// the block kernel (mt_next_block.cu), which runs it on groups of threads
// narrower than a warp.

constexpr int MT_SPAN = MT_N - MT_M;  // 227: rows of a twist phase
constexpr int TWIST4_AHEAD = 4;  // generator rows loaded before any is stored; < 227

struct CtaBarrier {
  __device__ void operator()() const { __syncthreads(); }
};

// Rows [lo, hi) of twist phase p (0, 1, 2) that warp w of `warps` owns.
__device__ __forceinline__ void phase_run(int p, int w, int warps, int& lo, int& hi) {
  const int a = p * MT_SPAN, len = (p == 2 ? MT_N : a + MT_SPAN) - a;
  lo = a + len * w / warps;
  hi = a + len * (w + 1) / warps;
}

__device__ __forceinline__ uint4 twist4(uint4 u, uint4 v, uint4 m) {
  return make_uint4(twist_word(u.x, v.x, m.x), twist_word(u.y, v.y, m.y),
                    twist_word(u.z, v.z, m.z), twist_word(u.w, v.w, m.w));
}

// Twist rows [lo, hi) of 4 neighbouring generator columns in order (16
// bytes a row, row stride ld4 16-byte words), TWIST4_AHEAD rows of loads
// ahead of the stores.  v_hi is old row hi (or new row 0 for hi == 624),
// loaded by the caller.  Row i's m term is mbase[(i + mshift) * ld4]: an
// old word (src, +397) in the first phase, a new word of an earlier phase
// (dst, -227) in the others.  Loads past the run's end are clamped to its
// last row and not used, so the loop reads no row that another run
// rewrites.  The generator is issue bound: 16-byte words and 32-bit
// offsets keep its address arithmetic small.
template <class Emit>
__device__ void twist_rows(const uint4* src, uint4* dst, const uint4* mbase, int mshift,
                           unsigned ld4, int lo, int hi, uint4 v_hi, const Emit& emit) {
  for (int i0 = lo; i0 < hi; i0 += TWIST4_AHEAD) {
    uint4 x[TWIST4_AHEAD + 1], m[TWIST4_AHEAD];
#pragma unroll
    for (int k = 0; k <= TWIST4_AHEAD; ++k) {
      const int i = min(i0 + k, hi - 1);
      x[k] = src[(unsigned)i * ld4];
      if (k < TWIST4_AHEAD) m[k] = mbase[(unsigned)(i + mshift) * ld4];
    }
#pragma unroll
    for (int k = 0; k < TWIST4_AHEAD; ++k) {
      const int i = i0 + k;
      if (i < hi) {
        const uint4 w = twist4(x[k], i + 1 < hi ? x[k + 1] : v_hi, m[k]);
        dst[(unsigned)i * ld4] = w;
        emit(i, w);
      }
    }
  }
}

// One block advance of a tile of generator columns (128 for the sweeps)
// by `warps` warps, or groups of threads that span the tile (this one is
// `warp`), 4 columns a thread (src, dst: the thread's 16-byte column;
// dst == src is in place).  `bar` synchronizes those warps: the whole CTA
// (CtaBarrier) or a named barrier of just them.  Ends with a barrier, so
// every new word and every emitted uniform is visible to them.
template <class Emit, class Barrier = CtaBarrier>
__device__ void twist_block(const uint4* src, uint4* dst, unsigned ld4, int warp, int warps,
                            const Emit& emit, const Barrier& bar = Barrier()) {
  uint4 edge[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    int lo, hi;
    phase_run(p, warp, warps, lo, hi);
    edge[p] = hi < MT_N ? src[(unsigned)hi * ld4] : uint4{};  // old row hi, before it is rewritten
  }
  bar();
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    int lo, hi;
    phase_run(p, warp, warps, lo, hi);
    twist_rows(src, dst, p == 0 ? src : dst, p == 0 ? MT_M : -MT_SPAN, ld4, lo, hi,
               hi < MT_N ? edge[p] : dst[0], emit);
    bar();  // the next phase reads this one's new words
  }
}

// The 24-bit uniform of a word: its tempered 24 high bits k as
// float(k) * 2^-24, without an int->float conversion, which issues at a
// quarter of the integer rate: k is 2^23 + k (k < 2^23) or 2k (k >= 2^23)
// as the float 0x4b000000 + k, and both scalings are exact.  Bit-equal to
// the conversion for every word (all 2^24 values of k, checked in
// tests/test_torch_colored_layout.py).
__device__ __forceinline__ float uniform_of(uint32_t y) {
  const uint32_t k = temper(y) >> 8;
  const float f = __uint_as_float(k + 0x4b000000u);
  return k < 0x800000u ? (f - 8388608.0f) * 0x1p-24f : f * 0x1p-25f;
}

// Tempers each new word of block blk into the sweep's uniform of its row
// (row blk*624 + i; rows past the sweep's last are the discarded tail).
struct EmitUniform {
  float4* u;  // the thread's 4 columns of the (rows, .) buffer
  unsigned stride4;  // its row stride in 16-byte words
  int base, rows;
  __device__ void operator()(int i, uint4 w) const {
    const int r = base + i;
    if (r < rows)
      u[(unsigned)r * stride4] =
          make_float4(uniform_of(w.x), uniform_of(w.y), uniform_of(w.z), uniform_of(w.w));
  }
};

}  // namespace
