// Interlaced MT19937 on the card: one thread per generator column.
//
// The state is (624, V) words, row-major, one generator per column
// (core/mt19937.py); a thread that owns column c reads and writes words
// c, c+V, c+2V, ..., so a warp's access to one state row is 32
// neighbouring words.  Shared by every kernel that draws uniforms:
// colored_multisweep.cu, metropolis_multisweep.cu and mt_next_block.cu.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MT_N = 624;
constexpr int MT_M = 397;
constexpr int TWIST_AHEAD = 8;  // rows loaded before any is stored; < 227
constexpr uint32_t MATRIX_A = 0x9908B0DFu;
constexpr uint32_t UPPER_MASK = 0x80000000u;
constexpr uint32_t LOWER_MASK = 0x7FFFFFFFu;
constexpr uint32_t TEMPER_B = 0x9D2C5680u;
constexpr uint32_t TEMPER_C = 0xEFC60000u;

__device__ __forceinline__ uint32_t twist_word(uint32_t u, uint32_t v, uint32_t m) {
  uint32_t y = (u & UPPER_MASK) | (v & LOWER_MASK);
  return m ^ (y >> 1) ^ ((y & 1u) * MATRIX_A);
}

struct NoEmit {
  __device__ void operator()(int, uint32_t) const {}
};

// One block advance of one generator column (row stride ld words).
// dst == src is the textbook in-place loop.  dst != src reads the old
// state from src and writes the new one to dst; the terms that the in-place
// loop reads after they were rewritten (m for i >= 227, v for i = 623) are
// read from dst.  Loads run TWIST_AHEAD rows ahead of stores: a row's new
// value is read back no sooner than 227 rows later, so that is safe.
// emit(i, word) sees each new word as it is stored, so a caller can write
// it out (tempered) without reading the column back.
template <class Emit = NoEmit>
__device__ void twist_column(const uint32_t* src, uint32_t* dst, size_t ld,
                             const Emit& emit = Emit()) {
  for (int i0 = 0; i0 < MT_N; i0 += TWIST_AHEAD) {
    uint32_t u[TWIST_AHEAD], v[TWIST_AHEAD], m[TWIST_AHEAD];
#pragma unroll
    for (int k = 0; k < TWIST_AHEAD; ++k) {
      const int i = i0 + k;
      u[k] = src[i * ld];
      v[k] = (i + 1 < MT_N) ? src[(i + 1) * ld] : dst[0];
      m[k] = (i + MT_M < MT_N) ? src[(i + MT_M) * ld] : dst[(i + MT_M - MT_N) * ld];
    }
#pragma unroll
    for (int k = 0; k < TWIST_AHEAD; ++k) {
      const uint32_t w = twist_word(u[k], v[k], m[k]);
      dst[(i0 + k) * ld] = w;
      emit(i0 + k, w);
    }
  }
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & TEMPER_B;
  y ^= (y << 15) & TEMPER_C;
  y ^= y >> 18;
  return y;
}

// Temper, keep the 24 high bits, scale to [0, 1).
__device__ __forceinline__ float uniform24(uint32_t y) {
  return (float)(temper(y) >> 8) * (1.0f / 16777216.0f);
}

}  // namespace
