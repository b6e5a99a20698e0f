// The "fast" bit-trick exp (core/fastexp.py:fastexp_fast) on the card.
//
// x * 2^23 log2(e) is one float32 rounding; __float2int_rz truncates,
// saturates and maps NaN to 0, like the reference's float->int32; the
// bias add wraps modulo 2^32; the result is reinterpreted and centred.
// The two float constants arrive from the host as bit patterns.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ float fastexp_fast(float x, float scale, float centre) {
  const int i = __float2int_rz(x * scale);  // trunc, saturating, NaN -> 0
  return __uint_as_float((uint32_t)i + (127u << 23)) * centre;
}

}  // namespace
