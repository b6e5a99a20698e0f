// The bit-trick exps (core/fastexp.py: fastexp_fast, fastexp_accurate)
// on the card.
//
// x * 2^23 log2(e) is one float32 rounding; __float2int_rz truncates,
// saturates and maps NaN to 0, like the reference's float->int32; the
// bias add wraps modulo 2^32; the result is reinterpreted and centred.
// A subnormal result is flushed to a zero of its sign, as the reference's
// float arithmetic flushes it: a select on |r| < FLT_MIN, not -ftz=true,
// so no other float op of the kernels that include this header changes.
// "accurate" clips with compares that keep a NaN (fminf/fmaxf would drop
// it), takes the fourth root as two float64 1/sqrt rounded to float32
// (IEEE double operations: the plain version rounds them the same way)
// and treats a subnormal input as zero.  The float constants arrive from
// the host as bit patterns.

#pragma once

#include <cfloat>
#include <stdint.h>

namespace {

__device__ __forceinline__ float flush_subnormal(float r) {
  return fabsf(r) < FLT_MIN ? copysignf(0.0f, r) : r;
}

// bitcast(trunc_sat(y) + 127 * 2^23) * centre, flushed.
__device__ __forceinline__ float exp_interpolant(float y, float centre) {
  const int i = __float2int_rz(y);  // trunc, saturating, NaN -> 0
  return flush_subnormal(__uint_as_float((uint32_t)i + (127u << 23)) * centre);
}

__device__ __forceinline__ float fastexp_fast(float x, float scale, float centre) {
  return exp_interpolant(x * scale, centre);
}

__device__ __forceinline__ float rsqrt_f64(float v) {
  return __double2float_rn(1.0 / sqrt((double)v));
}

__device__ __forceinline__ float fastexp_accurate(float x, float scale4, float centre, float lo,
                                                  float clip_hi) {
  x = flush_subnormal(x);
  float xc = x < lo ? lo : x;  // a NaN compares false and stays NaN
  xc = xc > clip_hi ? clip_hi : xc;
  float r = rsqrt_f64(rsqrt_f64(exp_interpolant(xc * scale4, centre)));
  if (x < lo) r = 0.0f;
  if (x > 0.0f && r < 1.0f) r = 1.0f;
  return r;
}

}  // namespace
