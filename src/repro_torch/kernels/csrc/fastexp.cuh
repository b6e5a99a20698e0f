// The exps of core/fastexp.py on the card: the bit tricks fastexp_fast and
// fastexp_accurate, and fastexp_exact (exp_reference), each a flavour of
// sweep_exp<F>, the exp the sweep kernels decide with.
//
// x * 2^23 log2(e) is one float32 rounding; __float2int_rz truncates,
// saturates and maps NaN to 0, like the reference's float->int32; the
// bias add wraps modulo 2^32; the result is reinterpreted and centred.
// A subnormal result is flushed to a zero of its sign, as the reference's
// float arithmetic flushes it: a select on |r| < FLT_MIN, not -ftz=true,
// so no other float op of the kernels that include this header changes.
// "accurate" clips with compares that keep a NaN (fminf/fmaxf would drop
// it), takes the fourth root as two 1/sqrt rounded to float32 and treats
// a subnormal input as zero.  The plain version takes each 1/sqrt in
// float64 (a sqrt, a division) and rounds it to float32; here it is
// float32 arithmetic with the same bits (rsqrt_f32), with which
// "accurate" over 2^26 elements runs 1.24x faster than with rsqrt_f64
// (PERF.md).  "exact" is expf with the same flush: not __expf and not
// --use_fast_math, so it is the exp that torch.exp computes on the card
// (chip_smoke.py holds sweep_exp<EXACT> to it on all 2^32 float32 inputs).
// The float constants arrive from the host as bit patterns.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <cstring>

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

// Whether 1/sqrt(v) > N * 2^e for v = Mv * 2^ev (all positive), in
// integers: v (N 2^e)^2 < 1, i.e. Mv N^2 < 2^S, S = -(ev + 2e); Mv < 2^24
// and N < 2^26, so Mv N^2 < 2^76 is held as 128 bits.  Never equal: an odd
// N > 1 squared times Mv is no power of two.
__device__ __forceinline__ bool rsqrt_exceeds(uint32_t Mv, int ev, uint32_t N, int e) {
  const uint64_t n2 = (uint64_t)N * N, hi = __umul64hi(n2, Mv), lo = n2 * Mv;
  const int S = -(ev + 2 * e);
  if (S >= 128) return true;
  if (S >= 64) return hi < (1ull << (S - 64));
  return S >= 0 && hi == 0 && lo < (1ull << S);
}

// z, a float within an ulp of 1/sqrt(v), stepped to 1/sqrt(v) rounded to
// nearest: up while 1/sqrt(v) lies above the midpoint to the next float,
// down while it lies below the midpoint to the previous one (a quarter
// ulp of z's binade below a power of two).  Out of line: rare, and long.
__device__ __noinline__ float rsqrt_round(uint32_t Mv, int ev, float z) {
  for (int k = 0; k < 3; ++k) {
    const uint32_t b = __float_as_uint(z), M = (b & 0x7FFFFFu) | 0x800000u;
    if (!rsqrt_exceeds(Mv, ev, 2 * M + 1, (int)(b >> 23) - 151)) break;
    z = __uint_as_float(b + 1);
  }
  for (int k = 0; k < 3; ++k) {
    const uint32_t b = __float_as_uint(z), M = (b & 0x7FFFFFu) | 0x800000u;
    const bool pow2 = M == 0x800000u;
    if (rsqrt_exceeds(Mv, ev, pow2 ? 4 * M - 1 : 2 * M - 1, (int)(b >> 23) - (pow2 ? 152 : 151)))
      break;
    z = __uint_as_float(b - 1);
  }
  return z;
}

// rsqrt_f64 in float32 arithmetic: 1/sqrt(v) rounded to nearest.  y, the
// card's approximate rsqrt (MUFU; v is normal, so .ftz changes nothing),
// within ~1 ulp; the residual r = 1 - v y^2 to ~2^-44 (v y split exactly
// by an FMA); 1/sqrt(v) = y + d, d = y (r/2 + 3 r^2 / 8), to ~2^-43.  If
// y + d rounds to one float all over [d - e, d + e], e = y 2^-37 (far
// wider than the error), that float is the rounded value; otherwise (~1
// input in 8,000, where 1/sqrt(v) lies near a midpoint) rsqrt_round
// decides in integers.  0, subnormal, negative, infinite and NaN inputs
// take rsqrt_f64 (none reaches here from the exp but 0 and +inf).  The
// plain version rounds twice, through float64; the two differ only within
// ~2^-52 of a float32 midpoint, and the exp is held to it on all 2^32
// float32 inputs on the card (chip_smoke.py: check_fastexp_exhaustive).
__device__ __forceinline__ float rsqrt_f32(float v) {
  if (!(v >= FLT_MIN && v <= FLT_MAX)) return rsqrt_f64(v);
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  const float h = v * y, hl = __fmaf_rn(v, y, -h);  // v y = h + hl exactly
  const float r = __fmaf_rn(-hl, y, __fmaf_rn(-h, y, 1.0f));  // 1 - v y^2
  const float d = y * (r * __fmaf_rn(0.375f, r, 0.5f));
  const float e = y * 0x1p-37f, z = y + (d - e);
  if (z == y + (d + e)) return z;
  const uint32_t bv = __float_as_uint(v);
  return rsqrt_round((bv & 0x7FFFFFu) | 0x800000u, (int)(bv >> 23) - 150, z);
}

__device__ __forceinline__ float fastexp_accurate(float x, float scale4, float centre, float lo,
                                                  float clip_hi) {
  x = flush_subnormal(x);
  float xc = x < lo ? lo : x;  // a NaN compares false and stays NaN
  xc = xc > clip_hi ? clip_hi : xc;
  const float f = exp_interpolant(xc * scale4, centre);
  float r = rsqrt_f32(rsqrt_f32(f));
  if (x < lo) r = 0.0f;
  if (x > 0.0f && r < 1.0f) r = 1.0f;
  return r;
}

__device__ __forceinline__ float fastexp_exact(float x) { return flush_subnormal(expf(x)); }

// The float constants of the bit tricks, in the order the C entries take
// their bit patterns (kernels/ops.py: _EXP_CONSTS).
struct ExpConsts {
  float scale, centre, scale4, lo, clip_hi;
};

inline float exp_const(uint32_t bits) {
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}

inline ExpConsts exp_consts(uint32_t scale, uint32_t centre, uint32_t scale4, uint32_t lo,
                            uint32_t clip_hi) {
  return ExpConsts{exp_const(scale), exp_const(centre), exp_const(scale4), exp_const(lo),
                   exp_const(clip_hi)};
}

// The exp flavours a sweep kernel is instantiated for, with the codes the C
// entries take (kernels/ops.py: SWEEP_FLAVOURS).
constexpr int EXP_FAST = 0, EXP_ACCURATE = 1, EXP_EXACT = 2;

template <int F>
__device__ __forceinline__ float sweep_exp(float x, const ExpConsts& c) {
  static_assert(F == EXP_FAST || F == EXP_ACCURATE || F == EXP_EXACT, "unknown exp flavour");
  if constexpr (F == EXP_FAST) return fastexp_fast(x, c.scale, c.centre);
  else if constexpr (F == EXP_ACCURATE)
    return fastexp_accurate(x, c.scale4, c.centre, c.lo, c.clip_hi);
  else return fastexp_exact(x);
}

// Instantiates K<..., F> for the flavour code `flavour` and returns what the
// call returns; an unknown code is cudaErrorInvalidValue.
#define SWEEP_EXP_DISPATCH(flavour, CALL)                   \
  ((flavour) == EXP_FAST       ? CALL(EXP_FAST)             \
   : (flavour) == EXP_ACCURATE ? CALL(EXP_ACCURATE)         \
   : (flavour) == EXP_EXACT    ? CALL(EXP_EXACT)            \
                               : (int)cudaErrorInvalidValue)

}  // namespace
