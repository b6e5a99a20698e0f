"""The float32 reciprocal square root of the "accurate" exp on the card
(csrc/fastexp.cuh: rsqrt_f32, rsqrt_round), emulated on the CPU.

The plain version takes each 1/sqrt(v) of the fourth root as a float64
sqrt and division rounded to float32 (`core.fastexp._rsqrt`).  The kernel
takes it in float32 arithmetic: the card's approximate rsqrt y, one
Newton-series step on the residual 1 - v y^2 with FMAs, a rounding test
by perturbed sums, and, near a midpoint, an exact decision in integers.

Here an exact emulation of that float32 path (numpy float32 operations;
each FMA as one rounding of its exact value, which 80-bit long double
holds for every FMA of the path) is started from every approximation
within 2 ulps of the answer, as the card's approximate rsqrt gives, and
held bit for bit to the float64 path: on random normal floats, on the
values the exp feeds it, and with the integer decision forced on every
input.  The card holds the kernel itself against the plain version on all
2^32 float32 exp inputs (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fastexp as fx
from repro_torch.kernels import _build

F32, LD = np.float32, np.longdouble
SRC = (_build.CSRC / "fastexp.cuh").read_text()


def _fma(a, b, c):
    """float32 fma: a*b (48 bits) + c is exact in long double here."""
    return (np.asarray(a, LD) * np.asarray(b, LD) + np.asarray(c, LD)).astype(F32)


def _exceeds(Mv: int, ev: int, N: int, e: int) -> bool:
    """rsqrt_exceeds, with its 128-bit product as two 64-bit halves."""
    q = N * N * Mv
    hi, lo = q >> 64, q & (2**64 - 1)
    S = -(ev + 2 * e)
    if S >= 128:
        return True
    if S >= 64:
        return hi < (1 << (S - 64))
    return S >= 0 and hi == 0 and lo < (1 << S)


def _round(v_bits: int, z_bits: int) -> int:
    """rsqrt_round: the bits of 1/sqrt(v) rounded to nearest, from z."""
    Mv, ev, b = (v_bits & 0x7FFFFF) | 0x800000, (v_bits >> 23) - 150, z_bits
    for _ in range(3):
        M = (b & 0x7FFFFF) | 0x800000
        if not _exceeds(Mv, ev, 2 * M + 1, (b >> 23) - 151):
            break
        b += 1
    for _ in range(3):
        M = (b & 0x7FFFFF) | 0x800000
        pow2 = M == 0x800000
        if _exceeds(Mv, ev, 4 * M - 1 if pow2 else 2 * M - 1, (b >> 23) - (152 if pow2 else 151)):
            break
        b -= 1
    return b


def _rsqrt_f32(v: np.ndarray, y: np.ndarray):
    """rsqrt_f32 on positive normal float32 ``v`` from the approximation
    ``y``: (results, mask of the inputs the float32 test decided)."""
    h = v * y
    hl = _fma(v, y, -h)
    r = _fma(-hl, y, _fma(-h, y, np.ones_like(v)))
    d = y * (r * _fma(np.full_like(v, 0.375), r, np.full_like(v, 0.5)))
    e = y * F32(2.0**-37)
    z = y + (d - e)
    fast = z == y + (d + e)
    out = z.view(np.uint32).copy()
    for i in np.flatnonzero(~fast):
        out[i] = _round(int(v.view(np.uint32)[i]), int(out[i]))
    return out.view(F32), fast


def _f64_path(v: np.ndarray) -> np.ndarray:
    """rsqrt_f64 / the plain version's `_rsqrt`."""
    got = fx._rsqrt(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, (1.0 / np.sqrt(v.astype(np.float64))).astype(F32))
    return got


def _inputs() -> np.ndarray:
    """Positive normal floats: random bit patterns over the whole normal
    range, powers of two and their neighbours, and what the exp feeds its two rsqrts
    (the interpolant of 4y on a grid of its clipped range, and the rsqrt
    of that)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0x00800000, 0x7F800000, 300_000, dtype=np.uint32)
    pows = np.ldexp(F32(1.0), np.arange(-126, 128)).astype(F32)
    # Their neighbours: 1/sqrt(v) just off a power of two, where the ulp
    # below is half the ulp above.
    pows = np.concatenate([pows] + [(pows.view(np.uint32) + np.uint32(j)).view(F32)
                                    for j in (1, 2, 3)]
                          + [(pows[1:].view(np.uint32) - np.uint32(1)).view(F32)])
    x = np.linspace(fx.ACCURATE_LO_F32, fx.ACCURATE_CLIP_HI_F32, 200_001).astype(F32)
    f = fx._interpolant(torch.from_numpy(x) * torch.tensor(fx.SCALE4_F32)).numpy()
    f = f[f >= np.finfo(F32).tiny]
    v = np.concatenate([bits.view(F32), pows, f, _f64_path(f)])
    assert np.all(np.isfinite(v)) and np.all(v >= np.finfo(F32).tiny)
    return v


V = _inputs()
WANT = _f64_path(V)


@pytest.mark.parametrize("k", [-2, -1, 0, 1, 2])
def test_float32_rsqrt_equals_the_float64_path(k):
    """From any approximation within 2 ulps the float32 path gives the
    float64 path's bits; the rare integer decision is taken on some inputs."""
    y = (WANT.view(np.uint32) + np.uint32(k) if k >= 0 else WANT.view(np.uint32)
         - np.uint32(-k)).view(F32)
    got, fast = _rsqrt_f32(V, y)
    np.testing.assert_array_equal(got.view(np.uint32), WANT.view(np.uint32))
    assert 0 < int((~fast).sum()) < V.size // 1000


@pytest.mark.parametrize("k", [-1, 1])
def test_integer_rounding_alone(k):
    """rsqrt_round, forced on every input from a neighbour of the answer,
    steps to the float64 path's bits (binade edges included: inputs next to
    powers of two, whose 1/sqrt lie just off one)."""
    edges = V[(V.view(np.uint32) & 0x7FFFFF) <= 3]  # powers of two, just above them
    sample = np.concatenate([V[:20_000], edges, V[-20_000:]])
    assert edges.size >= 4 * 254
    want = _f64_path(sample).view(np.uint32)
    for vb, wb in zip(sample.view(np.uint32), want):
        assert _round(int(vb), int(wb) + k) == int(wb)


def test_the_emulation_follows_the_source():
    """The constants and steps emulated here are those of fastexp.cuh."""
    for piece in ("rsqrt.approx.ftz.f32", "__fmaf_rn(v, y, -h)",
                  "__fmaf_rn(-hl, y, __fmaf_rn(-h, y, 1.0f))",
                  "y * (r * __fmaf_rn(0.375f, r, 0.5f))", "e = y * 0x1p-37f, z = y + (d - e)",
                  "if (z == y + (d + e)) return z;", "2 * M + 1, (int)(b >> 23) - 151",
                  "pow2 ? 4 * M - 1 : 2 * M - 1, (int)(b >> 23) - (pow2 ? 152 : 151)",
                  "(int)(bv >> 23) - 150", "float r = rsqrt_f32(rsqrt_f32(f));"):
        assert piece in SRC, piece
