"""Bit-trick exponential approximations (paper §2.4 / Appendix).

The paper replaces the ~83-cycle ``exp`` with two approximations built on
the IEEE-754 binary32 layout: interpreting the integer
``i = trunc(2^23 y) + 127 * 2^23`` as a float yields
``(1 + y mod 1) * 2^floor(y)`` — a piecewise-linear interpolant of
``2^y``.  Scaling by ``2 ln^2 2`` centres the relative error at zero
("fast").  Evaluating the interpolant at ``4y`` and taking a fourth root
quadruples the knot density ("accurate", relative error within
(-1%, +0.5%)).  "exact" is the plain exponential, the paper's baseline.

Three properties of the reference's float path are reproduced here, bit
for bit, because the exp decides every Metropolis accept:

* The float->int32 step TRUNCATES toward zero and SATURATES: values past
  the int32 range clamp to INT32_MIN/INT32_MAX and NaN becomes 0.  That
  is what the reference's conversion does and what CUDA's
  ``__float2int_rz`` (``cvt.rzi.s32.f32``) does; PyTorch's own
  ``.to(torch.int32)`` on the CPU does not (it gives INT32_MIN for all of
  them), so the conversion goes through float64 with explicit clamping.
  The bias add then wraps modulo 2^32: once ``|2^23 log2(e) x|`` passes
  2^31 (``|x| > 177.4``) a very favourable move gets a negative
  "probability" and is rejected — the reference's behaviour.
* Subnormal results are FLUSHED to a signed zero, as the reference's
  float arithmetic flushes them (``fastexp_fast`` for x in about
  [-88.03, -87.31] gives 0, not 3e-42).  The flush is an explicit select
  (`flush_subnormal`), not the process-wide ``torch.set_flush_denormal``,
  so no other float op of the program changes.  "accurate" flushes its
  interpolant before the fourth root (near ``ACCURATE_LO`` that makes the
  root 0) and treats a subnormal input as zero, as the reference does.
* The fourth root is two reciprocal square roots, each a float64
  ``1 / sqrt`` rounded to float32.  Those are IEEE-754 double operations,
  so they round the same on the CPU and on the card, and the plain
  version and the CUDA kernel agree bit for bit.  The reference's
  ``rsqrt`` is an approximation of its own, so "accurate" is within
  2 ulp of the reference, not equal to it; "exact" is within 1 ulp.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# --- constants from the paper -------------------------------------------------
LOG2_E = math.log2(math.e)
LN2 = math.log(2.0)
# Scale that zeroes the mean relative error of the linear interpolant:
# integral of (1+t)/2^t over [0,1) is 1/(2 ln^2 2), so multiply by 2 ln^2 2.
TWO_LN2_SQ = 2.0 * LN2 * LN2
EXPONENT_BIAS_BITS = 127 << 23  # 0x3F800000

# Valid input ranges (paper §2.4).
FAST_LO = -126.0 * LN2  # ~ -87.34
FAST_HI = 128.0 * LN2  # ~  88.72
ACCURATE_LO = -31.5 * LN2  # ~ -21.83
ACCURATE_HI = 32.0 * LN2  # ~  22.18

#: The float32 constants as the reference rounds them (nearest even).
SCALE_F32 = np.float32((1 << 23) * LOG2_E)
SCALE4_F32 = np.float32((1 << 25) * LOG2_E)
CENTRE_F32 = np.float32(TWO_LN2_SQ)
ACCURATE_LO_F32 = np.float32(ACCURATE_LO)
ACCURATE_CLIP_HI_F32 = np.float32(ACCURATE_HI - 1e-3)
#: The smallest normal float32; anything of smaller magnitude is flushed.
FLT_MIN = float(np.finfo(np.float32).tiny)


def f32_bits(x: np.float32) -> int:
    """The uint32 bit pattern of a float32 (kernels take constants so)."""
    return int(np.asarray(x, np.float32).view(np.uint32))


@functools.lru_cache(maxsize=64)
def _f32_const_on(value: float, device: str) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _f32_const(c: np.float32, device) -> torch.Tensor:
    """The float32 constant ``c`` as a 0-d tensor on ``device``, made once a
    device: later calls copy nothing from the host (on the card, no host
    sync).  Read-only: callers use it as an operand."""
    return _f32_const_on(float(c), str(device))


def flush_subnormal(r: torch.Tensor) -> torch.Tensor:
    """Subnormal values become a zero of the same sign (``r * 0``);
    everything else, inf and NaN included, passes unchanged."""
    return torch.where(r.abs() < FLT_MIN, r * 0.0, r)


def _interpolant(y: torch.Tensor) -> torch.Tensor:
    """``bitcast(trunc_sat(y) + 127 * 2^23) * 2 ln^2 2``, flushed: the
    linear interpolant of ``2^(y / 2^23)`` at ``y`` (float32)."""
    # Truncate + saturate to int32, NaN -> 0 (float64 holds every float32
    # exactly, so trunc/clamp there is the exact conversion).
    i = y.double().nan_to_num(0.0).trunc().clamp(-(2**31), 2**31 - 1)
    # Add 127 * 2^23, wrapping modulo 2^32 like an int32 add.
    w = (i.to(torch.int64) + EXPONENT_BIAS_BITS) & 0xFFFFFFFF
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    # Reinterpret as float and centre the relative error.
    return flush_subnormal(w.view(torch.float32) * _f32_const(CENTRE_F32, y.device))


def fastexp_fast(x: torch.Tensor) -> torch.Tensor:
    """Fast e^x approximation (paper's 4-cycle variant, no bounds checking).

    Valid for ``FAST_LO <= x < FAST_HI``; outside that range the result is
    unpredictable (exactly as in the paper) but bit-identical to the
    reference.  Max relative error ~(-3.9%, +2%).
    """
    x = x.to(torch.float32)
    # x * 2^23 log2(e) is one float32 rounding.
    return _interpolant(x * _f32_const(SCALE_F32, x.device))


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` in float64, rounded to float32 (``rsqrt(0)`` = inf,
    ``rsqrt(inf)`` = 0)."""
    return torch.reciprocal(torch.sqrt(v.double())).float()


def fastexp_accurate(x: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """Accurate e^x approximation (paper's 11-cycle variant).

    The interpolant of ``2^(4y)`` plus a fourth root, with the paper's
    masking: exactly 0.0 for ``x < -31.5 ln 2`` and at least 1.0 for
    ``x > 0`` (so Metropolis accept tests always accept on negative
    energy deltas).  Relative error roughly within (-1%, +0.5%).
    ``clamp=False`` skips both masks and returns the root itself.
    """
    x = flush_subnormal(x.to(torch.float32))  # a subnormal input is zero
    # Clip to the valid range; maximum/minimum keep a NaN.
    xc = torch.minimum(
        torch.maximum(x, _f32_const(ACCURATE_LO_F32, x.device)),
        _f32_const(ACCURATE_CLIP_HI_F32, x.device),
    )
    f = _interpolant(xc * _f32_const(SCALE4_F32, x.device))
    # The fourth root, as two reciprocal square roots.
    r = _rsqrt(_rsqrt(f))
    if not clamp:
        return r
    r = torch.where(x < _f32_const(ACCURATE_LO_F32, x.device), torch.zeros_like(r), r)
    return torch.where(x > 0, torch.clamp(r, min=1.0), r)


def exp_reference(x: torch.Tensor) -> torch.Tensor:
    """Exact exponential (the paper's unoptimized baseline path), with the
    reference's flush of subnormal results."""
    return flush_subnormal(torch.exp(x.to(torch.float32)))


#: Named registry so the Metropolis ladder can select the exp flavour.
EXP_FNS = {
    "exact": exp_reference,
    "fast": fastexp_fast,
    "accurate": fastexp_accurate,
}


def exp_fn(flavor: str):
    """The exp flavour ``flavor``; raises ValueError for unknown ones."""
    if flavor not in EXP_FNS:
        raise ValueError(f"unknown exp flavour {flavor!r}; available: {tuple(EXP_FNS)}")
    return EXP_FNS[flavor]
