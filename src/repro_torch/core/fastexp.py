"""Bit-trick exponential approximation (paper §2.4 / Appendix), "fast" flavour.

The paper replaces the ~83-cycle ``exp`` with an approximation built on
the IEEE-754 binary32 layout: interpreting the integer
``i = trunc(2^23 y) + 127 * 2^23`` as a float yields
``(1 + y mod 1) * 2^floor(y)`` — a piecewise-linear interpolant of
``2^y``.  Scaling by ``2 ln^2 2`` centres the relative error at zero.

The float->int32 step TRUNCATES toward zero and SATURATES: values past
the int32 range clamp to INT32_MIN/INT32_MAX and NaN becomes 0.  That is
what the reference's conversion does and what CUDA's ``__float2int_rz``
(``cvt.rzi.s32.f32``) does; PyTorch's own ``.to(torch.int32)`` on the CPU
does not (it gives INT32_MIN for all of them), so the conversion below
goes through float64 with explicit clamping.  The bias add then wraps
modulo 2^32: once ``|2^23 log2(e) x|`` passes 2^31 (``|x| > 177.4``) a
very favourable move gets a negative "probability" and is rejected —
the reference's behaviour, reproduced bit for bit.

Only the "fast" flavour is ported: it is the one every ported rung uses.
"""

from __future__ import annotations

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

#: The two float32 constants as the reference rounds them (nearest even).
SCALE_F32 = np.float32((1 << 23) * LOG2_E)
CENTRE_F32 = np.float32(TWO_LN2_SQ)


def f32_bits(x: np.float32) -> int:
    """The uint32 bit pattern of a float32 (kernels take constants so)."""
    return int(np.asarray(x, np.float32).view(np.uint32))


def _f32_const(c: np.float32, device) -> torch.Tensor:
    return torch.tensor(float(c), dtype=torch.float32, device=device)


def fastexp_fast(x: torch.Tensor) -> torch.Tensor:
    """Fast e^x approximation (paper's 4-cycle variant, no bounds checking).

    Valid for ``-126 ln 2 <= x < 128 ln 2`` (paper §2.4); outside that
    range the result is unpredictable (exactly as in the paper) but
    bit-identical to the reference.  Max relative error ~(-3.9%, +2%).
    """
    x = x.to(torch.float32)
    # Step 2: multiply by 2^23 * log2(e) (one float32 rounding).
    y = x * _f32_const(SCALE_F32, x.device)
    # Step 3: truncate + saturate to int32, NaN -> 0 (float64 holds every
    # float32 exactly, so trunc/clamp there is the exact conversion).
    i = y.double().nan_to_num(0.0).trunc().clamp(-(2**31), 2**31 - 1)
    # Step 4: add 127 * 2^23, wrapping modulo 2^32 like an int32 add.
    w = (i.to(torch.int64) + EXPONENT_BIAS_BITS) & 0xFFFFFFFF
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    # Step 5: reinterpret as float and centre the relative error.
    return w.view(torch.float32) * _f32_const(CENTRE_F32, x.device)


#: Named registry so the sweep can select the exp flavour.
EXP_FNS = {"fast": fastexp_fast}


def exp_fn(flavor: str):
    """The exp flavour ``flavor``; raises ValueError for unported ones."""
    if flavor not in EXP_FNS:
        raise ValueError(
            f"exp flavour {flavor!r} is not ported to repro_torch; "
            f"available: {tuple(EXP_FNS)}"
        )
    return EXP_FNS[flavor]
