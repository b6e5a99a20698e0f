"""The LM's floats cannot match the reference bit for bit (ROADMAP §3w).

XLA on the CPU and ATen on the CPU compute several of the LM's ops with
other approximations or in another order: ``rsqrt`` and the mean of
squares over a row of 1000 (the norms), ``cos`` / ``sin`` of the RoPE
angles, tanh-GELU, SiLU and softmax differ on a large share of their
inputs, in float32 by 1-9 ulps and in bfloat16 by one bfloat16 ulp of the
output's scale.  The products (the einsums of the projections and of
attention, at these sizes), the RoPE rotation and a bfloat16 tensor times
a bfloat16 scalar are equal here.  This file
measures each op on the same numpy inputs and holds it to the bound below;
the LM tests compare the port with the reference within the tolerances
named here, never bit for bit.

The error measure everywhere is the *scaled error*: ``max |a - b| /
max |a|``, the measure of the reference's own teacher-forcing bound
(``tests/test_archs.py:90``, 0.06).

* ``F32_OP`` / ``BF16_OP``: one op, measured here (float32: at most 3.2e-7
  on softmax; bfloat16: one bfloat16 ulp, 2^-8 of the output's scale, and
  just above it where softmax's largest value is below 1).
* ``F32_LAYER`` / ``BF16_LAYER``: one layer (norm, RoPE, MLP, attention, a
  decode step's attention): a chain of tens of ops, each within the op
  bound, with products that sum a few hundred terms (measured in
  `test_torch_lm_layers.py`: at most 3.0e-7 and 0.0069).
* ``F32_LOGITS`` / ``BF16_LOGITS``: a whole model's logits, or its caches,
  prefill and decode steps included: the layer bound through a stack of
  layers (2 at the test sizes, 18 for gemma-2b's full width on the card,
  where `chip_smoke.py` holds the card's float32 prefill to the CPU's with
  ``F32_LOGITS`` too).  Measured in `test_torch_lm_decoder.py`: at most
  1.4e-6 and 0.0145.  ``BF16_LOGITS`` stays below the reference's own
  teacher-forcing bound of 0.06.
* ``F32_TOP2_GAP``: served tokens in float32 are equal; a step may pick
  another token only where the reference's top-two logit gap, scaled by
  the largest logit, is below this (twice ``F32_LOGITS``: each side may
  move by it).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
F32_OP = 2.0**-21
BF16_OP = 2.0**-7
F32_LAYER = 2.0**-19
BF16_LAYER = 2.0**-6
F32_LOGITS = 2.0**-13
BF16_LOGITS = 2.0**-5
F32_TOP2_GAP = 2 * F32_LOGITS

N = 100_000
DTYPES = {"float32": (jnp.float32, torch.float32, F32_OP),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_OP)}


def scaled_error(want, got) -> float:
    """``max |want - got| / max |want|`` in float64."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "positive": rng.uniform(1e-3, 100.0, N).astype(np.float32),
        "angles": rng.uniform(0.0, 3000.0, N).astype(np.float32),
        "normal": (rng.standard_normal(N) * 3).astype(np.float32),
        "cos": np.cos(np.arange(N, dtype=np.float32) * np.float32(0.03)).astype(np.float32),
        "sin": np.sin(np.arange(N, dtype=np.float32) * np.float32(0.03)).astype(np.float32),
        "rows": (rng.standard_normal((N // 1000, 1000)) * 4).astype(np.float32),
        "a": rng.standard_normal((2, 8, 64)).astype(np.float32),
        "b": rng.standard_normal((64, 128)).astype(np.float32),
        "q": rng.standard_normal((2, 16, 2, 2, 32)).astype(np.float32),
        "k": rng.standard_normal((2, 16, 2, 32)).astype(np.float32),
    }


X = _inputs()

#: op -> (input names, reference function, port function, inputs cast to the dtype).
OPS = {
    "rsqrt": (("positive",), jax.lax.rsqrt, torch.rsqrt, True),
    "cos of RoPE angles": (("angles",), jnp.cos, torch.cos, False),
    "sin of RoPE angles": (("angles",), jnp.sin, torch.sin, False),
    "tanh-GELU": (("normal",), lambda x: jax.nn.gelu(x, approximate=True),
                  lambda x: F.gelu(x, approximate="tanh"), True),
    "SiLU": (("normal",), jax.nn.silu, F.silu, True),
    "softmax of rows of 1000": (("rows",), lambda x: jax.nn.softmax(x, axis=-1),
                                lambda x: torch.softmax(x, -1), True),
    "projection einsum": (("a", "b"), lambda a, b: jnp.einsum("bsd,df->bsf", a, b),
                          torch.matmul, True),
    "attention score einsum": (("q", "k"),
                               lambda q, k: jnp.einsum("bqkgd,bckd->bkgqc", q, k),
                               lambda q, k: torch.einsum("bqkgd,bckd->bkgqc", q, k), True),
    "mean of squares": (("rows",), lambda x: jnp.mean(jnp.square(x), axis=-1),
                        lambda x: torch.mean(torch.square(x), -1), True),
    "RoPE rotation": (("normal", "cos", "sin"), lambda x, c, s: x * c - x[::-1] * s,
                      lambda x, c, s: x * c - x.flip(0) * s, False),
    "times an embedding scale": (("normal",), lambda x: x * x.dtype.type(45.25),
                                 lambda x: x * 45.25, True),
}
#: dtype -> the ops whose results differ from the reference's.  The mean
#: of squares differs in float32 only: in bfloat16 the final rounding hides
#: the float32 sums' last bits.
DIFFERING = {
    "float32": {"rsqrt", "cos of RoPE angles", "sin of RoPE angles", "tanh-GELU", "SiLU",
                "softmax of rows of 1000", "mean of squares"},
    "bfloat16": {"rsqrt", "cos of RoPE angles", "sin of RoPE angles", "tanh-GELU", "SiLU",
                 "softmax of rows of 1000"},
}


def _run(op: str, dtype: str):
    names, jfn, tfn, cast = OPS[op]
    jdt, tdt, _ = DTYPES[dtype]
    jargs = [jnp.asarray(X[n]).astype(jdt if cast else jnp.float32) for n in names]
    targs = [torch.from_numpy(X[n]).to(tdt if cast else torch.float32) for n in names]
    want = np.asarray(jnp.asarray(jfn(*jargs)).astype(jnp.float32))
    got = tfn(*targs).float().numpy()
    return want, got


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", list(OPS))
def test_op_differences_are_measured_and_bounded(op, dtype):
    """Each op's scaled error is within its dtype's op bound; the ops
    named in `DIFFERING` do differ (so bit-equality cannot be asked of the
    layers), the others are equal."""
    want, got = _run(op, dtype)
    differ = int((want != got).sum())
    if op in DIFFERING[dtype]:
        assert differ > 0, op
    else:
        assert differ == 0, (op, differ)
    assert scaled_error(want, got) <= DTYPES[dtype][2], (op, scaled_error(want, got))


def test_the_float32_differences_are_a_few_ulps():
    """In float32 no differing op is off by more than 9 ulps where its
    result is not tiny (softmax's smallest weights aside), but tanh-GELU,
    whose ``1 + tanh`` cancels on the negative tail."""
    for op in DIFFERING["float32"] - {"tanh-GELU"}:
        want, got = _run(op, "float32")
        big = np.abs(want) > 1e-3
        wi, gi = want[big].view(np.int32).astype(np.int64), got[big].view(np.int32).astype(np.int64)
        assert np.abs(wi - gi).max() <= 9, op


def test_the_bounds_are_ordered():
    assert F32_OP < F32_LAYER < F32_LOGITS < F32_TOP2_GAP < BF16_OP
    assert BF16_OP <= BF16_LAYER <= BF16_LOGITS < 0.06


def test_chip_smoke_uses_these_bounds():
    """`chip_smoke.py` holds the card's float32 prefill to the CPU's, and
    the card's decode to teacher forcing, with these numbers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.LM_F32_LOGITS == F32_LOGITS
    assert chip_smoke.LM_TEACHER_FORCING == 0.06
