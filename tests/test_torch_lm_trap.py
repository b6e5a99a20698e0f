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

The other LM families (ROADMAP §3y, §3z) add the ops of their mixers:
``softplus`` (the Mamba2 step size; the port writes the reference's
``logaddexp(x, 0)``, `nn.mamba2.softplus`, not ``F.softplus``),
``sigmoid`` (the sigmoid router, RWKV's receptance gate), ``tanh`` (the
DDLerp and decay LoRAs), ``logsumexp`` (the router's z-loss), ``cumsum``
of log-decays and ``exp`` of their differences (both chunked scans).  In
float32 they differ by an ulp on a share of the inputs, within
``F32_OP``; in bfloat16 ``sigmoid`` differs by one bfloat16 ulp, within
``BF16_OP``.  ``exp`` of cumsum differences inherits the cumsums' one-ulp differences
as absolute errors of its exponent: within ``F32_SCAN_EXP`` (measured
3.8e-6 over 20 steps of log-decays down to -4; ulp(64) is 2^-17).
``sinusoid_positions`` (numpy in both) is equal.  Routing
must break ties as ``jax.lax.top_k`` and ``jnp.argsort`` do: ``torch.topk``
and an unstable ``torch.argsort`` do not.

* ``BF16_HYBRID_LOGITS``: zamba2's smoke model in bfloat16 (4 Mamba2
  layers and 2 calls of the shared attention block, 6 blocks deep) against
  the reference's: measured 0.048-0.074 over seeds 0-2, while the
  reference's own bfloat16 logits are 0.079-0.150 from its float32 ones
  (§3w's drift with depth; `test_torch_lm_families.py`).
* ``BF16_ROUTE_TIE``: in bfloat16 the router's input is one rounding away
  from another path's (teacher forcing against decode, the port against
  the reference), so an expert whose selection score is this close to the
  k-th (scaled by the row's largest score) may swap in or out, and the
  step's logits then differ by far more than ``BF16_LOGITS`` (0.85 at
  deepseek-v3's smoke size, §3z).  A bfloat16 MoE comparison that fails
  its bound must find such a tie at or before the failing step.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from repro.models import encdec as jencdec
from repro_torch.models import encdec
from repro_torch.nn.mamba2 import softplus

ROOT = Path(__file__).resolve().parents[1]
F32_OP = 2.0**-21
BF16_OP = 2.0**-7
F32_LAYER = 2.0**-19
BF16_LAYER = 2.0**-6
F32_LOGITS = 2.0**-13
BF16_LOGITS = 2.0**-5
F32_TOP2_GAP = 2 * F32_LOGITS
F32_SCAN_EXP = 2.0**-16
BF16_HYBRID_LOGITS = 2.0**-3
BF16_ROUTE_TIE = 2.0**-7

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
        "wide": (rng.standard_normal(N) * 8).astype(np.float32),
        "logit rows": (rng.standard_normal((N // 100, 100)) * 4).astype(np.float32),
        "log decays": -rng.uniform(1e-6, 4.0, (N // 100, 100)).astype(np.float32),
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
OPS.update({
    "sigmoid": (("wide",), jax.nn.sigmoid, torch.sigmoid, True),
    "tanh of a LoRA": (("wide",), jnp.tanh, torch.tanh, True),
})
#: Ops the LM runs in float32 only: op -> (input names, reference, port, bound).
OPS_F32 = {
    "softplus": (("wide",), jax.nn.softplus, softplus, F32_OP),
    "logsumexp of rows of 100": (("logit rows",), lambda x: jax.nn.logsumexp(x, axis=-1),
                                 lambda x: torch.logsumexp(x, -1), F32_OP),
    "cumsum of log decays": (("log decays",), lambda x: jnp.cumsum(x, axis=1),
                             lambda x: torch.cumsum(x, 1), F32_OP),
    "exp of cumsum differences": (
        ("log decays",),
        lambda x: jnp.exp(_lower(jnp.cumsum(x, axis=1)[:, 10:20, None]
                                 - jnp.cumsum(x, axis=1)[:, None, 10:20])),
        lambda x: torch.exp(_lower(torch.cumsum(x, 1)[:, 10:20, None]
                                   - torch.cumsum(x, 1)[:, None, 10:20])), F32_SCAN_EXP),
}
#: dtype -> the ops whose results differ from the reference's.  The mean
#: of squares differs in float32 only: in bfloat16 the final rounding hides
#: the float32 sums' last bits.
DIFFERING = {
    "float32": {"rsqrt", "cos of RoPE angles", "sin of RoPE angles", "tanh-GELU", "SiLU",
                "softmax of rows of 1000", "mean of squares", "sigmoid", "tanh of a LoRA"},
    "bfloat16": {"rsqrt", "cos of RoPE angles", "sin of RoPE angles", "tanh-GELU", "SiLU",
                 "softmax of rows of 1000", "sigmoid"},
}


def _lower(d):
    """The lower triangle of (rows, i, j) differences (i >= j, where the
    scans take their exps; the rest is 0): exponents <= 0."""
    i = np.arange(d.shape[1])
    return d * (i[:, None] >= i[None, :])


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


@pytest.mark.parametrize("op", list(OPS_F32))
def test_float32_op_differences_are_measured_and_bounded(op):
    """The ops the families run in float32 only: each differs from the
    reference's on some of its 100,000 inputs, within its bound."""
    names, jfn, tfn, bound = OPS_F32[op]
    want = np.asarray(jfn(*[jnp.asarray(X[n]) for n in names]))
    got = tfn(*[torch.from_numpy(X[n]) for n in names]).numpy()
    assert int((want != got).sum()) > 0, op
    assert scaled_error(want, got) <= bound, (op, scaled_error(want, got))


def test_softplus_is_written_the_references_way():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; `nn.mamba2.softplus`
    writes that, and is nearer the reference than ``F.softplus`` (which
    computes ``log1p(exp(x))`` below its threshold and returns ``x`` above
    it): in bfloat16 it is equal where ``F.softplus`` is not."""
    x = X["wide"]
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
        ours = softplus(torch.from_numpy(x).to(tdt)).float().numpy()
        theirs = torch.nn.functional.softplus(torch.from_numpy(x).to(tdt)).float().numpy()
        assert scaled_error(want, ours) <= scaled_error(want, theirs)
        if tdt == torch.bfloat16:
            assert int((want != ours).sum()) == 0 and int((want != theirs).sum()) > 0


def test_sinusoid_positions_are_the_references():
    for length, dim in ((1500, 384), (448, 384), (64, 64), (16, 64)):
        np.testing.assert_array_equal(encdec.sinusoid_positions(length, dim),
                                      jencdec.sinusoid_positions(length, dim))


def test_routing_needs_the_stable_tie_order():
    """``jax.lax.top_k`` breaks ties toward the lower index and
    ``jnp.argsort`` is stable.  ``torch.topk`` and an unstable
    ``torch.argsort`` order tied values otherwise on the CPU, so the
    router would pick other experts and the capacity sort would pass other
    (token, expert) pairs; `nn.moe`'s stable forms are the reference's."""
    from repro_torch.nn.moe import topk_lower_index_first

    ties = np.zeros((3, 64), np.float32)
    ties[1, ::3] = 1.0
    ties[2] = np.repeat(np.arange(8, dtype=np.float32), 8)
    want = np.asarray(jax.lax.top_k(jnp.asarray(ties), 8)[1])
    ours = topk_lower_index_first(torch.from_numpy(ties), 8)[1].numpy()
    np.testing.assert_array_equal(want, ours)
    assert not np.array_equal(want, torch.topk(torch.from_numpy(ties), 8).indices.numpy())
    experts = np.random.default_rng(0).integers(0, 8, 4096)
    want = np.asarray(jnp.argsort(jnp.asarray(experts)))
    np.testing.assert_array_equal(want, torch.argsort(torch.from_numpy(experts),
                                                      stable=True).numpy())
    assert not np.array_equal(want, torch.argsort(torch.from_numpy(experts)).numpy())


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
    assert F32_OP < F32_LAYER < F32_SCAN_EXP < F32_LOGITS < F32_TOP2_GAP < BF16_OP
    assert BF16_OP <= BF16_LAYER <= BF16_LOGITS < 0.06 < BF16_HYBRID_LOGITS
    assert BF16_ROUTE_TIE == BF16_OP


def test_chip_smoke_uses_these_bounds():
    """`chip_smoke.py` holds the card's float32 prefill to the CPU's, and
    the card's decode to teacher forcing, with these numbers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.LM_F32_LOGITS == F32_LOGITS
    assert chip_smoke.LM_TEACHER_FORCING == 0.06
