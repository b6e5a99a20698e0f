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
Training (the backward, the optimizer, the loss) adds its own:

* ``F32_BACKWARD_OP`` / ``BF16_BACKWARD_OP``: one op's gradient (its vjp
  on the same inputs and cotangents, 100,000 values): SiLU, tanh-GELU,
  softmax, logsumexp, the RMS norm and RoPE differ from XLA's derivative
  graphs (float32: at most 1.1e-5, logsumexp's; bfloat16: a few bfloat16
  ulps, at most 0.028).
* ``F32_ADAM``: one AdamW update on the same parameters, gradients and
  state.  Op by op (the reference run eagerly) the port's m and v are
  equal and its parameters differ where ``cos`` of the schedule or
  ``b**step`` of the bias corrections differ by an ulp; the jitted update
  (what the reference's training runs) contracts ``b1*m + (1-b1)*g`` into
  FMAs (§3c): 20% of m differ, at most 1.1e-7.  ``lr_schedule`` and the
  bias corrections: ``cos`` and ``pow`` differ by 1-4 ulps on a few steps.
* ``F32_GRAD``: a train step of a smoke config (2-6 blocks) from the same
  weights and batch: its gradients, Adam's m and v (measured at most
  9e-6, `test_torch_train_archs_*.py`); ``F32_GRAD_DEEP``: the same at 18
  layers (measured 2.1e-5 at gemma-2b's smoke width), and `chip_smoke.py`'s
  bound for gemma-2b's full-width step, card against CPU.
* ``F32_STEP``: the parameters after a step with a learning rate, as a
  share of the update's size: Adam's ``mh / (sqrt(vh) + eps)`` turns a
  gradient's last bits into a whole update where the gradient is near
  ``eps`` (measured at most 0.048).  The reference compares m, not the
  parameters, for this reason (``tests/test_train_infra.py:55-58``).
* ``BF16_GRAD_DRIFT``: in bfloat16 the reference's own gradients are
  0.017-0.64 from its float32 ones at the smoke configs (an MoE's
  router picks other experts, §3z); the port's bfloat16 gradients are held
  to be no farther from the reference's float32 gradients than this many
  times the reference's bfloat16 ones are (measured at most 2.2).

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
from repro.nn import basic as jbasic
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.models import encdec
from repro_torch.nn import basic as tbasic
from repro_torch.nn.mamba2 import softplus
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

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
F32_BACKWARD_OP = 2.0**-15
BF16_BACKWARD_OP = 2.0**-4
F32_ADAM = F32_OP
F32_GRAD = 2.0**-15
F32_GRAD_DEEP = 2.0**-13
F32_STEP = 2.0**-3
BF16_GRAD_DRIFT = 4.0

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
    assert F32_ADAM <= F32_BACKWARD_OP <= F32_GRAD < F32_GRAD_DEEP == F32_LOGITS
    assert BF16_LOGITS < BF16_BACKWARD_OP < F32_STEP


# -- training ---------------------------------------------------------------------------

_POS = np.broadcast_to(np.arange(50, dtype=np.int32) * 37, (2, 50)).copy()
X["heads"] = np.random.default_rng(1).standard_normal((2, 50, 4, 64)).astype(np.float32)
#: op -> (input name, reference function, port function): their vjps are compared.
BACKWARD = {
    "SiLU": ("normal", jax.nn.silu, F.silu),
    "tanh-GELU": ("normal", lambda x: jax.nn.gelu(x, approximate=True),
                  lambda x: F.gelu(x, approximate="tanh")),
    "softmax": ("logit rows", lambda x: jax.nn.softmax(x, axis=-1),
                lambda x: torch.softmax(x, -1)),
    "logsumexp": ("logit rows", lambda x: jax.nn.logsumexp(x, axis=-1),
                  lambda x: torch.logsumexp(x, -1)),
    "RMS norm": ("rows", lambda x: jbasic.rmsnorm_apply({"scale": jnp.ones(1000)}, x),
                 lambda x: tbasic.rmsnorm_apply({"scale": torch.ones(1000)}, x)),
    "RoPE": ("heads", lambda x: jbasic.apply_rope(x, jnp.asarray(_POS)),
             lambda x: tbasic.apply_rope(x, torch.from_numpy(_POS))),
}
BACKWARD_BOUND = {"float32": F32_BACKWARD_OP, "bfloat16": BF16_BACKWARD_OP}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", list(BACKWARD))
def test_backward_op_differences_are_measured_and_bounded(op, dtype):
    """Each op's gradient (vjp, the same inputs and cotangents) differs
    from XLA's derivative graph on some inputs, within the dtype's bound."""
    name, jfn, tfn = BACKWARD[op]
    jdt, tdt, _ = DTYPES[dtype]
    x = X[name]
    out, vjp = jax.vjp(jfn, jnp.asarray(x).astype(jdt))
    ct = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(ct).astype(out.dtype))[0].astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = tfn(tx)
    got = torch.autograd.grad(y, tx, torch.from_numpy(ct).to(y.dtype))[0].float().numpy()
    assert int((want != got).sum()) > 0, op
    assert scaled_error(want, got) <= BACKWARD_BOUND[dtype], (op, scaled_error(want, got))


SCHEDULES = [dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
             dict(lr=3e-4, warmup_steps=100, total_steps=2000),
             dict(lr=3e-3, warmup_steps=5, total_steps=20),
             dict(lr=1e-2, warmup_steps=0, total_steps=10)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"w{kw['warmup_steps']}t{kw['total_steps']}")
def test_lr_schedule_is_the_references_within_an_op(kw):
    """Step by step, as each package computes it: equal but where ``cos``
    differs by an ulp (the warmup ramp itself is exact)."""
    steps = range(0, kw["total_steps"] + 5)
    want = np.array([float(jadamw.lr_schedule(jadamw.AdamWConfig(**kw), jnp.int32(s)))
                     for s in steps], np.float32)
    got = np.array([float(tadamw.lr_schedule(tadamw.AdamWConfig(**kw), torch.tensor(s)))
                    for s in steps], np.float32)
    assert scaled_error(want, got) <= F32_OP
    ramp = slice(0, kw["warmup_steps"] + 1)
    np.testing.assert_array_equal(want[ramp], got[ramp])


@pytest.mark.parametrize("b", [0.9, 0.95, 0.999])
def test_bias_corrections_pow_differs_by_ulps(b):
    """``1 - b**step`` over 20,000 steps: XLA's and ATen's ``pow`` differ on
    a few steps by 1-4 ulps."""
    s = np.arange(1, 20_001, dtype=np.float32)
    want = np.asarray(1 - jnp.float32(b) ** jnp.asarray(s))
    got = (1 - torch.pow(torch.tensor(b, dtype=torch.float32), torch.from_numpy(s))).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert 0 < int((ulps > 0).sum()) < 100 and ulps.max() <= 4, (int((ulps > 0).sum()), ulps.max())


def _adam_inputs():
    rng = np.random.default_rng(3)
    n = 100_000
    return (rng.standard_normal(n).astype(np.float32),
            (rng.standard_normal(n) * np.exp(rng.uniform(-20, 2, n))).astype(np.float32),
            (rng.standard_normal(n) * 0.01).astype(np.float32),
            rng.uniform(0, 1e-3, n).astype(np.float32))


@pytest.mark.parametrize("step", [0, 3, 50])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_is_the_references_op_by_op(state_dtype, step):
    """One update on the same inputs, unclipped: against the reference run
    op by op, m and v are equal and the parameters within an op (an ulp of
    the learning rate moves a parameter by an ulp); against the jitted
    reference (FMAs, §3c) within ``F32_ADAM``."""
    p, g, m, v = _adam_inputs()
    # No clipping (scale 1): the global norm's float32 sum may differ from
    # XLA's by an ulp (its order depends on ATen's threads), which would move
    # every m; the norm is held within an op below.
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100, state_dtype=state_dtype, clip_norm=1e6)
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32

    def ref(jit):
        fn = lambda P, G, O: jadamw.adamw_update(jadamw.AdamWConfig(**kw), P, G, O,  # noqa: E731
                                                 jnp.int32(step))
        opt = jadamw.OptState({"w": jnp.asarray(m).astype(jdt)}, {"w": jnp.asarray(v).astype(jdt)})
        out = (jax.jit(fn) if jit else fn)({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)}, opt)
        return [np.asarray(jnp.asarray(t).astype(jnp.float32))
                for t in (out[0]["w"], out[1].m["w"], out[1].v["w"])], out[2]

    opt = tadamw.OptState({"w": torch.from_numpy(m.copy()).to(tdt)},  # updated in place
                          {"w": torch.from_numpy(v.copy()).to(tdt)})
    tp, to, tm = tadamw.adamw_update(tadamw.AdamWConfig(**kw), {"w": torch.from_numpy(p.copy())},
                                     {"w": torch.from_numpy(g.copy())}, opt, torch.tensor(step))
    got = [t.float().numpy() for t in (tp["w"], to.m["w"], to.v["w"])]
    eager, jm = ref(jit=False)
    np.testing.assert_array_equal(eager[1], got[1])
    np.testing.assert_array_equal(eager[2], got[2])
    assert scaled_error(eager[0], got[0]) <= F32_OP
    assert scaled_error(float(jm["grad_norm"]), float(tm["grad_norm"])) <= F32_OP
    jitted, _ = ref(jit=True)
    for want, have in zip(jitted, got):
        assert scaled_error(want, have) <= F32_ADAM


def test_global_norm_and_the_loss_within_an_op():
    """`global_norm` over a tree with a layer stack (the port's layers one
    name each) and `cross_entropy_loss` (float32 logits over 128 and
    256,000 classes, ignored labels), with the loss's gradient."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((64, 32)).astype(np.float32),
            "b": {"c": rng.standard_normal(1000).astype(np.float32)},
            "blocks": {"w": rng.standard_normal((3, 40, 50)).astype(np.float32)}}
    port = {"a": torch.from_numpy(tree["a"]), "b.c": torch.from_numpy(tree["b"]["c"])}
    port.update({f"blocks.{i}.w": torch.from_numpy(tree["blocks"]["w"][i]) for i in range(3)})
    want = float(jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    assert scaled_error(want, float(tadamw.global_norm(port))) <= F32_OP
    for V in (128, 256_000):
        logits = (rng.standard_normal((2, 8, V)) * 3).astype(np.float32)
        labels = rng.integers(0, V, (2, 8)).astype(np.int32)
        labels[0, -3:] = -100
        jt, jc = jstep.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
        tt, tc = tstep.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
        assert scaled_error(float(jt), float(tt)) <= F32_OP
        assert scaled_error(float(jc), float(tc)) <= F32_OP
        jg = jax.grad(lambda x: jstep.cross_entropy_loss(x, jnp.asarray(labels))[0])(
            jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        tg = torch.autograd.grad(tstep.cross_entropy_loss(x, torch.from_numpy(labels))[0], x)[0]
        assert scaled_error(np.asarray(jg), tg.numpy()) <= F32_BACKWARD_OP


def test_chip_smoke_uses_these_bounds():
    """`chip_smoke.py` holds the card's float32 prefill to the CPU's, and
    the card's decode to teacher forcing, with these numbers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.LM_F32_LOGITS == F32_LOGITS
    assert chip_smoke.LM_TEACHER_FORCING == 0.06
    assert chip_smoke.TRAIN_F32_GRAD_DEEP == F32_GRAD_DEEP
