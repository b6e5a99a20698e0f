"""One train step of each dense LM arch at its smoke config, the port's
against the reference's from the same weights (`core.convert`) and batch:
in float32 the loss, the gradient norm, Adam's m and v after the step
within ``F32_GRAD`` and the parameters within ``F32_STEP`` of the update
(Adam's normalisation, ROADMAP §3aa); in the config's bfloat16 the loss
within ``BF16_LOGITS`` and the gradients (m) no farther from the
reference's float32 ones than ``BF16_GRAD_DRIFT`` times the reference's own
bfloat16 gradients are.  The other families' cases are in
`test_torch_train_archs_families.py` (a file of their own for the suite's
wall time); the reference's results are computed once a module."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jget
from repro.models import decoder as jdec, encdec as jencdec
from repro.nn import mamba2 as jmamba2
from repro.nn.param import split_tree as jsplit
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from test_torch_lm_trap import BF16_GRAD_DRIFT, BF16_LOGITS, F32_GRAD, F32_STEP, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DENSE = ["qwen2.5-14b", "deepseek-coder-33b", "gemma-2b", "command-r-35b", "internvl2-26b"]
B, S = 2, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
METRICS = ("loss", "ce_loss", "aux_loss", "grad_norm")


class _ExpOfNonPositive:
    """``jnp`` with ``exp`` of ``where(x > 0, 0, x)``: the reference's
    Mamba2 chunk scan with the port's repair of its masked exp (§3ae)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jnp.exp(jnp.where(x > 0, 0.0, x))


def repaired_ssd_chunked():
    """The reference's `_ssd_chunked`, its exps taken of non-positive
    arguments: the forward is unchanged (the masked entries are 0 either
    way) and its gradient is finite."""
    f = jmamba2._ssd_chunked
    return types.FunctionType(f.__code__, dict(f.__globals__, jnp=_ExpOfNonPositive()),
                              f.__name__, f.__defaults__, f.__closure__)


def batch_for(cfg, seed=0):
    """test_archs.py's batch: B=2, 32 positions (patches included)."""
    rng = np.random.default_rng(seed)
    batch, text = {}, S - cfg.vlm_patches
    if cfg.vlm_patches:
        batch["visual_embeds"] = rng.standard_normal((B, cfg.vlm_patches, cfg.d_model), np.float32)
    if cfg.encdec:
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model), np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)
    return batch


def reference_step(arch, dtype):
    """The reference's initial values, its TrainState leaves after one
    jitted step (as numpy float32) and its metrics."""
    jcfg = dataclasses.replace(jget(arch, smoke=True), dtype=dtype)
    init = jencdec.init_params if jcfg.encdec else jdec.init_params
    values, _ = jsplit(init(jax.random.PRNGKey(0), jcfg))
    tc = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**OPT))
    state = jstep.init_train_state(values, tc)
    batch = {k: jnp.asarray(v) for k, v in batch_for(jcfg).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmamba2, "_ssd_chunked", repaired_ssd_chunked())
        state, metrics = jax.jit(jstep.make_train_step(jcfg, tc))(state, batch)
    leaves = [np.asarray(jnp.asarray(x).astype(jnp.float32))
              for x in jax.tree_util.tree_leaves(state)]
    return (jax.tree_util.tree_map(np.asarray, values), leaves,
            {k: float(v) for k, v in metrics.items()})


def port_step(arch, dtype, values):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    tc = tstep.TrainConfig(optimizer=AdamWConfig(**OPT))
    state = tstep.init_train_state(convert.lm_params_from_arrays(values, cfg, "cpu"), tc)
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    state, metrics = tstep.make_train_step(cfg, tc)(state, batch)
    leaves = [t.float().numpy() for t in convert.train_state_to_arrays(state).values()]
    return leaves, {k: float(v) for k, v in metrics.items()}


class Results:
    """arch -> dtype -> (reference values, reference leaves, metrics), once a module."""

    def __init__(self):
        self.cache = {}

    def __call__(self, arch, dtype):
        if (arch, dtype) not in self.cache:
            self.cache[arch, dtype] = reference_step(arch, dtype)
        return self.cache[arch, dtype]


def check_float32(ref, arch):
    values, want, jm = ref(arch, "float32")
    got, m = port_step(arch, "float32", values)
    assert len(got) == len(want) and want[0] == got[0] == 1
    for k in METRICS:
        assert scaled_error(jm[k], m[k]) <= F32_GRAD, (arch, k, jm[k], m[k])
    assert jm["lr"] == m["lr"]
    n = (len(want) - 1) // 3
    p0 = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(values)]
    for i in range(n):
        update = max(np.abs(want[1 + i] - p0[i]).max(), 1e-30)
        assert np.abs(want[1 + i] - got[1 + i]).max() / update <= F32_STEP, (arch, i)
        assert scaled_error(want[1 + n + i], got[1 + n + i]) <= F32_GRAD, (arch, "m", i)
        assert scaled_error(want[1 + 2 * n + i], got[1 + 2 * n + i]) <= 2 * F32_GRAD, (arch, i)


def check_bfloat16(ref, arch):
    values, want32, _ = ref(arch, "float32")
    _, want16, jm = ref(arch, "bfloat16")
    got, m = port_step(arch, "bfloat16", values)
    assert scaled_error(jm["loss"], m["loss"]) <= BF16_LOGITS, (arch, jm["loss"], m["loss"])
    n = (len(want32) - 1) // 3
    ms = slice(1 + n, 1 + 2 * n)
    drift = max(scaled_error(a, b) for a, b in zip(want32[ms], want16[ms]))
    ours = max(scaled_error(a, b) for a, b in zip(want32[ms], got[ms]))
    assert ours <= BF16_GRAD_DRIFT * drift, (arch, ours, drift)


@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("arch", DENSE)
def test_float32_train_step_matches_the_reference(ref, arch):
    check_float32(ref, arch)


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_train_step_within_the_references_own_drift(ref, arch):
    check_bfloat16(ref, arch)
