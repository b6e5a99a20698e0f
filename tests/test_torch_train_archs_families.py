"""One train step of the recurrent families and the encoder-decoder at
their smoke configs (the Mamba2 hybrid, RWKV6, whisper), the port's
against the reference's: the cases and bounds of
`test_torch_train_archs_dense.py` (the MoE families' are in
`test_torch_train_archs_moe.py`).  The reference's Mamba2 backward is NaN
at zamba2's smoke config (ROADMAP §3ae); the port's is finite and is held
against the reference with that one exp repaired."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jget
from repro.models import decoder as jdec
from repro.nn.param import split_tree as jsplit
from repro.train import step as jstep
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.train import step as tstep
from test_torch_train_archs_dense import Results, batch_for, check_bfloat16, check_float32
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ["zamba2-1.2b", "rwkv6-1.6b", "whisper-tiny"]


@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("arch", FAMILIES)
def test_float32_train_step_matches_the_reference(ref, arch):
    check_float32(ref, arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_train_step_within_the_references_own_drift(ref, arch):
    check_bfloat16(ref, arch)


def test_the_references_mamba2_gradients_are_nan_and_the_ports_finite():
    """exp of the chunk's masked upper triangle (cs_i - cs_j > 0)
    overflows at zamba2's smoke config; ``where`` masks the forward, but
    the gradient is 0 * inf.  The reference's every gradient is NaN (its
    loss finite); the port's are finite, its loss the same."""
    jcfg = dataclasses.replace(jget("zamba2-1.2b", smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True), dtype="float32")
    values, _ = jsplit(jdec.init_params(jax.random.PRNGKey(0), jcfg))
    batch = batch_for(jcfg)
    loss_fn = jstep.make_loss_fn(jcfg, jstep.TrainConfig())
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        values, {k: jnp.asarray(v) for k, v in batch.items()})
    assert np.isfinite(float(jl))
    mamba = jg["blocks"]["mamba"]
    assert all(np.isnan(np.asarray(g)).any() for g in jax.tree_util.tree_leaves(mamba))
    assert np.isnan(np.asarray(jg["embed"]["table"])).any()
    model = convert.lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, values), cfg, "cpu")
    model.requires_grad_(True)
    loss, _ = tstep.make_loss_fn(cfg, tstep.TrainConfig())(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
