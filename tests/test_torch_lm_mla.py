"""The port's multi-head latent attention (`repro_torch.nn.mla`) against
the reference's (`repro.nn.mla`), on the reference's initial parameters
and the same numpy inputs, in float32 and bfloat16: the full-sequence
path (per-head K/V up-projected, ``v`` padded for the shared chunked
attention) and its latents, and the absorbed decode over a latent cache.
Bounds: ROADMAP §3w's ``F32_LAYER`` / ``BF16_LAYER`` on the scaled error
(`test_torch_lm_trap.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.nn import mla as jmla
from repro.nn.param import split_tree as jsplit
from repro_torch.configs.base import MLASpec
from repro_torch.nn import mla
from test_torch_lm_trap import BF16_LAYER, F32_LAYER, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DT = {"float32": (jnp.float32, torch.float32, F32_LAYER),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_LAYER)}
SPEC = MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=12)
D, H = 64, 4
KW = dict(num_heads=H, kv_lora_rank=SPEC.kv_lora_rank, qk_rope_head_dim=SPEC.qk_rope_head_dim,
          rope_theta=1e4)


def _params(seed=0):
    values, _ = jsplit(jmla.mla_init(
        jax.random.PRNGKey(seed), D, H, q_lora_rank=SPEC.q_lora_rank,
        kv_lora_rank=SPEC.kv_lora_rank, qk_nope_head_dim=SPEC.qk_nope_head_dim,
        qk_rope_head_dim=SPEC.qk_rope_head_dim, v_head_dim=SPEC.v_head_dim))
    values = jax.tree_util.tree_map(np.asarray, values)
    return (jax.tree_util.tree_map(jnp.asarray, values),
            jax.tree_util.tree_map(torch.from_numpy, values))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _close(want, got, bound, what):
    assert _np(want).shape == _np(got).shape, what
    err = scaled_error(_np(want), _np(got))
    assert err <= bound, (what, err)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("S,chunk,skip", [(16, 16, False), (32, 8, False), (32, 8, True)])
def test_mla_apply_matches_the_reference(dtype, S, chunk, skip):
    jdt, tdt, bound = DT[dtype]
    jp, tp = _params()
    x = np.random.default_rng(1).standard_normal((2, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    chunks = dict(q_chunk=chunk, kv_chunk=chunk, skip_masked_chunks=skip)
    jy, (jc, jk) = jmla.mla_apply(jp, jnp.asarray(x).astype(jdt), jnp.asarray(pos), dtype=jdt,
                                  **KW, **chunks)
    y, (c, k) = mla.mla_apply(tp, torch.from_numpy(x).to(tdt), torch.from_numpy(pos.copy()),
                              dtype=tdt, **KW, **chunks)
    _close(jy, y, bound, "y")
    _close(jc, c, bound, "c_kv")
    _close(jk, k, bound, "k_rope")


@pytest.mark.parametrize("dtype", list(DT))
def test_absorbed_decode_matches_the_reference(dtype):
    """Six absorbed decode steps over a latent cache of 12 positions from
    empty caches: the outputs and the caches equal the reference's; the
    port writes the cache in place."""
    jdt, tdt, bound = DT[dtype]
    jp, tp = _params(2)
    x = np.random.default_rng(3).standard_normal((2, 6, D)).astype(np.float32)
    jc = jmla.MLACache(jnp.zeros((2, 12, SPEC.kv_lora_rank), jdt),
                       jnp.zeros((2, 12, SPEC.qk_rope_head_dim), jdt))
    tc = mla.MLACache(torch.zeros((2, 12, SPEC.kv_lora_rank), dtype=tdt),
                      torch.zeros((2, 12, SPEC.qk_rope_head_dim), dtype=tdt))
    for t in range(6):
        xt = x[:, t:t + 1]
        jy, jc = jmla.mla_decode_apply(jp, jnp.asarray(xt).astype(jdt), jc, jnp.int32(t),
                                       dtype=jdt, **KW)
        y, tc2 = mla.mla_decode_apply(tp, torch.from_numpy(xt).to(tdt), tc, t, dtype=tdt, **KW)
        assert tc2.c_kv is tc.c_kv
        _close(jy, y, bound, f"decode {t}")
    _close(jc.c_kv, tc.c_kv, bound, "c_kv cache")
    _close(jc.k_rope, tc.k_rope, bound, "k_rope cache")


def test_absorbed_decode_equals_the_up_projected_path():
    """The absorbed decode computes the full-sequence path's last row
    (float32, within `F32_LAYER`): the point of MLA's latent cache."""
    _, tp = _params(4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, D)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    full, _ = mla.mla_apply(tp, x, pos, dtype=torch.float32, q_chunk=8, kv_chunk=8, **KW)
    cache = mla.MLACache(torch.zeros((2, 8, SPEC.kv_lora_rank)),
                         torch.zeros((2, 8, SPEC.qk_rope_head_dim)))
    for t in range(8):
        y, cache = mla.mla_decode_apply(tp, x[:, t:t + 1], cache, t, dtype=torch.float32, **KW)
        assert scaled_error(full[:, t].numpy(), y[:, 0].numpy()) <= F32_LAYER, t


def test_mla_module_names_and_axes_are_the_references():
    tree = jax.eval_shape(lambda k: jmla.mla_init(
        k, D, H, q_lora_rank=SPEC.q_lora_rank, kv_lora_rank=SPEC.kv_lora_rank,
        qk_nope_head_dim=SPEC.qk_nope_head_dim, qk_rope_head_dim=SPEC.qk_rope_head_dim,
        v_head_dim=SPEC.v_head_dim), jax.random.PRNGKey(0))
    values, axes = jsplit(tree)
    want = {".".join(p.key for p in path): a for path, a in
            jax.tree_util.tree_flatten_with_path(axes, is_leaf=lambda x: isinstance(x, tuple))[0]}
    shapes = {".".join(p.key for p in path): tuple(v.shape) for path, v in
              jax.tree_util.tree_flatten_with_path(values)[0]}
    m = mla.MLA(torch.Generator().manual_seed(0), D, H, SPEC, device="cpu")
    assert m.logical_axes() == want
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == shapes
