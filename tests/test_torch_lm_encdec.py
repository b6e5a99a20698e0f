"""The port's encoder-decoder (`repro_torch.models.encdec`) against the
reference's (`repro.models.encdec`) at whisper-tiny's smoke size, the
reference's initial weights carried across by
`core.convert.lm_params_from_arrays`: ``encode``, ``apply``,
``init_decode_caches`` (the encoder once, every layer's cross K/V) and
``decode_step``, in float32 and bfloat16, within ROADMAP §3w's
``F32_LOGITS`` / ``BF16_LOGITS`` on the scaled error
(`test_torch_lm_trap.py`); decode against teacher forcing under the
reference's bound of 0.06; names, axes and the conversion round trip."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jget
from repro.models import encdec as jed
from repro.nn.param import split_tree as jsplit
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.models import encdec
from test_torch_lm_trap import BF16_LOGITS, F32_LOGITS, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "whisper-tiny"
BOUND = {"float32": F32_LOGITS, "bfloat16": BF16_LOGITS}
TEACHER_FORCING = 0.06


def _models(dtype, seed=0):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    values, _ = jsplit(jed.init_params(jax.random.PRNGKey(seed), jcfg))
    values = jax.tree_util.tree_map(np.asarray, values)
    return jcfg, cfg, values, convert.lm_params_from_arrays(values, cfg, "cpu")


def _inputs(cfg, S=12, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32),
            rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _check(want, got, dtype, what):
    assert _np(want).shape == _np(got).shape, what
    err = scaled_error(_np(want), _np(got))
    assert err <= BOUND[dtype], (what, dtype, err)


@pytest.mark.parametrize("dtype", list(BOUND))
def test_encode_apply_and_decode_match_the_reference(dtype):
    jcfg, cfg, values, model = _models(dtype)
    toks, frames = _inputs(cfg)
    jv = jax.tree_util.tree_map(jnp.asarray, values)
    with torch.no_grad():
        _check(jed.encode(jv, jnp.asarray(frames), jcfg),
               encdec.encode(model, torch.from_numpy(frames), cfg), dtype, "encode")
        jl, jaux = jed.apply(jv, jnp.asarray(toks), jnp.asarray(frames), jcfg)
        tl, taux = encdec.apply(model, torch.from_numpy(toks), torch.from_numpy(frames), cfg)
        assert tl.shape == (2, 12, cfg.padded_vocab) and float(taux) == float(jaux) == 0.0
        _check(jl, tl, dtype, "apply")
        jc = jed.init_decode_caches(jv, jnp.asarray(frames), jcfg, 16)
        tc = encdec.init_decode_caches(model, torch.from_numpy(frames), cfg, 16)
        assert tc.cross_k.shape == jc.cross_k.shape and tc.self_kv.k.shape == jc.self_kv.k.shape
        _check(jc.cross_k, tc.cross_k, dtype, "cross k")
        _check(jc.cross_v, tc.cross_v, dtype, "cross v")
        for t in range(6):
            step = toks[:, t:t + 1]
            jd, jc = jed.decode_step(jv, jnp.asarray(step), jc, jnp.int32(t), jcfg)
            td, tc2 = encdec.decode_step(model, torch.from_numpy(step), tc, t, cfg)
            assert tc2.self_kv.k is tc.self_kv.k  # written in place
            _check(jd, td, dtype, f"decode {t}")
        _check(jc.self_kv.k, tc.self_kv.k, dtype, "self k cache")


@pytest.mark.parametrize("dtype", list(BOUND))
def test_decode_matches_teacher_forcing(dtype):
    _, cfg, _, model = _models(dtype, seed=2)
    toks, frames = map(torch.from_numpy, _inputs(cfg, S=16, seed=3))
    with torch.no_grad():
        lg_tf, _ = encdec.apply(model, toks, frames, cfg)
        caches = encdec.init_decode_caches(model, frames, cfg, 16)
        for t in range(16):
            lg, caches = encdec.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
            assert scaled_error(_np(lg_tf[:, t]), _np(lg[:, 0])) < TEACHER_FORCING, t


def test_positions_past_the_table_clamp_as_the_references():
    """``decode_step`` reads its position from a ``max_target_length``
    table; past its end the reference's dynamic slice clamps to the last
    row, and so does the port."""
    jcfg, cfg, values, model = _models("float32")
    toks, frames = _inputs(cfg)
    jv = jax.tree_util.tree_map(jnp.asarray, values)
    n = cfg.max_target_length + 3
    jc = jed.init_decode_caches(jv, jnp.asarray(frames), jcfg, n + 1)
    tc = encdec.init_decode_caches(model, torch.from_numpy(frames), cfg, n + 1)
    with torch.no_grad():
        jd, _ = jed.decode_step(jv, jnp.asarray(toks[:, :1]), jc, jnp.int32(n), jcfg)
        td, _ = encdec.decode_step(model, torch.from_numpy(toks[:, :1]), tc, n, cfg)
    _check(jd, td, "float32", "clamped position")


def test_names_axes_and_the_conversion_round_trip():
    jcfg, cfg, values, model = _models("bfloat16")
    tree = jax.eval_shape(lambda k: jed.init_params(k, jcfg), jax.random.PRNGKey(0))
    jv, jl = jsplit(tree)
    want_axes, want_shapes = {}, {}
    for (path, axes), (_, v) in zip(
            jax.tree_util.tree_flatten_with_path(jl, is_leaf=lambda x: isinstance(x, tuple))[0],
            jax.tree_util.tree_flatten_with_path(jv)[0]):
        name = ".".join(p.key for p in path)
        stack, _, rest = name.partition(".")
        if stack in ("enc_blocks", "dec_blocks"):
            assert axes[0] == "layers"
            for layer in range(v.shape[0]):
                want_axes[f"{stack}.{layer}.{rest}"] = axes[1:]
                want_shapes[f"{stack}.{layer}.{rest}"] = tuple(v.shape[1:])
        else:
            want_axes[name], want_shapes[name] = axes, tuple(v.shape)
    assert model.logical_axes() == want_axes
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want_shapes
    back = convert.lm_params_to_arrays(model)
    flat_got = dict((jax.tree_util.keystr(p), v) for p, v in
                    jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(values)[0]
    assert len(flat_want) == len(flat_got)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[jax.tree_util.keystr(path)], v)


def test_held_weights_change_no_logit():
    _, cfg, _, model = _models("bfloat16")
    toks, frames = map(torch.from_numpy, _inputs(cfg))
    with torch.no_grad():
        want, _ = encdec.apply(model, toks, frames, cfg)
        model.hold_compute_dtype()
        got, _ = encdec.apply(model, toks, frames, cfg)
    assert torch.equal(want, got) and model.enc_norm.scale.dtype == torch.float32


def test_refuses_another_config():
    _, cfg, _, model = _models("float32")
    toks, frames = map(torch.from_numpy, _inputs(cfg))
    with pytest.raises(ValueError, match="other settings"):
        encdec.apply(model, toks, frames, dataclasses.replace(cfg, d_ff=64))
