"""Tree checkpoints (`CheckpointManager.save` / `restore` /
`restore_latest`) against the reference's: a reference-written
TrainState (float32 and bfloat16 m, v; with error-feedback buffers)
restored by the port bit for bit, the port's shards byte-equal to the
reference's for the same state, the reference restoring the port's
steps, the leaf order equal to JAX's ``tree_flatten`` of the reference's
TrainState for every LM arch, and the reference's own tree cases
(``tests/test_train_infra.py``) across both packages."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.ckpt.manager import CheckpointManager as JManager
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.registry import get_config as jget
from repro.models import decoder as jdec, encdec as jencdec
from repro.nn.param import split_tree as jsplit
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.ckpt.manager import CheckpointCorruptError, CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.models import decoder, encdec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=128, q_chunk=16, kv_chunk=16)
TINY, JTINY = ModelConfig(**TINY_KW), JModelConfig(**TINY_KW)
LM_ARCHS = ["qwen2.5-14b", "deepseek-coder-33b", "gemma-2b", "command-r-35b", "internvl2-26b",
            "deepseek-v3-671b", "llama4-scout-17b-a16e", "zamba2-1.2b", "rwkv6-1.6b",
            "whisper-tiny"]
STATES = {"float32": {}, "bfloat16": {"state_dtype": "bfloat16"},
          "int8_ef": {"grad_compression": "int8_ef"}}


def _tcs(kind):
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10, **({"state_dtype": "bfloat16"}
                                                          if kind == "bfloat16" else {}))
    extra = {"grad_compression": "int8_ef"} if kind == "int8_ef" else {}
    return (jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**opt), **extra),
            tstep.TrainConfig(optimizer=AdamWConfig(**opt), **extra))


def _batch():
    toks = np.random.default_rng(0).integers(0, 128, (4, 16)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


@pytest.fixture(scope="module")
def reference_states():
    """kind -> the reference's TrainState of TINY after one jitted step
    (int8_ef: its buffers set from the step's own clipped gradients)."""
    out = {}
    for kind in STATES:
        jtc, _ = _tcs(kind)
        values, _ = jsplit(jdec.init_params(jax.random.PRNGKey(0), JTINY))
        tc = jtc if kind != "int8_ef" else dataclasses.replace(jtc, grad_compression="none")
        state = jstep.init_train_state(values, jtc)
        stepped, _ = jax.jit(jstep.make_train_step(JTINY, tc))(
            state._replace(ef_residual=None), {k: jnp.asarray(v) for k, v in _batch().items()})
        ef = None if state.ef_residual is None else stepped.opt.m
        out[kind] = stepped._replace(ef_residual=ef)
    return out


def _port_state(kind, seed=3):
    _, tc = _tcs(kind)
    return tstep.init_train_state(decoder.init_params(torch.Generator().manual_seed(seed), TINY,
                                                      "cpu"), tc)


def _bits(x):
    """A leaf's bytes: numpy (ml_dtypes bfloat16 too) or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes() if x.dim() else \
            x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _ref_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.mark.parametrize("kind", list(STATES))
def test_reference_written_state_restored_bit_for_bit(tmp_path, reference_states, kind):
    want = reference_states[kind]
    JManager(str(tmp_path)).save(1, want, extra={"step": 1})
    like = _port_state(kind)
    step, got, extra = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 1 and extra == {"step": 1} and got is like
    leaves = list(convert.train_state_to_arrays(got).values())
    ref = _ref_leaves(want)
    assert len(leaves) == len(ref)
    for w, g in zip(ref, leaves):
        assert tuple(w.shape) == tuple(g.shape) and str(w.dtype) == str(g.dtype).split(".")[-1]
        assert _bits(w) == _bits(g)
    assert all(p.requires_grad for p in got.params.parameters())


@pytest.mark.parametrize("kind", list(STATES))
def test_port_shards_are_the_references_byte_for_byte(tmp_path, reference_states, kind):
    """The same state (the reference's leaves written into a port state)
    saved by both managers: every shard's bytes and every manifest entry
    but the time and the treedef string are equal."""
    want = reference_states[kind]
    state = convert.train_state_from_arrays(
        dict(zip(convert.train_state_names(_port_state(kind)), _ref_leaves(want))),
        _port_state(kind))
    JManager(str(tmp_path / "ref")).save(5, want, extra={"seed": 0})
    CheckpointManager(str(tmp_path / "port")).save(5, state, extra={"seed": 0})
    dirs = [tmp_path / d / "step_0000000005" for d in ("ref", "port")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    for m in manifests:
        m.pop("time"), m.pop("treedef")
    assert manifests[0] == manifests[1]
    if kind == "bfloat16":
        assert manifests[1]["raw_dtypes"] and set(manifests[1]["raw_dtypes"].values()) == {
            "bfloat16"}
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    for name in os.listdir(dirs[0]):
        if name != "manifest.json":
            assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes(), name


@pytest.mark.parametrize("kind", list(STATES))
def test_reference_restores_the_ports_steps(tmp_path, reference_states, kind):
    _, tc = _tcs(kind)
    state = _port_state(kind)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    tc1 = dataclasses.replace(tc, grad_compression="none")
    state, _ = tstep.make_train_step(TINY, tc1)(state._replace(ef_residual=None), batch)
    if kind == "int8_ef":
        state = state._replace(ef_residual={n: m.clone() for n, m in state.opt.m.items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=False)
    mgr.wait()
    restored, _ = JManager(str(tmp_path)).restore(2, reference_states[kind])
    for w, g in zip(convert.train_state_to_arrays(state).values(), _ref_leaves(restored)):
        assert _bits(w) == _bits(g)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_state_names_are_the_references_flatten_order(arch):
    """`train_state_names` == the key paths of JAX's ``tree_flatten`` of
    the reference's TrainState, name for name, shape for shape (layers
    stacked; int8_ef adds ``ef_residual``)."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    jinit, init = (jencdec, encdec) if cfg.encdec else (jdec, decoder)
    values = jax.eval_shape(lambda: jsplit(jinit.init_params(jax.random.PRNGKey(0), jcfg))[0])
    jstate = jax.eval_shape(lambda v: jstep.init_train_state(
        v, jstep.TrainConfig(grad_compression="int8_ef")), values)
    paths = jax.tree_util.tree_flatten_with_path(jstate)[0]
    want = [".".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path)
            for path, _ in paths]
    state = tstep.init_train_state(init.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
                                   tstep.TrainConfig(grad_compression="int8_ef"))
    names = convert.train_state_names(state)
    assert names == want
    arrays = convert.train_state_to_arrays(state)
    assert list(arrays) == names
    for (_, leaf), (name, got) in zip(paths, arrays.items()):
        assert tuple(leaf.shape) == tuple(got.shape), name
    no_ef = state._replace(ef_residual=None)
    assert convert.train_state_names(no_ef) == [n for n in names if not n.startswith("ef_")]


def test_train_state_from_arrays_checks_before_writing():
    state = _port_state("float32")
    arrays = convert.train_state_to_arrays(_port_state("float32", seed=4))
    before = convert.train_state_to_arrays(state)
    bad = dict(arrays)
    bad["params.final_norm.scale"] = torch.zeros(5)
    with pytest.raises(ValueError, match="final_norm"):
        convert.train_state_from_arrays(bad, state)
    missing = dict(arrays)
    missing.pop("opt.v.embed.table")
    with pytest.raises(ValueError, match="missing"):
        convert.train_state_from_arrays(missing, state)
    for k, v in convert.train_state_to_arrays(state).items():
        assert torch.equal(v, before[k])
    convert.train_state_from_arrays(arrays, state)
    for k, v in convert.train_state_to_arrays(state).items():
        assert torch.equal(v, arrays[k])


def test_failed_restore_leaves_the_state_untouched(tmp_path):
    """A corrupt newest step: `restore_latest` falls back to the older one
    (and removes the corrupt one); with no valid step the state is not
    written at all."""
    mgr = CheckpointManager(str(tmp_path))
    older, newer = _port_state("float32", 5), _port_state("float32", 6)
    mgr.save(1, older)
    mgr.save(2, newer)
    shard = tmp_path / "step_0000000002" / "leaf_0_00007.npy"
    shard.write_bytes(shard.read_bytes()[:-4] + b"\0\0\0\0")
    like = _port_state("float32", 7)
    step, got, _ = mgr.restore_latest(like)
    assert step == 1 and mgr.valid_steps() == [1]
    for k, v in convert.train_state_to_arrays(older).items():
        assert torch.equal(convert.train_state_to_arrays(got)[k], v)
    shard = tmp_path / "step_0000000001" / "leaf_0_00003.npy"
    shard.write_bytes(shard.read_bytes()[:-4] + b"\0\0\0\0")
    like = _port_state("float32", 8)
    before = convert.train_state_to_arrays(like)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(1, like)
    assert mgr.restore_latest(like) == (None, None, {})
    for k, v in convert.train_state_to_arrays(like).items():
        assert torch.equal(v, before[k])


def test_restore_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _port_state("float32"))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, _port_state("int8_ef"))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"a": torch.zeros(3)})


def test_async_save_copies_before_returning(tmp_path):
    """The train step updates the state in place right after an async
    save: the checkpoint must hold the values at the save (§3p)."""
    mgr = CheckpointManager(str(tmp_path))
    state = _port_state("float32")
    want = convert.train_state_to_arrays(state)
    mgr.save(3, state, blocking=False)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
        state.step.add_(1)
    mgr.wait()
    got = mgr.restore(3, _port_state("float32", 9))[0]
    for k, v in convert.train_state_to_arrays(got).items():
        assert torch.equal(v, want[k]), k


# ---- the reference's tree cases, across both packages ----


def _tree_port():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "s": (torch.tensor(2.5), None, [np.arange(3, dtype=np.int32)])}


def _tree_ref():
    return {"a": jnp.arange(6).reshape(2, 3), "b": {"c": jnp.ones(4, jnp.bfloat16)},
            "s": (jnp.float32(2.5), None, [jnp.arange(3, dtype=jnp.int32)])}


def test_ckpt_roundtrip_and_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree_port()
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"step": step})
    assert mgr.latest_step() == 3
    assert not os.path.exists(os.path.join(str(tmp_path), "step_0000000001"))
    restored, extra = mgr.restore(3, tree)
    assert torch.equal(restored["a"], tree["a"]) and restored["a"].dtype == tree["a"].dtype
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert restored["s"][1] is None and isinstance(restored["s"][2], list)
    np.testing.assert_array_equal(restored["s"][2][0], tree["s"][2][0])
    assert extra["step"] == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tree_checkpoints_cross_packages(tmp_path, writer):
    """Either package's tree checkpoint, bf16 leaf included, reads back in
    the other, leaf for leaf."""
    if writer == "reference":
        JManager(str(tmp_path)).save(4, _tree_ref())
        got, _ = CheckpointManager(str(tmp_path)).restore(4, _tree_port())
        want = jax.tree_util.tree_leaves(_tree_ref())
        leaves = [got["a"], got["b"]["c"], got["s"][0], got["s"][2][0]]
    else:
        CheckpointManager(str(tmp_path)).save(4, _tree_port())
        got, _ = JManager(str(tmp_path)).restore(4, _tree_ref())
        want = [got["a"], got["b"]["c"], got["s"][0], got["s"][2][0]]
        leaves = [_tree_port()["a"], _tree_port()["b"]["c"], _tree_port()["s"][0],
                  _tree_port()["s"][2][0]]
    for w, g in zip(want, leaves):
        assert _bits(np.asarray(w)) == _bits(g)


def test_ckpt_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"x": torch.ones((128, 128))}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_ckpt_ignores_incomplete(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))  # no manifest
    assert mgr.latest_step() is None
