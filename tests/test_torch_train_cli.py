"""`launch.train` and `launch.specs` against the reference's.

The CLI on the CPU (``--smoke --device cpu``) with the reference's
initial weights (the same PRNG draw, carried across by `core.convert`)
trains the reference's losses within ``BF16_LOGITS`` step for step (the
smoke configs compute in bfloat16); it resumes from the reference CLI's
checkpoint directory, and from its own bit for bit; a preempted run writes
its emergency checkpoint and a restart ends in the uninterrupted run's
state.  The reference labels a preempted state with the final step (its
fault, repaired in the port; ROADMAP §3af).  The partition specs of
every parameter, batch and decode cache are the reference's."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.registry import get_config as jget
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import decoder as jdec, encdec as jencdec
from repro.nn.param import split_tree as jsplit
from repro.sharding import ShardingCtx as JCtx
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.examples import train_lm
from repro_torch.launch import specs, train
from repro_torch.models import decoder, encdec
from repro_torch.nn.param import STACKS, leaf_groups
from repro_torch.sharding import ShardingCtx
from test_torch_lm_trap import BF16_LOGITS, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = ["--smoke", "--steps", "6", "--seq-len", "32", "--batch", "4", "--ckpt-every", "4"]
LM_ARCHS = ["qwen2.5-14b", "deepseek-coder-33b", "gemma-2b", "command-r-35b", "internvl2-26b",
            "deepseek-v3-671b", "llama4-scout-17b-a16e", "zamba2-1.2b", "rwkv6-1.6b",
            "whisper-tiny"]


class PreemptAfter:
    """Stands in for `PreemptionHandler`: ``should_exit`` turns true at its
    ``steps``-th read (the loop reads it once a step)."""

    def __init__(self, steps: int):
        self.reads, self.steps = 0, steps

    def __call__(self):
        return self

    @property
    def should_exit(self) -> bool:
        self.reads += 1
        return self.reads >= self.steps

    def uninstall(self):
        pass


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's CLI draws the reference's initial weights (arch smoke
    config, seed 0)."""
    def init(generator, cfg, device="cuda"):
        values, _ = jsplit(jdec.init_params(jax.random.PRNGKey(0), _jcfg(cfg)))
        return convert.lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, values), cfg,
                                             device)
    monkeypatch.setattr(decoder, "init_params", init)


def _jcfg(cfg):
    for arch in LM_ARCHS:
        if get_config(arch, smoke=True) == cfg:
            return jget(arch, smoke=True)
    raise KeyError(cfg.name)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference CLI's losses over 6 steps and its checkpoint directory
    (steps 4 and 6)."""
    d = str(tmp_path_factory.mktemp("reference"))
    losses = jtrain.main(ARGS + ["--ckpt-dir", d])
    return losses, d


def _step_dir(d, step):
    return os.path.join(d, f"step_{step:010d}")


def _only_step(src, step, dst):
    shutil.copytree(_step_dir(src, step), _step_dir(dst, step))
    return dst


def _shards(d, step):
    sd = _step_dir(d, step)
    return {n: open(os.path.join(sd, n), "rb").read() for n in sorted(os.listdir(sd))
            if n != "manifest.json"}


def test_cli_losses_are_the_references(reference_run, reference_weights, tmp_path, capsys):
    want, _ = reference_run
    got = train.main(ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert scaled_error(w, g) <= BF16_LOGITS, (want, got)
    out = capsys.readouterr().out
    assert [f"{x:.4f}" for x in got] == [line.split()[3] for line in out.splitlines()
                                         if line.startswith("step ")]
    assert CheckpointManager(str(tmp_path)).valid_steps() == [4, 6]


def test_cli_resumes_from_the_reference_clis_checkpoint(reference_run, reference_weights,
                                                         tmp_path, capsys):
    want, ref_dir = reference_run
    d = _only_step(ref_dir, 4, str(tmp_path / "from_reference"))
    got = train.main(ARGS + ["--device", "cpu", "--ckpt-dir", d])
    assert "resumed from checkpoint step 4" in capsys.readouterr().out
    assert len(got) == 2
    for w, g in zip(want[4:], got):
        assert scaled_error(w, g) <= BF16_LOGITS, (want[4:], got)


def test_cli_resumes_from_its_own_checkpoint_bit_for_bit(tmp_path):
    whole = str(tmp_path / "whole")
    losses = train.main(ARGS + ["--device", "cpu", "--ckpt-dir", whole])
    d = _only_step(whole, 4, str(tmp_path / "resumed"))
    resumed = train.main(ARGS + ["--device", "cpu", "--ckpt-dir", d])
    assert resumed == losses[4:]
    assert _shards(d, 6) == _shards(whole, 6)
    assert train.main(ARGS + ["--device", "cpu", "--ckpt-dir", d]) == []  # nothing left


def test_preempted_run_resumes_to_the_uninterrupted_state(tmp_path, monkeypatch, capsys):
    """Preempted after step 2 of 4: only the emergency checkpoint (step 2)
    is written; a restart trains steps 2-3 and ends in the uninterrupted
    run's state, shard for shard."""
    args = ["--smoke", "--steps", "4", "--seq-len", "32", "--batch", "4", "--device", "cpu"]
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    losses = train.main(args + ["--ckpt-dir", whole])
    with monkeypatch.context() as mp:
        mp.setattr(train, "PreemptionHandler", PreemptAfter(2))
        first = train.main(args + ["--ckpt-dir", cut])
    assert "preemption: writing emergency checkpoint" in capsys.readouterr().out
    assert first == losses[:2] and CheckpointManager(cut).valid_steps() == [2]
    assert train.main(args + ["--ckpt-dir", cut]) == losses[2:]
    assert _shards(cut, 4) == _shards(whole, 4)


def test_the_reference_labels_a_preempted_state_with_the_final_step(tmp_path, monkeypatch):
    """The reference's fault: after the emergency checkpoint it also saves
    the preempted state as step ``--steps``, so a restart resumes from a
    step never reached (and, with no step left, fails on its empty losses)."""
    monkeypatch.setattr(jtrain, "PreemptionHandler", PreemptAfter(2))
    jtrain.main(["--smoke", "--steps", "4", "--seq-len", "32", "--batch", "4",
                 "--ckpt-dir", str(tmp_path)])
    assert CheckpointManager(str(tmp_path)).valid_steps() == [2, 4]
    assert _shards(str(tmp_path), 2) == _shards(str(tmp_path), 4)


def test_cli_flags():
    args = train.parse_args([])
    assert args.smoke is False and args.device == "cuda" and args.arch == "qwen2.5-14b"
    assert train.parse_args(["--smoke"]).smoke is True
    for flag in ("--data", "--model"):
        with pytest.raises(ValueError, match=flag):
            train.parse_args([flag, "2"])


def test_example_trains_on_the_cpu(capsys):
    losses = train_lm.main(["--device", "cpu", "--steps", "40"])
    assert len(losses) == 40 and losses[0] - losses[-1] > 0.5
    assert capsys.readouterr().out.rstrip().endswith("OK")


# ---- launch/specs ----


def _mesh(shape, axes):
    devs = np.asarray(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


def _spec_leaves(tree) -> list:
    """The specs of a cache tree (NamedTuples of spec tuples, None for none)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields") or isinstance(tree, list):
        return [leaf for child in tree for leaf in _spec_leaves(child)]
    return [P(*tree)]


MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model"))]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_specs_are_the_references(arch, mesh):
    """Every parameter's spec (the reference's stacked leaves carry a
    leading replicated "layers" axis) and every decode cache's."""
    shape, axes = mesh
    jctx, ctx = JCtx(_mesh(shape, axes)), ShardingCtx(dict(zip(axes, shape)))
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    jinit, init = (jencdec, encdec) if cfg.encdec else (jdec, decoder)
    values, logical = jsplit(jinit.init_params(jax.random.PRNGKey(0), jcfg))
    want = jspecs.param_shardings(jctx, values, logical)
    model = init.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    got = specs.param_shardings(ctx, dict(model.named_parameters()), model.logical_axes())
    for ref, names in leaf_groups(got):
        node = want
        for k in ref.split("."):
            node = node[k]
        stacked = ref.split(".")[0] in STACKS
        for n in names:
            assert (P(None, *got[n]) if stacked else P(*got[n])) == node.spec, (n, node.spec)
    assert specs.tree_size_bytes(dict(model.named_parameters())) == jspecs.tree_size_bytes(values)
    if cfg.encdec:
        return
    jc = jdec.init_decode_caches(jcfg, 2, 16)
    tc = decoder.init_decode_caches(cfg, 2, 16, device="cpu")
    want = [s.spec for s in jax.tree_util.tree_leaves(jspecs.cache_shardings(jctx, jc))]
    assert want == _spec_leaves(specs.cache_shardings(ctx, tc))


def test_batch_and_scalar_specs_are_the_references():
    jctx, ctx = JCtx(_mesh((2, 2), ("data", "model"))), ShardingCtx({"data": 2, "model": 2})
    batch = {"tokens": np.zeros((4, 8), np.int32), "frames": np.zeros((3, 5, 2), np.float32),
             "n": np.zeros((), np.int32)}
    want = jspecs.batch_shardings(jctx, {k: jnp.asarray(v) for k, v in batch.items()})
    got = specs.batch_shardings(ctx, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert {k: v.spec for k, v in want.items()} == {k: P(*v) for k, v in got.items()}
    assert P(*specs.scalar_sharding(ctx)) == jspecs.scalar_sharding(jctx).spec
    assert specs.tree_size_bytes({k: torch.from_numpy(v) for k, v in batch.items()}) == \
        jspecs.tree_size_bytes(batch)
