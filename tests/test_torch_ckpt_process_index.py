"""Multi-process checkpoints (`CheckpointManager(process_index=)`) against the reference's.

* Each process's files are named for it (``leaf_<process>_<i>.npy``,
  staged under ``<step>.tmp<process>``), byte-equal to the files the
  reference's manager writes for that process index.
* Two processes committing one step: the port's directory holds both
  processes' files, and its manifest unions theirs (``"processes"``, each
  entry the reference's manifest fields for that process; the top level
  the lowest process's, which the reference's manager restores).  Each
  process's manager restores its own tree.  The reference's manager
  replaces the directory, so its last committer's files alone remain
  (held as the reference's behaviour, not repaired there).
* ``restore(..., shardings=)`` places each leaf with the current mesh's
  placements: on 2 gloo ranks each rank's DTensor block is its slice.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_gloo import run_ranks

TREES = {
    0: {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "step": np.asarray(7, np.int32),
        "h": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)},
    1: {"v": np.linspace(-1, 1, 10, dtype=np.float32), "k": np.arange(5, dtype=np.int32)},
}
FIELDS = ("num_leaves", "shards", "raw_dtypes", "checksums", "dtypes", "shapes", "extra", "step")


def _ref_tree(proc):
    import jax.numpy as jnp

    return {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) if isinstance(v, torch.Tensor)
            else jnp.asarray(v) for k, v in TREES[proc].items()}


def _like(proc):
    return {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else np.zeros_like(v))
            for k, v in TREES[proc].items()}


def _write_both(tmp_path):
    from repro.ckpt.manager import CheckpointManager as JManager
    from repro_torch.ckpt.manager import CheckpointManager

    ref = {p: JManager(str(tmp_path / f"ref{p}"), process_index=p) for p in TREES}
    port = {p: CheckpointManager(str(tmp_path / "port"), process_index=p) for p in TREES}
    for p in TREES:
        ref[p].save(5, _ref_tree(p), extra={"proc": p})
        port[p].save(5, TREES[p], extra={"proc": p})
    return ref, port


def _manifest(d):
    with open(os.path.join(d, "step_0000000005", "manifest.json")) as f:
        return json.load(f)


def test_each_process_writes_the_references_files_byte_for_byte(tmp_path):
    _write_both(tmp_path)
    port_dir = tmp_path / "port" / "step_0000000005"
    for p in TREES:
        ref_dir = tmp_path / f"ref{p}" / "step_0000000005"
        shards = sorted(n for n in os.listdir(ref_dir) if n.endswith(".npy"))
        assert shards and all(n.startswith(f"leaf_{p}_") for n in shards)
        for name in shards:
            assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name


def test_the_manifest_unions_the_references_manifests(tmp_path):
    _write_both(tmp_path)
    got = _manifest(tmp_path / "port")
    assert sorted(got["processes"], key=int) == ["0", "1"]
    for p in TREES:
        want = _manifest(tmp_path / f"ref{p}")
        entry = got["processes"][str(p)]
        for f in FIELDS:
            if f in entry:
                assert entry[f] == want[f], (p, f)
        assert {f for f in ("num_leaves", "shards", "checksums", "dtypes", "shapes")} <= set(entry)
    first = _manifest(tmp_path / "ref0")
    for f in ("num_leaves", "shards", "checksums", "dtypes", "shapes", "raw_dtypes"):
        assert got[f] == first[f], f


def test_each_process_restores_its_own_tree(tmp_path):
    _, port = _write_both(tmp_path)
    for p in TREES:
        assert port[p].valid_steps() == [5]
        assert port[p].processes(5) == [0, 1]
        tree, extra = port[p].restore(5, _like(p))
        assert extra == {"proc": p}
        for k, v in TREES[p].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(tree[k], v), k
            else:
                np.testing.assert_array_equal(tree[k], v)
    stranger = type(port[0])(str(tmp_path / "port"), process_index=3)
    with pytest.raises(Exception, match="not 3"):
        stranger.restore(5, _like(0))


def test_the_reference_restores_the_lowest_process(tmp_path):
    from repro.ckpt.manager import CheckpointManager as JManager

    _write_both(tmp_path)
    import jax.numpy as jnp

    like = {k: jnp.zeros(np.shape(v), jnp.bfloat16 if isinstance(v, torch.Tensor) else v.dtype)
            for k, v in TREES[0].items()}
    tree, extra = JManager(str(tmp_path / "port")).restore(5, like)
    assert extra == {"proc": 0}
    np.testing.assert_array_equal(np.asarray(tree["w"]), TREES[0]["w"])


def test_a_missing_process_shard_invalidates_the_step(tmp_path):
    _, port = _write_both(tmp_path)
    os.remove(tmp_path / "port" / "step_0000000005" / "leaf_1_00000.npy")
    assert port[0].valid_steps() == []


def test_the_references_last_committer_replaces_the_step(tmp_path):
    """The reference's trap: a second process's commit removes the first's
    files (its ``_write_payload`` deletes the step directory)."""
    from repro.ckpt.manager import CheckpointManager as JManager

    for p in TREES:
        JManager(str(tmp_path / "both"), process_index=p).save(5, _ref_tree(p))
    names = os.listdir(tmp_path / "both" / "step_0000000005")
    assert not any(n.startswith("leaf_0_") for n in names)
    assert any(n.startswith("leaf_1_") for n in names)


def _restore_rank(rank, n, d):
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import ShardingCtx

    ctx = ShardingCtx.over(make_host_mesh(n, 1, device="cpu"))
    mgr = CheckpointManager(d)
    shardings = {"w": ctx.sharding(("batch", None), (4, 6)), "b": None,
                 "c": ctx.sharding(("batch",), (6,))}
    tree, _ = mgr.restore(2, {"w": np.zeros((4, 6), np.float32), "b": np.zeros(3, np.float32),
                              "c": torch.zeros(6, dtype=torch.bfloat16)}, shardings=shardings)
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    assert isinstance(tree["w"], DTensor) and isinstance(tree["c"], DTensor)
    np.testing.assert_array_equal(tree["w"].to_local().numpy(), full[rank * 2:(rank + 1) * 2])
    np.testing.assert_array_equal(tree["b"], np.ones(3, np.float32))
    assert torch.equal(tree["c"].to_local(), torch.arange(6).to(torch.bfloat16)[rank * 3:
                                                                               (rank + 1) * 3])
    np.testing.assert_array_equal(tree["w"].full_tensor().numpy(), full)


def test_restore_places_each_leaf_with_the_current_mesh(tmp_path):
    from repro_torch.ckpt.manager import CheckpointManager

    d = str(tmp_path / "ckpt")
    CheckpointManager(d).save(2, {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
                                  "b": np.ones(3, np.float32),
                                  "c": torch.arange(6).to(torch.bfloat16)})
    run_ranks(_restore_rank, 2, tmp_path, d)


def test_restore_with_shardings_refuses_a_train_state(tmp_path):
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder
    from repro_torch.train import step as tstep

    cfg = get_config("gemma-2b", smoke=True)
    state = tstep.init_train_state(decoder.init_params(torch.Generator().manual_seed(0), cfg,
                                                       "cpu"), tstep.TrainConfig())
    mgr = CheckpointManager(str(tmp_path / "ts"))
    mgr.save(1, state)
    with pytest.raises(ValueError, match="TrainState"):
        mgr.restore(1, state, shardings={})
