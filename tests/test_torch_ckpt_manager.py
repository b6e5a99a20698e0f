"""The port's CheckpointManager: the reference's contract and its format.

Counterparts of tests/test_ckpt_manager.py (atomicity, checksums,
corrupt-dir fallback, keep-N, the async writer) on
`repro_torch.ckpt.manager`, plus cross-reads: a directory written by the
JAX package's manager reads back in the port's and the reverse, with the
same manifest keys and the same shard bytes.
"""

import json
import os

import numpy as np
import pytest

from repro.ckpt import manager as jman
from repro_torch.ckpt.manager import CheckpointCorruptError, CheckpointManager


def _arrays(step, seed=0):
    rng = np.random.default_rng(seed + step)
    return {
        "carry/spins": rng.integers(0, 2, (4, 10)).astype(np.int8),
        "carry/rng": rng.integers(0, 2**32, (624, 8), dtype=np.uint64).astype(np.uint32),
        "job/0/betas": rng.random(3).astype(np.float32),
    }


def _save(mgr, step, seed=0):
    arrays = _arrays(step, seed)
    mgr.save_named(step, arrays, extra={"step": step, "note": f"s{step}"})
    return arrays


def test_named_roundtrip_preserves_dtypes_and_extra(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    arrays = _save(mgr, 5)
    got, extra = mgr.restore_named(5)
    assert set(got) == set(arrays)
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    assert extra == {"step": 5, "note": "s5"}


def _bf16():
    """bfloat16 values: a dtype numpy does not treat as numeric (kind 'V'),
    which the manager stores as a uint8 view with the dtype recorded."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = np.asarray([1.5, -2.25, 3.0], np.float32).astype(ml_dtypes.bfloat16)
    assert x.dtype.kind not in "biufc"
    return x


def test_named_roundtrip_bf16_raw_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = _bf16()
    mgr.save_named(1, {"x": x})
    got, _ = mgr.restore_named(1)
    assert got["x"].dtype == x.dtype  # bf16 survives the uint8 detour
    np.testing.assert_array_equal(got["x"], x)


def _flip_byte(step_dir):
    """Corrupt the first shard in ``step_dir`` in place (manifest intact)."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    shard = os.path.join(step_dir, manifest["shards"]["0"])
    data = bytearray(open(shard, "rb").read())
    data[-1] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(data)


def test_checksum_mismatch_raises_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save(mgr, 3)
    _flip_byte(os.path.join(str(tmp_path), "step_0000000003"))
    assert mgr.latest_step() == 3  # the dir still LOOKS complete ...
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        mgr.restore_named(3)  # ... but the shard fails its sha256


def test_restore_latest_falls_back_past_corrupt_and_gcs_it(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    good = _save(mgr, 10)
    _save(mgr, 20)
    _flip_byte(os.path.join(str(tmp_path), "step_0000000020"))
    step, arrays, extra = mgr.restore_latest_named()
    assert step == 10  # newest snapshot that VERIFIES wins
    np.testing.assert_array_equal(arrays["carry/spins"], good["carry/spins"])
    assert extra["step"] == 10
    assert not os.path.exists(os.path.join(str(tmp_path), "step_0000000020"))


def test_partial_dirs_skipped_and_gced(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    _save(mgr, 1)
    missing = os.path.join(str(tmp_path), "step_0000000007")
    os.makedirs(missing)
    with open(os.path.join(missing, "manifest.json"), "w") as f:
        json.dump({"shards": {"0": "leaf_0_00000.npy"}}, f)
    garbled = os.path.join(str(tmp_path), "step_0000000008")
    os.makedirs(garbled)
    with open(os.path.join(garbled, "manifest.json"), "w") as f:
        f.write("{not json")
    assert mgr.latest_step() == 1  # crash debris never wins the scan
    assert not os.path.exists(missing)
    assert not os.path.exists(garbled)


def test_stale_tmp_staging_dirs_gced(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save(mgr, 2)
    stale = os.path.join(str(tmp_path), "step_0000000009.tmp0")
    os.makedirs(stale)
    with open(os.path.join(stale, "leaf_0_00000.npy"), "wb") as f:
        f.write(b"half-written")
    assert mgr.valid_steps() == [2]
    assert not os.path.exists(stale)  # killed writer's debris removed


def test_keep_n_gc_named(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        _save(mgr, s)
    assert mgr.valid_steps() == [2, 3]
    assert not os.path.exists(os.path.join(str(tmp_path), "step_0000000001"))


def test_async_named_save_serializes_with_next_save(tmp_path):
    """One save in flight at a time: a save issued while an async write is
    still running waits for it instead of racing it in the directory."""
    mgr = CheckpointManager(str(tmp_path), keep=0)
    big = {"x": np.ones((512, 512), np.float64)}
    mgr.save_named(1, big, blocking=False)
    mgr.save_named(2, big)  # blocking: must first join the async writer
    assert mgr.valid_steps() == [1, 2]
    got, _ = mgr.restore_named(1)
    np.testing.assert_array_equal(got["x"], big["x"])


def test_restore_latest_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest_named() == (None, None, {})


# -----------------------------------------------------------------------------
# The format is the reference's: each package reads the other's directories.
# -----------------------------------------------------------------------------


def _payload():
    arrays = _arrays(4)
    arrays["x/bf16"] = _bf16()
    return arrays, {"version": 1, "config": {"rung": "cb", "capacities": None}}


@pytest.mark.parametrize("writer,reader", [(jman, "port"), ("port", jman)],
                         ids=["jax-to-port", "port-to-jax"])
def test_cross_package_read(tmp_path, writer, reader):
    arrays, extra = _payload()
    w = (CheckpointManager if writer == "port" else writer.CheckpointManager)(str(tmp_path))
    w.save_named(4, arrays, extra=extra, blocking=False)
    w.wait()
    r = (CheckpointManager if reader == "port" else reader.CheckpointManager)(str(tmp_path))
    assert r.latest_step() == 4
    step, got, got_extra = r.restore_latest_named()
    assert step == 4 and got_extra == extra
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_both_managers_write_the_same_manifest_and_shards(tmp_path):
    arrays, extra = _payload()
    dirs = {}
    for name, cls in (("jax", jman.CheckpointManager), ("port", CheckpointManager)):
        dirs[name] = tmp_path / name
        cls(str(dirs[name])).save_named(7, arrays, extra=extra)
    man = {k: json.loads((d / "step_0000000007" / "manifest.json").read_text())
           for k, d in dirs.items()}
    assert list(man["jax"]) == list(man["port"])  # key for key, in order
    for key in man["jax"]:
        if key != "time":
            assert man["jax"][key] == man["port"][key], key
    for fname in man["jax"]["shards"].values():
        assert ((dirs["jax"] / "step_0000000007" / fname).read_bytes()
                == (dirs["port"] / "step_0000000007" / fname).read_bytes()), fname
