"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's.

The reference's dry run forces 512 host devices (``XLA_FLAGS``) before JAX
starts; the port's makes its process rank 0 of a 256- or 512-rank fake
world.  Neither belongs in a test process, so each side runs in ONE child
(this file run as a script, ``ref`` or ``port``), which builds every cell
and writes what it found to a JSON file:

* gemma-2b x {train_4k, prefill_32k, decode_32k} on 16x16, and train_4k
  on 2x16x16 (int8_ef): meta, and per argument leaf the path, global
  shape, dtype and partition spec, are the reference's ``build_cell``'s
  (the port's per-layer parameters against the reference's stacked
  leaves, whose layer axis is replicated); the port's ``argument_bytes``
  (rank 0's local shard bytes) equals the sum of the reference's
  ``NamedSharding.shard_shape`` bytes;
* the long_500k skip rows are the reference's, reason included;
* qwen2.5-14b decode_32k runs through the port's CLI (``--device cpu``):
  ok, mesh 16x16, collectives > 0 and temp bytes > 0, the reference's own
  test's check (``tests/test_dryrun_integration.py``), which its own dry
  run fails on this JAX;
* that failure is held as the reference's trap: its row is an error
  naming Explicit-axis meshes ("only refer to Auto axes").  A JAX that
  lowers the cell flips this test;
* train cells run with each backward on a new thread, as autograd runs it
  on the card's device thread (ROADMAP §3al).
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest

from torch_gloo import Child

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

CELLS = [("gemma-2b", "train_4k", False), ("gemma-2b", "prefill_32k", False),
         ("gemma-2b", "decode_32k", False), ("gemma-2b", "train_4k", True)]
SKIPS = [("qwen2.5-14b", "long_500k"), ("gemma-2b", "long_500k"),
         ("deepseek-v3-671b", "long_500k")]
META = ("arch", "shape", "kind", "mesh", "multi_pod", "params", "active_params", "seq_len",
        "global_batch", "grad_accum")


def _key(cell):
    return "/".join(map(str, cell))


def _spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _ref_side():
    import jax
    from jax.sharding import NamedSharding

    from repro.launch import dryrun as J  # forces its 512 host devices first

    assert len(jax.devices()) == 512
    groups = {"prefill": ("params", "batch"), "decode": ("params", "token", "caches", "cur_len")}
    out = {"cells": {}, "skips": {}}
    for cell in CELLS:
        fn, args, shardings, donate, meta, ctx = J.build_cell(*cell)
        names = groups.get(meta["kind"])
        flat = jax.tree_util.tree_flatten_with_path(args)[0]
        shards = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(flat) == len(shards)
        leaves, nbytes = {}, 0
        for (path, leaf), sh in zip(flat, shards):
            parts = [getattr(p, "name", getattr(p, "key", getattr(p, "idx", None))) for p in path]
            if meta["kind"] == "train":  # (TrainState, batch)
                head = ["batch"] if parts[0] == 1 else [str(p) for p in parts[1:3]
                                                          if p in ("params", "opt", "m", "v",
                                                                   "ef_residual", "step")]
                rest = parts[1:] if parts[0] == 1 else parts[2 + (parts[1] == "opt"):]
            else:
                head, rest = [names[parts[0]]], parts[1:]
            name = ".".join(head + [str(p) for p in rest])
            leaves[name] = {"shape": list(leaf.shape), "dtype": str(leaf.dtype),
                            "spec": _spec(tuple(sh.spec) + (None,) * (len(leaf.shape)
                                                                      - len(sh.spec)))}
            nbytes += int(np.prod(sh.shard_shape(leaf.shape))) * np.dtype(leaf.dtype).itemsize
        out["cells"][_key(cell)] = {"meta": meta, "leaves": leaves, "argument_bytes": nbytes}
    for arch, shape in SKIPS:
        out["skips"][f"{arch}/{shape}"] = J.run_cell(arch, shape, False, analyze=False)
    try:
        out["qwen_decode"] = J.run_cell("qwen2.5-14b", "decode_32k", False, analyze=False)
    except Exception as e:  # noqa: BLE001 - the reference's main() reports it so
        out["qwen_decode"] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
    return out


def _port_side():
    from repro_torch.launch import dryrun as D
    from repro_torch.nn.param import STACKS, leaf_groups

    out = {"cells": {}, "skips": {}}
    for cell in CELLS:
        D.init_fake_world(cell[2])
        c = D.build_cell(*cell, device="cpu")
        by_path = {l["path"]: l for l in c.leaves}
        leaves = {}
        for group in ("params", "opt.m", "opt.v", "ef_residual"):
            names = [p[len(group) + 1:] for p in by_path if p.startswith(group + ".")]
            for ref, members in leaf_groups(names):
                recs = [by_path[f"{group}.{n}"] for n in members]
                first = recs[0]
                assert all(r == first | {"path": r["path"]} for r in recs), ref
                stacked = ref.split(".")[0] in STACKS
                leaves[f"{group}.{ref}"] = {
                    "shape": ([len(recs)] if stacked else []) + first["shape"],
                    "dtype": first["dtype"],
                    "spec": ([None] if stacked else []) + _spec(first["spec"])}
        for p, r in by_path.items():
            if not p.startswith(("params.", "opt.", "ef_residual.")):
                leaves[p] = {"shape": r["shape"], "dtype": r["dtype"], "spec": _spec(r["spec"])}
        out["cells"][_key(cell)] = {"meta": c.meta, "leaves": leaves,
                                    "argument_bytes": D.local_bytes(c.args)}
    for arch, shape in SKIPS:
        out["skips"][f"{arch}/{shape}"] = D.run_cell(arch, shape, False, analyze=False,
                                                     device="cpu")
    return out


#: The qwen2.5-14b decode_32k cell through the port's CLI.
QWEN_CLI = ["-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch", "qwen2.5-14b",
            "--shape", "decode_32k", "--no-analyze"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child of this file, run at once: ``{"ref", "port", "thread":
    the JSON each wrote, "qwen": the CLI's standard output}``; a child that
    failed is its AssertionError, raised by `_got` in the tests that read it."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _SRC, "OMP_NUM_THREADS": "1"}
    argv = {side: [sys.executable, __file__, side, str(tmp / f"{side}.json")]
            for side in ("ref", "port", "thread")}
    argv["qwen"] = [sys.executable] + QWEN_CLI
    out = {}
    with contextlib.ExitStack() as stack:
        children = {k: stack.enter_context(Child(a, env)) for k, a in argv.items()}
        for k, child in children.items():
            try:
                stdout = child.wait()
            except AssertionError as e:
                out[k] = e
                continue
            if k == "qwen":
                out[k] = stdout
            else:
                with open(tmp / f"{k}.json") as f:
                    out[k] = json.load(f)
    return out


def _got(runs, key):
    if isinstance(runs[key], AssertionError):
        raise runs[key]
    return runs[key]


@pytest.fixture(scope="module")
def ref(runs):
    return _got(runs, "ref")


@pytest.fixture(scope="module")
def port(runs):
    return _got(runs, "port")


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_meta_is_the_references(cell, ref, port):
    want, got = ref["cells"][_key(cell)]["meta"], port["cells"][_key(cell)]["meta"]
    assert {k: got.get(k) for k in META} == {k: want.get(k) for k in META}


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_every_leaf_is_the_references(cell, ref, port):
    want, got = ref["cells"][_key(cell)]["leaves"], port["cells"][_key(cell)]["leaves"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_argument_bytes_are_the_references_shard_bytes(cell, ref, port):
    assert port["cells"][_key(cell)]["argument_bytes"] == ref["cells"][_key(cell)][
        "argument_bytes"]


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in SKIPS])
def test_skip_rows_are_the_references(cell, ref, port):
    assert port["skips"][cell] == ref["skips"][cell]
    assert port["skips"][cell]["status"] == "skipped"
    assert "sub-quadratic" in port["skips"][cell]["reason"]


def test_the_references_dry_run_fails_on_explicit_axes(ref):
    """The reference's trap (ROADMAP §3): ``jax.make_mesh`` makes Explicit
    axes on this JAX, and its ``with_sharding_constraint`` refuses them."""
    row = ref["qwen_decode"]
    assert row["status"] == "error", row
    assert "only refer to Auto axes" in row["error"]


def test_qwen_decode_cell_runs_through_the_cli(runs):
    row = json.loads([l for l in _got(runs, "qwen").splitlines() if l.startswith("{")][-1])
    assert row["status"] == "ok", row
    assert row["mesh"] == {"data": 16, "model": 16}
    assert row["memory"]["temp_bytes"] > 0
    assert row["memory"]["argument_bytes"] > 0 and row["memory"]["code_bytes"] == 0
    assert sum(row["collectives"]["counts"].values()) > 0
    assert row["xla_cost"]["flops_body_once"] > 0


#: A train cell run with its backward on another thread, as on the card
#: (whisper: remat's recompute nests the mesh context in the encoder).
THREAD_CELLS = [("whisper-tiny", "train_4k")]


def _thread_side():
    """On the card autograd runs the backward on its device thread, which
    sees neither the caller's sharding context nor its implicit
    replication; here each `torch.autograd.grad` runs on a new thread."""
    import threading

    import torch

    from repro_torch.launch import dryrun as D

    grad = torch.autograd.grad

    def on_a_thread(*args, **kwargs):
        out = []
        t = threading.Thread(target=lambda: out.append(_result(grad, args, kwargs)))
        t.start()
        t.join()
        if isinstance(out[0], BaseException):
            raise out[0]
        return out[0]

    torch.autograd.grad = on_a_thread
    return {f"{a}/{s}": D.run_cell(a, s, False, analyze=False, device="cpu")["status"]
            for a, s in THREAD_CELLS}


def _result(fn, args, kwargs):
    try:
        return fn(*args, **kwargs)
    except BaseException as e:  # noqa: BLE001 - raised again by the caller's thread
        return e


def test_train_cells_with_the_backward_on_another_thread(runs):
    got = _got(runs, "thread")
    assert got == {f"{a}/{s}": "ok" for a, s in THREAD_CELLS}


def test_analyze_names_the_unported_analyzer():
    from repro_torch.launch import dryrun as D

    with pytest.raises(ValueError, match="hlo_analysis"):
        D.run_cell("gemma-2b", "train_4k", False, analyze=True, device="cpu")


if __name__ == "__main__":
    side, path = sys.argv[1], sys.argv[2]
    result = {"ref": _ref_side, "port": _port_side, "thread": _thread_side}[side]()
    with open(path, "w") as f:
        json.dump(result, f)
