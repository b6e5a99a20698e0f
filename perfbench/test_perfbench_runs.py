"""Whole runs of every cell on the host, at the configurations' and mixes'
``cpu_rehearsal`` sizes with the program's plain backend: the result
line's shape, the metrics each cell reports, a stall that the end-to-end
metric and the queue's tail see, and a process that never loads JAX or the JAX package."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pbench import cli, spec as specmod

HERE = Path(__file__).resolve().parent
SPEC = specmod.Spec(HERE.parent)
CELLS = [w["name"] for w in SPEC.data["workloads"]]
SEED = 2**31 + 77


def _run(cell, tmp_path, trace=False, seconds=3.0, **kw):
    return cli.run_cell(SPEC, cell, SEED, seconds, trace, cpu=True, out_dir=tmp_path,
                        grace_s=20.0, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_of_every_cell(cell, tmp_path):
    res = cli._finite(_run(cell, tmp_path))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    json.dumps(res, allow_nan=False)
    assert res["correct"] is True, res["checks"]
    assert res["checked_jobs"] > 0 and res["failed"] == 0
    want = {m["name"] for m in SPEC.metrics(SPEC.cell(cell), False)}
    assert set(res["metrics"]) == want
    assert "setup_s" in want and len(want) >= 2
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", ["cb-pt115", "cb-anneal-short"])
def test_traced_rehearsal_reads_the_host_metrics(cell, tmp_path):
    res = _run(cell, tmp_path, trace=True)
    assert res["correct"] is True
    names = {m["name"] for m in SPEC.metrics(SPEC.cell(cell), True)}
    host = {n for n in names if not n.startswith(("device_idle", "sweep_roofline", "step_mfu"))}
    assert host <= set(res["metrics"]) <= names
    assert res["breakdown"]["idle_gaps"]
    for m in res["metrics"].values():
        assert 0 < m["value"] and (m["unit"] != "%" or m["value"] <= 100)


def _stall_once(seconds, after=0.5):
    """A step hook that stalls the server once, ``after`` seconds into the window."""
    state = {"t0": None, "done": False}

    def hook(server):
        now = time.perf_counter()
        if state["t0"] is None:
            state["t0"] = now
        elif not state["done"] and now - state["t0"] > after:
            state["done"] = True
            time.sleep(seconds)
    return hook


@pytest.mark.parametrize("cell", CELLS)
def test_a_stall_in_the_window_moves_the_end_to_end_metric(cell, tmp_path):
    """A stall that runs past the window's close counts as time of the window."""
    clean = _run(cell, tmp_path)["metrics"]["slot_sweeps_per_s"]["value"]
    stalled = _run(cell, tmp_path, step_hook=_stall_once(4.0))["metrics"]["slot_sweeps_per_s"]["value"]
    assert stalled < 0.75 * clean, (clean, stalled)


def test_a_stall_in_the_window_moves_the_queue_p95():
    """The queue's tail counts every job due in the window: those a stall
    held back, and one never retired (waiting until the last return)."""
    read = SPEC.reader("job_latency_p95_s.queue").read

    def rec(stall_s, lost=False):
        jobs = {k: {"due": 0.1 * k, "done": 0.1 * k + 0.02 + (stall_s if k >= 180 else 0.0)}
                for k in range(200)}
        if lost:
            jobs[0]["done"] = None
        return {"jobs": jobs, "t1": 20.0}

    clean = read(rec(0.0))
    assert clean == pytest.approx(0.02)
    assert read(rec(1.5)) > clean + 0.3
    assert read(rec(0.0, lost=True)) == pytest.approx(0.02)  # one in 200 is under the 5% tail
    jobs = rec(0.0)["jobs"]
    for k in range(0, 200, 10):
        jobs[k]["done"] = None
    assert read({"jobs": jobs, "t1": 20.0}) > 5.0


PROBE = r"""
import sys
sys.path.insert(0, {here!r}); sys.path.insert(1, {src!r})
from pathlib import Path
from pbench import cli, spec
res = cli.run_cell(spec.Spec(), "cb-pt115", 5, 3.0, True, cpu=True, out_dir=Path({tmp!r}))
assert res["correct"], res
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}}))
print(cli.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    code = PROBE.format(here=str(HERE), src=str(HERE.parent / "src"), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=HERE.parent, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"], out.stdout


def test_no_source_of_the_benchmark_imports_jax_or_the_reference_package():
    import ast

    for path in sorted(HERE.rglob("*.py")):
        if "out" in path.relative_to(HERE).parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) and node.module and not node.level else []
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), (path, name)


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "cb-anneal-short",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=HERE.parent,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == "", (out.returncode, out.stdout, out.stderr[-2000:])
