"""The check that decides ``correct`` fails when it should, and the harness
grows by files alone.

Runs go through everything but the look for a card (`cli.run_cell` on
the host, the configurations' ``cpu_rehearsal`` sizes): the control (the
reference in bfloat16 in the program's place) and each fault a cell can
have, planted under the timed path, must come out not correct.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pbench import cli, readers, spec as specmod, trace

HERE = Path(__file__).resolve().parent
SPEC = specmod.Spec(HERE.parent)
SEED = 2**31 + 12345


def _run(cell, tmp_path, seconds=3.0, **kw):
    return cli.run_cell(SPEC, cell, SEED, seconds, False, cpu=True, out_dir=tmp_path, grace_s=20.0,
                        **kw)


def test_sound_run_reads_zero():
    res = _run("cb-anneal-short", Path("/nonexistent"))
    assert res["correct"] is True
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("cell", ["cb-anneal-short", "cb-pt115"])
def test_the_control_fails(cell, tmp_path):
    """At this size a cold model freezes and bfloat16 rarely changes a
    decision; the anneals here run hot (beta 0.3-0.6), as the cells' hot
    jobs do at the full size, where every job differs."""
    hot = {"job": {"constant_beta": [0.3, 0.6], "ramp_share": 0.0}}
    res = _run(cell, tmp_path, control=True,
               mix_over=hot if cell != "cb-pt115" else {"job": {"rounds": 20}})
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["spin_mismatches"]["value"] > 0


def _frozen(server):
    server.engine.run = lambda carry, num_sweeps: carry


def _half_batch(server):
    from repro_torch.core.engine import SweepCarry

    eng, orig = server.engine, server.engine.run

    def run(carry, num_sweeps):
        new = orig(carry, num_sweeps)
        h = carry.spins.shape[0] // 2
        cols = h * eng.V
        return SweepCarry(*(torch.cat([a[:h], b[h:]]) for a, b in zip(new[:4], carry[:4])),
                          rng=torch.cat([new.rng[:, :cols], carry.rng[:, cols:]], dim=1))

    eng.run = run


def _altered_answer(server):
    orig = server.step

    def step():
        out = orig()
        for k, r in enumerate(out):
            spins = np.array(r.spins)
            spins.reshape(-1)[0] *= -1
            out[k] = r._replace(spins=spins)
        return out

    server.step = step


FAULTS = {"frozen step": _frozen, "half the batch left out": _half_batch,
          "an answer altered where it is produced": _altered_answer}


@pytest.mark.parametrize("cell", ["cb-anneal-short", "cb-pt115"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_fault_fails(cell, fault, tmp_path):
    res = _run(cell, tmp_path, fault=FAULTS[fault])
    assert res["correct"] is False, (fault, res["checks"])


def test_a_job_never_returned_is_missing_though_not_sampled(tmp_path):
    def lose_odd_jobs(server):
        orig = server.step
        server.step = lambda: [r for r in orig() if r.jid % 2 == 0]

    res = _run("cb-anneal-short", tmp_path, fault=lose_odd_jobs, mix_over={"check_jobs": 1})
    assert res["checked_jobs"] == 1
    assert res["correct"] is False and res["checks"]["missing"]["value"] == res["failed"] > 0


def test_a_ladder_without_its_swaps_fails(tmp_path, monkeypatch):
    from repro_torch.serve_mc import jobs

    monkeypatch.setattr(jobs.PTJob, "on_segment", lambda self, server, carry, slots: carry)
    res = _run("cb-pt115", tmp_path)
    assert res["correct"] is False
    assert res["checks"]["beta_mismatches"]["value"] > 0


def _checkout_with_new_cell(tmp_path, config_over: dict, chips: int, metrics: dict):
    """A copy of the benchmark with a configuration, a mix and the
    ``metrics`` ({name: reader source}) added as files plus entries, and
    the bytes of every file it had before; the new cell is "cb-acc-few"."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / HERE.name, ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    bench = root / HERE.name
    cfg = specmod.merged(json.loads((bench / "configs" / "ising-qmc-cb.json").read_text()),
                         dict(config_over, name="ising-qmc-cb16"))
    (bench / "configs" / "ising-qmc-cb16.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "anneal-short.json").read_text())
    mix.update(loop="closed", outstanding=3, population=64, check_jobs=8)
    (bench / "traffic" / "anneal-few.json").write_text(json.dumps(mix))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "ising-qmc-cb16", "source": "x", "reduced": [], "why": "x",
                            "file": f"{HERE.name}/configs/ising-qmc-cb16.json"})
    data["workloads"].append({"name": "cb-acc-few", "config": "ising-qmc-cb16",
                              "traffic": "anneal-few", "chips": chips, "why": "x"})
    data["end_to_end"][1]["workloads"].append("cb-acc-few")
    for name, source in metrics.items():
        (bench / "metrics" / f"{name}.py").write_text(source)
        data["per_layer"].append({"name": name, "unit": "x", "better": "higher",
                                  "source": "program_counter",
                                  "layer": "serve_mc.scheduler admission",
                                  "moves": "slot_sweeps_per_s", "workloads": ["cb-acc-few"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root, before


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix and a metric added as files plus entries
    make a cell that runs, without an edit to any file already there."""
    root, before = _checkout_with_new_cell(
        tmp_path, {"server": {"chunk_sweeps": 16}}, 1,
        {"jobs_per_s": "def read(rec):\n"
                       "    c0, c1 = rec['counters']\n"
                       "    return (c1['serve.jobs_completed'] - c0['serve.jobs_completed'])"
                       " / rec['wall_s']\n"})
    spec = specmod.Spec(root)
    for trace_on, names in ((False, {"setup_s", "slot_sweeps_per_s"}), (True, {"jobs_per_s"})):
        res = cli.run_cell(spec, "cb-acc-few", 3, 3.0, trace_on, cpu=True, out_dir=tmp_path)
        assert res["correct"] is True, res["checks"]
        assert names <= set(res["metrics"])
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_new_cell_on_four_devices_needs_only_new_files(tmp_path):
    """A configuration on a four-device slot mesh (``devices: 4``, four
    logical host devices here) and metrics reading a span and a counter
    that no metric of the benchmark reads make a cell that runs, served
    bit for bit, without an edit to any file already there."""
    root, before = _checkout_with_new_cell(
        tmp_path, {"devices": 4, "cpu_rehearsal": {"server": {"slots": 8}}}, 4,
        {"launch_share": "from pbench.readers import span_share\n\n\n"
                         "def read(rec):\n"
                         "    return span_share(rec, rec.get('spans', {}).get('sched.launch'))\n",
         "straggler_events": "from pbench.readers import delta\n\n\n"
                             "def read(rec):\n"
                             "    return delta(rec, 'serve.straggler_events')\n"})
    spec = specmod.Spec(root)
    meshes = []
    for trace_on, names in ((False, {"setup_s", "slot_sweeps_per_s"}),
                            (True, {"launch_share", "straggler_events"})):
        res = cli.run_cell(spec, "cb-acc-few", 3, 3.0, trace_on, cpu=True, out_dir=tmp_path,
                           step_hook=lambda server: meshes.append(len(server.engine.mesh)))
        assert res["correct"] is True, res["checks"]
        assert all(v["value"] == 0 for v in res["checks"].values()), res["checks"]
        assert names <= set(res["metrics"])
    assert set(meshes) == {4}
    assert 0 < res["metrics"]["launch_share"]["value"] < 100
    assert res["metrics"]["straggler_events"]["value"] >= 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_trace_parsing_attributes_kernels_by_their_launch():
    t_mark = 100.0
    base = 5_000_000.0  # trace microseconds at the mark

    def ev(name, cat, ts, dur, tid=1, **args):
        e = {"name": name, "cat": cat, "ph": "X", "ts": base + ts, "dur": dur, "tid": tid}
        if args:
            e["args"] = args
        return e

    events = [
        ev("pb.mark", "user_annotation", 0, 1),
        ev("pb.engine_run", "user_annotation", 100, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=7),
        ev("sweep_kernel", "kernel", 130, 400, tid=7, correlation=7, device=0),
        ev("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=8),  # outside the range
        ev("elementwise", "kernel", 600, 100, tid=7, correlation=8, device=0),
        ev("Memcpy HtoD", "gpu_memcpy", 800, 50, tid=7, device=0),
    ]
    got = trace.parse({"traceEvents": events}, t_mark, t_mark + 0.002)
    assert got["engine_kernel_s"] == pytest.approx(400e-6)
    assert sum(b - a for a, b in got["busy"]) == pytest.approx(550e-6)
    assert got["kernels_by_name"] == {"sweep_kernel": pytest.approx(400e-6),
                                      "elementwise": pytest.approx(100e-6)}
    rec = {"device": got, "launches": [(t_mark + 110e-6, 64)], "cards": [0],
           "shapes": {"rung": "cb", "slots": 115, "rows": 192, "sd": 6, "lanes": 128}}
    roof = specmod.load_module(HERE / "metrics" / "sweep_roofline.py", "t_roof").read(rec)
    assert roof == pytest.approx(100 * readers.bound_s(rec, {64: 1}) / 400e-6)
    idle = specmod.load_module(HERE / "metrics" / "device_idle.py", "t_idle").read(rec)
    assert idle == pytest.approx(100 * (1 - 550 / 2000))


def test_readers_return_nothing_without_a_trace():
    rec = {"counters": ({"launches_by_chunk": {}}, {"launches_by_chunk": {}}), "wall_s": 1.0,
           "shapes": {"rung": "cb", "slots": 2, "rows": 32, "sd": 5, "lanes": 4}}
    for name in ("sweep_roofline", "device_idle", "step_mfu", "swap_share"):
        assert specmod.load_module(HERE / "metrics" / f"{name}.py", f"t_{name}").read(rec) is None
