"""A cell on several devices: the slot mesh a configuration names, the
device readings per card, and the record that holds every span and
counter of the server.  On one card every reading is the formula the
harness had before it read cards apart; a recorded one-card trace and
record (``testdata/``) hold it to that."""

import gzip
import json
import shutil
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from pbench import cli, readers, spec as specmod, system, trace

HERE = Path(__file__).resolve().parent
SPEC = specmod.Spec(HERE.parent)
SEED = 2**31 + 2929


def _read(name, rec):
    return specmod.load_module(HERE / "metrics" / f"{name}.py", f"t_dev_{name}").read(rec)


def _checkout(tmp_path, config_over: dict, chips: int):
    """A copy of the benchmark whose configuration has ``config_over`` laid
    on it and whose cells ask for ``chips``."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / HERE.name, ignore=shutil.ignore_patterns("out", "__pycache__"))
    data = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in data["workloads"]:
        w["chips"] = chips
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    path = root / data["configs"][0]["file"]
    path.write_text(json.dumps(specmod.merged(json.loads(path.read_text()), config_over)))
    return specmod.Spec(root)


# -- the slot mesh from the configuration ------------------------------------------


@pytest.mark.parametrize("cell", ["cb-anneal-short", "cb-pt115"])
def test_four_device_rehearsal_serves_the_reference_bit_for_bit(cell, tmp_path):
    """Four logical host devices with an uneven split: every checked answer
    equals the reference's exactly (a ladder spans the devices)."""
    spec = _checkout(tmp_path, {"devices": 4, "server": {"capacities": [29, 28, 29, 29]},
                                "cpu_rehearsal": {"server": {"slots": 8,
                                                             "capacities": [3, 1, 2, 2]}}}, 4)
    seen = []
    res = cli.run_cell(spec, cell, SEED, 3.0, False, cpu=True, out_dir=tmp_path, grace_s=20.0,
                       step_hook=lambda s: seen.append((len(s.engine.mesh), s.engine.capacities)))
    assert set(seen) == {(4, (3, 1, 2, 2))}
    assert res["correct"] is True and res["checked_jobs"] > 0
    assert all(v["value"] == 0 for v in res["checks"].values()), res["checks"]
    assert res["device"]["count"] == 1  # four logical devices of one host


def test_without_devices_the_server_is_built_as_before():
    cfg = specmod.merged(SPEC.config("ising-qmc-cb"), SPEC.config("ising-qmc-cb")["cpu_rehearsal"])
    ref = SPEC.reference(cfg)
    server = system.build_server(cfg, ref.make_model(cfg, 1), backend="torch", device="cpu")
    assert server.engine.mesh is None and server.config.capacities is None
    assert system.devices(server) == [torch.device("cpu")]


def test_the_slot_mesh_a_configuration_names():
    assert system.slot_mesh(4, "cpu").devices == (torch.device("cpu"),) * 4
    assert system.slot_mesh(["cuda:0"] * 4, "cpu").devices == (torch.device("cpu"),) * 4
    assert system.slot_mesh(["cuda:0"] * 4, "cuda").devices == (torch.device("cuda", 0),) * 4
    assert system.slot_mesh(["cuda:0", "cuda:1"], "cuda").devices == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    assert [system.cuda_cards(d) for d in (None, 4, ["cuda:0"] * 4, ["cuda", "cuda:0"],
                                           ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])] == \
        [1, 4, 1, 1, 4]


@pytest.mark.parametrize("devices,chips,refused", [
    (None, 4, True), (4, 1, True), (["cuda:0"] * 4, 4, True), (4, 4, False),
    (["cuda:0"] * 4, 1, False), (None, 1, False)])
def test_a_cell_whose_chips_disagree_with_its_devices_is_refused(devices, chips, refused,
                                                                 tmp_path):
    spec = _checkout(tmp_path, {} if devices is None else {"devices": devices}, chips)
    if refused:
        with pytest.raises(ValueError, match="chip"):
            spec.cell("cb-pt115")
    else:
        assert spec.cell("cb-pt115")["chips"] == chips


# -- every span and counter in the record ------------------------------------------


def test_the_record_holds_every_counter_and_span():
    from repro_torch.obs import Telemetry

    cfg = specmod.merged(SPEC.config("ising-qmc-cb"), SPEC.config("ising-qmc-cb")["cpu_rehearsal"])
    ref = SPEC.reference(cfg)
    server = system.build_server(cfg, ref.make_model(cfg, 1), backend="torch", device="cpu",
                                 telemetry=Telemetry(enabled=True))
    server.submit(system.make_job({"kind": "anneal", "seed": 5, "schedule": [[3, 0.5], [2, 1.0]],
                                   "user": "u", "priority": 0}))
    server.drain()
    tel = server.telemetry
    got = system.counters(server)
    for name in ("serve.launches", "serve.sweeps_elapsed", "serve.busy_slot_sweeps",
                 "serve.jobs_completed", "serve.straggler_events", "serve.slots_spliced",
                 "serve.launch_device_s", "serve.launches_timed", "pt.swap_fused",
                 "sched.placements_affine"):
        assert got[name] == tel.value(name), name
    chunks = {int(lab["chunk"]): v for lab, v in tel.series("serve.launches_by_chunk")}
    assert got["launches_by_chunk"] == chunks and len(chunks) == 2
    assert all(got[f"serve.launches_by_chunk{{chunk={k}}}"] == v for k, v in chunks.items())
    spans = cli._spans(tel)
    for name in ("sched.step", "sched.admit", "sched.admit.plan", "sched.admit.init",
                 "sched.admit.splice", "sched.launch", "sched.segment", "sched.retire",
                 "sched.wait"):
        assert spans[name] and all(a <= b for a, b in spans[name]), name
    assert len(spans["sched.retire"]) == 1 and len(spans["sched.launch"]) == 2


def test_a_counter_first_counted_in_the_window_grows_from_zero():
    rec = {"counters": ({"a": 2}, {"a": 5, "b{chunk=8}": 3})}
    assert readers.delta(rec, "a") == 3 and readers.delta(rec, "b{chunk=8}") == 3
    # A labelled series never counted (a chunk that never ran) reads 0.
    assert readers.delta(rec, "b{chunk=3}") == 0


def test_the_two_new_span_shares_read_their_spans():
    rec = {"t0": 10.0, "t1": 12.0, "wall_s": 2.0, "events_dropped": 0,
           "spans": {"sched.admit.init": [(9.5, 10.5), (10.2, 10.7), (11.0, 11.1)],
                     "sched.retire": [(11.5, 12.5)]}}
    assert _read("admit_init_share", rec) == pytest.approx(100 * 0.8 / 2.0)
    assert _read("retire_share", rec) == pytest.approx(100 * 0.5 / 2.0)
    assert _read("admit_init_share", dict(rec, events_dropped=3)) is None
    assert _read("retire_share", dict(rec, spans={})) is None


# -- the device readings per card --------------------------------------------------


def _before_device_idle(rec):
    """The harness's ``device_idle`` before it read cards apart."""
    dev = rec.get("device")
    if not dev or not dev.get("busy"):
        return None
    busy = sum(b - a for a, b in dev["busy"])
    return 100.0 * (1.0 - busy / (dev["t1"] - dev["t0"]))


def _before_step_mfu(rec):
    bound = readers.bound_s(rec, readers.launch_chunks(rec))
    return None if not bound else 100.0 * bound / rec["wall_s"]


@pytest.mark.parametrize("cell", ["cb-anneal-short", "cb-pt115"])
def test_a_one_card_record_reads_as_before(cell):
    """A traced run of the cell on one H100 (a slice of its profiler window
    and its record): device_idle, busy_s and step_mfu are exactly the
    one-card formulas, and the card's busy intervals are the union's."""
    fix = json.loads(gzip.decompress((HERE / "testdata" / f"one_card_{cell}.json.gz").read_bytes()))
    dev = trace.parse(fix["trace"], fix["t_mark"], fix["t_stop"])
    rec = dict(fix["record"], device=dev)
    rec["counters"] = tuple(rec["counters"])
    for c in rec["counters"]:
        c["launches_by_chunk"] = {int(k): v for k, v in c["launches_by_chunk"].items()}
    assert rec["cards"] == [0] and list(dev["busy_by_device"]) == [0]
    assert dev["busy_by_device"][0] == dev["busy"] and len(dev["busy"]) > 100
    assert _read("device_idle", rec) == _before_device_idle(rec)
    assert 0 < _read("device_idle", rec) < 100
    assert statistics.fmean(readers.busy_by_card(rec)) == sum(b - a for a, b in dev["busy"])
    assert _read("step_mfu", rec) == _before_step_mfu(rec) > 0


def test_a_two_card_trace_reads_each_card_and_their_mean():
    t_mark, base = 50.0, 1_000_000.0

    def ev(name, cat, ts, dur, pid=0, **args):
        return {"name": name, "cat": cat, "ph": "X", "ts": base + ts, "dur": dur, "pid": pid,
                "tid": 7, "args": args}

    events = [ev("pb.mark", "user_annotation", 0, 1, pid=4242),
              ev("k", "kernel", 100, 300, device=0), ev("k", "kernel", 200, 300, device=0),
              ev("k", "kernel", 100, 100, device=1), ev("Memcpy", "gpu_memcpy", 900, 100, pid=1),
              ev("k", "kernel", 1900, 400, device=1)]  # past the window's end
    dev = trace.parse({"traceEvents": events}, t_mark, t_mark + 0.002)
    assert dev["busy_by_device"][0] == [pytest.approx((t_mark + 100e-6, t_mark + 500e-6))]
    assert sum(b - a for a, b in dev["busy_by_device"][1]) == pytest.approx(300e-6)
    rec = {"device": dev, "cards": [0, 1]}
    assert readers.busy_by_card(rec) == pytest.approx([400e-6, 300e-6])
    idle = [100 * (1 - 400 / 2000), 100 * (1 - 300 / 2000)]
    assert _read("device_idle", rec) == pytest.approx(sum(idle) / 2)
    # A card of the cell that did nothing is idle throughout.
    assert _read("device_idle", dict(rec, cards=[0, 1, 2])) == pytest.approx((sum(idle) + 100) / 3)
    # The union over both cards, which the breakdown's idle gaps read, is kept.
    assert sum(b - a for a, b in dev["busy"]) == pytest.approx(600e-6)
    # A trace that names a card by another id than the engine's fails the
    # run rather than read that card's time as idle.
    for stray in ([0], [0, 3], ["cpu", 1]):
        with pytest.raises(ValueError, match="outside the engine's cards"):
            readers.busy_by_card(dict(rec, cards=stray))
        with pytest.raises(ValueError, match="outside the engine's cards"):
            _read("device_idle", dict(rec, cards=stray))


def test_step_mfu_is_a_share_of_every_card_of_the_cell():
    counters = ({"launches_by_chunk": {}}, {"launches_by_chunk": {64: 100}})
    rec = {"counters": counters, "wall_s": 2.0,
           "shapes": {"rung": "cb", "slots": 460, "rows": 192, "sd": 6, "lanes": 128}}
    one = _read("step_mfu", dict(rec, cards=[0]))
    assert one == _before_step_mfu(rec) > 0
    assert _read("step_mfu", dict(rec, cards=[0, 1, 2, 3])) == pytest.approx(one / 4)


def _fake_cuda(monkeypatch, peaks: dict):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d=None: peaks[torch.device(d)])
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(torch.device(d)))
    return synced


def _server(mesh):
    from repro_torch.launch.mesh import SlotMesh

    mesh = None if mesh is None else SlotMesh(mesh)
    return SimpleNamespace(engine=SimpleNamespace(mesh=mesh, device=torch.device("cuda", 0)
                                                  if mesh is None else mesh[0]))


def test_one_card_count_and_memory_peak_read_as_before(monkeypatch):
    cuda0 = torch.device("cuda", 0)
    synced = _fake_cuda(monkeypatch, {cuda0: 214_100_000})
    server = _server(None)
    devs = system.devices(server)
    before = {"platform": "gpu", "kind": torch.cuda.get_device_name(server.engine.device),
              "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(server.engine.device))}
    assert cli._device(devs) == before
    assert system.devices(_server(["cuda:0"] * 4)) == [cuda0]  # four logical devices, one card
    cli._synchronize(devs)
    assert synced == [cuda0]


def test_four_cards_count_each_and_take_the_fullest(monkeypatch):
    cards = [torch.device("cuda", k) for k in range(4)]
    synced = _fake_cuda(monkeypatch, dict(zip(cards, (5, 9, 7, 3))))
    devs = system.devices(_server([f"cuda:{k}" for k in range(4)]))
    assert devs == cards
    assert cli._device(devs)["count"] == 4 and cli._device(devs)["memory_peak_bytes"] == 9
    cli._synchronize(devs)
    assert synced == cards
