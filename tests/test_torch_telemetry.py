"""The port's telemetry inside the server: the spans of admission's parts,
the launch, the wait, the segment hooks, the swap phase and retirement;
the counters of spliced slots, retirement passes and retired slots and
timed launches; the tuple ring; the
spans mirrored into a recording `torch.profiler`; launches timed on the
card by CUDA events with no `torch.cuda.synchronize` in `step` (the one
test marked ``cuda``, which skips without a card).
"""

import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ising
from repro_torch.obs import Telemetry, validate_events
from repro_torch.obs import telemetry as telemetry_mod
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

MODEL = ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)

#: Every span a step can emit, and its parent.
PARENT = {
    "sched.admit": "sched.step",
    "sched.admit.plan": "sched.admit",
    "sched.admit.park": "sched.admit",
    "sched.admit.init": "sched.admit",
    "sched.admit.splice": "sched.admit",
    "sched.launch": "sched.step",
    "sched.wait": "sched.step",
    "sched.segment": "sched.step",
    "pt.swap": "sched.segment",
    "sched.retire": "sched.step",
}


def _server(rung="cb", **kw):
    kw = {"slots": 4, "chunk_sweeps": 4, "policy": "backfill", **kw}
    return SampleServer(MODEL, backend="torch", device="cpu", V=4, rung=rung, **kw)


def _serve(srv):
    """Anneal jobs and a ladder, then an urgent job that preempts one of
    them (a park and a resume), drained."""
    for seed, budget in [(10, 9), (11, 7)]:
        srv.submit(AnnealJob.constant(seed=seed, sweeps=budget, beta=1.0))
    srv.submit(PTJob(seed=9, betas=np.linspace(0.5, 1.5, 2), num_rounds=3, sweeps_per_round=4))
    out = srv.step()
    srv.submit(AnnealJob.constant(seed=12, sweeps=6, beta=1.2, priority=1))
    return {r.jid: r for r in out + srv.drain()}


def _parents(events):
    """(name, parent) of every sync span, from the B/E stream of tid 0."""
    stack, out = [], []
    for e in events:
        if e["tid"] != 0:
            continue
        if e["ph"] == "B":
            out.append((e["name"], stack[-1] if stack else None))
            stack.append(e["name"])
        elif e["ph"] == "E":
            assert stack.pop() == e["name"]
    return out


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_traced_drain_emits_every_span_nested_under_the_step(rung):
    srv = _server(rung)
    results = _serve(srv)
    assert len(results) == 4 and srv.preemptions == 1
    events = srv.telemetry.chrome_trace()["traceEvents"]
    validate_events(events)
    seen = _parents(events)
    assert {n for n, _ in seen} == set(PARENT) | {"sched.step"}
    for name, parent in seen:
        assert parent == PARENT.get(name), (name, parent)
    # A CPU engine times its launches on the host: the box stays on tid 0.
    launches = [e for e in events if e["name"] == "engine.launch"]
    assert len(launches) == srv.launches and {e["tid"] for e in launches} == {0}


def test_counters_count_spliced_slots_and_timed_launches():
    srv = _server()
    _serve(srv)
    tel = srv.telemetry
    placed = [e for e in tel.events() if e["name"] == "job" and e["ph"] == "n"
              and e["args"].get("phase") in ("admit", "resume")]
    # Two anneal jobs, the ladder's two slots, the urgent job, the ladder
    # resumed on two slots after the urgent job preempted it.
    assert tel.value("serve.slots_spliced") == sum(len(e["args"]["slots"]) for e in placed) == 7
    # One retirement pass a step that retires: four such steps, five slots
    # (the three anneal jobs and the ladder's two).
    passes = [e for e in tel.events() if e["name"] == "sched.retire" and e["ph"] == "B"]
    assert tel.value("serve.retire_passes") == len(passes) == 4
    assert tel.value("serve.retired_slots") == 5
    assert tel.value("serve.launches_timed") == tel.value("serve.launches") == srv.launches > 0
    hist = tel.histogram("serve.launch_s", phase="steady").sum + \
        tel.histogram("serve.launch_s", phase="compile").sum
    assert tel.value("serve.launch_device_s") == pytest.approx(hist) and hist > 0


def test_counters_count_with_events_off():
    """Metrics count with events off; an untimed launch counts nothing."""
    srv = _server(telemetry=False)
    _serve(srv)
    tel = srv.telemetry
    assert tel.num_events == 0
    assert tel.value("serve.slots_spliced") == 7
    assert (tel.value("serve.retire_passes"), tel.value("serve.retired_slots")) == (4, 5)
    assert tel.value("serve.launches_timed") == 0 and tel.value("serve.launch_device_s") == 0


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_results_bit_identical_with_telemetry_on_and_off(rung):
    on, off = _serve(_server(rung)), _serve(_server(rung, telemetry=False))
    assert sorted(on) == sorted(off)
    for jid, r in on.items():
        for field in ("spins", "energy", "magnetization"):
            np.testing.assert_array_equal(getattr(r, field), getattr(off[jid], field))
        assert r.sweeps_done == off[jid].sweeps_done and r.chunks == off[jid].chunks
    pt = [r for r in on.values() if "betas" in r.extras]
    assert len(pt) == 1
    np.testing.assert_array_equal(pt[0].extras["betas"], off[pt[0].jid].extras["betas"])


def test_spans_enter_the_profilers_trace_while_it_records(tmp_path):
    srv = _server()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(srv)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"sched.step", "sched.admit.init", "sched.admit.splice", "pt.swap",
            "sched.retire"} <= ranges


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    def record_function(name, *a, **k):
        entered.append(name)
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    srv = _server()
    assert len(_serve(srv)) == 4
    assert entered == [] and srv.telemetry.num_events > 0


class _Clock:
    """A clock that advances 1.5 s a read, so every timestamp is known."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1.5
        return self.t


def _old_events(pid):
    """The events `_emit_each` produces, as the dict ring built them: name,
    ph, ts, pid, tid, cat, then args when given, then the phase's own key."""
    def ev(name, ph, ts, tid, cat, args=None, **extra):
        out = {"name": name, "ph": ph, "ts": ts, "pid": pid, "tid": tid, "cat": cat}
        if args:
            out["args"] = args
        out.update(extra)
        return out

    return [
        ev("sched.step", "B", 1.5e6, 0, "serve"),
        ev("sched.admit", "B", 3.0e6, 0, "serve", {"k": 1}),
        ev("sched.plan", "i", 4.5e6, 0, "serve", {"free": 3}, s="t"),
        ev("sched.admit", "E", 6.0e6, 0, "serve"),
        ev("engine.launch", "X", 7.5e6 - 250.0, 2, "engine", {"chunk": 8}, dur=250.0),
        ev("engine.launch", "X", 5.0, 0, "engine", dur=1.0),
        ev("job", "b", 9.0e6, 0, "job", {"kind": "anneal"}, id="7"),
        ev("job", "n", 10.5e6, 3, "job", {"phase": "admit"}, id="7"),
        ev("job", "e", 12.0e6, 0, "job", id="7"),
        ev("sched.step", "E", 13.5e6, 0, "serve"),
    ]


def _emit_each(tel):
    with tel.span("sched.step"):
        with tel.span("sched.admit", k=1):
            tel.instant("sched.plan", free=3)
        tel.complete("engine.launch", 250.0, tid=2, cat="engine", chunk=8)
        tel.complete("engine.launch", 1.0, cat="engine", ts=5.0)
        tel.async_begin("job", 7, kind="anneal")
        tel.async_instant("job", 7, tid=3, phase="admit")
        tel.async_end("job", 7)


def test_tuple_ring_events_equal_the_dict_ring_field_for_field():
    tel = Telemetry(clock=_Clock())
    _emit_each(tel)
    got, want = tel.events(), _old_events(tel.pid)
    assert [list(e.items()) for e in got] == [list(e.items()) for e in want]
    validate_events(got)
    assert tel.chrome_trace()["traceEvents"][1:] == want  # after the process name
    # A ring that overflows keeps the newest events and counts the rest.
    small = Telemetry(clock=_Clock(), max_events=4)
    _emit_each(small)
    assert small.events() == want[-4:] and small.dropped_events == len(want) - 4


def test_disabled_spans_emit_nothing_and_spans_are_reused():
    tel = Telemetry(enabled=False)
    with tel.span("a"), tel.span("b"):
        pass
    assert tel.num_events == 0
    tel = Telemetry()
    assert tel.span("a") is tel.span("a")  # a plain span is made once
    assert tel.span("a", k=1) is not tel.span("a", k=1)
    with tel.span("a"):
        with tel.span("a"):  # the same object nested in itself
            pass
    assert [(e["name"], e["ph"]) for e in tel.events()] == [("a", "B"), ("a", "B"), ("a", "E"),
                                                             ("a", "E")]


def test_nested_spans_close_their_own_profiler_ranges(tmp_path):
    """A span nested in itself opens and closes a range each; a span
    entered before the profiler started closes none."""
    tel = Telemetry()
    with tel.span("outer"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tel.span("a"):
                with tel.span("a"):
                    pass
        assert tel._ranges == []
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ranges = [e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    assert sorted(ranges) == ["a", "a"]


class _Event:
    """A stand-in for `torch.cuda.Event`: completes when told, at a set
    device time in ms."""

    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def test_device_intervals_resolve_in_order_without_blocking():
    tel = Telemetry()
    tel._anchors[0] = (_Event(10.0), 1000.0)  # device 10 ms is trace 1000 us
    tel.name_thread(telemetry_mod.DEVICE_TID, "device")
    got = []
    first = (_Event(12.0), _Event(12.5))
    second = (_Event(13.0), _Event(14.0, done=False))
    tel.device_interval("engine.launch", *first, got.append, chunk=8)
    tel.device_interval("engine.launch", *second, got.append, chunk=4)
    tel.poll_device()  # the second has not ended: it waits, unblocked
    assert got == [pytest.approx(0.5e-3)] and len(tel._pending) == 1
    tel.poll_device(block=True)
    assert got[1] == pytest.approx(1e-3) and len(tel._pending) == 0
    boxes = [e for e in tel.events() if e["name"] == "engine.launch"]
    assert [(e["tid"], e["ts"], e["dur"], e["args"]["chunk"]) for e in boxes] == [
        (1, pytest.approx(3000.0), pytest.approx(500.0), 8),
        (1, pytest.approx(4000.0), pytest.approx(1000.0), 4),
    ]
    # Metrics count with events off; no box is emitted then.
    tel.enabled = False
    tel.device_interval("engine.launch", _Event(15.0), _Event(15.25), got.append)
    tel.poll_device()
    assert got[2] == pytest.approx(0.25e-3) and len(tel.events()) == 2


def test_device_intervals_of_each_card_land_on_its_track():
    """A slot mesh's intervals: each placed from its own card's anchor, on
    the track it names; a card with no anchor counts and emits no box."""
    tel = Telemetry()
    tel._anchors[0] = (_Event(10.0), 1000.0)
    tel._anchors[1] = (_Event(50.0), 2000.0)
    got = []
    tel.device_interval("engine.launch", _Event(12.0), _Event(13.0), got.append,
                        tid=telemetry_mod.DEVICE_TID, card=0, device=0)
    tel.device_interval("engine.launch", _Event(51.0), _Event(53.0), got.append,
                        tid=telemetry_mod.DEVICE_TID + 1, card=1, device=1)
    tel.device_interval("engine.launch", _Event(7.0), _Event(7.5), got.append,
                        tid=telemetry_mod.DEVICE_TID + 2, card=2, device=2)
    tel.poll_device()
    assert got == [pytest.approx(1e-3), pytest.approx(2e-3), pytest.approx(0.5e-3)]
    boxes = [e for e in tel.events() if e["name"] == "engine.launch"]
    assert [(e["tid"], e["ts"], e["dur"], e["args"]["device"]) for e in boxes] == [
        (1, pytest.approx(3000.0), pytest.approx(1000.0), 0),
        (2, pytest.approx(3000.0), pytest.approx(2000.0), 1),
    ]


def test_exporters_resolve_queued_intervals():
    tel = Telemetry()
    tel._anchors[0] = (_Event(0.0), 0.0)
    got = []
    for name in ("events", "metrics_snapshot", "prometheus_text", "chrome_trace"):
        tel.device_interval("engine.launch", _Event(1.0), _Event(2.0, done=False), got.append)
        getattr(tel, name)()
        assert len(tel._pending) == 0, name
    assert len(got) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_card_launches_timed_by_events_without_a_synchronize(monkeypatch, rung):
    """On one card with telemetry on and a static chunk, `step` never calls
    `torch.cuda.synchronize`; the launches' device seconds are counted, and
    their boxes sit on the device track inside the steps' wall."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = ising.random_layered_model(n=8, L=256, seed=0, beta=1.2)
    srv = SampleServer(m, slots=4, chunk_sweeps=4, rung=rung, backend="cuda", device="cuda")
    plain = SampleServer(m, slots=4, chunk_sweeps=4, rung=rung, backend="cuda", device="cuda",
                         telemetry=False)
    for s in (srv, plain):
        for i in range(6):
            s.submit(AnnealJob.constant(seed=i, sweeps=5 + 3 * i, beta=0.5 + 0.2 * i))
        s.submit(PTJob(seed=9, betas=np.linspace(0.5, 1.5, 2), num_rounds=3,
                       sweeps_per_round=4))
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (calls.append(a), real(*a)))
    t0 = time.perf_counter()
    got = []
    while srv.num_active or srv.num_queued:
        got.extend(srv.step())
    wall = time.perf_counter() - t0
    assert calls == []
    monkeypatch.undo()
    want = {r.jid: r for r in plain.drain()}
    for r in got:
        np.testing.assert_array_equal(r.spins, want[r.jid].spins)
    tel = srv.telemetry
    st = srv.stats()  # resolves what is still queued
    assert len(tel._pending) == 0 and st["launches"] == tel.value("serve.launches_timed")
    device_s = tel.value("serve.launch_device_s")
    assert 0 < device_s < wall
    events = tel.chrome_trace()["traceEvents"]
    validate_events(events)
    boxes = [e for e in events if e["name"] == "engine.launch"]
    assert len(boxes) == srv.launches and {e["tid"] for e in boxes} == {1}
    steps = [e["ts"] for e in events if e["name"] == "sched.step"]
    assert all(steps[0] <= e["ts"] <= steps[-1] for e in boxes)


@pytest.mark.cuda
def test_card_profiler_window_holds_its_launches_and_the_spans(tmp_path):
    """`arm_profiler` on the card: exactly the window's launches resolve
    between its start and stop, and its trace holds the kernel and the
    server's spans as ``user_annotation`` ranges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = ising.random_layered_model(n=8, L=256, seed=0, beta=1.2)
    srv = SampleServer(m, slots=4, chunk_sweeps=2, rung="cb", backend="cuda", device="cuda")
    srv.submit(AnnealJob.constant(seed=5, sweeps=4, beta=1.0))
    srv.drain()
    srv.arm_profiler(tmp_path / "prof", num_chunks=3)
    srv.submit(AnnealJob.constant(seed=6, sweeps=12, beta=1.0))
    srv.drain()
    names = [e["name"] for e in srv.telemetry.events()]
    i0, i1 = names.index("profiler.start"), names.index("profiler.stop")
    assert names[i0:i1].count("engine.launch") == 3
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in trace if e.get("cat") == "user_annotation"}
    kernels = {e["name"] for e in trace if e.get("cat") == "kernel"}
    assert {"sched.step", "sched.launch"} <= ranges
    assert any("colored_multisweep" in k for k in kernels)
