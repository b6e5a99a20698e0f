"""The port's observable stream and profiler window, against the reference.

* `repro_torch.obs.ObservableStream` on a `SampleServer(stream=...)`
  records the same samples as the reference's `repro.obs.ObservableStream`
  on the same jobs (energies, magnetizations, best-so-far, the job and
  server sweep clocks), bit for bit; its trace window is bounded; a
  streamed run equals an untapped one and a telemetry-off one.
* `SampleServer.arm_profiler` opens a `torch.profiler` window around
  exactly N launches (the profiler replaced by a recorder, as the
  reference's test replaces `jax.profiler`), writes a Chrome trace with
  the real one, and a profiler failure never stops serving.
* The server's trace with snapshot and restore events is schema-valid.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import ising as jis
from repro.obs import ObservableStream as JStream
from repro.serve_mc import AnnealJob as JAnnealJob
from repro.serve_mc import PTJob as JPTJob
from repro.serve_mc import SampleServer as JSampleServer
from repro_torch.core import ising, observables
from repro_torch.obs import ObservableStream, validate_events
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

MODEL = ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)
JMODEL = jis.random_layered_model(n=5, L=8, seed=1, beta=1.0)
MIXED = [(10, 9), (11, 7), (12, 5)]  # (seed, budget)
KW = dict(V=4, slots=4, chunk_sweeps=4)


def _server(**kw):
    kw = {"rung": "a4", **KW, **kw}
    return SampleServer(MODEL, backend="torch", device="cpu", **kw)


def _mixed_jobs(A=AnnealJob, P=PTJob):
    jobs = [A.constant(seed=s, sweeps=b, beta=1.0) for s, b in MIXED]
    jobs.append(P(seed=9, betas=np.linspace(0.5, 1.5, 2), num_rounds=3, sweeps_per_round=4))
    return jobs


def _drain(srv, jobs=None):
    for j in _mixed_jobs() if jobs is None else jobs:
        srv.submit(j)
    return sorted(srv.drain(), key=lambda r: r.jid)


@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_stream_equals_the_references(rung):
    got, want = ObservableStream(), JStream()
    seen = []
    got.subscribe(seen.append)
    results = _drain(_server(rung=rung, stream=got, policy="fifo"))
    jsrv = JSampleServer(JMODEL, backend="jnp", rung=rung, stream=want, policy="fifo", **KW)
    _drain(jsrv, _mixed_jobs(JAnnealJob, JPTJob))
    assert got.samples_taken == want.samples_taken == len(seen) > 0
    for r in results:
        tr, jtr = got.trace(r.jid), want.trace(r.jid)
        assert len(tr) == len(jtr) > 0
        for a, b in zip(tr, jtr):
            assert (a.jid, a.sweeps_done, a.sweeps_elapsed) == (b.jid, b.sweeps_done,
                                                                 b.sweeps_elapsed)
            np.testing.assert_array_equal(a.energy, b.energy)
            np.testing.assert_array_equal(a.magnetization, b.magnetization)
            assert a.best_energy == b.best_energy
        best, jbest = got.best(r.jid), want.best(r.jid)
        assert (best.energy, best.sweeps_done) == (jbest.energy, jbest.sweeps_done)
        np.testing.assert_array_equal(best.spins, jbest.spins)
        # The last sample IS the retirement state, and the best state
        # evaluates to the reported energy.
        np.testing.assert_array_equal(np.atleast_1d(r.energy), tr[-1].energy)
        assert [s.sweeps_done for s in tr][-1] == r.sweeps_done
        assert best.energy == min(float(np.min(s.energy)) for s in tr)
        assert float(observables.energies(MODEL, best.spins)) == best.energy
    got.forget(results[0].jid)
    assert got.trace(results[0].jid) == [] and got.best(results[0].jid) is None


def test_stream_trace_window_is_bounded():
    stream = ObservableStream(trace_window=4)
    srv = _server(slots=1, chunk_sweeps=1, stream=stream, policy="fifo")
    srv.submit(AnnealJob.constant(seed=3, sweeps=20, beta=1.0))
    (r,) = srv.drain()
    assert [s.sweeps_done for s in stream.trace(r.jid)] == [17, 18, 19, 20]
    with pytest.raises(ValueError, match="trace_window"):
        ObservableStream(trace_window=0)


@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_streamed_run_equals_an_untapped_one(rung):
    off = _drain(_server(rung=rung, telemetry=False))
    on = _drain(_server(rung=rung, telemetry=True))
    tapped = _drain(_server(rung=rung, stream=ObservableStream()))
    assert len(off) == len(on) == len(tapped) == 4
    for a, b, c in zip(off, on, tapped):
        for field in ("spins", "energy", "magnetization"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            np.testing.assert_array_equal(getattr(a, field), getattr(c, field))


class _RecordingProfile:
    """Stands in for `torch.profiler.profile`: records start/stop/export."""

    calls: list = []

    def __init__(self, activities):
        self.calls.append(("init", tuple(activities)))

    def start(self):
        self.calls.append(("start",))

    def stop(self):
        self.calls.append(("stop",))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))


def test_profiler_window_spans_n_chunks(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(_RecordingProfile, "calls", calls)
    monkeypatch.setattr(torch.profiler, "profile", _RecordingProfile)
    srv = _server(slots=1, chunk_sweeps=1, policy="fifo")
    srv.arm_profiler(tmp_path / "prof", num_chunks=3)
    srv.submit(AnnealJob.constant(seed=5, sweeps=8, beta=1.0))
    srv.drain()
    path = str(tmp_path / "prof" / "trace.json")
    assert calls == [("init", (torch.profiler.ProfilerActivity.CPU,)), ("start",), ("stop",),
                     ("export", path)]
    names = [e["name"] for e in srv.telemetry.events()]
    i_start, i_stop = names.index("profiler.start"), names.index("profiler.stop")
    launches = [i for i, n in enumerate(names) if n == "engine.launch"]
    assert len([i for i in launches if i_start < i < i_stop]) == 3  # exactly 3 in the window
    assert srv._profiler is None  # disarmed after the window
    with pytest.raises(ValueError):
        srv.arm_profiler(tmp_path, num_chunks=0)


@pytest.mark.parametrize("fails", ["start", "stop", "export_chrome_trace"])
def test_profiler_failure_never_kills_serving(monkeypatch, tmp_path, fails):
    def boom(*args):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(_RecordingProfile, "calls", [])
    monkeypatch.setattr(_RecordingProfile, fails, boom)
    monkeypatch.setattr(torch.profiler, "profile", _RecordingProfile)
    srv = _server(slots=1, chunk_sweeps=2, policy="fifo")
    srv.arm_profiler(tmp_path / "prof", num_chunks=1)
    srv.submit(AnnealJob.constant(seed=5, sweeps=4, beta=1.0))
    (r,) = srv.drain()  # must complete despite the profiler error
    assert r.sweeps_done == 4
    errors = [e for e in srv.telemetry.events() if e["name"] == "profiler.error"]
    assert len(errors) == 1 and "unavailable" in errors[0]["args"]["error"]
    assert srv._profiler is None


def test_profiler_writes_a_chrome_trace(tmp_path):
    """The real `torch.profiler` on the CPU: the window's trace lands under
    the directory and holds the launches' operators."""
    srv = _server(slots=1, chunk_sweeps=2, policy="fifo")
    srv.arm_profiler(tmp_path / "prof", num_chunks=2)
    srv.submit(AnnealJob.constant(seed=5, sweeps=6, beta=1.0))
    srv.drain()
    assert not [e for e in srv.telemetry.events() if e["name"] == "profiler.error"]
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])


def test_trace_with_snapshot_events_is_valid(tmp_path):
    srv = _server(rung="cb", snapshot_manager=str(tmp_path / "snaps"), snapshot_every_sweeps=4)
    for j in _mixed_jobs():
        srv.submit(j)
    srv.step()
    srv.step()
    srv.wait_snapshots()
    restored = SampleServer.restore(str(tmp_path / "snaps"), device="cpu")
    restored.drain()
    for server, names in ((srv, {"snapshot.save"}), (restored, {"snapshot.restore", "job"})):
        path = server.telemetry.write_chrome_trace(str(tmp_path / "trace.json"))
        events = json.loads(open(path).read())["traceEvents"]
        validate_events(events)
        assert names <= {e["name"] for e in events}
