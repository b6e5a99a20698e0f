"""Launch skew on a slot mesh: the port's `StragglerMonitor` and
`LaunchSkewMonitor` flag what the reference's flag, and the probe that
feeds them never moves a bit.

* On seeded per-device time series (steady, one straggling device, a
  burst, microsecond jitter, a device of capacity 0 that reads 0 s) both
  packages' monitors flag the same (launch, device) pairs with the same
  evidence; bad shapes and knobs raise the same messages.
* A D=4 server (and one on [3, 3, 2, 0]) gives identical results with
  telemetry on and off; with it on, every launch's ready times feed the
  monitor (one record a launch), and a straggling device injected into the
  ready times is counted in ``serve.straggler_events`` and traced as
  ``engine.straggler``.
"""

import numpy as np
import pytest

from repro.obs import LaunchSkewMonitor as JSkew
from repro.runtime.ft import StragglerMonitor as JStraggler
from repro_torch.core import ising
from repro_torch.launch.mesh import make_slot_mesh
from repro_torch.obs import LaunchSkewMonitor, SkewEvent
from repro_torch.runtime.ft import StragglerMonitor
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

MODEL = ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)


def _series(kind, seed, D=4, n=40):
    rng = np.random.default_rng(seed)
    t = 0.01 * (1 + 0.03 * rng.standard_normal((n, D)))
    if kind == "straggler":
        t[n // 2:, 2] *= 4.0
    elif kind == "burst":
        t[10:13] *= 6.0
    elif kind == "jitter":  # the reference's case: a 10x spread, all tiny
        t = np.tile([1e-6, 2e-6, 5e-6, 1e-5], (n, 1))
    elif kind == "zero-device":
        t[:, 3] = 0.0
        t[25, 1] *= 9.0
    return t


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["steady", "straggler", "burst", "jitter", "zero-device"])
def test_monitors_flag_what_the_reference_flags(kind, seed):
    times = _series(kind, seed)
    port, ref = LaunchSkewMonitor(4, warmup_steps=3), JSkew(4, warmup_steps=3)
    for row in times:
        assert port.record(row) == ref.record(row)
    assert [(e.launch, e.device, e.seconds, e.device_median) for e in port.events] == \
        [(e.launch, e.device, e.seconds, e.device_median) for e in ref.events]
    assert all(isinstance(e, SkewEvent) for e in port.events)
    if kind == "straggler":
        assert any(e.device == 2 for e in port.events)
    if kind == "jitter":
        assert not port.events
    one, jone = StragglerMonitor(warmup_steps=3), JStraggler(warmup_steps=3)
    for i, row in enumerate(times):
        assert one.record(i, float(row[0])) == jone.record(i, float(row[0]))
    assert one.flagged == jone.flagged and one.mean == jone.mean and one.var == jone.var


def test_monitor_refusals_are_the_references():
    for make in (lambda M: M(0), lambda M: M(2, rel_threshold=1.0),
                 lambda M: M(4).record([1.0, 2.0])):
        with pytest.raises(ValueError) as want:
            make(JSkew)
        with pytest.raises(ValueError) as got:
            make(LaunchSkewMonitor)
        assert str(got.value) == str(want.value)


def _drain(caps=None, **kw):
    srv = SampleServer(MODEL, slots=8, chunk_sweeps=2, rung="a4", backend="torch", V=4,
                       device="cpu", mesh=make_slot_mesh(4, "cpu"), capacities=caps, **kw)
    for s, b in [(10, 9), (11, 7), (12, 5)]:
        srv.submit(AnnealJob.constant(seed=s, sweeps=b, beta=1.0))
    srv.submit(PTJob(seed=3, betas=np.linspace(0.5, 1.5, 3).astype(np.float32), num_rounds=3,
                     sweeps_per_round=2))
    return srv, sorted(srv.drain(), key=lambda r: r.jid)


@pytest.mark.parametrize("caps", [None, (3, 3, 2, 0)], ids=["d4", "zero"])
def test_mesh_results_identical_with_telemetry_on_off(caps):
    off_srv, off = _drain(caps, telemetry=False)
    on_srv, on = _drain(caps, telemetry=True)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.spins, b.spins)
        np.testing.assert_array_equal(a.energy, b.energy)
    np.testing.assert_array_equal(off_srv.engine.extract_pool(off_srv.carry).carry.rng,
                                  on_srv.engine.extract_pool(on_srv.carry).carry.rng)
    assert off_srv._skew.launches == 0  # telemetry off: the probe never ran
    assert on_srv._skew.launches == on_srv.launches  # on: one record a launch
    assert on_srv.stats()["telemetry"]["devices"] == 4


def test_a_straggling_device_is_counted_and_traced():
    srv = SampleServer(MODEL, slots=8, chunk_sweeps=1, rung="cb", backend="torch", V=4,
                       device="cpu", mesh=make_slot_mesh(4, "cpu"))
    real = srv.engine.device_ready_times
    calls = []

    def slow_device_2(carry, t0):
        real(carry, t0)  # the probe still runs; its host-clock times are replaced
        calls.append(len(calls))
        times = np.full(4, 0.01)
        if len(calls) > 8:
            times[2] += 1.0  # device 2 lags by a second from the ninth launch on
        return times

    srv.engine.device_ready_times = slow_device_2
    srv.submit(AnnealJob.constant(seed=1, sweeps=12, beta=1.0))
    srv.drain()
    st = srv.stats()["telemetry"]
    assert len(calls) == srv.launches == 12
    assert st["straggler_events"] == 4
    events = [e for e in srv.telemetry.chrome_trace()["traceEvents"]
              if e.get("name") == "engine.straggler"]
    assert events and all(e["args"]["devices"] == [2] for e in events)


@pytest.mark.parametrize("caps", [None, (3, 3, 2, 0)], ids=["d4", "zero"])
def test_host_mesh_counts_each_devices_timed_launches(caps):
    """On the host path every launching device counts its launches and its
    ready times under the label ``device=d``; the unlabelled counters keep
    one entry a launch, the slowest device's time."""
    srv, _ = _drain(caps)
    tel = srv.telemetry
    launched = [d for d, c in enumerate(srv.engine.capacities) if c]
    assert tel.value("serve.launches_timed") == srv.launches > 0
    for d in range(4):
        want = srv.launches if d in launched else 0
        assert tel.value("serve.launches_timed", device=d) == want, d
        assert (tel.value("serve.launch_device_s", device=d) > 0) == (d in launched), d
    total = tel.value("serve.launch_device_s")
    assert max(tel.value("serve.launch_device_s", device=d) for d in launched) <= total + 1e-12


class _Event:
    """A recorded CUDA timing event's stand-in: a device time in ms."""

    def __init__(self, t_ms):
        self.t_ms = t_ms

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def test_mesh_event_intervals_count_per_device_and_feed_the_skew_monitor():
    """The event-timed mesh path (`SampleServer._queue_blocks`), its card
    events replaced: each block's interval counts on its device's labelled
    counters, each launch adds its slowest block once to the unlabelled
    ones, and the skew monitor gets every launch's per-device seconds
    (device 3 of capacity 0 reads 0; device 2 lags from the ninth launch)."""
    srv = SampleServer(MODEL, slots=8, chunk_sweeps=1, rung="cb", backend="torch", V=4,
                       device="cpu", mesh=make_slot_mesh(4, "cpu"), capacities=(3, 3, 2, 0))
    srv._event_timing, srv._cards = True, []
    srv._tracks = [(1 + d, 0) for d in range(4)]
    launches = []

    def block_events():
        k = len(launches)
        launches.append(k)
        ms = [1.0, 1.5, 2.0 + (100.0 if k >= 8 else 0.0)]
        return [(_Event(10.0 * k), _Event(10.0 * k + t)) for t in ms] + [None]

    srv.engine.block_events = block_events
    srv.submit(AnnealJob.constant(seed=1, sweeps=12, beta=1.0))
    srv.drain()
    tel = srv.telemetry
    assert len(launches) == srv.launches == 12 and srv._skew.launches == 12
    for d, ms in enumerate([1.0, 1.5]):
        assert tel.value("serve.launches_timed", device=d) == 12
        assert tel.value("serve.launch_device_s", device=d) == pytest.approx(12 * ms * 1e-3)
    assert tel.value("serve.launches_timed", device=3) == 0
    assert tel.value("serve.launches_timed") == 12
    assert tel.value("serve.launch_device_s") == pytest.approx((8 * 2.0 + 4 * 102.0) * 1e-3)
    st = srv.stats()["telemetry"]
    assert st["straggler_events"] == 4
    events = [e for e in tel.chrome_trace()["traceEvents"] if e.get("name") == "engine.straggler"]
    assert len(events) == 4 and all(e["args"]["devices"] == [2] for e in events)


def test_one_device_event_intervals_count_as_before():
    """The same event-timed path on one device, its card events replaced:
    each launch's interval counts once on the unlabelled counters, no
    ``device=d`` series or skew record appears, and the launch box lands
    on the "device" track (tid 1) without a ``device`` argument."""
    srv = SampleServer(MODEL, slots=2, chunk_sweeps=1, rung="cb", backend="torch", V=4,
                       device="cpu")
    srv._event_timing, srv._cards, srv._tracks = True, [], [(1, 0)]
    srv.telemetry._anchors[0] = (_Event(0.0), 0.0)
    launches = []

    def block_events():
        k = len(launches)
        launches.append(k)
        return [(_Event(10.0 * k), _Event(10.0 * k + 1.0 + 0.5 * (k % 2)))]

    srv.engine.block_events = block_events
    srv.submit(AnnealJob.constant(seed=1, sweeps=6, beta=1.0))
    srv.drain()
    tel = srv.telemetry
    assert srv._skew is None and len(launches) == srv.launches == 6
    assert tel.value("serve.launches_timed") == 6
    assert tel.value("serve.launch_device_s") == pytest.approx(7.5e-3)
    assert tel.value("serve.launches_timed", device=0) == 0
    boxes = [e for e in tel.chrome_trace()["traceEvents"] if e.get("name") == "engine.launch"]
    assert len(boxes) == 6 and all(e["tid"] == 1 and "device" not in e["args"] for e in boxes)
    assert [e["ts"] for e in boxes] == [1e4 * k for k in range(6)]
