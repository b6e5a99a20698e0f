"""`Telemetry` — the metrics registry + structured event ring of the stack.

The paper's 9-12x vectorization wins were found by *measuring* every
step; the serving stack (engine -> scheduler -> launch) had no runtime
visibility beyond `SampleServer.stats()`.  This module is the missing
instrument: ONE registry of named metrics plus ONE bounded ring buffer of
structured events, shared by everything that wants to observe a server.

Three metric kinds, all host-side and O(1) per update:

  counter     monotone accumulator (launches, sweeps, preemptions).
  gauge       last-write-wins level (active jobs, queue depth).
  histogram   count/sum/min/max plus a bounded reservoir of recent
              samples for percentiles (launch wall time, queue waits).

Metrics take optional LABELS (``counter("serve.launches", chunk=8)``):
each distinct label set is its own series, exactly the Prometheus data
model the exporter renders (`repro_torch.obs.metrics`).

Events are Chrome-trace-event dicts (name/ph/ts/pid/tid + args) appended
to a ``deque(maxlen=...)`` — a long-lived server can trace forever and
hold only the most recent window; ``dropped_events`` counts what the ring
evicted so truncation is visible, never silent.  Three event shapes:

  * sync spans   (`span` -> ph "B"/"E"): scheduler phases on one track;
                 properly nested per tid by construction (a context
                 manager owns the B/E pairing).
  * complete     (`complete` -> ph "X" with ``dur``): engine launches —
                 one event per fused launch with its measured wall time.
  * async spans  (`async_begin`/`async_instant`/`async_end` -> ph
                 "b"/"n"/"e" with an ``id``): job lifecycles, which
                 overlap arbitrarily and so cannot live on a sync stack.

Everything is EXPLICITLY clocked by `time.perf_counter` (monotonic — the
same timer the rest of the repo standardized on) with timestamps in
microseconds since the registry's construction, the unit Chrome traces
use natively.

The hard contract: telemetry never touches carries,
so telemetry-on and telemetry-off runs are bit-identical — observation
changes what you SEE, never what is computed.  ``enabled=False`` turns
every event emission into an early return while counters/gauges keep
counting: `SampleServer.stats()` reads this registry (the single source
of truth — stats and exporters can never disagree), so accounting must
survive with tracing off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

import numpy as np

#: Reservoir size per histogram: enough for stable p50/p95 over recent
#: traffic, bounded so a resident server never grows it.
HIST_WINDOW = 1024


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotone accumulator.  ``add`` rejects negative increments —
    counters only go up; levels belong in gauges."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def add(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (add {n})")
        self.value += n


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """count/sum/min/max + a bounded recent-sample reservoir.

    Percentiles come from the reservoir (the last `HIST_WINDOW`
    observations), the same recency-weighted convention as the server's
    rolling queue-wait window: a long-lived process alerts on what is
    happening NOW, not on a lifetime average.
    """

    __slots__ = ("name", "labels", "count", "sum", "min", "max", "_recent")

    def __init__(self, name: str, labels: dict, window: int = HIST_WINDOW):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._recent = deque(maxlen=window)

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._recent.append(v)

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
        }
        if self._recent:
            arr = np.asarray(self._recent, np.float64)
            out["p50"] = float(np.percentile(arr, 50))
            out["p95"] = float(np.percentile(arr, 95))
        return out


class Telemetry:
    """One registry of metrics + one bounded ring of trace events."""

    def __init__(
        self,
        enabled: bool = True,
        max_events: int = 65536,
        clock=time.perf_counter,
    ):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        #: Event recording switch.  Metrics ALWAYS count — `stats()` and
        #: the exporters read them — only the event ring obeys this.
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        self._clock = clock
        self._t0 = clock()
        self._events: deque = deque(maxlen=int(max_events))
        self._appended = 0  # total emitted, for dropped accounting
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}
        # Per-tid open sync spans: `span` pushes on B and pops on E, so a
        # well-formed program cannot emit crossing B/E pairs (the schema
        # validator in tests re-checks the invariant on the output side).
        self._span_stacks: dict[int, list] = {}
        self._thread_names: dict[int, str] = {}
        self._lock = threading.Lock()  # registry creation only; updates
        # are single-writer (the scheduler loop) by design.

    # -- clock ----------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since this registry was constructed (trace time)."""
        return (self._clock() - self._t0) * 1e6

    # -- metrics registry -----------------------------------------------------

    def _series(self, store: dict, cls, name: str, labels: dict):
        key = (name, _label_key(labels))
        s = store.get(key)
        if s is None:
            with self._lock:
                s = store.get(key)
                if s is None:
                    s = store[key] = cls(name, dict(labels))
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._series(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._series(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._series(self._histograms, Histogram, name, labels)

    def value(self, name: str, **labels):
        """Current value of a counter/gauge (0 if never touched — a
        metric that was never incremented reads as zero, not missing)."""
        key = (name, _label_key(labels))
        if key in self._counters:
            return self._counters[key].value
        if key in self._gauges:
            return self._gauges[key].value
        return 0

    def series(self, name: str) -> list[tuple[dict, float]]:
        """Every label set of a counter ``name`` as ``(labels, value)``
        pairs (e.g. the per-chunk-size launch counts)."""
        return [
            (dict(key[1]), c.value)
            for key, c in self._counters.items()
            if key[0] == name
        ]

    # -- event emission -------------------------------------------------------

    @property
    def num_events(self) -> int:
        """Events currently held by the ring (cheap — no copy)."""
        return len(self._events)

    @property
    def dropped_events(self) -> int:
        """Events evicted by the bounded ring (visible truncation)."""
        return max(0, self._appended - len(self._events))

    def _emit(self, ev: dict) -> None:
        self._appended += 1
        self._events.append(ev)

    def _base(self, name, ph, tid, cat, ts, args) -> dict:
        ev = {
            "name": name,
            "ph": ph,
            "ts": self.now_us() if ts is None else ts,
            "pid": self.pid,
            "tid": int(tid),
            "cat": cat,
        }
        if args:
            ev["args"] = args
        return ev

    def name_thread(self, tid: int, name: str) -> None:
        """Label a tid's track in the exported trace (metadata event)."""
        self._thread_names[int(tid)] = str(name)

    def instant(self, name: str, tid: int = 0, cat: str = "serve", **args):
        """Thread-scoped instant event (ph "i")."""
        if not self.enabled:
            return
        ev = self._base(name, "i", tid, cat, None, args)
        ev["s"] = "t"
        self._emit(ev)

    def complete(self, name: str, dur_us: float, tid: int = 0,
                 cat: str = "serve", ts: float = None, **args):
        """Complete event (ph "X"): one box of ``dur_us`` starting at
        ``ts`` (defaults to now - dur, i.e. the caller timed it and is
        reporting at the end)."""
        if not self.enabled:
            return
        if ts is None:
            ts = self.now_us() - dur_us
        ev = self._base(name, "X", tid, cat, ts, args)
        ev["dur"] = dur_us
        self._emit(ev)

    @contextmanager
    def span(self, name: str, tid: int = 0, cat: str = "serve", **args):
        """Sync span (ph "B"/"E") on track ``tid``; nests by construction."""
        if not self.enabled:
            yield
            return
        self._span_stacks.setdefault(tid, []).append(name)
        self._emit(self._base(name, "B", tid, cat, None, args))
        try:
            yield
        finally:
            top = self._span_stacks[tid].pop()
            assert top == name, f"span stack corrupted: {top} != {name}"
            self._emit(self._base(name, "E", tid, cat, None, None))

    # Async (id-keyed) spans: job lifecycles overlap arbitrarily, so they
    # cannot share a sync stack — Chrome's b/n/e events pair by (cat, id).

    def async_begin(self, name: str, id, tid: int = 0, cat: str = "job",
                    **args):
        if not self.enabled:
            return
        ev = self._base(name, "b", tid, cat, None, args)
        ev["id"] = str(id)
        self._emit(ev)

    def async_instant(self, name: str, id, tid: int = 0, cat: str = "job",
                      **args):
        if not self.enabled:
            return
        ev = self._base(name, "n", tid, cat, None, args)
        ev["id"] = str(id)
        self._emit(ev)

    def async_end(self, name: str, id, tid: int = 0, cat: str = "job",
                  **args):
        if not self.enabled:
            return
        ev = self._base(name, "e", tid, cat, None, args)
        ev["id"] = str(id)
        self._emit(ev)

    # -- export ---------------------------------------------------------------

    def events(self) -> list[dict]:
        """The ring's current contents, oldest first (copies)."""
        return [dict(ev) for ev in self._events]

    def chrome_trace(self) -> dict:
        """A `chrome://tracing` / Perfetto-loadable trace object
        (`repro_torch.obs.trace.chrome_trace`)."""
        from repro_torch.obs import trace

        return trace.chrome_trace(self)

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def metrics_snapshot(self) -> dict:
        """JSON-ready snapshot of every metric series
        (`repro_torch.obs.metrics.snapshot`)."""
        from repro_torch.obs import metrics

        return metrics.snapshot(self)

    def prometheus_text(self, prefix: str = "repro") -> str:
        """Prometheus text-exposition rendering of the registry
        (`repro_torch.obs.metrics.prometheus_text`)."""
        from repro_torch.obs import metrics

        return metrics.prometheus_text(self, prefix=prefix)
