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

Events are Chrome-trace events, held in a ``deque(maxlen=...)`` as
tuples ``(ph, name, ts, tid, cat, args, extra)`` and turned into the
trace's dicts only by `events` / `chrome_trace` — a long-lived server can
trace forever and hold only the most recent window; ``dropped_events``
counts what the ring evicted so truncation is visible, never silent.
Four event shapes:

  * sync spans   (`span` -> ph "B"/"E"): scheduler phases on one track;
                 properly nested per tid by construction (a slotted
                 context manager owns the B/E pairing).  While a
                 `torch.profiler` records (``torch.autograd.profiler.
                 _is_profiler_enabled``), each span also enters
                 ``torch.profiler.record_function(<name>)``, so the spans
                 sit in the profiler's own trace as ``user_annotation``
                 ranges, on the kernels' clock; with no profiler
                 recording none is entered.
  * complete     (`complete` -> ph "X" with ``dur``): one box of a
                 measured duration (an engine launch timed on the host).
  * device track (`device_interval` -> ph "X" on tid `DEVICE_TID`, or a
                 track of its own per device of a slot mesh): an interval
                 between two CUDA timing events (an engine launch on the
                 card), queued without waiting and resolved by
                 `poll_device` once its end event has completed; its
                 ``ts`` is the device start, put on the registry's clock
                 through its card's anchor event (`anchor_device`).
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

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

#: Reservoir size per histogram: enough for stable p50/p95 over recent
#: traffic, bounded so a resident server never grows it.
HIST_WINDOW = 1024

#: The track of intervals timed on the card (`Telemetry.device_interval`);
#: a slot mesh's device d has track ``DEVICE_TID + d``.
DEVICE_TID = 1

#: The kind-specific field of each phase's trace event.
_EXTRA_KEY = {"X": "dur", "i": "s", "b": "id", "n": "id", "e": "id"}


def card_index(device) -> int:
    """The CUDA index of ``device`` (the current card for a bare ``cuda``):
    the key of its anchor."""
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


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
        # Sync spans of a name with no args on track 0, made once; and the
        # `record_function` ranges that open spans entered, innermost last.
        self._plain_spans: dict[str, _Span] = {}
        self._ranges: list = []
        self._thread_names: dict[int, str] = {}
        # Device intervals queued by `device_interval`, oldest first, and
        # each card's anchor (event, trace us) that places them on this clock.
        self._pending: deque = deque()
        self._anchors: dict[int, tuple] = {}
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

    def _emit(self, ph, name, ts, tid, cat, args, extra=None) -> None:
        self._appended += 1
        self._events.append((ph, name, ts, tid, cat, args, extra))

    def name_thread(self, tid: int, name: str) -> None:
        """Label a tid's track in the exported trace (metadata event)."""
        self._thread_names[int(tid)] = str(name)

    def instant(self, name: str, tid: int = 0, cat: str = "serve", **args):
        """Thread-scoped instant event (ph "i")."""
        if self.enabled:
            self._emit("i", name, self.now_us(), int(tid), cat, args, "t")

    def complete(self, name: str, dur_us: float, tid: int = 0,
                 cat: str = "serve", ts: float = None, **args):
        """Complete event (ph "X"): one box of ``dur_us`` starting at
        ``ts`` (defaults to now - dur, i.e. the caller timed it and is
        reporting at the end)."""
        if not self.enabled:
            return
        if ts is None:
            ts = self.now_us() - dur_us
        self._emit("X", name, ts, int(tid), cat, args, dur_us)

    def span(self, name: str, tid: int = 0, cat: str = "serve", **args):
        """Sync span (ph "B"/"E") on track ``tid``, a context manager (a
        ``with`` statement nests it by construction), mirrored into a
        recording profiler's trace (module docstring)."""
        if not self.enabled:
            return _NULL_SPAN
        if args or tid or cat != "serve":
            return _Span(self, name, int(tid), cat, args)
        span = self._plain_spans.get(name)
        if span is None:
            span = self._plain_spans[name] = _Span(self, name, 0, "serve", None)
        return span

    # Async (id-keyed) spans: job lifecycles overlap arbitrarily, so they
    # cannot share a sync stack — Chrome's b/n/e events pair by (cat, id).

    def async_begin(self, name: str, id, tid: int = 0, cat: str = "job",
                    **args):
        if self.enabled:
            self._emit("b", name, self.now_us(), int(tid), cat, args, str(id))

    def async_instant(self, name: str, id, tid: int = 0, cat: str = "job",
                      **args):
        if self.enabled:
            self._emit("n", name, self.now_us(), int(tid), cat, args, str(id))

    def async_end(self, name: str, id, tid: int = 0, cat: str = "job",
                  **args):
        if self.enabled:
            self._emit("e", name, self.now_us(), int(tid), cat, args, str(id))

    # -- the device track -------------------------------------------------------
    #
    # An interval on the card is a pair of recorded `torch.cuda.Event`s
    # (``enable_timing=True``).  It is queued without waiting; `poll_device`
    # resolves the queued pairs, oldest first, once their end events have
    # completed (``query()``), or waits for them (``block=True``) where the
    # host waits anyway.  Each card's clock is tied to the registry's by an
    # anchor: an event recorded on the card's stream, waited for and read
    # against `now_us` the moment the wait returns.

    def anchor_device(self, device) -> None:
        """Record an anchor event on ``device``'s current stream, wait for
        it and read the registry's clock: the time origin of the card's
        intervals.  Every interval resolved later is placed from its card's
        newest anchor, so renewing it where the host waits anyway keeps the
        two clocks from drifting apart."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()
        self._anchors[card_index(device)] = (ev, self.now_us())

    def device_interval(self, name: str, start, end, on_done=None, cat: str = "engine", *,
                        tid: int = DEVICE_TID, card: int = 0, **args) -> None:
        """Queue the interval between two timing events recorded on card
        ``card`` (its CUDA index).  When it is resolved, ``on_done(seconds)``
        receives its device time (metrics count whether or not events are
        enabled) and, with events enabled and the card anchored, a complete
        event lands on track ``tid``."""
        self._pending.append((name, start, end, on_done, cat, tid, card, args))

    def poll_device(self, block: bool = False) -> None:
        """Resolve the queued device intervals whose end event has
        completed, oldest first; with ``block`` wait for every one."""
        pending = self._pending
        while pending:
            name, start, end, on_done, cat, tid, card, args = pending[0]
            if not end.query():
                if not block:
                    return
                end.synchronize()
            pending.popleft()
            dur_ms = start.elapsed_time(end)
            if on_done is not None:
                on_done(dur_ms * 1e-3)
            if self.enabled and card in self._anchors:
                anchor, t_us = self._anchors[card]
                ts = t_us + anchor.elapsed_time(start) * 1e3
                self._emit("X", name, ts, tid, cat, args, dur_ms * 1e3)

    # -- export ---------------------------------------------------------------

    def events(self) -> list[dict]:
        """The ring's current contents as trace-event dicts, oldest first
        (queued device intervals resolved first, waiting for them)."""
        self.poll_device(block=True)
        pid, extra_key = self.pid, _EXTRA_KEY
        out = []
        for ph, name, ts, tid, cat, args, extra in self._events:
            ev = {"name": name, "ph": ph, "ts": ts, "pid": pid, "tid": tid, "cat": cat}
            if args:
                ev["args"] = args
            if extra is not None:
                ev[extra_key[ph]] = extra
            out.append(ev)
        return out

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

        self.poll_device(block=True)
        return metrics.snapshot(self)

    def prometheus_text(self, prefix: str = "repro") -> str:
        """Prometheus text-exposition rendering of the registry
        (`repro_torch.obs.metrics.prometheus_text`)."""
        from repro_torch.obs import metrics

        self.poll_device(block=True)
        return metrics.prometheus_text(self, prefix=prefix)


class _Span:
    """One sync span: B on enter, E on exit; inside, a `record_function`
    range of the same name while a profiler records.  The span of a name
    with no args on the scheduler's track is made once and reused (it
    holds no state of its own: a range it opened sits on the registry's
    ``_ranges`` stack), so the hot path allocates nothing but its two
    ring entries."""

    __slots__ = ("tel", "name", "tid", "cat", "args")

    def __init__(self, tel: Telemetry, name: str, tid: int, cat: str, args: dict | None):
        self.tel = tel
        self.name = name
        self.tid = tid
        self.cat = cat
        self.args = args

    def __enter__(self):
        tel = self.tel
        tel._appended += 1
        tel._events.append(("B", self.name, (tel._clock() - tel._t0) * 1e6, self.tid,
                            self.cat, self.args, None))
        if _autograd_profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            tel._ranges.append((self, rf))
        return self

    def __exit__(self, *exc) -> bool:
        tel = self.tel
        ranges = tel._ranges
        if ranges and ranges[-1][0] is self:
            ranges.pop()[1].__exit__(*exc)
        tel._appended += 1
        tel._events.append(("E", self.name, (tel._clock() - tel._t0) * 1e6, self.tid,
                            self.cat, None, None))
        return False


class _NullSpan:
    """The span of a registry with events off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()
