"""What the metric readers (``metrics/<name>.py``) share: a reader takes
the run's record and returns the metric's value, or None when the record
holds nothing to read it from."""

from __future__ import annotations

from statistics import fmean

from pbench import yardstick
from pbench.trace import clip, union


def delta(rec: dict, name: str) -> float:
    """A counter's growth over the window (``name`` as `system.counters`
    keys it; a series not yet counted at either end reads 0 there)."""
    c0, c1 = rec["counters"]
    return c1.get(name, 0) - c0.get(name, 0)


def span_share(rec: dict, spans) -> float | None:
    """Percent of the window's wall covered by ``spans`` (host seconds)."""
    if spans is None or rec.get("events_dropped"):
        return None
    covered = sum(b - a for a, b in union(clip(spans, rec["t0"], rec["t1"])))
    return 100.0 * covered / rec["wall_s"]


def busy_by_card(rec: dict) -> list[float]:
    """Seconds of the profiler window in which each of the record's
    ``cards`` was busy (0 for a card with no activity).  A trace that names
    a device the engine does not span fails: its time would read as idle."""
    by = rec["device"]["busy_by_device"]
    stray = set(by) - set(rec["cards"])
    if stray:
        raise ValueError(f"the trace names devices {sorted(stray, key=str)} outside the "
                         f"engine's cards {rec['cards']}")
    return [sum(b - a for a, b in by.get(c, ())) for c in rec["cards"]]


def device_idle(rec: dict) -> float | None:
    """The mean over the cell's cards of each card's idle share of the
    profiler window; None where no card was busy."""
    dev = rec.get("device")
    if not dev or not dev.get("busy"):
        return None
    span = dev["t1"] - dev["t0"]
    return 100.0 * fmean([1.0 - busy / span for busy in busy_by_card(rec)])


def launch_chunks(rec: dict) -> dict:
    """Launches of the window by chunk size: ``{sweeps: count}``."""
    c0, c1 = rec["counters"]
    a, b = c0["launches_by_chunk"], c1["launches_by_chunk"]
    return {k: v - a.get(k, 0) for k, v in b.items() if v - a.get(k, 0) > 0}


def bound_s(rec: dict, chunks: dict) -> float | None:
    sh = rec["shapes"]
    if sh["rung"] not in yardstick.COUNTS or sh["lanes"] != yardstick.LANES or not chunks:
        return None
    return yardstick.launches_bound_s(sh["rung"], sh["slots"], sh["rows"], sh["sd"], chunks)
