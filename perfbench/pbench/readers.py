"""What the metric readers (``metrics/<name>.py``) share: a reader takes
the run's record and returns the metric's value, or None when the record
holds nothing to read it from."""

from __future__ import annotations

from pbench import yardstick
from pbench.trace import clip, union


def delta(rec: dict, name: str) -> float:
    c0, c1 = rec["counters"]
    return c1[name] - c0[name]


def span_share(rec: dict, spans) -> float | None:
    """Percent of the window's wall covered by ``spans`` (host seconds)."""
    if spans is None or rec.get("events_dropped"):
        return None
    covered = sum(b - a for a, b in union(clip(spans, rec["t0"], rec["t1"])))
    return 100.0 * covered / rec["wall_s"]


def device_idle(rec: dict) -> float | None:
    dev = rec.get("device")
    if not dev or not dev.get("busy"):
        return None
    busy = sum(b - a for a, b in dev["busy"])
    return 100.0 * (1.0 - busy / (dev["t1"] - dev["t0"]))


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
