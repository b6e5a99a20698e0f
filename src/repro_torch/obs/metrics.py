"""Metrics export: JSON snapshot + Prometheus text exposition.

Two renderings of the SAME `Telemetry` registry (there is exactly one
source of numbers — `SampleServer.stats()` reads the same counters, so
a scrape and a stats() call can never disagree):

  * `snapshot(tel)` — a JSON-ready dict of every series, the shape the
    CLI's ``--metrics`` prints and benches archive.
  * `prometheus_text(tel)` — the text exposition format
    (``# TYPE``-annotated, labelled series) a Prometheus scrape endpoint
    would serve; histograms render as summaries (count/sum + p50/p95
    quantiles over the bounded reservoir).

Metric names are sanitized to the Prometheus grammar
(``[a-zA-Z_:][a-zA-Z0-9_:]*``): dots become underscores, everything gets
the ``repro_`` prefix.
"""

from __future__ import annotations

import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(prefix: str, name: str) -> str:
    out = _NAME_RE.sub("_", f"{prefix}_{name}" if prefix else name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{_LABEL_RE.sub("_", str(k))}="{v}"' for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def _series_key(name: str, labels: dict) -> str:
    """Stable JSON key for one series: name, plus labels when present."""
    if not labels:
        return name
    body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def snapshot(tel) -> dict:
    """JSON-ready snapshot: every counter/gauge/histogram series."""
    return {
        "counters": {
            _series_key(c.name, c.labels): c.value
            for c in tel._counters.values()
        },
        "gauges": {
            _series_key(g.name, g.labels): g.value
            for g in tel._gauges.values()
        },
        "histograms": {
            _series_key(h.name, h.labels): h.snapshot()
            for h in tel._histograms.values()
        },
        "events_recorded": tel._appended,
        "events_dropped": tel.dropped_events,
    }


def prometheus_text(tel, prefix: str = "repro") -> str:
    """Prometheus text-exposition rendering of the registry."""
    lines: list[str] = []
    typed: set[str] = set()

    def _type_line(pname: str, kind: str) -> None:
        if pname not in typed:
            typed.add(pname)
            lines.append(f"# TYPE {pname} {kind}")

    for c in sorted(tel._counters.values(), key=lambda s: s.name):
        pname = _prom_name(prefix, c.name)
        _type_line(pname, "counter")
        lines.append(f"{pname}{_prom_labels(c.labels)} {c.value}")
    for g in sorted(tel._gauges.values(), key=lambda s: s.name):
        pname = _prom_name(prefix, g.name)
        _type_line(pname, "gauge")
        lines.append(f"{pname}{_prom_labels(g.labels)} {g.value}")
    for h in sorted(tel._histograms.values(), key=lambda s: s.name):
        pname = _prom_name(prefix, h.name)
        _type_line(pname, "summary")
        snap = h.snapshot()
        lines.append(f"{pname}_count{_prom_labels(h.labels)} {snap['count']}")
        lines.append(f"{pname}_sum{_prom_labels(h.labels)} {snap['sum']}")
        for q, key in ((0.5, "p50"), (0.95, "p95")):
            if key in snap:
                lab = _prom_labels(h.labels, {"quantile": q})
                lines.append(f"{pname}{lab} {snap[key]}")
    lines.append(
        f"{_prom_name(prefix, 'telemetry.events_dropped')} {tel.dropped_events}"
    )
    return "\n".join(lines) + "\n"
