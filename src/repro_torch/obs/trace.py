"""Chrome-trace-event export of a `Telemetry` ring.

The output is the Trace Event Format's "JSON Object" flavour —
``{"traceEvents": [...], "displayTimeUnit": "ms"}`` — loadable by
`chrome://tracing` and Perfetto's legacy importer.  Every event carries
the required ``name/ph/ts/pid/tid`` fields (the `Telemetry` emitters
guarantee it; `validate_events` re-checks the exported side) with
timestamps in microseconds since the registry's construction.

Beyond the recorded events the exporter prepends METADATA events
(ph "M"): a process name and one thread name per labelled track
(`Telemetry.name_thread`), so the scheduler / per-job tracks come up
readable instead of as bare tids.  When the bounded ring has evicted
events, a single instant event at the head marks how many — truncation
is visible in the trace itself, not just in a counter.
"""

from __future__ import annotations

#: Fields the Trace Event Format requires on every event; the schema
#: validator checks the exported trace against this.
REQUIRED_FIELDS = ("name", "ph", "ts", "pid", "tid")


def metadata_events(tel) -> list[dict]:
    """Process/thread-name metadata (ph "M") for the labelled tracks."""
    out = [
        {
            "name": "process_name",
            "ph": "M",
            "ts": 0,
            "pid": tel.pid,
            "tid": 0,
            "args": {"name": "repro_torch.serve_mc"},
        }
    ]
    for tid, name in sorted(tel._thread_names.items()):
        out.append(
            {
                "name": "thread_name",
                "ph": "M",
                "ts": 0,
                "pid": tel.pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
    return out


def chrome_trace(tel) -> dict:
    """The full loadable trace object for a `Telemetry` instance."""
    events = metadata_events(tel)
    dropped = tel.dropped_events
    if dropped:
        events.append(
            {
                "name": "events_dropped_by_ring",
                "ph": "i",
                "s": "g",
                "ts": 0,
                "pid": tel.pid,
                "tid": 0,
                "cat": "meta",
                "args": {"dropped": dropped},
            }
        )
    events.extend(tel.events())
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_events(events: list[dict]) -> None:
    """Raise unless every event has the required fields and sync B/E
    spans nest properly per (pid, tid).

    This is the exporter's own self-check, shared with the test suite:
    a trace that fails here would render wrong (or not at all) in the
    viewers, so it is a bug wherever it was produced.
    """
    stacks: dict[tuple, list] = {}
    for ev in events:
        for field in REQUIRED_FIELDS:
            if field not in ev:
                raise ValueError(f"trace event missing {field!r}: {ev}")
        ph = ev["ph"]
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"unmatched span end on track {key}: {ev}")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(
                    f"crossed spans on track {key}: E {ev['name']!r} "
                    f"closes B {top!r}"
                )
        elif ph == "X" and "dur" not in ev:
            raise ValueError(f"complete event missing dur: {ev}")
        elif ph in ("b", "n", "e") and "id" not in ev:
            raise ValueError(f"async event missing id: {ev}")
    open_spans = {k: v for k, v in stacks.items() if v}
    if open_spans:
        raise ValueError(f"unclosed spans at trace end: {open_spans}")
