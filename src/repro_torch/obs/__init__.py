"""Observability for the SampleServer stack.

    telemetry  one metrics registry (counters/gauges/histograms, with
               labels) + one bounded ring of Chrome-trace events, held as
               tuples and built into dicts on export; slotted spans for
               scheduler phases (mirrored into a recording
               `torch.profiler`'s trace as ``record_function`` ranges),
               complete events for launches timed on the host, a device
               track of launches timed by CUDA events and resolved
               without blocking, async spans for job lifecycles.
    trace      Chrome-trace-event JSON exporter (+ the schema validator).
    metrics    JSON snapshot + Prometheus text exposition of the registry.
    stream     opt-in per-chunk observable tap (energy / magnetization /
               best-so-far per active job).
    skew       per-device launch-skew detection on mesh engines, over
               runtime/ft.py's StragglerMonitor.

Hard contract: observation never touches carries — telemetry-on runs are
bit-identical to telemetry-off.
"""

from repro_torch.obs.skew import LaunchSkewMonitor, SkewEvent
from repro_torch.obs.stream import BestState, ChunkSample, ObservableStream
from repro_torch.obs.telemetry import Counter, Gauge, Histogram, Telemetry
from repro_torch.obs.trace import validate_events

__all__ = [
    "BestState",
    "ChunkSample",
    "Counter",
    "Gauge",
    "Histogram",
    "LaunchSkewMonitor",
    "ObservableStream",
    "SkewEvent",
    "Telemetry",
    "validate_events",
]
