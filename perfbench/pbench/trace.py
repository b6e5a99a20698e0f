"""The traced run's device window: a `torch.profiler` window of a few
seconds, read back from its Chrome trace.

Kernels launched inside the benchmark's ``pb.engine_run`` ranges (the
`record_function` it wraps around the engine's launches in traced runs)
are the sweep kernels, whatever their names; they are found through the
correlation ids of their launch calls.  The host clock and the trace's
clock are tied by a ``pb.mark`` range recorded right after the window
opens.  Device activity is kept as one union over every card and per
card (an event's ``args.device``, else its ``pid``).
"""

from __future__ import annotations

import bisect
import json
import time
from pathlib import Path

ENGINE_RANGE = "pb.engine_run"
MARK = "pb.mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Window:
    """Start and stop one profiler window; `read` parses what it caught."""

    def __init__(self, out: Path, devices: list):
        import torch

        self._torch = torch
        self.cards = [d for d in devices if d.type == "cuda"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cards:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.out = Path(out)
        self.t_mark = self.t_stop = None

    def start(self) -> None:
        self.prof.start()
        self.t_mark = time.perf_counter()
        with self._torch.profiler.record_function(MARK):
            pass

    def stop(self) -> None:
        for d in self.cards:  # every card the engine spans
            self._torch.cuda.synchronize(d)
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.out))

    def read(self) -> dict:
        return parse(json.loads(self.out.read_text()), self.t_mark, self.t_stop)


def union(intervals) -> list[tuple[float, float]]:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def intersection(u: list, v: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(v):
        lo, hi = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        total += max(0.0, hi - lo)
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def parse(trace: dict, t_mark: float, t_stop: float) -> dict:
    """Device intervals in host seconds (``perf_counter``), over every card
    (``busy``) and by card (``busy_by_device``), the sweep kernels' time
    and launches, kernel time by name, from a Chrome trace."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"]
    if not marks:
        return {}
    offset = float(marks[0]["ts"]) - t_mark * 1e6  # trace us - host us

    def host(ts_us: float) -> float:
        return (float(ts_us) - offset) * 1e-6

    device, by_dev, by_corr, by_name = [], {}, {}, {}
    ranges, launches = [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = host(e["ts"])
        b = a + float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((a, b))
            by_dev.setdefault((e.get("args") or {}).get("device", e.get("pid")), []).append((a, b))
            if cat == "kernel":
                by_name[name] = by_name.get(name, 0.0) + (b - a)
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    by_corr[corr] = by_corr.get(corr, 0.0) + (b - a)
        elif name == ENGINE_RANGE and cat == "user_annotation":
            ranges.append((e.get("tid"), a, b))
        elif cat in ("cuda_runtime", "cuda_driver") and "Launch" in name:
            launches.append((e.get("tid"), a, (e.get("args") or {}).get("correlation")))
    by_tid: dict = {}
    for tid, a, b in sorted(ranges, key=lambda r: r[1]):
        by_tid.setdefault(tid, ([], []))
        by_tid[tid][0].append(a)
        by_tid[tid][1].append(b)
    engine_corr = set()
    for tid, t, c in launches:
        starts, ends = by_tid.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if c is not None and i >= 0 and t <= ends[i]:
            engine_corr.add(c)
    return {
        "t0": t_mark, "t1": t_stop,
        "busy": clip(union(device), t_mark, t_stop),
        "busy_by_device": {k: clip(union(v), t_mark, t_stop) for k, v in by_dev.items()},
        "engine_kernel_s": sum(by_corr.get(c, 0.0) for c in engine_corr),
        "engine_ranges": len(ranges),
        "kernels_by_name": by_name,
    }
