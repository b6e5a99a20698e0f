"""Per-device launch-skew detection for mesh engines.

On a mesh `SampleServer` every chunk is one launch per device, and the
launches are independent — so one slow device stretches EVERY chunk to
its pace while the skew stays invisible in the aggregate wall time.
`LaunchSkewMonitor` runs one `runtime.ft.StragglerMonitor` a device and
adds the cross-device comparison a single series cannot make: a device is
flagged when its launch time is anomalous against its OWN history (the
monitor's sigma test) or out of line with the OTHER devices of this
launch (relative skew against the device median).

The scheduler feeds the per-device times when telemetry is on and the
engine has a mesh: with the kernels on the card and a static chunk, each
device block's device seconds between the CUDA timing events around its
kernel (`SweepEngine.block_events`), once all of the launch's have
resolved; otherwise `SweepEngine.device_ready_times`, each device's ready
time on the host clock, synchronized in device order.  Detection is the
monitor's whole job; mitigation is an orchestration action.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.runtime.ft import StragglerMonitor


@dataclasses.dataclass
class SkewEvent:
    """One flagged (launch, device) pair, with the evidence."""

    launch: int
    device: int
    seconds: float
    device_median: float


class LaunchSkewMonitor:
    """Per-device `StragglerMonitor`s + cross-device relative skew.

    ``rel_threshold`` is the cross-device test: device d is skewed on a
    launch when ``t_d > rel_threshold * median(t)`` and the absolute gap
    clears ``min_gap_s`` (so microsecond jitter on near-instant launches
    never trips it).  The per-device test is StragglerMonitor's: warmup,
    sigma floor, no EMA poisoning by flagged launches.
    """

    def __init__(
        self,
        num_devices: int,
        rel_threshold: float = 2.0,
        min_gap_s: float = 1e-4,
        alpha: float = 0.1,
        threshold_sigma: float = 3.0,
        warmup_steps: int = 5,
    ):
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if rel_threshold <= 1.0:
            raise ValueError(f"rel_threshold must be > 1, got {rel_threshold}")
        self.num_devices = int(num_devices)
        self.rel_threshold = float(rel_threshold)
        self.min_gap_s = float(min_gap_s)
        self.monitors = [
            StragglerMonitor(alpha=alpha, threshold_sigma=threshold_sigma,
                             warmup_steps=warmup_steps)
            for _ in range(self.num_devices)
        ]
        self.launches = 0
        self.events: list[SkewEvent] = []

    def record(self, times) -> list[int]:
        """Feed one launch's per-device wall times; returns the flagged
        device indices (empty when the launch looks healthy)."""
        times = np.asarray(times, np.float64)
        if times.shape != (self.num_devices,):
            raise ValueError(
                f"expected {self.num_devices} per-device times, got shape {times.shape}"
            )
        med = float(np.median(times))
        flagged = []
        for d, (mon, t) in enumerate(zip(self.monitors, times)):
            t = float(t)
            own = mon.record(self.launches, t)
            rel = t > self.rel_threshold * med and t - med > self.min_gap_s
            if own or rel:
                flagged.append(d)
                self.events.append(SkewEvent(self.launches, d, t, med))
        self.launches += 1
        return flagged
