"""Fault-tolerance runtime: preemption handling, straggler detection,
elastic re-meshing.

Preemption / planned maintenance — SIGTERM arrives with a grace window.
``PreemptionHandler`` flips a flag that the serving loop checks between
chunks (`SampleServer.drain` with ``preemption=``) and the train loop
after each step (`launch.train`); the server finishes the chunk, writes a
blocking snapshot and returns, the trainer writes an emergency
checkpoint, and a later restore continues bit-exactly.

Stragglers — ``StragglerMonitor`` is an EMA anomaly detector over one
series of step (launch) times, fed by ``StepTimer`` in the train loop;
`obs.skew.LaunchSkewMonitor` runs one per mesh device.  Detection only:
mitigation is an orchestration action.

Node loss — ``elastic_plan`` recomputes a mesh shape from the surviving
device count, keeping the model axis.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import threading
import time
from typing import Optional


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag.

    Installation is cooperative: any handler that was already registered
    for the signal is chained (called after the flag is set) rather than
    clobbered, so embedding hosts — test harnesses, notebook kernels,
    process supervisors — keep their own SIGTERM behaviour.  Installs
    that the interpreter refuses (non-main thread, non-main interpreter,
    unsupported signal) are swallowed and reported via ``installed``;
    ``trigger()`` still works, so drive loops behave identically whether
    or not the OS-level hook landed.
    """

    def __init__(self, install: bool = True, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev: dict[int, object] = {}
        self.installed = False
        if install:
            for sig in signals:
                try:
                    self._prev[int(sig)] = signal.signal(sig, self._on_signal)
                    self.installed = True
                except (ValueError, OSError, RuntimeError, TypeError):
                    # non-main thread / non-main interpreter / bad signum
                    self._prev.pop(int(sig), None)

    def _on_signal(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(int(signum))
        # Chain a real previously-installed handler; SIG_DFL/SIG_IGN and
        # None (no previous Python-level handler) are not callable.
        if callable(prev):
            prev(signum, frame)

    def uninstall(self):
        """Put back whatever handlers we displaced (tests, embedders)."""
        for sig, prev in list(self._prev.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError, RuntimeError, TypeError):
                pass
        self._prev.clear()
        self.installed = False

    def trigger(self):  # for tests / manual drain
        self._flag.set()

    @property
    def should_exit(self) -> bool:
        return self._flag.is_set()


@dataclasses.dataclass
class StragglerMonitor:
    """EMA-based step-time anomaly detector (the reference's, number for
    number): after ``warmup_steps`` a time above ``mean +
    threshold_sigma * sigma`` is flagged, sigma floored at 5% of the mean,
    and a flagged time does not update the EMA."""

    alpha: float = 0.1
    threshold_sigma: float = 3.0
    warmup_steps: int = 5

    def __post_init__(self):
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.count = 0
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler event."""
        self.count += 1
        if self.mean is None:
            self.mean = seconds
            return False
        is_straggler = False
        if self.count > self.warmup_steps:
            # Relative floor on sigma: ordinary jitter (a few %) must never
            # trip the detector, even when the EMA variance is tiny after a
            # long stable run.
            sigma = max(math.sqrt(self.var), 0.05 * self.mean, 1e-9)
            if seconds > self.mean + self.threshold_sigma * sigma:
                is_straggler = True
                self.flagged.append((step, seconds, self.mean))
        # EMA update (skipped on flagged steps, so they do not poison it).
        if not is_straggler:
            delta = seconds - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return is_straggler


def elastic_plan(num_devices: int, *, model_parallel: int = 16, prefer_pods: bool = True):
    """Recompute a mesh shape after node loss.

    Keeps the model axis intact (TP degree is a property of the model
    sharding) and shrinks data/pod parallelism to the surviving devices.
    Returns (shape, axes), or raises ValueError if impossible.
    """
    if num_devices % model_parallel != 0:
        raise ValueError(
            f"{num_devices} devices cannot keep model_parallel={model_parallel}"
        )
    rest = num_devices // model_parallel
    if prefer_pods and rest % 16 == 0 and rest // 16 >= 2:
        return (rest // 16, 16, model_parallel), ("pod", "data", "model")
    return (rest, model_parallel), ("data", "model")


class StepTimer:
    """Context manager feeding the straggler monitor (host clock).  The
    train loop reads the step's loss inside it (``float(loss)``), which
    waits for the device: the time is the step's, not its enqueue's."""

    def __init__(self, monitor: StragglerMonitor, step: int):
        self.monitor = monitor
        self.step = step

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.is_straggler = self.monitor.record(self.step, self.seconds)
        return False
