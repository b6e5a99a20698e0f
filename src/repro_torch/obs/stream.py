"""Per-chunk observable streaming: the tap the async front-end will drink.

A retired job reports one final summary (`core/observables.py`); a
MILLION-user service also needs the trajectory — energy traces, best
state so far — streamed back WHILE the job runs.  `ObservableStream` is
that tap: attach one to a `SampleServer` (``stream=``) and at every chunk
boundary the server hands it the live carry; the stream computes each
active job's per-slot energy/magnetization with the SAME batched
`observables` functions retirement uses, updates a best-so-far record,
appends to a bounded per-job trace, and fans the sample out to
subscribers.

The tap is OPT-IN because it is the one observability feature that is
not free: reading spins at a chunk boundary is a device->host transfer
of the whole slot pool each chunk, which also waits for the launch to
finish.  The telemetry event ring and metric counters cost nanoseconds;
this costs a fraction of a launch — pay it when a client is listening.

Contract: the stream only READS the carry (`SweepEngine.spins_flat` is a
pure read), so a streamed run is bit-identical to an untapped one.  A
front-end consumes exactly this interface: `subscribe` a callback that
forwards `ChunkSample`s over the wire.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core import observables


class ChunkSample(NamedTuple):
    """One job's observables at one chunk boundary."""

    jid: int
    sweeps_done: int  # job-local sweep clock
    sweeps_elapsed: int  # server-global sweep clock
    energy: np.ndarray  # (num_slots,) per-replica energies
    magnetization: np.ndarray  # (num_slots,)
    best_energy: float  # lowest per-replica energy seen so far


class BestState(NamedTuple):
    """Lowest-energy configuration a job has visited at a chunk boundary."""

    energy: float
    spins: np.ndarray  # flat (N,) layer-major
    sweeps_done: int


class ObservableStream:
    """Chunk-boundary observable tap over a `SampleServer`.

    ``trace_window`` bounds the retained per-job trace (a resident
    server streams forever; subscribers see every sample regardless).
    """

    def __init__(self, trace_window: int = 1024):
        if trace_window < 1:
            raise ValueError(f"trace_window must be >= 1, got {trace_window}")
        self.trace_window = int(trace_window)
        self._traces: dict[int, deque] = {}
        self._best: dict[int, BestState] = {}
        self._subscribers: list[Callable[[ChunkSample], None]] = []
        self.samples_taken = 0

    def subscribe(self, fn: Callable[[ChunkSample], None]) -> None:
        """Register a per-sample callback (the front-end's send hook)."""
        self._subscribers.append(fn)

    # -- the server-facing hook ----------------------------------------------

    def record(self, server) -> list[ChunkSample]:
        """Sample every active job of ``server`` at this chunk boundary.

        Called by `SampleServer.step` right after the launch completes
        (before hooks/retire, so the final chunk of a retiring job is
        included).  Reads spins once for the whole batch, then slices
        per job — one device->host transfer per chunk, not per job; the
        energies are the host `observables`' (float64), as at retirement.
        """
        if not server._active:
            return []
        eng = server.engine
        spins_all = eng.spins_flat(server.carry)  # (B, N) host copy
        sweeps_elapsed = server.sweeps_elapsed
        out = []
        for jid, (job, slots) in server._active.items():
            spins = spins_all[np.asarray(slots)]
            m = job.model_on(server)
            e = np.atleast_1d(observables.energies(m, spins))
            mag = np.atleast_1d(observables.magnetization(spins))
            k = int(np.argmin(e))
            best = self._best.get(jid)
            if best is None or float(e[k]) < best.energy:
                best = BestState(float(e[k]), spins[k].copy(), job.sweeps_done)
                self._best[jid] = best
            sample = ChunkSample(
                jid=jid,
                sweeps_done=job.sweeps_done,
                sweeps_elapsed=sweeps_elapsed,
                energy=e,
                magnetization=mag,
                best_energy=best.energy,
            )
            self._traces.setdefault(
                jid, deque(maxlen=self.trace_window)
            ).append(sample)
            out.append(sample)
        self.samples_taken += len(out)
        for sample in out:
            for fn in self._subscribers:
                fn(sample)
        return out

    # -- client-facing views ---------------------------------------------------

    def trace(self, jid: int) -> list[ChunkSample]:
        """The retained per-chunk samples of one job, oldest first."""
        return list(self._traces.get(jid, ()))

    def best(self, jid: int) -> BestState | None:
        """The job's lowest-energy visited configuration (None before its
        first sampled chunk)."""
        return self._best.get(jid)

    def forget(self, jid: int) -> None:
        """Drop a job's retained trace/best state (a front-end calls this
        once results are delivered, keeping a resident server bounded)."""
        self._traces.pop(jid, None)
        self._best.pop(jid, None)
