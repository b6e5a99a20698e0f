"""SampleServer — continuous-batching annealing service over one SweepEngine.

ONE resident `SweepEngine` of ``slots`` replicas stays alive for the
server's lifetime, and every scheduling round advances the whole batch
by a chunk of sweeps as a single launch (with ``backend="cuda"`` one
launch of the rung's hand-written multisweep kernel).  Between chunks
the scheduler does the bookkeeping the card never sees:

  admit    ask the server's `AdmissionPolicy` which queued jobs enter the
           free slots (plus which active jobs to checkpoint-preempt for
           them); splice each admitted job's per-slot carry (spins,
           fields, beta, RNG lane columns) into its slots.  The round's
           fresh slots have their generators seeded in one vectorised
           pass (`SweepEngine.seed_slot_rngs`).
  chunk    ``min(chunk_sweeps, min remaining-in-segment over active
           jobs)`` — chunks never cross a segment boundary, so per-job
           beta schedules land exactly where a solo run would put them.
           ``chunk_sweeps="adaptive"`` replaces the static knob with
           `AdaptiveChunker`.
  hooks    jobs whose segment ended run `on_segment`; the anneal jobs'
           hook is a beta rewrite (`segment_betas`), and the step writes
           all of them in one `SweepEngine.set_slot_betas`.
  retire   one pass a step: every retiring slot's spins and beta read in
           one gather and copy a device (`SweepEngine.retire_rows`), the
           `core/observables.py` summaries evaluated over that stack a
           model at a time, each job finalized from its rows and its slots
           returned to the free list.

Determinism contract: a job's final spins/energy/RNG are bit-identical
whether it ran solo or packed with arbitrary neighbours across
admit/retire slot reuse, because (a) each slot owns private RNG lane
columns that advance by a fixed number of blocks per sweep regardless of
batch size, (b) chunk boundaries never change the stream position, and
(c) chunks stop at segment boundaries.  Idle slots keep sweeping whatever
they last held — wasted work, not wrong work; utilization is reported in
`stats()`.  The port's results are bit-identical to the JAX reference
server's for the same job list.

Admission is PLUGGABLE: ``policy="fifo"`` (strict submission order),
``"backfill"`` (priority classes, EASY backfill with exact reservations,
checkpoint-preemption) and ``"fair"`` (adds per-user weighted fairness).
Scheduling decides WHEN a job runs, never what it computes.

TELEMETRY: the server owns a `repro_torch.obs.Telemetry` registry that
`stats()` reads, plus a bounded ring of Chrome-trace events (scheduler
spans, one complete event per launch, async job lifecycles).  The spans
of one step, all on tid 0 and nested under ``sched.step``:
``sched.admit`` (``sched.admit.plan``: the policy's plan and a mesh's
rebalance; ``sched.admit.park``; ``sched.admit.init``: the round's
generators seeded and admitted jobs' slot carries built on the host;
``sched.admit.splice``: splice, resume
and tenant tables), ``sched.launch`` (the launch's enqueue),
``sched.wait`` (the host waiting, on purpose, for the launch's end
before retiring), ``sched.segment`` (the jobs' segment hooks; a ladder's
swap phase is ``pt.swap`` inside) and ``sched.retire`` (the retirement
pass: the read, the observables, finalize and the release of the slots).
Counters ``serve.slots_spliced`` (slots spliced or resumed by admission),
``serve.retire_passes`` and ``serve.retired_slots`` (retirement passes
and the slots they retired), ``serve.launch_device_s`` and
``serve.launches_timed`` (the timed launches' device seconds and count;
on a mesh a launch counts its slowest device's seconds there, and each
device's own under the label ``device=d``).  On CUDA devices with the
kernels (``backend="cuda"``) and a static chunk, a launch is timed on the
card by the pair of CUDA events that `SweepEngine.run` records right
around the kernels' C calls (on a mesh a pair a device block, on its
stream: `SweepEngine.block_events`), resolved without blocking (at a
later step, or where the host waits anyway: ``sched.wait``, the
profiler's start and stop, `stats`, the end of `drain`, the
exporters); its ``engine.launch``
box lands at its device start on the "device" track (tid 1), on a mesh
on device d's track "device <d>" (tid 1 + d), and the step never calls
`torch.cuda.synchronize` or waits for an event.  The adaptive chunker
(which needs each launch's time before the next), the plain version and
CPU engines time a launch on the host, to its end, and keep
``engine.launch`` on tid 0.

MULTI-TENANCY: ``multi_tenant=True`` builds a multi-tenant engine
(``SweepEngine.create([model] * slots)``): every slot starts on the
server's model, and a job carrying its own ``model=`` (same lattice,
own couplings) gets that model's coupling tables spliced into its slot
at admission, so one launch sweeps each slot with its own model
(``backend="cuda"``: the multi-tenant kernels).  A model-less job resets
its slot to the server's model, so a retired tenant's tables never leak.

The server runs every rung: "a4" and "cb" on both backends, the paper's
slower rungs a1-a3 (one model) on ``backend="torch"`` only; every exp
flavour ("fast", "accurate", "exact") on every backend.  Anneal jobs and
parallel-tempering jobs (`PTJob`, R slots each) share the launches.

MESH: ``mesh=`` (a `launch.mesh.SlotMesh`) lays the slot pool out over D
devices (``capacities=[...]`` per device, default the equal split) and
every chunk launches once per device.  The `SlotPool` keeps a free list
per device; ``placement="affine"`` (the default) packs a multi-slot job
onto one device when any has room and falls back to a spanning placement,
a chunk-boundary rebalancer migrates single slots (park + resume) to
clear a device for a queued ladder, and a PT ladder that spans devices
swaps from gathered energies (`SweepEngine.slot_energies`).  With
telemetry on, each launch's per-device seconds feed a
`obs.LaunchSkewMonitor` (``serve.straggler_events``, ``engine.straggler``
events): with the kernels and a static chunk each block's own device time
from its CUDA events, once all of the launch's have resolved; else the
host-timed ready times (`SweepEngine.device_ready_times`), which wait for
every device after every launch.  Placement changes which device a slot
sits on, never what a job computes: D devices, any capacities, affine or
flat, give the results of one device bit for bit, and every placement
decision is the reference's.

OBSERVATION: ``stream=`` attaches an `obs.ObservableStream`, an opt-in
per-chunk energy/magnetization/best-so-far tap over the active jobs (one
host copy of the pool's spins a chunk).  `arm_profiler` opens a
`torch.profiler` window (CPU + CUDA activities) around the next N
launches and writes its Chrome trace under a directory; a profiler that
fails to start, stop or export records a ``profiler.error`` event and
never stops serving.

RECOVERY (`serve_mc.snapshot`): ``snapshot_manager=`` (a
`ckpt.manager.CheckpointManager` or a directory) arms whole-server
snapshots — `snapshot()` on demand, ``snapshot_every_sweeps=K`` every K
sweeps at the step boundary through the manager's background writer —
and ``preemption=`` (a `runtime.ft.PreemptionHandler`) a graceful drain:
once triggered, `drain()` stops at the next chunk boundary, takes a
blocking snapshot and returns with ``preempted`` set.
`SampleServer.restore` continues a snapshot bit-exactly, the JAX
reference server's included.  With none of them armed, `step` runs
nothing more than before.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import time
from collections import Counter, defaultdict, deque
from typing import List

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import ising, observables
from repro_torch.core.engine import SweepEngine, normalize_capacities
from repro_torch.obs import LaunchSkewMonitor, Telemetry
from repro_torch.obs.telemetry import DEVICE_TID, card_index

from repro_torch.serve_mc.jobs import JobResult, RetiredRows


# -----------------------------------------------------------------------------
# Admission policies.
#
# A policy owns the queue of not-yet-running jobs and, between launches,
# PLANS one scheduling round: which queued jobs enter the free slots and
# which active jobs get checkpoint-preempted to make room.  The plan is
# pure bookkeeping over slot counts and exact remaining sweep budgets;
# the server executes it with the engine's slot APIs.  Policies never
# touch carries, so they cannot affect results.
# -----------------------------------------------------------------------------


def _job_cost(job) -> int:
    """Service demand in slot-sweeps (the unit fairness accounts in)."""
    return job.num_slots * job.total_remaining()


class SlotPool:
    """Free lists keyed by DEVICE over the global slot index space.

    The mesh lays the slots out as contiguous per-device blocks
    (`SweepEngine`'s mesh mode), so global slot ``b`` lives on the device
    whose capacity bracket holds it — a pure function of the index, which
    is what lets the scheduler name locality.  The pool keeps one SORTED
    free list per device and guards every transition: releasing a slot
    that is already free, or taking one that is not, raises instead of
    silently double-booking a launch.

    ``mode`` picks the allocation discipline:

    * ``"affine"`` (the default) packs a multi-slot job onto ONE device
      whenever any device has room — best-fit over the per-device free
      counts, so narrow jobs fill the emptiest-fitting device last and a
      wide ladder keeps finding whole devices — and falls back to a
      SPANNING placement (fewest devices, most-free first) only when
      fragmentation forces it.  Placement never changes results (slot
      state is slot-private); it changes which PT swap phases stay on the
      in-device fast path.
    * ``"flat"`` takes the lowest global indices first, devices ignored.

    With ``devices == 1`` the two modes coincide.  Every decision is the
    JAX reference's, call for call.
    """

    def __init__(
        self,
        slots: int,
        devices: int = 1,
        mode: str = "affine",
        capacities=None,
    ):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if mode not in ("affine", "flat"):
            raise ValueError(
                f"placement mode must be 'affine' or 'flat', got {mode!r}"
            )
        self.slots = int(slots)
        self.devices = int(devices)
        # One validation path with the engine: the equal split (which must
        # divide evenly) when capacities is None, else the explicit vector.
        self.capacities = normalize_capacities(self.devices, self.slots, capacities)
        # Largest per-device block: the bound on how wide a job can be
        # placed without spanning (planner gates check W <= cap).
        self.cap = max(self.capacities)
        self.mode = mode
        self._cum = [0]
        for c in self.capacities:
            self._cum.append(self._cum[-1] + c)
        self._free: list[list[int]] = [
            list(range(self._cum[d], self._cum[d + 1]))
            for d in range(self.devices)
        ]

    def device_of(self, b: int) -> int:
        """Device owning global slot ``b``: the prefix-sum bracket of the
        capacity vector (with equal capacities, ``b // (B/D)``)."""
        return bisect.bisect_right(self._cum, int(b)) - 1

    def _rel_free(self, d: int) -> float:
        """Free fraction of device ``d`` (0.0 for a zero-capacity device).

        Tie-break currency on heterogeneous pools: comparing absolute
        free counts would treat "2 of 8 free" as fuller than "1 of 1
        free"; relative capacity ranks devices by how full they really
        are.  On equal-capacity pools every comparison below reduces to
        the absolute-count order (same denominator).
        """
        c = self.capacities[d]
        return len(self._free[d]) / c if c else 0.0

    @property
    def total_free(self) -> int:
        return sum(len(f) for f in self._free)

    def free_by_device(self) -> list[int]:
        return [len(f) for f in self._free]

    def free_on(self, d: int) -> list[int]:
        return list(self._free[d])

    def flat_free(self) -> list[int]:
        """All free slots as one sorted global list (snapshot format)."""
        return [b for f in self._free for b in f]

    def clone(self) -> "SlotPool":
        out = SlotPool.__new__(SlotPool)
        out.slots, out.devices = self.slots, self.devices
        out.cap, out.mode = self.cap, self.mode
        out.capacities, out._cum = self.capacities, list(self._cum)
        out._free = [list(f) for f in self._free]
        return out

    def release(self, b: int) -> None:
        """Return one slot to its device's free list (sorted insert);
        raises on double-free — a slot on a free list twice silently
        double-books a later launch, the bug class this pool closes."""
        b = int(b)
        if not 0 <= b < self.slots:
            raise ValueError(f"slot {b} outside pool of {self.slots}")
        f = self._free[self.device_of(b)]
        i = bisect.bisect_left(f, b)
        if i < len(f) and f[i] == b:
            raise RuntimeError(f"slot {b} released twice (double-free)")
        f.insert(i, b)

    def release_all(self, slots) -> None:
        for b in slots:
            self.release(b)

    def take(self, slots) -> None:
        """Claim specific slots; raises if any is not currently free."""
        for b in slots:
            b = int(b)
            f = self._free[self.device_of(b)]
            i = bisect.bisect_left(f, b)
            if i >= len(f) or f[i] != b:
                raise RuntimeError(
                    f"slot {b} is not free (placement double-books slots)"
                )
            del f[i]

    def _take_lowest(self, d: int, n: int) -> list[int]:
        taken, self._free[d] = self._free[d][:n], self._free[d][n:]
        return taken

    def alloc(self, n: int, avoid: int | None = None) -> tuple[int, ...]:
        """Allocate ``n`` slots under the pool's placement mode.

        ``avoid`` (affine mode) steers the placement off one device —
        other devices are preferred at every stage — but is a preference,
        not a guarantee: callers enforcing a hard budget on the avoided
        device count the returned slots themselves.
        """
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > self.total_free:
            raise RuntimeError(
                f"alloc({n}) with only {self.total_free} slots free"
            )
        if self.mode == "flat":
            # Lowest global indices, devices ignored.
            taken: list[int] = []
            for d in range(self.devices):
                take = min(n - len(taken), len(self._free[d]))
                taken.extend(self._take_lowest(d, take))
                if len(taken) == n:
                    break
            return tuple(taken)
        # Device-affine: best-fit device (smallest RELATIVE free fraction
        # that still fits, then fewest absolute free, ties to the lowest
        # index) keeps the emptiest devices whole for wide ladders across
        # uneven capacity vectors; `avoid` is considered only when
        # nothing else fits.
        fits = [d for d in range(self.devices) if len(self._free[d]) >= n]
        pick = [d for d in fits if d != avoid] or fits
        if pick:
            d = min(pick, key=lambda d: (self._rel_free(d), len(self._free[d]), d))
            return tuple(self._take_lowest(d, n))
        # Spanning fallback: fragmentation forces a cross-device placement;
        # take from the relatively-emptiest devices first so the job
        # straddles as few devices as possible (the avoided device
        # contributes last).
        order = sorted(
            (d for d in range(self.devices) if self._free[d]),
            key=lambda d: (d == avoid, -self._rel_free(d), -len(self._free[d]), d),
        )
        taken = []
        for d in order:
            take = min(n - len(taken), len(self._free[d]))
            taken.extend(self._take_lowest(d, take))
            if len(taken) == n:
                break
        return tuple(taken)

    def restore_free(self, flat) -> None:
        """Reset the free lists from a flat global list (snapshot restore:
        the per-device keying is recomputed for THIS pool's device count,
        which is how a D=4 snapshot restores onto D=1 and vice versa)."""
        for f in self._free:
            f.clear()
        self.release_all(int(b) for b in flat)


class PlacementPlanner(int):
    """The free-pool view handed to `AdmissionPolicy.plan`.

    Subclasses ``int`` (its value is the free-slot count), so custom
    policies that treat ``free`` as the
    free-slot count (compare, subtract) keep working and may keep
    returning bare jobs — the server then places them itself.  Built-in
    policies use the placement API instead: `alloc`/`putback` simulate
    placements against a PRIVATE clone of the server's pool (the real
    pool mutates only when the server executes the plan), `release_job`
    models a planned preemption, and `slots_of` exposes where each active
    job sits so reservations can count freed slots per device.
    """

    def __new__(cls, pool: SlotPool, held: dict | None = None):
        return int.__new__(cls, pool.total_free)

    def __init__(self, pool: SlotPool, held: dict | None = None):
        self._pool = pool.clone()
        self._held = dict(held or {})  # id(job) -> slots tuple

    @classmethod
    def from_counts(cls, free: int, active=()) -> "PlacementPlanner":
        """A single-device planner synthesized from bare counts — the
        adapter behind direct ``plan(free_count, active)`` calls."""
        active = list(active)
        total = int(free) + sum(j.num_slots for j in active)
        pool = SlotPool(max(total, 1), devices=1)
        if total == 0:
            pool.take((0,))  # the padding slot is not actually free
        held, nxt = {}, int(free)
        for j in active:
            slots = tuple(range(nxt, nxt + j.num_slots))
            pool.take(slots)
            held[id(j)] = slots
            nxt += j.num_slots
        return cls(pool, held)

    @property
    def devices(self) -> int:
        return self._pool.devices

    @property
    def mode(self) -> str:
        return self._pool.mode

    @property
    def cap(self) -> int:
        return self._pool.cap

    @property
    def capacities(self) -> tuple:
        return self._pool.capacities

    @property
    def total_free(self) -> int:
        return self._pool.total_free

    def free_by_device(self) -> list[int]:
        return self._pool.free_by_device()

    def device_of(self, b: int) -> int:
        return self._pool.device_of(b)

    def slots_of(self, job) -> tuple:
        return self._held.get(id(job), ())

    def alloc(self, job, avoid: int | None = None) -> tuple[int, ...]:
        slots = self._pool.alloc(job.num_slots, avoid=avoid)
        self._held[id(job)] = slots
        return slots

    def putback(self, job) -> None:
        """Undo a simulated `alloc` (the candidate was rejected)."""
        self._pool.release_all(self._held.pop(id(job), ()))

    def release_job(self, job) -> tuple:
        """Model a planned preemption: the victim's slots free up."""
        slots = self._held.pop(id(job), ())
        self._pool.release_all(slots)
        return slots


class AdmissionPolicy:
    """FIFO admission: fill free slots in strict submission order.

    The base class doubles as the policy interface: `enqueue` receives
    submitted (and re-queued preempted) jobs, `plan` returns one round's
    ``(preempt_jobs, admit_jobs)`` given the free pool and the currently
    active jobs.  ``free`` arrives as a `PlacementPlanner` (an ``int``
    subclass whose value is the free-slot count): built-in policies call
    its placement API and return admits as ``(job, slots)`` pairs, while
    custom policies may keep treating it as a bare count and returning
    bare jobs — the server places those itself.  FIFO never preempts and
    never reorders, so a wide job at the queue head blocks everything
    behind it while slots idle — exactly the utilization leak the
    priority policies close.
    """

    name = "fifo"

    #: The server's sweep clock, refreshed before every `plan` call —
    #: policies that age waiting jobs (`PriorityBackfillPolicy`) read it;
    #: FIFO ignores it.
    clock = 0

    def __init__(self):
        self._queued: list = []
        self._seq = 0

    def enqueue(self, job) -> None:
        if getattr(job, "_seq", None) is None:
            job._seq = self._seq  # preempted jobs keep their original seq
            self._seq += 1
        self._queued.append(job)
        self._queued.sort(key=lambda j: j._seq)

    def __len__(self) -> int:
        return len(self._queued)

    def jobs(self) -> list:
        return list(self._queued)

    def plan(self, free, active: list) -> tuple[list, list]:
        planner = free if isinstance(free, PlacementPlanner) else None
        n_free = int(free)
        admit = []
        while self._queued and self._queued[0].num_slots <= n_free:
            job = self._queued.pop(0)
            n_free -= job.num_slots
            if planner is not None:
                admit.append((job, planner.alloc(job)))
            else:
                admit.append(job)  # a bare-count call: the server places it
        return [], admit


class PriorityBackfillPolicy(AdmissionPolicy):
    """Priority classes + EASY backfill + checkpoint-preemption, with
    optional per-user weighted fairness (``policy="fair"``).

    Candidate order: priority tiers are strict (higher first); within a
    tier, submission order — or, when ``fair=True``, weighted fair order:
    each user accumulates ``served += cost/weight`` (cost in slot-sweeps)
    as their jobs are admitted, and the tier is ordered by repeatedly
    taking the head job of the least-served user (deficit round-robin
    over user queues: a heavy user's backlog cannot starve a light one,
    because every admission pushes the heavy user's served level past the
    light user's).  A user entering the backlog is floored to the least
    served level of the users already waiting, so idle time cannot be
    banked into a later monopoly.

    One scheduling round walks the candidates:

    * fits -> admit.
    * first candidate that does NOT fit: try preemption — evict active
      jobs of strictly lower priority (lowest first) at this chunk
      boundary until the candidate fits; eviction parks each slot's
      carry (and coupling tables) for a later bit-exact resume, so
      preemption costs placement, never work.  If preemption cannot free
      enough, the candidate becomes the round's RESERVED job.
    * after a reservation exists, later candidates only BACKFILL: admit
      a candidate iff it fits the free list now and either (a) it
      retires within ``start`` sweeps — the reserved job's provably
      earliest start, when enough active jobs have retired — or (b) it
      needs no more than the ``spare`` slots left over at that start.
      Both are exact slot-count accounting over known budgets, so
      backfill can NEVER delay the reserved job.

    Reservation arithmetic (sweeps are the clock; all active slots
    advance in lockstep): with ``free`` slots free now and active jobs
    retiring after ``r_i`` more sweeps freeing ``k_i`` slots each, the
    reserved job (width W) starts at ``start = min r`` with
    ``free + sum(k_i : r_i <= r) >= W``, and
    ``spare = free + freed(start) - W``.

    PRIORITY AGING (``aging_sweeps > 0``): a queued job's EFFECTIVE
    priority for candidate ordering is ``priority + waited // aging_sweeps``
    with ``waited`` in sweeps since submission — so under sustained
    higher-tier traffic a priority-p job reaches tier p+k after at most
    ``k * aging_sweeps`` sweeps of waiting, which bounds cross-tier
    starvation.  Aging escalates ORDERING and
    reservation rights only; preemption keeps STATIC priorities (an aged
    priority-0 job may be admitted ahead of priority-1 arrivals, but never
    earns the right to evict genuinely higher-priority work).
    """

    def __init__(
        self,
        *,
        backfill: bool = True,
        preempt: bool = True,
        fair: bool = False,
        user_weights: dict[str, float] | None = None,
        aging_sweeps: int = 0,
    ):
        super().__init__()
        self.backfill = bool(backfill)
        self.preempt = bool(preempt)
        self.fair = bool(fair)
        self.user_weights = dict(user_weights or {})
        if aging_sweeps < 0:
            raise ValueError(f"aging_sweeps must be >= 0, got {aging_sweeps}")
        self.aging_sweeps = int(aging_sweeps)
        self.name = "fair" if self.fair else "backfill"
        self._served: dict[str, float] = {}  # user -> served cost / weight

    def _weight(self, user: str) -> float:
        w = float(self.user_weights.get(user, 1.0))
        if w <= 0:
            raise ValueError(f"user weight must be > 0, got {w} for {user!r}")
        return w

    def enqueue(self, job) -> None:
        if self.fair:
            backlogged = {j.user for j in self._queued}
            if job.user not in backlogged:
                # Entering the backlog: floor to the least-served waiting
                # user so service credit cannot be banked while idle.
                floor = min(
                    (self._served.get(u, 0.0) for u in backlogged),
                    default=0.0,
                )
                self._served[job.user] = max(
                    self._served.get(job.user, 0.0), floor
                )
            if len(self._served) > self.SERVED_LEDGER_MAX:
                # Compact: users with nothing queued re-enter floored
                # later, so dropping them only forfeits their surplus.
                keep = backlogged | {job.user}
                self._served = {
                    u: v for u, v in self._served.items() if u in keep
                }
        super().enqueue(job)

    def _eff_priority(self, job) -> int:
        """Ordering priority: static class plus one tier per
        ``aging_sweeps`` sweeps waited since submission."""
        if not self.aging_sweeps:
            return job.priority
        waited = max(0, self.clock - (job._submit_sweep or 0))
        return job.priority + waited // self.aging_sweeps

    def _order(self) -> list:
        """Queued jobs in admission-candidate order."""
        if not self.fair:
            return sorted(
                self._queued, key=lambda j: (-self._eff_priority(j), j._seq)
            )
        out = []
        tiers: dict[int, list] = defaultdict(list)
        for j in self._queued:
            tiers[self._eff_priority(j)].append(j)
        for prio in sorted(tiers, reverse=True):
            queues: dict[str, deque] = defaultdict(deque)
            for j in sorted(tiers[prio], key=lambda j: j._seq):
                queues[j.user].append(j)
            proj = {u: self._served.get(u, 0.0) for u in queues}
            while queues:
                u = min(queues, key=lambda v: (proj[v], v))
                j = queues[u].popleft()
                out.append(j)
                proj[u] += _job_cost(j) / self._weight(u)
                if not queues[u]:
                    del queues[u]
        return out

    #: Bound on the served-cost ledger; past it, users with no queued
    #: jobs are dropped (they re-enter floored, losing nothing but their
    #: surplus) so a resident server's memory stays bounded however many
    #: distinct user ids traffic brings.
    SERVED_LEDGER_MAX = 10_000

    def _charge(self, job) -> None:
        """Record an admission for fairness accounting.  Re-admissions of
        a preempted job are NOT re-charged: its full cost was charged
        when it first entered, and eviction already costs the user
        placement time — double-charging would penalize preemption
        victims twice."""
        if self.fair and job.parked is None:
            u = job.user
            self._served[u] = (
                self._served.get(u, 0.0) + _job_cost(job) / self._weight(u)
            )

    @staticmethod
    def _reservation(job, free: int, running: list) -> tuple[int, int]:
        """(start, spare) for a blocked ``job``: the exact sweep count at
        which enough slots will have retired, and the slots left over."""
        need = job.num_slots - free
        events = sorted((j.total_remaining(), j.num_slots) for j in running)
        acc, start = 0, None
        for r, k in events:
            acc += k
            if acc >= need:
                start = r
                break
        assert start is not None, "submit() bounds num_slots by server slots"
        freed = sum(k for r, k in events if r <= start)
        return start, free + freed - job.num_slots

    def _pick_victims(self, job, running: list, free: int) -> list | None:
        """Lowest-priority active jobs to evict so ``job`` fits, or None
        if even evicting every lower-priority job would not suffice."""
        need = job.num_slots - free
        cands = sorted(
            (v for v in running if v.priority < job.priority),
            key=lambda v: (v.priority, -v.num_slots, v.jid),
        )
        take: list = []
        got = 0
        for v in cands:
            take.append(v)
            got += v.num_slots
            if got >= need:
                break
        if got < need:
            return None
        # Trim overshoot: drop any victim whose slots we don't need
        # (smallest first), so preemption evicts the minimum set.
        for v in sorted(take, key=lambda v: (v.num_slots, -v.priority)):
            if got - v.num_slots >= need:
                take.remove(v)
                got -= v.num_slots
        return take

    def _reservation_placed(self, job, planner, running) -> tuple:
        """(start, spare, d_star, spare_dev) for a blocked ``job``.

        ``start``/``spare`` are the exact GLOBAL accounting of
        `_reservation`.  When the pool spans devices and the job fits on
        one (W <= slots-per-device), the reservation additionally pins
        ``d_star`` — the device provably able to host the job WHOLE at
        ``start`` (free slots now plus slots its running jobs retire by
        then) — and ``spare_dev``, d_star's start-time surplus beyond W.
        Condition-(b) backfill must keep that surplus intact: counting
        freed slots only globally lets a narrow admit occupy d_star past
        ``start`` and silently demote the wide job's single-device start
        to a spanning one.
        """
        start, spare = self._reservation(job, planner.total_free, running)
        d_star = spare_dev = None
        W = job.num_slots
        # Per-device protection only matters when placement is affine:
        # a flat pool ignores devices, so guarding one would change
        # admission timing for nothing in return.
        if (
            planner.devices > 1
            and planner.mode == "affine"
            and W <= planner.cap
        ):
            avail = planner.free_by_device()
            for j in running:
                if j.total_remaining() <= start:
                    for b in planner.slots_of(j):
                        avail[planner.device_of(b)] += 1
            # Only devices that can hold W at all are candidates (an
            # uneven pool may have devices smaller than the job); rank
            # by RELATIVE projected availability so a half-empty small
            # device does not outbid a nearly-empty big one.
            caps = planner.capacities
            feas = [d for d in range(planner.devices) if caps[d] >= W]
            if feas:
                best = max(
                    feas, key=lambda d: (avail[d] / caps[d], avail[d], -d)
                )
                if avail[best] >= W:
                    d_star, spare_dev = best, avail[best] - W
        return start, spare, d_star, spare_dev

    def _pick_victims(self, job, running: list, free: int) -> list | None:
        """Lowest-priority active jobs to evict so ``job`` fits, or None
        if even evicting every lower-priority job would not suffice."""
        need = job.num_slots - free
        cands = sorted(
            (v for v in running if v.priority < job.priority),
            key=lambda v: (v.priority, -v.num_slots, v.jid),
        )
        take: list = []
        got = 0
        for v in cands:
            take.append(v)
            got += v.num_slots
            if got >= need:
                break
        if got < need:
            return None
        # Trim overshoot: drop any victim whose slots we don't need
        # (smallest first), so preemption evicts the minimum set.
        for v in sorted(take, key=lambda v: (v.num_slots, -v.priority)):
            if got - v.num_slots >= need:
                take.remove(v)
                got -= v.num_slots
        return take

    def plan(self, free, active: list) -> tuple[list, list]:
        bare = not isinstance(free, PlacementPlanner)  # a custom policy's count
        planner = PlacementPlanner.from_counts(free, active) if bare else free
        preempt: list = []
        admit: list = []  # (job, slots) pairs
        running = list(active)  # original actives + planned admissions
        originals = set(id(j) for j in active)
        reservation = None  # (start, spare, d_star, spare_dev) of the blocked job
        for job in self._order():
            n = job.num_slots
            if reservation is None:
                if n <= planner.total_free:
                    admit.append((job, planner.alloc(job)))
                    self._charge(job)
                    running.append(job)
                    continue
                if self.preempt:
                    victims = self._pick_victims(
                        job,
                        [v for v in running if id(v) in originals],
                        planner.total_free,
                    )
                    if victims is not None:
                        for v in victims:
                            preempt.append(v)
                            running.remove(v)
                            originals.discard(id(v))
                            planner.release_job(v)
                        admit.append((job, planner.alloc(job)))
                        self._charge(job)
                        running.append(job)
                        continue
                if not self.backfill:
                    break
                reservation = self._reservation_placed(job, planner, running)
                continue
            # Backfill under the reservation: exact no-delay accounting.
            start, spare, d_star, spare_dev = reservation
            if n <= planner.total_free and job.total_remaining() <= start:
                # Retires before the reserved start: its slots (wherever
                # placed) are back by then, so it cannot erode the
                # reservation globally OR on d_star.
                admit.append((job, planner.alloc(job)))
                self._charge(job)
                running.append(job)
            elif n <= planner.total_free and n <= spare:
                # Fits the slots the reserved job spares — but only if it
                # also leaves d_star's start-time surplus intact, else a
                # narrow admit would force the wide job to span devices.
                slots = planner.alloc(job, avoid=d_star)
                if d_star is not None:
                    on_star = sum(
                        1 for b in slots if planner.device_of(b) == d_star
                    )
                    if on_star > spare_dev:
                        planner.putback(job)
                        continue
                    spare_dev -= on_star
                admit.append((job, slots))
                self._charge(job)
                running.append(job)
                reservation = (start, spare - n, d_star, spare_dev)
        for job, _ in admit:
            self._queued.remove(job)
        for job in preempt:
            # Evicted jobs go back in the queue under their ORIGINAL
            # submission seq, so they re-sort ahead of later arrivals of
            # the same priority/user and resume as soon as slots free up.
            self.enqueue(job)
        if bare:
            return preempt, [job for job, _ in admit]
        return preempt, admit


def make_policy(policy, user_weights=None, aging_sweeps=0) -> AdmissionPolicy:
    """``"fifo"`` | ``"backfill"`` | ``"fair"`` | an `AdmissionPolicy`."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    if policy == "fifo":
        if user_weights:
            raise ValueError("user_weights only apply to policy='fair'")
        if aging_sweeps:
            raise ValueError(
                "aging_sweeps applies to the priority policies "
                "('backfill'/'fair'); FIFO has no priorities to age"
            )
        return AdmissionPolicy()
    if policy == "backfill":
        return PriorityBackfillPolicy(
            fair=False, user_weights=user_weights, aging_sweeps=aging_sweeps
        )
    if policy == "fair":
        return PriorityBackfillPolicy(
            fair=True, user_weights=user_weights, aging_sweeps=aging_sweeps
        )
    raise ValueError(
        f"unknown policy {policy!r}; choose 'fifo', 'backfill', 'fair' or "
        "pass an AdmissionPolicy instance"
    )


class AdaptiveChunker:
    """Chunk-size policy: launch-cost EWMA + queue depth -> menu chunk.

    ``chunk_sweeps="adaptive"`` replaces the static knob.  Two pressures trade off: bigger chunks
    amortize per-launch overhead (throughput), smaller chunks reach
    admit/retire points sooner so queued jobs start earlier (latency).
    The policy measures the per-sweep launch cost as an EWMA and sizes
    the next chunk to a target launch wall time, shrunk by the current
    queue depth; the result is floored to a fixed power-of-two MENU so
    the set of distinct launch shapes stays bounded by ``len(menu)`` no
    matter how traffic fluctuates (chunks are additionally capped at
    segment boundaries, and every such clamp is floored to the menu too
    — 1 is always a member).

    Chunk size never changes results (the determinism contract), so
    adapting it on wall-clock measurements is safe.

    An instance holds per-engine state (the EWMA and the set of
    already-seen chunk sizes): give each `SampleServer` its OWN chunker.
    """

    def __init__(
        self,
        target_launch_s: float = 0.05,
        max_chunk: int = 64,
        init_chunk: int = 8,
        alpha: float = 0.3,
    ):
        if max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
        menu = [1]
        while menu[-1] * 2 <= max_chunk:
            menu.append(menu[-1] * 2)
        self.menu = tuple(menu)
        self.target_launch_s = float(target_launch_s)
        self.init_chunk = int(init_chunk)
        self.alpha = float(alpha)
        self.per_sweep_ewma: float | None = None
        self._warm: set[int] = set()  # chunk sizes already launched once

    def floor_to_menu(self, k: int) -> int:
        """Largest menu chunk <= max(1, k)."""
        k = max(1, int(k))
        out = 1
        for c in self.menu:
            if c <= k:
                out = c
        return out

    def propose(self, queue_depth: int, segment_bound: int) -> int:
        """Next chunk: cost-targeted, queue-shrunk, boundary-capped."""
        if self.per_sweep_ewma is None or self.per_sweep_ewma <= 0.0:
            desired = float(self.init_chunk)
        else:
            desired = self.target_launch_s / self.per_sweep_ewma
        desired = desired / (1 + queue_depth)
        return self.floor_to_menu(int(min(desired, segment_bound)))

    def observe(self, chunk: int, launch_s: float) -> None:
        if chunk not in self._warm:
            # The first launch at a chunk size pays one-time set-up (the
            # kernel build, allocator warm-up) — far above steady state;
            # recording it would collapse the policy to chunk=1 for the
            # whole warm-up ramp.  Discard it.
            self._warm.add(chunk)
            return
        per_sweep = launch_s / max(1, chunk)
        if self.per_sweep_ewma is None:
            self.per_sweep_ewma = per_sweep
        else:
            self.per_sweep_ewma += self.alpha * (per_sweep - self.per_sweep_ewma)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every `SampleServer` construction knob as one value object.

    ``SampleServer(model, config=cfg)`` and ``SampleServer(model, slots=8,
    ...)`` are the same thing: bare kwargs are folded into the config
    (kwargs win over a config's field when both are given).  The port's
    defaults serve on the card: ``backend="cuda"``, ``V=128``,
    ``device="cuda"``; pass ``backend="torch", device="cpu"`` (any V) for
    the plain version on the CPU.  ``multi_tenant=True`` admits jobs that
    carry their own model.  ``replica_tile`` goes to the engine
    (`SweepEngine.create`; backend "cuda" only).  ``mesh`` (a
    `launch.mesh.SlotMesh` on ``device``'s type) and ``capacities`` lay the
    slots out over several devices; ``placement`` is the slot-placement
    mode, "affine" or "flat" (alike on one device).
    ``stream``, ``snapshot_manager``, ``snapshot_every_sweeps`` and
    ``preemption`` arm observation and recovery (module docstring).
    """

    slots: int = 8
    chunk_sweeps: int | str = 8
    rung: str = "cb"
    backend: str = "cuda"
    V: int = 128
    exp_flavor: str | None = None
    device: str = "cuda"
    idle_seed: int = 0
    chunker: "AdaptiveChunker | None" = None
    policy: object = "fair"
    user_weights: dict | None = None
    aging_sweeps: int = 0
    wait_window: int = 256
    telemetry: object = True
    multi_tenant: bool = False
    replica_tile: int | None = None
    placement: str = "affine"
    mesh: object = None
    capacities: tuple | None = None
    stream: object = None
    snapshot_manager: object = None
    snapshot_every_sweeps: int = 0
    preemption: object = None


class SampleServer:
    """Schedules a queue of jobs onto the batch dim of one engine.

    Construction: ``SampleServer(model, config=ServeConfig(...))`` or bare
    kwargs (``SampleServer(model, slots=8, ...)``) folded into the config;
    the merged config is kept as ``self.config``.
    """

    def __init__(
        self,
        model: ising.LayeredModel,
        *,
        config: ServeConfig | None = None,
        **kwargs,
    ):
        if config is None:
            cfg = ServeConfig(**kwargs)  # TypeError names unknown kwargs
        elif kwargs:
            cfg = dataclasses.replace(config, **kwargs)
        else:
            cfg = config
        if cfg.placement not in ("affine", "flat"):
            raise ValueError(
                f"placement mode must be 'affine' or 'flat', got {cfg.placement!r}"
            )
        self.config = cfg
        chunk_sweeps = cfg.chunk_sweeps
        if chunk_sweeps == "adaptive":
            self._chunker = cfg.chunker or AdaptiveChunker()
        elif isinstance(chunk_sweeps, str):
            raise ValueError(
                f"chunk_sweeps must be an int >= 1 or 'adaptive', got {chunk_sweeps!r}"
            )
        elif chunk_sweeps < 1:
            raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
        else:
            self._chunker = None
        self.multi_tenant = bool(cfg.multi_tenant)
        # One constructor path for both tenancy shapes: a multi-tenant
        # server starts every slot on the server's model.
        self.engine = SweepEngine.create(
            [model] * cfg.slots if self.multi_tenant else model,
            rung=cfg.rung,
            backend=cfg.backend,
            batch=None if self.multi_tenant else cfg.slots,
            V=cfg.V,
            exp_flavor=cfg.exp_flavor,
            device=cfg.device,
            replica_tile=cfg.replica_tile,
            mesh=cfg.mesh,
            capacities=cfg.capacities,
        )
        # Idle slots hold (and keep sweeping) this placeholder state until
        # a job is spliced over it.
        self.carry = self.engine.init_carry(seed=cfg.idle_seed)
        self.chunk_sweeps = None if self._chunker else int(chunk_sweeps)
        self.policy = make_policy(cfg.policy, cfg.user_weights, cfg.aging_sweeps)
        self._active: dict[int, tuple] = {}  # jid -> (job, slots tuple)
        self._next_jid = 0
        # The one metrics registry: stats(), the Prometheus/JSON exporters
        # and the Chrome trace all read it.  telemetry=False only silences
        # EVENT recording — counters keep counting because stats() is
        # built on them.
        telemetry = cfg.telemetry
        self.telemetry = (
            telemetry if isinstance(telemetry, Telemetry) else Telemetry(enabled=bool(telemetry))
        )
        self.telemetry.name_thread(0, "scheduler")
        tel = self.telemetry
        self._c_launches = tel.counter("serve.launches")
        # the global sweep clock (sum of chunks), read via .sweeps_elapsed
        self._c_sweeps = tel.counter("serve.sweeps_elapsed")
        self._c_busy = tel.counter("serve.busy_slot_sweeps")
        self._c_total = tel.counter("serve.total_slot_sweeps")
        self._c_preempt = tel.counter("serve.preemptions")
        self._c_submitted = tel.counter("serve.jobs_submitted")
        self._c_completed = tel.counter("serve.jobs_completed")
        self._c_straggler = tel.counter("serve.straggler_events")
        self._h_wait = tel.histogram("serve.queue_wait_s")
        # Placement decisions and PT swap routing: affine = all of a job's
        # slots on one device; swap_local = a ladder's swap phase found its
        # replicas on one device of the mesh.
        self._c_place_affine = tel.counter("sched.placements_affine")
        self._c_place_span = tel.counter("sched.placements_spanning")
        self._c_migrations = tel.counter("sched.rebalance_migrations")
        self._c_swap_local = tel.counter("pt.swap_local")
        self._c_swap_cross = tel.counter("pt.swap_cross")
        # Rounds whose swap phase ran as the kernel (csrc/pt_swap.cu).  Not in
        # a snapshot (its layout is the reference's): a restore counts from 0.
        self._c_swap_fused = tel.counter("pt.swap_fused")
        self._c_spliced = tel.counter("serve.slots_spliced")
        # Retirement passes that retired a slot, and the slots they retired:
        # their ratio is the pass's stack height.
        self._c_retire_passes = tel.counter("serve.retire_passes")
        self._c_retired_slots = tel.counter("serve.retired_slots")
        # Timed launches: their device seconds (CUDA events on the card, the
        # host wall of the launch elsewhere) and how many were timed.
        self._c_launch_s = tel.counter("serve.launch_device_s")
        self._c_timed = tel.counter("serve.launches_timed")
        # Chunk sizes already launched: the first launch at a size pays
        # one-time set-up, and its trace event says so (compile=True).
        self._warm_chunks: set[int] = set()
        self.devices = len(self.engine.mesh) if self.engine.mesh is not None else 1
        # Free lists keyed by device over the mesh's per-device blocks.
        self._pool = SlotPool(
            self.slots, devices=self.devices, mode=cfg.placement,
            capacities=self.engine.capacities,
        )
        self._skew = LaunchSkewMonitor(self.devices) if self.devices > 1 else None
        # Each mesh device's timed launches: its device seconds and count.
        self._c_device_s = [tel.counter("serve.launch_device_s", device=d)
                            for d in range(self.devices)] if self.devices > 1 else []
        self._c_device_timed = [tel.counter("serve.launches_timed", device=d)
                                for d in range(self.devices)] if self.devices > 1 else []
        # The kernels on CUDA devices with a static chunk: launches are
        # timed by CUDA events on the card (module docstring), each device's
        # on its own track, placed on the telemetry clock through one anchor
        # a card, taken now and renewed at `sched.wait`.
        self._event_timing = (
            self.engine.device.type == "cuda" and self.engine.backend == "cuda"
            and self._chunker is None
        )
        self._last_end: list = []  # the end events of the newest timed launch
        if self._event_timing:
            mesh = self.engine.mesh
            devs = list(mesh or [self.engine.device])
            self._cards = list(dict.fromkeys(devs))
            # (track, card) of each device: "device" on one, "device <d>" on a mesh.
            self._tracks = [(DEVICE_TID + d, card_index(dev)) for d, dev in enumerate(devs)]
            for d, (tid, _) in enumerate(self._tracks):
                tel.name_thread(tid, "device" if mesh is None else f"device {d}")
            for dev in self._cards:
                tel.anchor_device(dev)
        # Queue-wait samples (user, priority, wait_s, wait_sweeps), taken
        # at FIRST admission; bounded so a resident server never grows it
        # without limit.
        self._wait_records: deque = deque(maxlen=100_000)
        if cfg.wait_window < 1:
            raise ValueError(f"wait_window must be >= 1, got {cfg.wait_window}")
        self._wait_recent: deque = deque(maxlen=int(cfg.wait_window))
        # Retirement log (jids in retirement order), bounded like the wait
        # ring; snapshots persist it.
        self._retired: deque = deque(maxlen=100_000)
        self.stream = cfg.stream
        self._profiler: dict | None = None
        snapshot_manager = cfg.snapshot_manager
        if isinstance(snapshot_manager, (str, os.PathLike)):
            snapshot_manager = CheckpointManager(str(snapshot_manager))
        self.snapshot_manager = snapshot_manager
        if cfg.snapshot_every_sweeps < 0:
            raise ValueError(
                f"snapshot_every_sweeps must be >= 0, got {cfg.snapshot_every_sweeps}"
            )
        if cfg.snapshot_every_sweeps and snapshot_manager is None:
            raise ValueError("snapshot_every_sweeps needs a snapshot_manager (or directory)")
        self.snapshot_every_sweeps = int(cfg.snapshot_every_sweeps)
        self.preemption = cfg.preemption
        self.preempted = False
        self._last_snapshot_sweep = 0

    # -- submission -----------------------------------------------------------

    @property
    def slots(self) -> int:
        return self.engine.batch

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_queued(self) -> int:
        return len(self.policy)

    @property
    def launches(self) -> int:
        return self._c_launches.value

    @property
    def busy_slot_sweeps(self) -> int:
        return self._c_busy.value

    @property
    def total_slot_sweeps(self) -> int:
        return self._c_total.value

    @property
    def sweeps_elapsed(self) -> int:
        return self._c_sweeps.value

    @property
    def preemptions(self) -> int:
        return self._c_preempt.value

    @property
    def launch_chunks(self) -> Counter:
        """chunk size -> launch count, rebuilt from the labeled counter."""
        return Counter(
            {
                int(labels["chunk"]): int(value)
                for labels, value in self.telemetry.series("serve.launches_by_chunk")
            }
        )

    def submit(self, job) -> int:
        """Enqueue a job; returns its assigned job id."""
        if job.num_slots > self.slots:
            raise ValueError(f"job needs {job.num_slots} slots, server has {self.slots}")
        if job.jid is not None:
            raise ValueError(f"job already submitted (jid={job.jid})")
        if getattr(job, "model", None) is not None:
            if not self.multi_tenant:
                raise ValueError(
                    "job carries its own model; this server is single-model "
                    "— construct it with multi_tenant=True"
                )
            self.engine.check_model(job.model)  # reject a topology mismatch now
        job.jid = self._next_jid
        self._next_jid += 1
        job._submit_time = time.perf_counter()
        job._submit_sweep = self.sweeps_elapsed
        job._admit_time = None
        self.policy.enqueue(job)
        self._c_submitted.add(1)
        self.telemetry.async_begin(
            "job",
            job.jid,
            kind=job.kind,
            slots=job.num_slots,
            priority=job.priority,
            user=job.user,
            submit_sweep=job._submit_sweep,
        )
        return job.jid

    # -- scheduling -----------------------------------------------------------

    def _admit(self) -> None:
        """One planning round at a chunk boundary: the policy decides, the
        server executes (park preempted jobs, place admitted ones)."""
        tel = self.telemetry
        # Refresh the policy's sweep clock first: priority aging reads it.
        self.policy.clock = self.sweeps_elapsed
        with tel.span("sched.admit.plan"):
            if self._pool.mode == "affine" and self.devices > 1:
                self._rebalance()
            planner = PlacementPlanner(
                self._pool,
                {id(j): slots for j, slots in self._active.values()},
            )
            free_before = planner.total_free
            preempts, admits = self.policy.plan(planner, [j for j, _ in self._active.values()])
        # Built-in policies return (job, slots) placements; custom
        # policies may return bare jobs — the server places those.
        admits = [e if isinstance(e, tuple) else (e, None) for e in admits]
        if preempts or admits:
            tel.instant(
                "sched.plan",
                policy=self.policy.name,
                free=free_before,
                queued=len(self.policy),
                admitted=[j.jid for j, _ in admits],
                preempted=[j.jid for j in preempts],
            )
        if preempts:
            with tel.span("sched.admit.park"):
                for job in preempts:
                    self._park(job)
        fresh = [job for job, _ in admits if job.parked is None]
        rngs = {}  # a fresh job's slot generators, seeded in one pass
        if fresh:
            with tel.span("sched.admit.init"):
                seeds = [job.slot_seeds(self) for job in fresh]
                states = iter(self.engine.seed_slot_rngs([r for rows in seeds for r in rows]))
                rngs = {id(job): [next(states) for _ in rows] for job, rows in zip(fresh, seeds)}
        for job, slots in admits:
            self._place(job, slots, rngs.get(id(job)))

    def _park(self, job) -> None:
        """Checkpoint-preempt an active job: extract each slot's carry into
        the job's ``parked`` list and free the slots."""
        _, taken = self._active.pop(job.jid)
        job.parked = [self.engine.slot(b).park(self.carry) for b in taken]
        job.preemptions += 1
        self._c_preempt.add(1)
        self._pool.release_all(taken)  # raises on double-free
        self.telemetry.async_instant(
            "job", job.jid, phase="park", reason="preempt", sweeps_done=job.sweeps_done
        )

    def _place(self, job, placement, rngs) -> None:
        """Splice a job into free slots: fresh init on first admission
        (``rngs``: its slots' generators, seeded by `_admit`), parked-state
        resume after a preemption."""
        if placement is None:
            if job.num_slots > self._pool.total_free:
                raise RuntimeError(
                    f"policy {self.policy.name!r} admitted job {job.jid} needing "
                    f"{job.num_slots} slots with only {self._pool.total_free} free"
                )
            taken = self._pool.alloc(job.num_slots)
        else:
            taken = tuple(int(b) for b in placement)
            self._pool.take(taken)  # raises if the plan double-booked a slot
        devs = sorted({self._pool.device_of(b) for b in taken})
        if self.devices > 1:
            affine = len(devs) == 1
            (self._c_place_affine if affine else self._c_place_span).add(1)
            self.telemetry.instant(
                "sched.placement", jid=job.jid, slots=list(taken), devices=devs,
                affine=affine, mode=self._pool.mode,
            )
        tel = self.telemetry
        if job.parked is not None:
            model = job.model_on(self) if self.multi_tenant else None
            with tel.span("sched.admit.splice"):
                for b, parked in zip(taken, job.parked):
                    self.carry = self.engine.slot(b).resume(self.carry, parked, model=model)
            job.parked = None
        else:
            with tel.span("sched.admit.init"):
                carries = job.init_carries(self, rngs)
            with tel.span("sched.admit.splice"):
                for b, slot_carry in zip(taken, carries):
                    if self.multi_tenant:
                        # The slot sweeps the job's model from now on; a job
                        # without one resets the slot to the server's model.
                        self.engine.set_slot_model(b, job.model_on(self))
                    self.carry = self.engine.slot(b).splice(self.carry, slot_carry)
        self._c_spliced.add(len(taken))
        if job._admit_time is None:
            job._admit_time = time.perf_counter()
            job._admit_sweep = self.sweeps_elapsed
            wait_s = job._admit_time - job._submit_time
            wait_sweeps = self.sweeps_elapsed - job._submit_sweep
            self._wait_records.append((job.user, job.priority, wait_s, wait_sweeps))
            self._wait_recent.append((wait_s, wait_sweeps))
            self._h_wait.observe(wait_s)
            self.telemetry.async_instant(
                "job", job.jid, phase="admit", slots=list(taken),
                wait_s=wait_s, wait_sweeps=wait_sweeps,
            )
        else:
            self.telemetry.async_instant(
                "job", job.jid, phase="resume", slots=list(taken),
                sweeps_done=job.sweeps_done,
            )
        self._active[job.jid] = (job, taken)

    def _rebalance(self) -> None:
        """Chunk-boundary defragmentation (affine mode, ``devices > 1``).

        When a queued multi-slot job would fit one device (W no wider
        than the largest per-device capacity) and fits the pool
        globally, but fragmentation leaves no single device with W free,
        migrate active slots OFF the relatively-most-free device that
        can hold W until it can host the job whole.  Each migration is a
        park+resume pair (slot state is position- and device-independent),
        so rebalancing changes placement, never results.  Invariants: the
        total free count is unchanged (one release per alloc); migrations
        happen only at the chunk boundary (the same safety point as
        preemption); a migrated slot never lands back on the target
        device (the loop stops if fragmentation leaves nowhere else).
        """
        pool = self._pool
        target = None
        for job in self.policy.jobs():
            W = job.num_slots
            if (
                1 < W <= pool.cap
                and W <= pool.total_free
                and max(pool.free_by_device()) < W
            ):
                target = job
                break
        if target is None:
            return
        free_by = pool.free_by_device()
        caps = pool.capacities
        # Migration target: relatively-emptiest device big enough to
        # host the job whole (absolute free, then lowest index, as ties).
        feas = [d for d in range(self.devices) if caps[d] >= target.num_slots]
        if not feas:
            return
        d_t = max(
            feas,
            key=lambda d: (
                free_by[d] / caps[d] if caps[d] else 0.0,
                free_by[d],
                -d,
            ),
        )
        need = target.num_slots - free_by[d_t]
        if need > pool.total_free - free_by[d_t]:
            return  # nowhere else to absorb the displaced slots
        # Occupied slots on the target device, preferring single-slot
        # jobs (moving one rung of a resident ladder would split it) and
        # higher indices (displaced state re-packs lowest-first).
        occupants = []
        for jid, (job, slots) in self._active.items():
            for i, b in enumerate(slots):
                if pool.device_of(b) == d_t:
                    occupants.append((job.num_slots != 1, -b, jid, i, b))
        occupants.sort()
        moved = 0
        for _, _, jid, i, b_src in occupants:
            if moved >= need:
                break
            job, slots = self._active[jid]
            (b_dst,) = pool.alloc(1, avoid=d_t)
            if pool.device_of(b_dst) == d_t:
                pool.release(b_dst)  # only d_t itself had room: stop
                break
            parked = self.engine.slot(b_src).park(self.carry)
            model = job.model_on(self) if self.multi_tenant else None
            self.carry = self.engine.slot(b_dst).resume(
                self.carry, parked, model=model
            )
            new_slots = list(slots)
            new_slots[i] = b_dst
            self._active[jid] = (job, tuple(new_slots))
            pool.release(b_src)
            moved += 1
            self._c_migrations.add(1)
            self.telemetry.async_instant(
                "job",
                jid,
                phase="migrate",
                src=int(b_src),
                dst=int(b_dst),
                reason=f"defrag_device_{d_t}",
            )
        if moved:
            self.telemetry.instant(
                "sched.rebalance",
                device=d_t,
                migrated=moved,
                for_jid=target.jid,
                free_by_device=pool.free_by_device(),
            )

    def arm_profiler(self, logdir: str, num_chunks: int = 4) -> None:
        """Arm a `torch.profiler` window (CPU + CUDA activities) around the
        next ``num_chunks`` engine launches: the kernels' device timeline,
        which the scheduler's own trace cannot see.  The window opens right
        before the next launch and closes after the Nth, writing
        ``<logdir>/trace.json`` (Chrome trace, Perfetto-loadable).  A
        failure to start, stop or export becomes a ``profiler.error``
        event, never an exception: profiling must not kill a resident
        server."""
        if num_chunks < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        self._profiler = {"logdir": str(logdir), "remaining": int(num_chunks), "prof": None}

    def _start_profiler(self) -> None:
        p, tel = self._profiler, self.telemetry
        tel.poll_device(block=True)  # earlier launches resolve outside the window
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as e:  # the profiler's own failure; serving goes on
            tel.instant("profiler.error", error=str(e))
            self._profiler = None
            return
        p["prof"] = prof
        tel.instant("profiler.start", logdir=p["logdir"])

    def _stop_profiler(self) -> None:
        p, tel = self._profiler, self.telemetry
        self._profiler = None
        tel.poll_device(block=True)  # the window's launches resolve inside it
        path = os.path.join(p["logdir"], "trace.json")
        try:
            p["prof"].stop()
            os.makedirs(p["logdir"], exist_ok=True)
            p["prof"].export_chrome_trace(path)
        except Exception as e:  # the profiler's own failure; serving goes on
            tel.instant("profiler.error", error=str(e))
            return
        tel.instant("profiler.stop", path=path)

    def _launch(self, chunk: int):
        """Enqueue one engine launch and count it.  On CUDA devices with
        the kernels, telemetry on and a static chunk, the engine's CUDA
        event pair around the launch (on a mesh, around each device
        block's) goes onto the telemetry's device track (resolved later,
        without blocking) and None is returned.  Otherwise ``(t0, warm)`` when the launch is to be
        timed on the host (telemetry on, or an adaptive chunker), which
        `_settle_launch` waits for and records, else None."""
        tel = self.telemetry
        if self._profiler is not None and self._profiler["prof"] is None:
            self._start_profiler()
        warm = chunk in self._warm_chunks
        pending = None
        if self._event_timing and tel.enabled:
            self.carry = self.engine.run(self.carry, chunk)
            self._queue_blocks(chunk, warm)
        else:
            if self._chunker is not None or tel.enabled:
                pending = (time.perf_counter(), warm)
            self.carry = self.engine.run(self.carry, chunk)
        self._warm_chunks.add(chunk)
        self._c_launches.add(1)
        tel.counter("serve.launches_by_chunk", chunk=chunk).add(1)
        self._c_sweeps.add(chunk)
        return pending

    def _queue_blocks(self, chunk: int, warm: bool) -> None:
        """Queue each device block's launch interval (`SweepEngine.
        block_events`) on its device's track.  Once all of the launch's
        have resolved, the slowest block's seconds count as the launch's.
        On a mesh each resolved interval also counts on its device's
        labelled counters, and the launch's per-device seconds feed the
        skew monitor (a device that launched nothing reads 0)."""
        tel = self.telemetry
        mesh = self.devices > 1
        events = self.engine.block_events()
        times = np.zeros(self.devices)
        left = sum(ev is not None for ev in events)

        def resolved(d):
            def on_done(dt):
                nonlocal left
                times[d], left = dt, left - 1
                if mesh:
                    self._observe_device(d, dt)
                if not left:
                    self._observe_launch(chunk, warm, float(times.max()))
                    if mesh:
                        self._check_skew(times)
            return on_done

        for d, ev in enumerate(events):
            if ev is not None:
                tid, card = self._tracks[d]
                args = dict(chunk=chunk, jobs=len(self._active), devices=self.devices)
                if mesh:
                    args["device"] = d
                tel.device_interval("engine.launch", *ev, resolved(d), tid=tid, card=card,
                                    **args, compile=not warm)
        self._last_end = [ev[1] for ev in events if ev is not None]

    def _observe_launch(self, chunk: int, warm: bool, dt: float) -> None:
        """Count one timed launch of ``dt`` seconds."""
        self._c_launch_s.add(dt)
        self._c_timed.add(1)
        self.telemetry.histogram("serve.launch_s", phase="steady" if warm else "compile").observe(dt)

    def _observe_device(self, d: int, dt: float) -> None:
        """Count mesh device ``d``'s share of a timed launch: ``dt`` seconds."""
        self._c_device_s[d].add(dt)
        self._c_device_timed[d].add(1)

    def _check_skew(self, times) -> None:
        """Feed one launch's per-device seconds to the skew monitor; count
        and trace the devices it flags."""
        flagged = self._skew.record(times)
        if flagged:
            self._c_straggler.add(len(flagged))
            self.telemetry.instant(
                "engine.straggler", cat="engine", devices=flagged,
                times_s=[float(t) for t in times],
            )

    def _settle_launch(self, chunk: int, pending) -> None:
        """Record a launch timed on the host; close an armed profiler window
        after its last launch."""
        if pending is not None:
            self._record_launch(chunk, pending)
        if self._profiler is not None and self._profiler["prof"] is not None:
            self._profiler["remaining"] -= 1
            if self._profiler["remaining"] <= 0:
                self._stop_profiler()

    def _record_launch(self, chunk: int, pending) -> None:
        """Wait for a launch timed on the host and record its wall time.  On
        a mesh with telemetry on, the launch's per-device ready times
        (`SweepEngine.device_ready_times`) count on each launching device's
        labelled counters and feed the skew monitor, so one straggling
        device is flagged, not averaged into the wall time."""
        t0, warm = pending
        tel = self.telemetry
        if self._skew is not None and tel.enabled:
            times = self.engine.device_ready_times(self.carry, t0)
            dt = float(times.max())
            for d, t in enumerate(times):
                if self.engine.capacities[d]:
                    self._observe_device(d, float(t))
            self._check_skew(times)
        else:
            if self.engine.device.type == "cuda":
                for dev in sorted({str(d) for d in (self.engine.mesh or [self.engine.device])}):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        if self._chunker is not None:
            self._chunker.observe(chunk, dt)
        self._observe_launch(chunk, warm, dt)
        tel.complete(
            "engine.launch",
            dur_us=dt * 1e6,
            cat="engine",
            chunk=chunk,
            jobs=len(self._active),
            devices=self.devices,
            compile=not warm,
        )

    def _wait_launch(self) -> None:
        """The host waits, on purpose, for the newest launch's end event of
        every device (`sched.wait`) before retirement's first device-to-host
        copy, so that `sched.retire` holds host work only; every queued
        launch is resolved and each card's clock anchor renewed meanwhile.
        A launch timed on the host has been waited for already."""
        tel = self.telemetry
        with tel.span("sched.wait"):
            ends, self._last_end = self._last_end, []
            if ends:
                for end in ends:
                    end.synchronize()
                tel.poll_device(block=True)
                for dev in self._cards:
                    tel.anchor_device(dev)

    def _retire(self, retiring: list) -> List[JobResult]:
        """The step's retirement pass, in ``retiring`` order: every retiring
        slot's spins and beta read in one `SweepEngine.retire_rows` (one
        gather and copy a device), the observables evaluated over that stack
        a model at a time, each job finalized from its rows, its slots
        released."""
        tel = self.telemetry
        jobs = [self._active[jid] for jid in retiring]
        slots = [b for _, taken in jobs for b in taken]
        spins, betas = self.engine.retire_rows(self.carry, slots)
        parts, groups = [], {}  # each job's rows; id(model) -> (model, rows)
        for job, taken in jobs:
            lo = parts[-1].stop if parts else 0
            parts.append(slice(lo, lo + len(taken)))
            m = job.model_on(self)
            groups.setdefault(id(m), (m, []))[1].extend(range(lo, lo + len(taken)))
        energy, mag = np.empty(len(slots)), np.empty(len(slots))
        for m, rows in groups.values():
            stack = spins if len(rows) == len(slots) else spins[rows]
            energy[rows] = observables.energies(m, stack)
            mag[rows] = observables.magnetization(stack)
        self._c_retire_passes.add(1)
        self._c_retired_slots.add(len(slots))
        completed = []
        for jid, (job, taken), part in zip(retiring, jobs, parts):
            rows = [x[part] for x in (spins, betas, energy, mag)]
            if len(jobs) > 1:  # a job's own copies where others share the stack
                rows = [x.copy() for x in rows]
            completed.append(job.finalize(RetiredRows(*rows)))
            self._pool.release_all(taken)  # raises on double-free
            del self._active[jid]
            self._retired.append(jid)
            self._c_completed.add(1)
            tel.async_end(
                "job", jid, sweeps_done=job.sweeps_done,
                chunks=job.chunks, preemptions=job.preemptions,
            )
        return completed

    def step(self) -> List[JobResult]:
        """One scheduling round: admit, one chunked launch, hooks, retire.

        Returns the jobs that retired this round (possibly empty).
        """
        tel = self.telemetry
        with tel.span("sched.step"):
            tel.poll_device()  # launches of earlier steps that have ended
            with tel.span("sched.admit"):
                self._admit()
            tel.gauge("serve.active_jobs").set(len(self._active))
            tel.gauge("serve.queued_jobs").set(len(self.policy))
            tel.gauge("serve.free_slots").set(self._pool.total_free)
            if self.devices > 1:
                for d, nfree in enumerate(self._pool.free_by_device()):
                    tel.gauge("serve.free_slots_dev", device=d).set(nfree)
            if not self._active:
                return []
            bound = min(j.remaining_in_segment() for j, _ in self._active.values())
            if self._chunker is not None:
                chunk = self._chunker.propose(len(self.policy), bound)
            else:
                chunk = min(self.chunk_sweeps, bound)
            with tel.span("sched.launch"):
                pending = self._launch(chunk)
            busy = sum(j.num_slots for j, _ in self._active.values())
            self._c_busy.add(chunk * busy)
            self._c_total.add(chunk * self.slots)
            boundary = [
                jid for jid in list(self._active) if self._active[jid][0].advance(chunk)
            ]
            self._settle_launch(chunk, pending)
            # Tap the stream after every job has advanced (sweeps_done is
            # current) and before the hooks and retirement, so a retiring
            # job's final chunk is sampled (hooks rewrite betas, never spins).
            if self.stream is not None:
                self.stream.record(self)
            completed: List[JobResult] = []
            if boundary:
                # Every hook runs before any retirement: a job's hook and
                # finalize touch its own slots only, so the order between
                # jobs changes nothing, and the beta rewrites go as one.
                retiring = [jid for jid in boundary if self._active[jid][0].done]
                if retiring:
                    self._wait_launch()
                with tel.span("sched.segment"):
                    rows, betas = [], []
                    for jid in boundary:
                        job, taken = self._active[jid]
                        new = job.segment_betas(self)
                        if new is None:
                            self.carry = job.on_segment(self, self.carry, taken)
                        else:
                            rows += taken[: len(new)]
                            betas += new
                    if rows:
                        self.carry = self.engine.set_slot_betas(self.carry, rows, betas)
                if retiring:
                    with tel.span("sched.retire"):
                        completed = self._retire(retiring)
            if (
                self.snapshot_every_sweeps
                and self.sweeps_elapsed - self._last_snapshot_sweep >= self.snapshot_every_sweeps
            ):
                # Periodic snapshot at the step boundary: the host copies
                # are taken now (they must see THIS boundary), the fsync'd
                # writes ride the manager's writer thread.
                self.snapshot(blocking=False)
        return completed

    def drain(self, max_steps: int = 1_000_000) -> List[JobResult]:
        """Run scheduling rounds until queue and slots are empty.

        With a ``preemption`` handler armed, a triggered handler (SIGTERM,
        or `trigger()`) is honoured between chunks: the in-flight chunk has
        finished — chunk boundaries are the only consistent checkpoint —
        so the server snapshots (blocking: durable before the process
        exits) and returns the results retired so far with
        ``self.preempted`` set.  `SampleServer.restore` continues the rest.
        """
        results: List[JobResult] = []
        for _ in range(max_steps):
            if not len(self.policy) and not self._active:
                self.wait_snapshots()  # no dangling writer past a drain
                self.telemetry.poll_device(block=True)
                return results
            if self.preemption is not None and self.preemption.should_exit:
                self.telemetry.instant(
                    "sched.preempt_drain",
                    queued=len(self.policy),
                    active=len(self._active),
                    sweeps_elapsed=self.sweeps_elapsed,
                )
                if self.snapshot_manager is not None:
                    self.snapshot(blocking=True)
                self.preempted = True
                self.telemetry.poll_device(block=True)
                return results
            results.extend(self.step())
        raise RuntimeError(f"drain did not converge in {max_steps} steps")

    # -- snapshot / restore (serve_mc/snapshot.py) ------------------------------

    def wait_snapshots(self) -> None:
        """Join any background snapshot write (after this returns, the
        newest snapshot is fully on disk)."""
        if self.snapshot_manager is not None:
            self.snapshot_manager.wait()

    def snapshot(self, manager=None, *, step: int | None = None, blocking: bool = True) -> int:
        """Write a whole-server snapshot; returns its step number.

        Call between scheduling rounds (never mid-`step`): a chunk boundary
        is the one point where pool + bookkeeping form a consistent
        resumable state.  ``manager`` (a manager or a directory) defaults to
        the server's ``snapshot_manager``; ``step`` to the sweep clock.
        """
        from repro_torch.serve_mc import snapshot as snap

        mgr = manager if manager is not None else self.snapshot_manager
        if mgr is None:
            raise ValueError(
                "no snapshot manager: pass one here or construct the server "
                "with snapshot_manager=..."
            )
        if not isinstance(mgr, CheckpointManager):
            mgr = CheckpointManager(str(mgr))
        step = snap.save_snapshot(self, mgr, step=step, blocking=blocking)
        self._last_snapshot_sweep = self.sweeps_elapsed
        return step

    @classmethod
    def restore(cls, source, **overrides) -> "SampleServer":
        """Rebuild a server from a snapshot (`serve_mc.snapshot.
        restore_server`, which takes the overrides) and continue
        bit-exactly, on the card unless ``device="cpu"``."""
        from repro_torch.serve_mc import snapshot as snap

        return snap.restore_server(source, **overrides)

    # -- reporting ------------------------------------------------------------

    @staticmethod
    def _wait_summary(waits: list[float]) -> dict:
        if not waits:
            return {"count": 0}
        arr = np.sort(np.asarray(waits, np.float64))
        return {
            "count": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "max_s": float(arr[-1]),
        }

    def _wait_recent_summary(self) -> dict:
        out = {"window": self._wait_recent.maxlen, "count": len(self._wait_recent)}
        if not self._wait_recent:
            return out
        secs = np.asarray([w for w, _ in self._wait_recent], np.float64)
        sweeps = np.asarray([s for _, s in self._wait_recent], np.float64)
        out.update(
            p50_s=float(np.percentile(secs, 50)),
            p95_s=float(np.percentile(secs, 95)),
            p50_sweeps=float(np.percentile(sweeps, 50)),
            p95_sweeps=float(np.percentile(sweeps, 95)),
        )
        return out

    def stats(self) -> dict:
        self.telemetry.poll_device(block=True)
        n = self.engine.model.num_spins
        # Utilization split: useful sweeps advanced a resident job; idle
        # resweeps advanced a free slot's stale state (wasted work, never
        # wrong work) because the whole batch launches together.
        useful = self.busy_slot_sweeps
        idle = self.total_slot_sweeps - useful
        by_user: dict[str, list] = defaultdict(list)
        by_priority: dict[int, list] = defaultdict(list)
        all_waits: list[float] = []
        for user, priority, wait_s, _wait_sweeps in self._wait_records:
            by_user[user].append(wait_s)
            by_priority[priority].append(wait_s)
            all_waits.append(wait_s)
        return {
            "slots": self.slots,
            "policy": self.policy.name,
            "launches": self.launches,
            "distinct_chunks": len(self.launch_chunks),
            "busy_slot_sweeps": self.busy_slot_sweeps,
            "total_slot_sweeps": self.total_slot_sweeps,
            "useful_slot_sweeps": useful,
            "idle_resweep_slot_sweeps": idle,
            "sweeps_elapsed": self.sweeps_elapsed,
            "preemptions": self.preemptions,
            "utilization": (
                self.busy_slot_sweeps / self.total_slot_sweeps if self.total_slot_sweeps else 0.0
            ),
            # One attempted Metropolis update per spin per sweep.
            "spin_flips": self.busy_slot_sweeps * n,
            "queue_wait": {
                "overall": self._wait_summary(all_waits),
                "by_user": {u: self._wait_summary(w) for u, w in by_user.items()},
                "by_priority": {p: self._wait_summary(w) for p, w in by_priority.items()},
            },
            "queue_wait_recent": self._wait_recent_summary(),
            # Placement health: admissions that landed on one device vs
            # spanning, rebalancer migrations, and which PT swap path ran.
            "placement": {
                "mode": self._pool.mode,
                "devices": self.devices,
                "free_by_device": self._pool.free_by_device(),
                "affine": self._c_place_affine.value,
                "spanning": self._c_place_span.value,
                "rebalance_migrations": self._c_migrations.value,
                "pt_swap_local": self._c_swap_local.value,
                "pt_swap_cross": self._c_swap_cross.value,
                "pt_swap_fused": self._c_swap_fused.value,
            },
            "telemetry": {
                "enabled": self.telemetry.enabled,
                "events_recorded": self.telemetry.num_events,
                "events_dropped": self.telemetry.dropped_events,
                "straggler_events": self._c_straggler.value,
                "devices": self.devices,
            },
        }
