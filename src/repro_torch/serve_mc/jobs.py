"""Job types the `SampleServer` schedules onto engine slots.

A job is a unit of sampling work that occupies ``num_slots`` slots of the
server's resident `SweepEngine` batch from admission to retirement.  Its
lifetime is expressed in *segments*: maximal runs of sweeps during which
the job's betas are constant.  The scheduler may cut a segment into
several fused-launch chunks (chunk boundaries never change results — the
RNG stream position is a pure function of sweeps completed), but it
always stops exactly at segment boundaries, where the job's
``on_segment`` hook runs.

  * `AnnealJob` — one slot; a piecewise-constant anneal schedule.  The
    hook rewrites the slot's beta to the next segment's value.  It equals
    a solo ``SweepEngine`` run with the same seed and schedule, no matter
    which slot it lands in or what runs beside it.  On a multi-tenant
    server a job may carry its own model (``model=``); it then equals the
    solo run of that model.
  * `PTJob` — R slots; every segment is one parallel-tempering round.
    The hook is `tempering.swap_phase` over the job's own slots (read in
    place in the shared carry), so a tempering round is "one scheduled
    chunk + swap" and shares launches with whatever else is resident.  It
    equals `tempering.run_parallel_tempering` with the same seed, betas and
    rounds bit for bit, wherever its slots land (a job's own model, on a
    multi-tenant server, included).

Every job serializes to a JSON-safe ``meta`` dict plus named numpy
arrays (`snapshot_state`) and back (`from_snapshot`), with the JAX
reference's meta keys and array names: a job snapshotted by either
package continues in the other (`serve_mc.snapshot`).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np

import torch

from repro_torch.core import convert
from repro_torch.core import engine as sweep_engine
from repro_torch.core import ising, mt19937, tempering
from repro_torch.kernels import ops


class JobResult(NamedTuple):
    """What a retired job hands back to the submitter."""

    jid: int
    spins: np.ndarray  # (N,) flat layer-major; (R, N) for multi-slot jobs
    energy: float | np.ndarray
    magnetization: float | np.ndarray
    sweeps_done: int
    chunks: int  # fused launches this job rode in
    extras: dict


class RetiredRows(NamedTuple):
    """A retiring job's share of the step's retirement pass, host numpy in
    the job's slot order (`SampleServer._retire`): its slots' flat spins
    (k, N) float32 and betas (k,) float32 (`SweepEngine.retire_rows`), and
    the float64 energies and magnetizations of those spins
    (`core.observables`, evaluated over the pass's stack)."""

    spins: np.ndarray
    betas: np.ndarray
    energy: np.ndarray
    magnetization: np.ndarray


class _ScheduledJob:
    """Segment bookkeeping shared by every job type.

    ``segments`` is a list of positive sweep counts.  The scheduler only
    ever advances a job by ``k <= remaining_in_segment()`` sweeps.

    ``priority`` and ``user`` feed the server's admission policy: higher
    priority admits first (strict tiers; 0 is the default class), and
    under the fair policy jobs compete for slots per ``user``.  Neither
    affects results.

    ``parked`` is the job's checkpoint state after a preemption: one
    `engine.ParkedSlot` per occupied slot, extracted at the chunk boundary
    it was evicted on; re-admission splices them back.

    ``model`` is the job's own model (a tenant: the server's lattice with
    its own couplings, e.g. `ising.reseed_couplings`); None samples the
    server's model.  A job with a model needs a multi-tenant server
    (``SampleServer(..., multi_tenant=True)``), which splices the model's
    coupling tables into the job's slot at admission.
    """

    num_slots = 1
    kind = "job"  # telemetry label (job lifecycle trace events)

    def __init__(
        self,
        segments: Sequence[int],
        model: ising.LayeredModel | None = None,
        priority: int = 0,
        user: str | None = None,
    ):
        segments = [int(s) for s in segments]
        if not segments or any(s <= 0 for s in segments):
            raise ValueError(f"segments must be positive sweep counts: {segments}")
        self._segments = segments
        self._seg = 0
        self._in_seg = 0
        self.sweeps_done = 0
        self.chunks = 0
        self.jid: int | None = None  # assigned by SampleServer.submit
        self.model = model
        self.priority = int(priority)
        self.user = "default" if user is None else str(user)
        self.parked: list | None = None  # ParkedSlot per slot while evicted
        self.preemptions = 0  # times evicted (stats; resume is bit-exact)
        # Scheduler bookkeeping (set by SampleServer.submit/_place): wall
        # and sweep-clock stamps for queue-wait reporting.
        self._submit_time = self._admit_time = None
        self._submit_sweep = self._admit_sweep = None
        self._seq = None  # admission-policy submission order

    def model_on(self, server) -> ising.LayeredModel:
        """The model this job samples when served by ``server``."""
        return self.model if self.model is not None else server.engine.model

    @property
    def done(self) -> bool:
        return self._seg >= len(self._segments)

    @property
    def segment_index(self) -> int:
        return self._seg

    def remaining_in_segment(self) -> int:
        if self.done:
            return 0
        return self._segments[self._seg] - self._in_seg

    def total_remaining(self) -> int:
        return sum(self._segments[self._seg :]) - self._in_seg

    def segment_betas(self, server) -> list[float] | None:
        """The betas the job's slots take at the segment boundary just
        reached, in slot order, where rewriting them is all its hook does:
        the server then writes every such job's at once.  None (here) where
        the job runs its own `on_segment`."""
        return None

    def advance(self, k: int) -> bool:
        """Record ``k`` sweeps of progress; True iff a segment boundary was
        reached (the scheduler then runs `on_segment`)."""
        if k <= 0 or k > self.remaining_in_segment():
            raise ValueError(
                f"advance({k}) outside segment (remaining "
                f"{self.remaining_in_segment()})"
            )
        self._in_seg += k
        self.sweeps_done += k
        self.chunks += 1
        if self._in_seg == self._segments[self._seg]:
            self._seg += 1
            self._in_seg = 0
            return True
        return False

    # -- snapshot/restore (serve_mc.snapshot) ---------------------------------
    #
    # ``meta`` carries everything the segment bookkeeping and the admission
    # policy need to continue exactly where an uninterrupted run would be
    # (progress counters, priority/user, submission seq, sweep-clock
    # stamps); the arrays carry parked-slot state and the subclass's own
    # tensors, as host numpy COPIES: a background writer may read them
    # while the server steps on.  The job's private model (if any) is
    # serialized by `serve_mc.snapshot` alongside, not here.

    def _snapshot_base(self) -> tuple[dict, dict]:
        meta = {
            "kind": self.kind,
            "jid": self.jid,
            "segments": list(self._segments),
            "seg": self._seg,
            "in_seg": self._in_seg,
            "sweeps_done": self.sweeps_done,
            "chunks": self.chunks,
            "priority": self.priority,
            "user": self.user,
            "preemptions": self.preemptions,
            "seq": self._seq,
            "submit_sweep": self._submit_sweep,
            "admit_sweep": self._admit_sweep,
            # Wall-clock wait ACCRUED so far by a still-queued job; restore
            # re-anchors `_submit_time` to ``now - waited_s``, so the time a
            # process spent dead between save and restore never shows up
            # as queue latency.
            "waited_s": (
                time.perf_counter() - self._submit_time
                if self._submit_time is not None and self._admit_sweep is None
                else None
            ),
        }
        arrays: dict = {}
        if self.parked is not None:
            meta["num_parked"] = len(self.parked)
            meta["parked_tables"] = any(p.tables is not None for p in self.parked)
            for i, p in enumerate(self.parked):
                for name, v in convert.carry_to_numpy(p.carry).items():
                    arrays[f"parked/{i}/carry/{name}"] = v
                if p.tables is not None:
                    for k in sorted(p.tables):  # the reference's (pytree) order
                        arrays[f"parked/{i}/tables/{k}"] = convert.host_copy(p.tables[k])
        return meta, arrays

    def _restore_base(self, meta: dict, arrays: dict) -> None:
        self.jid = meta["jid"]
        self._seg = int(meta["seg"])
        self._in_seg = int(meta["in_seg"])
        self.sweeps_done = int(meta["sweeps_done"])
        self.chunks = int(meta["chunks"])
        self.preemptions = int(meta["preemptions"])
        self._seq = meta["seq"]
        self._submit_sweep = meta["submit_sweep"]
        self._admit_sweep = meta["admit_sweep"]
        now = time.perf_counter()
        waited = meta.get("waited_s")
        self._submit_time = now - float(waited) if waited is not None else now
        self._admit_time = self._submit_time if self._admit_sweep is not None else None
        if meta.get("num_parked"):
            # Parked state stays on the host until re-admission splices it
            # into the server's carry (on whatever device that lives).
            parked = []
            for i in range(meta["num_parked"]):
                carry = convert.carry_from_numpy(
                    {f: arrays[f"parked/{i}/carry/{f}"] for f in sweep_engine.SweepCarry._fields},
                    "cpu",
                )
                prefix = f"parked/{i}/tables/"
                tabs = {
                    k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
                    for k, v in arrays.items()
                    if k.startswith(prefix)
                }
                parked.append(sweep_engine.ParkedSlot(carry, tabs or None))
            self.parked = parked

    def snapshot_state(self) -> tuple[dict, dict]:
        """(JSON-safe meta, {name: ndarray}) capturing this job exactly."""
        raise NotImplementedError

    @classmethod
    def from_snapshot(cls, meta: dict, arrays: dict, model=None):
        """Rebuild a job from `snapshot_state` output (inverse, bit-exact)."""
        raise NotImplementedError


class AnnealJob(_ScheduledJob):
    """One slot, one seed, a piecewise-constant beta schedule.

    ``schedule`` is a list of ``(num_sweeps, beta)`` pairs; ``beta=None``
    means the model's default.  Single-segment jobs are plain constant-
    temperature sampling; multi-segment jobs are annealing ladders.
    """

    kind = "anneal"

    def __init__(
        self,
        seed: int,
        schedule: Sequence[tuple[int, float | None]],
        spins: np.ndarray | None = None,
        model: ising.LayeredModel | None = None,
        priority: int = 0,
        user: str | None = None,
    ):
        super().__init__(
            [s for s, _ in schedule], model=model, priority=priority, user=user
        )
        self.seed = int(seed)
        self._betas = [b if b is None else float(b) for _, b in schedule]
        self._init_spins = None if spins is None else np.asarray(spins, np.float32)

    @classmethod
    def constant(
        cls,
        seed: int,
        sweeps: int,
        beta: float | None = None,
        model: ising.LayeredModel | None = None,
        priority: int = 0,
        user: str | None = None,
    ):
        return cls(seed, [(sweeps, beta)], model=model, priority=priority, user=user)

    @classmethod
    def ramp(
        cls,
        seed: int,
        beta_start: float,
        beta_end: float,
        steps: int,
        sweeps_per_step: int,
        model: ising.LayeredModel | None = None,
        priority: int = 0,
        user: str | None = None,
    ):
        """Linear beta ramp: ``steps`` segments of ``sweeps_per_step``."""
        betas = np.linspace(beta_start, beta_end, steps)
        return cls(
            seed, [(sweeps_per_step, float(b)) for b in betas], model=model,
            priority=priority, user=user,
        )

    def snapshot_state(self) -> tuple[dict, dict]:
        meta, arrays = self._snapshot_base()
        meta["seed"] = self.seed
        meta["betas"] = list(self._betas)  # None entries survive as JSON null
        if self._init_spins is not None:
            arrays["init_spins"] = self._init_spins
        return meta, arrays

    @classmethod
    def from_snapshot(cls, meta: dict, arrays: dict, model=None):
        job = cls(
            meta["seed"],
            list(zip(meta["segments"], meta["betas"])),
            spins=arrays.get("init_spins"),
            model=model,
            priority=meta["priority"],
            user=meta["user"],
        )
        job._restore_base(meta, arrays)
        return job

    def _beta(self, server, seg: int) -> float:
        b = self._betas[seg]
        return float(self.model_on(server).beta) if b is None else b

    def current_beta(self, server) -> float:
        return self._beta(server, self._seg)

    # -- scheduler interface --------------------------------------------------

    def slot_seeds(self, server) -> list[np.ndarray]:
        """The lane seeds of each of the job's slots (`init_carries`' rngs
        are the generators seeded from them)."""
        return [sweep_engine.lane_seeds(1, server.engine._slot_lanes(), self.seed)]

    def init_carries(self, server, rngs) -> list[sweep_engine.SweepCarry]:
        """The job's slot carries; ``rngs`` holds their generator states,
        seeded by the server from `slot_seeds`."""
        return [
            server.engine.init_slot_carry(
                seed=self.seed,
                spins=self._init_spins,
                beta=self._beta(server, 0),
                model=self.model,
                rng_state=rngs[0],
            )
        ]

    def segment_betas(self, server) -> list[float]:
        return [] if self.done else [self.current_beta(server)]

    def on_segment(self, server, carry, slots):
        betas = self.segment_betas(server)
        return server.engine.set_slot_betas(carry, slots, betas) if betas else carry

    def finalize(self, rows: RetiredRows) -> JobResult:
        return JobResult(
            jid=self.jid,
            spins=rows.spins[0],
            energy=float(rows.energy[0]),
            magnetization=float(rows.magnetization[0]),
            sweeps_done=self.sweeps_done,
            chunks=self.chunks,
            extras={
                "final_beta": float(rows.betas[0]),
                "preemptions": self.preemptions,
            },
        )


class PTJob(_ScheduledJob):
    """A whole parallel-tempering workload as ONE multi-slot job.

    Occupies R slots (one per replica).  Every segment is one PT round of
    ``sweeps_per_round`` sweeps; at each boundary the job runs the swap
    phase the standalone run makes (`kernels.ops.pt_swap`, which
    `tempering.swap_phase` calls) on its slots where they lie in the shared
    carry, and the carry takes the swapped betas.  Seeding reproduces
    `tempering.init_pt` exactly (replica b gets RNG lane seeds
    ``lane_seeds(R, V, seed)[b*V:(b+1)*V]`` and spins
    ``init_spins(m, seed*1000 + b)``), so the result is bit-identical to
    `tempering.run_parallel_tempering` wherever the slots land.  The swap
    generator and counters live on the server's device.
    """

    kind = "pt"

    def __init__(
        self,
        seed: int,
        betas: np.ndarray,
        num_rounds: int,
        sweeps_per_round: int = 1,
        model: ising.LayeredModel | None = None,
        priority: int = 0,
        user: str | None = None,
    ):
        if num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {num_rounds}")
        super().__init__(
            [int(sweeps_per_round)] * int(num_rounds), model=model,
            priority=priority, user=user,
        )
        self.seed = int(seed)
        self.betas = np.asarray(betas, np.float32)
        self.num_slots = len(self.betas)
        # The swap generator and counters, as `tempering.init_pt` makes
        # them; moved to the server's device at first admission.
        self.swap_rng = mt19937.mt_init(self.seed + 17, "cpu")
        self.swap_accept = torch.zeros((), dtype=torch.int32)
        self.swap_propose = torch.zeros((), dtype=torch.int32)
        self._energy_tables = {}  # device -> a private model's tables, built on first swap
        self._rows = self._rows_key = None  # `_ladder_rows`' cache: rows, (slots, device)

    def snapshot_state(self) -> tuple[dict, dict]:
        """The reference's layout: the swap generator's state as uint32 at
        its exact position and the accept/propose tallies (read back from
        the device here, and only here).  `_energy_tables` is a pure cache,
        rebuilt from the model after a restore."""
        meta, arrays = self._snapshot_base()
        meta["seed"] = self.seed
        meta["sweeps_per_round"] = self._segments[0]
        meta["swap_accept"] = int(self.swap_accept)
        meta["swap_propose"] = int(self.swap_propose)
        arrays["betas"] = self.betas
        arrays["swap_rng"] = convert.host_copy(self.swap_rng).view(np.uint32)
        return meta, arrays

    @classmethod
    def from_snapshot(cls, meta: dict, arrays: dict, model=None):
        job = cls(
            meta["seed"],
            arrays["betas"],
            num_rounds=len(meta["segments"]),
            sweeps_per_round=meta["sweeps_per_round"],
            model=model,
            priority=meta["priority"],
            user=meta["user"],
        )
        job._restore_base(meta, arrays)
        rng = np.ascontiguousarray(arrays["swap_rng"], np.uint32).view(np.int32)
        job.swap_rng = torch.from_numpy(rng.copy())
        job.swap_accept = torch.tensor(int(meta["swap_accept"]), dtype=torch.int32)
        job.swap_propose = torch.tensor(int(meta["swap_propose"]), dtype=torch.int32)
        return job

    # -- scheduler interface --------------------------------------------------

    def _to_device(self, dev) -> None:
        """Keep the swap generator and counters on the server's device (a
        no-op once they are there; a restored job arrives on the host)."""
        self.swap_rng, self.swap_accept, self.swap_propose = (
            t.to(dev) for t in (self.swap_rng, self.swap_accept, self.swap_propose))

    def slot_seeds(self, server) -> list[np.ndarray]:
        """Each replica's lane seeds: ``lane_seeds(R, V, seed)`` cut a
        replica at a time."""
        lanes = server.engine._slot_lanes()
        seeds = sweep_engine.lane_seeds(self.num_slots, lanes, self.seed)
        return [seeds[b * lanes : (b + 1) * lanes] for b in range(self.num_slots)]

    def init_carries(self, server, rngs) -> list[sweep_engine.SweepCarry]:
        """The replicas' slot carries; ``rngs`` holds their generator
        states, seeded by the server from `slot_seeds`."""
        eng, m = server.engine, self.model_on(server)
        self._to_device(eng.device)
        return [
            eng.init_slot_carry(
                seed=self.seed,
                spins=ising.init_spins(m, seed=self.seed * 1000 + b),
                beta=float(self.betas[b]),
                model=self.model,
                rng_state=rngs[b],
            )
            for b in range(self.num_slots)
        ]

    def _ladder_rows(self, eng, carry, slots):
        """(the carry, or on a mesh the device block, holding the ladder;
        the ladder's rows there in replica order as an int32 tensor on its
        device).  The rows are made once per placement: a ladder resumed on
        other slots makes them anew.  On the card they are copied from
        pinned memory without a wait."""
        blk = eng.slot_row(carry, slots[0])[0]
        dev = blk.spins.device
        key = (tuple(slots), str(dev))
        if self._rows_key != key:
            rows = torch.tensor([eng.slot_row(carry, b)[1] for b in slots], dtype=torch.int32)
            if dev.type == "cuda":
                rows = rows.pin_memory().to(dev, non_blocking=True)
            self._rows, self._rows_key = rows, key
        return blk, self._rows

    def _swap_energy_tables(self, eng, device):
        """Energy tables of the job's model on ``device``: the engine's when
        the job has none, else built once per job from the private model."""
        if self.model is None:
            return eng.energy_tables_on(device)
        key = str(device)
        if key not in self._energy_tables:
            self._energy_tables[key] = tempering.model_energy_tables(self.model, device)
        return self._energy_tables[key]

    def on_segment(self, server, carry, slots):
        """The swap phase of the round just completed, in a ``pt.swap``
        span of the server's telemetry."""
        with server.telemetry.span("pt.swap"):
            return self._swap(server, carry, slots)

    def _swap(self, server, carry, slots):
        eng = server.engine
        parity = (self._seg - 1) % 2  # the round just completed: the standalone r % 2
        # A ladder whose slots span devices gathers only its R energies and
        # betas (`slot_energies`: each device evaluates its own slots) and
        # decides with the same `_swap_decide` as the resident path, so the
        # route is invisible in the results.  A ladder on one device (what
        # affine placement produces) takes the resident path.
        spans = eng.mesh is not None and len({eng.slot_device(b) for b in slots}) > 1
        if eng.mesh is not None:
            (server._c_swap_cross if spans else server._c_swap_local).add(1)
        if spans:
            self._to_device(eng.device)
            idx = torch.as_tensor(np.asarray(slots, np.int64), device=eng.device)
            betas = eng.gather_betas(carry, slots)
            betas, self.swap_rng, self.swap_accept, self.swap_propose = (
                tempering.swap_phase_from_energies(
                    betas, eng.slot_energies(carry)[idx], self.swap_rng, self.swap_accept,
                    self.swap_propose, parity, eng.exp_flavor,
                )
            )
            return eng.set_slot_betas(carry, slots, betas)
        # One device: `ops.pt_swap` reads the ladder's spins where they lie in
        # the block, one launch of csrc/pt_swap.cu on the card (the plain
        # version on the CPU); the block's betas are replaced, not written.
        blk, rows = self._ladder_rows(eng, carry, slots)
        dev = blk.spins.device
        self._to_device(dev)
        if dev.type == "cuda":
            server._c_swap_fused.add(1)
        _, betas, self.swap_rng, self.swap_accept, self.swap_propose = ops.pt_swap(
            blk.spins, blk.betas, rows, self.swap_rng, self.swap_accept, self.swap_propose,
            *self._swap_energy_tables(eng, dev), eng.model.n, parity, eng.exp_flavor,
        )
        return eng._replace_block(carry, slots[0], blk._replace(betas=betas))

    def finalize(self, rows: RetiredRows) -> JobResult:
        """The ladder's result; the swap counts are read from the device
        here, once a ladder."""
        return JobResult(
            jid=self.jid,
            spins=rows.spins,
            energy=rows.energy,
            magnetization=rows.magnetization,
            sweeps_done=self.sweeps_done,
            chunks=self.chunks,
            extras={
                "betas": rows.betas,
                "swap_accept": int(self.swap_accept),
                "swap_propose": int(self.swap_propose),
                "preemptions": self.preemptions,
            },
        )
