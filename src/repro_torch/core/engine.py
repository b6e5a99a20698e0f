"""`SweepEngine` — the single construction path for Metropolis sweeps.

One API owns the sweep lifecycle of a batch of replicas:

    eng = SweepEngine.create(model, rung="cb", backend="cuda", batch=8)
    carry = eng.init_carry(seed=0)
    carry = eng.run(carry, num_sweeps)       # one kernel launch
    spins = eng.spins_flat(carry)            # (B, N) layer-major numpy

Carry layout (`SweepCarry`), batched over replicas:

    spins/h_space/h_tau   (B, N) float32      flat rungs a1/a2
                          (B, rows, V) float32 lane rungs a3/a4/cb
    betas                 (B,) float32       per-replica inverse temperature
    rng                   (624, B) int32     flat rungs: one scalar MT19937
                                             per replica
                          (624, B*V) int32   lane rungs: V interlaced MT19937
                                             generators per replica (replica
                                             b owns columns b*V..(b+1)*V);
                                             uint32 bits stored as int32

Backends (`register_backend`):

  * ``"torch"`` — the plain PyTorch version (`kernels.ref`, `metropolis`),
    every rung and exp flavour, any V, on CPU or CUDA tensors; uniforms
    come from the host-side-formulated blocked MT19937, one draw per
    sweep (``N`` per replica on the flat rungs, ``rows`` per lane on the
    lane rungs).
  * ``"cuda"``  — the hand-written kernels: one launch advances every
    replica ``num_sweeps`` sweeps with the MT19937 twist/temper inside the
    kernel (rung "a4": kernels/csrc/metropolis_multisweep.cu, rung "cb":
    kernels/csrc/colored_multisweep.cu; on multi-tenant engines their twins
    metropolis_multisweep_multi.cu and colored_multisweep_multi.cu).  V
    must be 128, the device a CUDA device and the rung a4 or cb; every exp
    flavour ("fast", "accurate", "exact") is a template instantiation of
    the kernels.

Both evaluate the identical twist -> temper -> 24-bit-float pipeline on
the identical per-replica generator columns and the identical row (a4)
or class (cb) visit order, so they are bit-exact with each other and
with the JAX reference's jnp and Pallas backends.

Rungs: the paper's ladder a1-a4 (`metropolis`) carries ``h_space``/
``h_tau`` as state and updates them incrementally; "cb", the
graph-colored sweep, recomputes them densely at the end of each run.
a1 (edge-centric) and a2 (per-spin layout) sweep the flat layer-major
layout; a3 and a4 the lane layout, a3 with per-lane neighbour updates.

Multi-tenant engines (``create([m0, m1, ...])``, rungs "a4" and "cb"):
one slot per model, all models on one lattice (same lane shape and
``space_nbr``, `check_same_topology`).  The lattice's structure (neighbour
table, color classes) is engine state; each slot's couplings and fields
ride as ``[B, ...]`` tensors (`slot_tables`) that every launch reads, so
one launch sweeps B slots each with its own model.  With B copies of one
model this is the single-model engine, bit for bit.

Every rung runs on one device: a4 and cb for one model or one model per
slot, a1-a3 for one model on the "torch" backend.

MESH engines (``create(..., mesh=SlotMesh(...))``, `launch.mesh`) lay the
slot pool out over D devices: device d owns a contiguous block of
``capacities[d]`` logical slots (default: the equal ``batch / D`` split),
stored as its own `SweepCarry` of ``B_max = max(capacities)`` rows in
that device's memory (`MeshCarry`; the ``B_max - capacities[d]`` padding
rows are idle slots no API addresses, and a device of capacity 0 holds
no block and launches nothing).  `run` launches the unmodified
single-device body once per device, on that device's own stream, so
slots stay independent and D devices equal one bit for bit.  The slot
APIs keep addressing GLOBAL logical slot indices; `extract_pool` and
`spins_flat` give the logical layout, so a pool moves between meshes of
any device count or capacity vector.  An entry of the mesh may repeat
(``SlotMesh(("cuda:0",) * 4)``: four logical devices on one card).

``replica_tile`` (backend "cuda" only, as the reference takes it on its
Pallas backend only) must divide the batch.  On a4 it is the replicas a
CTA holds: each walked by its own 4 warps, all sharing the CTA's
generator warps (kernels/csrc/a4_sweep.cuh); a tile whose shared memory
or threads do not fit is refused (at n=96 L=256 only a tile of 1 fits,
and no CTA takes more than 2).  The
colored kernels already give each replica its own CTA of 1,024 threads,
so on cb the knob is checked and the launch does not change.  Results do
not depend on it.  ``create`` refuses a lattice past a rung's kernel
limits (`ops.check_kernel_rows`) before anything is built.

Slots: a batched carry is a row of independent slots; slot b owns row b
of spins/fields/betas and its own generator columns, so a slot's
trajectory is a pure function of its spliced-in state and the sweep
count — the invariant continuous batching rests on.  Carries are
treated as values: every method returns new tensors and never writes
into the carry it was given.
"""

from __future__ import annotations

import copy
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import fastexp, ising, metropolis, mt19937 as mt, reorder

RUNGS = ("a1", "a2", "a3", "a4", "cb")
FLAT_RUNGS = ("a1", "a2")
LANE_RUNGS = ("a3", "a4", "cb")
#: Rungs the "cuda" backend implements (the fully vectorized lane layouts).
CUDA_RUNGS = ("a4", "cb")
#: Rungs with a multi-tenant flavour (one model per slot).
MULTI_RUNGS = ("a4", "cb")

#: Default exp flavour per rung (the paper's a1 uses the exact exp; every
#: later rung the bit-trick "fast" one).
DEFAULT_EXP = {"a1": "exact", "a2": "fast", "a3": "fast", "a4": "fast", "cb": "fast"}

#: Seed-scrambling multiplier for per-lane MT19937 seeds (Knuth's 2^32/phi).
LANE_SEED_MULT = np.uint32(2654435761)


class SweepCarry(NamedTuple):
    """Batched sweep state: everything `run` needs, nothing it doesn't."""

    spins: torch.Tensor  # (B, N) | (B, rows, V)
    h_space: torch.Tensor  # same shape as spins
    h_tau: torch.Tensor  # same shape as spins
    betas: torch.Tensor  # (B,)
    rng: torch.Tensor  # (624, B) | (624, B*V) int32 holding uint32 bits


class MeshCarry(NamedTuple):
    """A mesh engine's pool: one `SweepCarry` block per mesh device, each of
    ``B_max`` rows (logical slots first, then padding) in that device's own
    storage, or None for a device of capacity 0.  A value like a carry:
    every engine method returns new blocks."""

    blocks: tuple


class PoolState(NamedTuple):
    """A whole slot pool's resumable state on the HOST (`extract_pool`).

    The server-snapshot analogue of `ParkedSlot`: every slot row of the
    batched carry — idle slots' stale state included, whose resweeps are
    part of the pool's deterministic trajectory — plus, on multi-tenant
    engines, the batched coupling tables (keys `convert.SLOT_TABLE_KEYS`).
    The leaves are numpy copies in the JAX reference's layout (``rng`` as
    uint32), so a pool crosses between the two packages and between the
    card and the CPU unchanged."""

    carry: SweepCarry  # numpy leaves, batch layout, rng uint32
    tables: dict | None  # numpy batched coupling tables (multi only)


class ParkedSlot(NamedTuple):
    """A preempted slot's complete resumable state (`SlotHandle.park`).

    ``carry`` is the single-slot `SweepCarry` at the chunk boundary the
    slot was evicted on; ``tables`` is the slot's single-slot coupling
    tables on multi-tenant engines (None on single-model engines, where the
    couplings are engine constants).  Re-splicing both continues the slot's
    trajectory bit-exactly: the RNG stream position is a pure function of
    sweeps completed."""

    carry: SweepCarry
    tables: dict | None


class SlotHandle:
    """All per-slot operations on one logical slot (`engine.slot(b)`):
    ``extract()``/``splice()`` and their scheduler names ``park()``/
    ``resume()``, the carry row and, on multi-tenant engines, the coupling
    row together.  Cheap value objects — create them on the fly."""

    __slots__ = ("engine", "index")

    def __init__(self, engine: "SweepEngine", index: int):
        self.engine = engine
        self.index = index

    def __repr__(self) -> str:
        return f"SlotHandle(b={self.index}, device={self.device})"

    @property
    def device(self) -> int:
        """Mesh device index owning this slot (0 without a mesh)."""
        return self.engine.slot_device(self.index)

    def extract(self, carry: SweepCarry) -> ParkedSlot:
        """This slot's complete resumable state (carry row, and coupling
        row on multi-tenant engines).  Pure read."""
        eng, b = self.engine, self.index
        tables = eng.extract_slot_tables(b) if eng.multi else None
        return ParkedSlot(eng.extract_slot(carry, b), tables)

    def splice(self, carry: SweepCarry, state, model=None) -> SweepCarry:
        """Write ``state`` — a `ParkedSlot` or a bare single-slot
        `SweepCarry` — into this slot; returns the updated carry.

        A `ParkedSlot` with tables splices them too; ``model`` (multi-
        tenant only) then records the tables' provenance so that a later
        `set_slot_model` of the same tenant is a no-op.  A bare carry with
        ``model`` installs that model's tables first (`set_slot_model`)."""
        eng, b = self.engine, self.index
        if model is not None and not eng.multi:
            raise ValueError("per-slot models need a multi-tenant engine (a model list)")
        if isinstance(state, ParkedSlot):
            if eng.multi and state.tables is not None:
                eng.splice_slot_tables(b, state.tables)
                if model is not None:
                    eng.check_model(model)
                    eng.models = eng.models[:b] + (model,) + eng.models[b + 1 :]
            return eng.splice_slot(carry, b, state.carry)
        if model is not None:
            eng.set_slot_model(b, model)
        return eng.splice_slot(carry, b, state)

    def park(self, carry: SweepCarry) -> ParkedSlot:
        """`extract` under the scheduler's preemption name."""
        return self.extract(carry)

    def resume(self, carry: SweepCarry, parked: ParkedSlot, model=None) -> SweepCarry:
        """`splice` under the scheduler's preemption name."""
        return self.splice(carry, parked, model=model)


def lane_seeds(batch: int, V: int, seed: int) -> np.ndarray:
    """Per-lane MT19937 seeds for `batch` replicas of `V` interlaced lanes
    (replica ``b`` owns lanes ``b*V .. (b+1)*V``)."""
    return np.arange(batch * V, dtype=np.uint32) * LANE_SEED_MULT + np.uint32(seed)


def normalize_capacities(devices: int, batch: int, capacities=None) -> tuple[int, ...]:
    """Validate a per-device slot capacity vector (or make the equal split
    when ``capacities`` is None), with the reference's messages: ``len ==
    devices``, every entry a non-negative int (a device may own no slot),
    at least one positive, summing to the LOGICAL batch; the equal split
    needs ``batch % devices == 0``."""
    if capacities is None:
        if batch % devices != 0:
            raise ValueError(
                f"batch {batch} must divide evenly over {devices} devices "
                "(pass capacities=[...] for an uneven split)"
            )
        return (batch // devices,) * devices
    caps = tuple(int(c) for c in capacities)
    if len(caps) != devices:
        raise ValueError(f"capacities has {len(caps)} entries for {devices} devices")
    if any(c < 0 for c in caps):
        raise ValueError(f"capacities must be >= 0, got {caps}")
    if not any(caps):
        raise ValueError("at least one device needs capacity > 0")
    if sum(caps) != batch:
        raise ValueError(f"capacities sum {sum(caps)} != batch {batch}")
    return caps


def _validate_mesh(mesh, batch: int, replica_tile: int | None, capacities=None):
    """``(SlotMesh, capacities)`` of a mesh engine, or the reference's
    ValueError: the mesh needs a "data" axis and no other non-trivial one;
    the capacities obey `normalize_capacities`; ``replica_tile`` divides
    the largest per-device block."""
    from repro_torch.launch.mesh import SlotMesh

    shape = getattr(mesh, "shape", None)
    shape = dict(shape) if isinstance(shape, dict) else {}
    if "data" not in shape:
        raise ValueError(f'engine meshes need a "data" axis; got {shape}')
    extra = {a: s for a, s in shape.items() if a != "data" and s != 1}
    if extra:
        raise ValueError(
            'engine slots shard over the "data" axis only; mesh has '
            f"non-trivial axes {extra}"
        )
    caps = normalize_capacities(shape["data"], batch, capacities)
    b_max = max(caps)
    if replica_tile is not None and b_max % replica_tile != 0:
        raise ValueError(
            f"replica_tile {replica_tile} must divide the per-device batch {b_max}"
        )
    return SlotMesh(mesh.devices), caps


def check_same_topology(base: ising.LayeredModel, other: ising.LayeredModel,
                        what: str = "model") -> None:
    """Raise unless ``other`` has ``base``'s lane shape and ``space_nbr``."""
    if other.n != base.n or other.L != base.L:
        raise ValueError(
            f"{what}: lane shape (n={other.n}, L={other.L}) differs from the "
            f"engine's (n={base.n}, L={base.L})"
        )
    if other.space_nbr.shape != base.space_nbr.shape or not np.array_equal(
        other.space_nbr, base.space_nbr
    ):
        raise ValueError(f"{what}: space_nbr differs from the engine's model")


def _coupling_tables(model: ising.LayeredModel, device) -> dict:
    """The per-slot tables of a multi-tenant engine, float32 on ``device``:
    everything that may differ between models on one lattice.  The doubled
    ones feed the a4 sweep, the undoubled ones the colored sweep and its
    field refresh; the same expressions as the single-model tables."""

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return dict(
        h=dev(model.h),
        base_J=dev(model.space_J),
        tau_J=dev(model.tau_J),
        base_J2=dev(2.0 * model.space_J),
        tau_J2=dev(2.0 * model.tau_J),
    )


# -----------------------------------------------------------------------------
# Backend registry.
# -----------------------------------------------------------------------------

_BACKENDS: dict[str, Callable[["SweepEngine"], Callable]] = {}
_MULTI_BACKENDS: dict[str, Callable[["SweepEngine"], Callable]] = {}


def register_backend(name: str, builder: Callable[["SweepEngine"], Callable]) -> None:
    """Register ``builder(engine) -> fn(carry, num_sweeps) -> carry``.

    The builder runs once at `SweepEngine.create` time and may close over
    the engine's model tables.
    """
    _BACKENDS[name] = builder


def register_multi_backend(name: str, builder: Callable[["SweepEngine"], Callable]) -> None:
    """Register the multi-tenant flavour of a backend: ``builder(engine) ->
    fn(carry, slot_tables, num_sweeps) -> carry``.  The coupling tables are
    not closed over: they arrive with every call as ``[B, ...]`` tensors
    (`SweepEngine.slot_tables`), so one built function serves any mix of
    models on the engine's lattice."""
    _MULTI_BACKENDS[name] = builder


def backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def _timed(body: Callable, args: tuple, stream) -> tuple:
    """``body(*args)`` between a pair of CUDA timing events on ``stream``,
    which the kernel entries record right around their C calls
    (`ops.launch_timing`), so the pair spans the kernels and not the Python
    before them; a body that calls no kernel entry (the plain version) gets
    both after its ops.  Returns ``(result, (start, end))``."""
    from repro_torch.kernels import ops

    timing = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), False]
    ops.launch_timing = timing
    try:
        out = body(*args)
    finally:
        ops.launch_timing = None
    if not timing[2]:
        timing[0].record(stream)
        timing[1].record(stream)
    return out, (timing[0], timing[1])


class SweepEngine:
    """One sweep lifecycle: model tables + backend dispatch."""

    #: Bound on the per-model slot-table cache; a larger tenant set simply
    #: re-uploads (only admission latency changes).
    SLOT_TABLES_CACHE_MAX = 64

    def __init__(
        self,
        model: ising.LayeredModel,
        rung: str,
        backend: str,
        batch: int,
        V: int,
        exp_flavor: str,
        device: torch.device,
        models: tuple | None = None,
        replica_tile: int | None = None,
        mesh=None,
        capacities: tuple | None = None,
    ):
        self.model = model
        self.replica_tile = replica_tile
        self.rung = rung
        self.backend = backend
        self.batch = batch  # LOGICAL slot count: what every public API sees
        self.V = V
        self.exp_flavor = exp_flavor
        self.device = device
        # Lane rows (None on the flat rungs, which have no lane layout).
        self.rows = reorder.check_lane_shape(model.n, model.L, V) if rung in LANE_RUNGS else None
        self.classes = reorder.colored_classes(model, V) if rung == "cb" else None
        # Mesh layout: logical slot b lives on device d at row l of d's
        # block, d*B_max + l == _phys_index[b]; without a mesh every
        # translation is the identity.
        self.mesh = mesh
        self.capacities = capacities
        if mesh is not None:
            D, b_max = len(mesh), max(capacities)
            self._cum = np.concatenate([[0], np.cumsum(capacities)]).astype(np.int64)
            self._phys_index = np.concatenate(
                [d * b_max + np.arange(c, dtype=np.int64) for d, c in enumerate(capacities)]
            )
        else:
            D, b_max = 1, batch
            self._cum = None
            self._phys_index = np.arange(batch, dtype=np.int64)
        self._b_max = b_max
        self._phys_batch = D * b_max
        self._ragged = self._phys_batch != batch
        self._pad_state = None  # the padding rows' template, built on first use
        # Multi-tenant: the model each slot sweeps (None after a raw table
        # splice) and its coupling tables, stacked [B, ...] (on a mesh, one
        # [B_max, ...] dict a device in `block_tables`, padding rows on the
        # base model).  The tables are values like the carry: a splice
        # builds new tensors.
        self.multi = models is not None
        self.models = models
        self.slot_tables = None
        self.block_tables = None
        if self.multi:
            if mesh is None:
                per_slot = [_coupling_tables(mm, device) for mm in models]
                self.slot_tables = {
                    k: torch.stack([t[k] for t in per_slot]) for k in per_slot[0]
                }
            else:
                per_slot = [_coupling_tables(mm, "cpu") for mm in models]
                self.block_tables = self._table_blocks(
                    {k: torch.stack([t[k] for t in per_slot]).numpy() for k in per_slot[0]}
                )
        # Per-model single-slot tables: a server's tenant set recurs, so a
        # model's tables are uploaded once, not per admission.  Models are
        # kept referenced so a dead id can never alias a new model.
        self._slot_tables_cache: dict[int, tuple] = {}
        builder = (_MULTI_BACKENDS if self.multi else _BACKENDS)[backend]
        if mesh is None:
            self._run = builder(self)
        else:
            # One body per distinct device, built for the per-device block
            # (entries of one card share it: its tables are read-only).
            self._bodies = {}
            for dev in mesh:
                if str(dev) not in self._bodies:
                    self._bodies[str(dev)] = builder(self._local_view(dev))
            self._streams = [None] * D
            self.device_launches = [0] * D  # body launches per mesh device
        # The last launch's (start, end) CUDA timing events of each device
        # block (`block_events`); on a host block the moment it returned.
        self._started = [None] * D
        self._ready = [None] * D
        self._energy_tabs: dict = {}  # base-model energy tables per device
        # `retire_rows`: the lane-to-flat index per device, a pinned host
        # buffer per device block (on the card).
        self._flat_index: dict = {}
        self._retire_bufs: dict = {}

    # -- construction ---------------------------------------------------------

    @classmethod
    def create(
        cls,
        models,
        rung: str = "cb",
        backend: str = "cuda",
        *,
        batch: int | None = None,
        V: int = 128,
        exp_flavor: str | None = None,
        device="cuda",
        replica_tile: int | None = None,
        mesh=None,
        capacities=None,
    ) -> "SweepEngine":
        """THE constructor.  ``models`` is one `LayeredModel` (``batch``
        replica slots, default 1) or a sequence of models on one lattice (a
        multi-tenant engine, one slot per model; ``batch`` must be omitted
        or equal its length).  The slots live on ``device``.
        ``backend="cuda"`` needs ``V=128`` and a CUDA ``device``;
        ``backend="torch"`` runs the plain version on any device and any V."""
        multi = None
        if not isinstance(models, ising.LayeredModel):
            multi = tuple(models)
            if not multi:
                raise ValueError("a multi-tenant engine needs at least one model")
            if batch is not None and batch != len(multi):
                raise ValueError(
                    f"batch {batch} != len(models) {len(multi)}: multi-tenant engines "
                    "have exactly one slot per model"
                )
            for i, other in enumerate(multi[1:], 1):
                check_same_topology(multi[0], other, what=f"models[{i}]")
            if rung in RUNGS and rung not in MULTI_RUNGS:
                raise ValueError(
                    f"multi-tenant engines implement rungs {MULTI_RUNGS}; got rung={rung!r}"
                )
            models, batch = multi[0], len(multi)
        if rung not in RUNGS:
            raise ValueError(f"unknown rung {rung!r}; choose from {RUNGS}")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; registered: {backends()}")
        batch = 1 if batch is None else int(batch)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        exp_flavor = exp_flavor or DEFAULT_EXP[rung]
        fastexp.exp_fn(exp_flavor)  # raises for unknown flavours
        device = torch.device(device)
        if replica_tile is not None and backend != "cuda":
            raise ValueError("replica_tile is a cuda-backend knob")
        if replica_tile is not None and (replica_tile < 1 or batch % replica_tile != 0):
            raise ValueError(f"replica_tile {replica_tile} must divide batch {batch}")
        if mesh is None and capacities is not None:
            raise ValueError("capacities need a mesh-sharded engine (mesh=...)")
        if mesh is not None:
            mesh, capacities = _validate_mesh(mesh, batch, replica_tile, capacities)
            if mesh[0].type != device.type:
                raise ValueError(
                    f"the mesh's devices are {mesh[0].type}, device={str(device)!r}: "
                    "pass the device type the mesh is on"
                )
            device = mesh[0]
        if backend == "cuda":
            from repro_torch.kernels import ops

            if rung not in CUDA_RUNGS:
                raise ValueError(
                    f"backend='cuda' implements the fully vectorized rungs {CUDA_RUNGS} only; "
                    f"got rung={rung!r} (use backend='torch')"
                )
            if V != ops.LANES:
                raise ValueError(f"backend='cuda' requires V={ops.LANES}; got V={V}")
            if device.type != "cuda":
                raise ValueError(
                    f"backend='cuda' runs on a CUDA device; got device={str(device)!r} "
                    "(use backend='torch' on the CPU)"
                )
            ops.check_kernel_rows(
                rung, reorder.check_lane_shape(models.n, models.L, V), models.n,
                models.space_degree,
                len(reorder.colored_classes(models, V)) if rung == "cb" else 0,
                replica_tile=replica_tile or 1, multi=multi is not None,
            )
        return cls(models, rung, backend, batch, V, exp_flavor, device, models=multi,
                   replica_tile=replica_tile, mesh=mesh, capacities=capacities)

    @classmethod
    def build(cls, model: ising.LayeredModel, rung: str = "cb", backend: str = "cuda", *,
              batch: int = 1, **kwargs) -> "SweepEngine":
        """DEPRECATED: use `SweepEngine.create` (this is it, bit for bit)."""
        warnings.warn(
            "SweepEngine.build is deprecated; use SweepEngine.create",
            DeprecationWarning,
            stacklevel=2,
        )
        if not isinstance(model, ising.LayeredModel):
            raise ValueError("SweepEngine.build takes one model; use build_multi for a list")
        return cls.create(model, rung, backend, batch=batch, **kwargs)

    @classmethod
    def build_multi(cls, models, rung: str = "cb", backend: str = "cuda",
                    **kwargs) -> "SweepEngine":
        """DEPRECATED: use `SweepEngine.create` with a model list (bit for bit)."""
        warnings.warn(
            "SweepEngine.build_multi is deprecated; use SweepEngine.create",
            DeprecationWarning,
            stacklevel=2,
        )
        models = tuple(models)
        if not models:
            raise ValueError("build_multi needs at least one model")
        return cls.create(models, rung, backend, **kwargs)

    def _local_view(self, device: torch.device) -> "SweepEngine":
        """A shallow copy for one device's block: ``B_max`` slots on
        ``device``, no mesh.  The backend builders read the model, rung,
        flavour and device from it and build that device's tables."""
        loc = copy.copy(self)
        loc.batch, loc.device, loc.mesh, loc.capacities = self._b_max, device, None, None
        loc._slot_tables_cache = {}
        return loc

    # -- lifecycle ------------------------------------------------------------

    def init_carry(
        self,
        seed: int = 0,
        spins: np.ndarray | None = None,
        betas: np.ndarray | None = None,
    ) -> SweepCarry:
        """Initial batched carry (a `MeshCarry` on a mesh engine).

        ``spins`` may be None (per-replica random init from ``seed``), one
        flat (N,) configuration (replicated), or a (B, N) stack.  ``betas``
        defaults to the model beta on every replica (each slot's own
        model's beta on a multi-tenant engine); the fields are likewise
        each slot's own model's.  On a mesh the logical carry is the one a
        single device would start from, laid out into the devices' blocks.
        """
        m, B = self.model, self.batch
        # Slots whose tables were raw-spliced (model None) use the base model.
        slot_models = (
            tuple(mm if mm is not None else m for mm in self.models) if self.multi else (m,) * B
        )
        if spins is None:
            spin_list = [ising.init_spins(mm, seed=seed * 1000 + b)
                         for b, mm in enumerate(slot_models)]
        else:
            spins = np.asarray(spins, np.float32)
            if spins.ndim == 1:
                spin_list = [spins] * B
            else:
                if spins.shape[0] != B:
                    raise ValueError(f"spins batch {spins.shape[0]} != {B}")
                spin_list = list(spins)
        if betas is None:
            betas = np.asarray([mm.beta for mm in slot_models], np.float32)
        dev = self.device if self.mesh is None else "cpu"
        states = [self._slot_state(mm, sp, dev) for mm, sp in zip(slot_models, spin_list)]
        stacked = [torch.stack([s[i] for s in states]) for i in range(3)]
        # Flat rungs: one scalar generator per replica, seeds scrambled like
        # the lane rungs'.
        carry = SweepCarry(
            *stacked,
            betas=torch.as_tensor(np.asarray(betas, np.float32), device=dev),
            rng=mt.mt_init(lane_seeds(B, self._slot_lanes(), seed), dev),
        )
        if self.mesh is None:
            return carry
        from repro_torch.core import convert

        return self._carry_blocks(convert.carry_to_numpy(carry))

    def _slot_state(self, m: ising.LayeredModel, spins: np.ndarray, device=None):
        """One replica's state in the rung's layout, fields from scratch."""
        device = self.device if device is None else device
        if self.rung in FLAT_RUNGS:
            return metropolis.make_flat_state(m, spins, device)
        return metropolis.make_lane_state(m, spins, self.V, device)

    def run(self, carry, num_sweeps: int):
        """Advance every replica by ``num_sweeps`` Metropolis sweeps (one
        kernel launch on the "cuda" backend; on a mesh one a device, each on
        its device's own stream).  Returns a new carry.  A multi-tenant
        engine's launch reads the current slot tables.  On the card every
        launch is timed by CUDA events (`block_events`)."""
        if self.mesh is not None:
            return self._mesh_run(carry, int(num_sweeps))
        args = (carry, self.slot_tables, int(num_sweeps)) if self.multi else (carry, int(num_sweeps))
        if self.device.type != "cuda":
            return self._run(*args)
        out, (self._started[0], self._ready[0]) = _timed(
            self._run, args, torch.cuda.current_stream(self.device))
        return out

    def run_fn(self, num_sweeps: int) -> Callable:
        """Steady-state callable for benchmarking: ``fn(carry) -> carry``."""
        n = int(num_sweeps)
        return lambda carry: self.run(carry, n)

    # -- the mesh: per-device launches ------------------------------------------

    def _stream(self, d: int):
        if self._streams[d] is None:
            self._streams[d] = torch.cuda.Stream(device=self.mesh[d])
        return self._streams[d]

    def _mesh_run(self, carry: MeshCarry, num_sweeps: int) -> MeshCarry:
        """The unmodified single-device body once per device block.  On the
        card each block launches on its device's own stream, which first
        waits for the device's current stream (the splices and beta writes
        before it) and is then waited for by it (so every later read, write
        or free on the current stream follows the launch).  Each block's
        launch is timed by its own pair of CUDA timing events on that
        stream (`_timed`): `block_events` hands the pairs out, and the end
        event is what `device_ready_times` waits on."""
        blocks = list(carry.blocks)
        for d, blk in enumerate(blocks):
            if blk is None:
                self._ready[d] = self._started[d] = None
                continue
            dev = self.mesh[d]
            body = self._bodies[str(dev)]
            self.device_launches[d] += 1
            args = (blk, self.block_tables[d], num_sweeps) if self.multi else (blk, num_sweeps)
            if dev.type != "cuda":
                blocks[d] = body(*args)
                self._ready[d] = time.perf_counter()
                continue
            cur, stream = torch.cuda.current_stream(dev), self._stream(d)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                blocks[d], (self._started[d], self._ready[d]) = _timed(body, args, stream)
            cur.wait_stream(stream)
        return MeshCarry(tuple(blocks))

    def block_events(self) -> list:
        """The last launch's ``(start, end)`` CUDA timing events of each
        device block, in mesh device order (one pair without a mesh); None
        for a device that launched nothing (capacity 0) or runs on the
        host.  Recorded, never waited for."""
        return [(a, b) if isinstance(b, torch.cuda.Event) else None
                for a, b in zip(self._started, self._ready)]

    def device_ready_times(self, carry: MeshCarry, t0: float) -> np.ndarray:
        """(D,) wall seconds from ``t0`` until each device's block of the
        last launch was ready, in mesh device order (mesh engines only):
        the host-timed path, which waits.  On the card: the end event of
        each block's launch, synchronized in device order, ``perf_counter()
        - t0`` taken then (so a device behind a slower one reads its
        lateness: per-device device time is `block_events`'); on the host
        the moment each block's body returned.  A device of capacity 0 (no
        launch) reads as ready when its turn comes.  Pure reads; ``carry``
        (the launch's result) is untouched."""
        if self.mesh is None:
            raise ValueError("device_ready_times needs a mesh-sharded engine")
        if not isinstance(carry, MeshCarry) or len(carry.blocks) != len(self.mesh):
            raise ValueError("device_ready_times takes this engine's pool carry")
        out = np.empty(len(self.mesh), np.float64)
        for d, ready in enumerate(self._ready):
            if isinstance(ready, torch.cuda.Event):
                ready.synchronize()
                out[d] = time.perf_counter() - t0
            elif ready is None:
                out[d] = time.perf_counter() - t0
            else:
                out[d] = ready - t0
        return out

    def slot_energies(self, carry) -> torch.Tensor:
        """Per-slot energies (B,) float32 of the carry's spins, each device
        evaluating its own slots (lane rungs only), on the engine's device.

        `tempering.lane_energy` is the same expression the swap phase
        evaluates and its bits do not depend on the device or the batch, so
        a ladder spanning devices gathers only these B scalars and swaps
        exactly as a resident one.  Multi-tenant engines use each slot's
        own coupling tables."""
        from repro_torch.core.tempering import lane_energy as _lane_energy

        if self.rung not in LANE_RUNGS:
            raise ValueError(
                f"slot_energies is defined for lane rungs {LANE_RUNGS}; got rung={self.rung!r}"
            )
        if self.mesh is None:
            blocks, tables, caps = [carry], [self.slot_tables], [self.batch]
        else:
            blocks, tables, caps = carry.blocks, self.block_tables or [None] * len(self.mesh), \
                self.capacities
        out = []
        for d, (blk, tabs, cap) in enumerate(zip(blocks, tables, caps)):
            if not cap:
                continue
            dev = blk.spins.device
            nbr, bJ, tJ, h = self.energy_tables_on(dev)
            if self.multi:
                e = torch.stack([
                    _lane_energy(blk.spins[l], tabs["h"][l], nbr, tabs["base_J"][l],
                                 tabs["tau_J"][l], self.model.n)
                    for l in range(cap)
                ])
            else:
                e = _lane_energy(blk.spins[:cap], h, nbr, bJ, tJ, self.model.n)
            out.append(e.to(self.device))
        return torch.cat(out)

    def energy_tables_on(self, device):
        """`tempering.model_energy_tables` of the base model on ``device``,
        built once per engine and device."""
        from repro_torch.core import tempering

        key = str(device)
        if key not in self._energy_tabs:
            self._energy_tabs[key] = tempering.model_energy_tables(self.model, device)
        return self._energy_tabs[key]

    # -- views ----------------------------------------------------------------

    def spins_flat(self, carry) -> np.ndarray:
        """(B, N) spins in flat layer-major order (host numpy), comparable
        across rungs: always the LOGICAL slots (a mesh pool's padding rows
        dropped).  A single-slot carry (`extract_slot`) passes through."""
        m = self.model
        if isinstance(carry, MeshCarry):
            spins = self._logical_rows(carry, "spins")
        else:
            spins = carry.spins.cpu().numpy()
        if self.rung in FLAT_RUNGS:
            return spins
        return np.stack([reorder.from_lane(s, m.n, m.L, self.V) for s in spins])

    def state_of(self, carry, b: int = 0):
        """Replica ``b`` as a per-replica `FlatState` or `LaneState`."""
        cls = metropolis.FlatState if self.rung in FLAT_RUNGS else metropolis.LaneState
        blk, l = self.slot_row(carry, b)
        return cls(blk.spins[l], blk.h_space[l], blk.h_tau[l])

    def gather_betas(self, carry, slots) -> torch.Tensor:
        """The betas of the given logical slots, in order, as a float32
        tensor on the engine's device (no host round trip)."""
        return torch.cat([
            blk.betas[l : l + 1].to(self.device)
            for blk, l in (self.slot_row(carry, b) for b in slots)
        ])

    def retire_rows(self, carry, slots) -> tuple[np.ndarray, np.ndarray]:
        """The spins (K, N) float32, flat layer-major, and the betas (K,)
        float32 of the given logical slots, in order, as host numpy: what
        ``spins_flat(extract_slot(carry, b))[0]`` and `gather_betas` give,
        bit for bit, read in one pass.  Each device block holding some of
        the slots makes one indexed gather of their rows, the lane-to-flat
        permutation applied there, and one copy to the host (on the card
        non-blocking, into pinned memory); the host then waits once for
        every device.  Pure reads; a mesh's padding rows are never read."""
        slots = [int(b) for b in slots]
        groups: dict = {}  # device block -> (positions in ``slots``, rows there)
        for i, b in enumerate(slots):
            d, l = self._locate(b)
            pos, rows = groups.setdefault(d, ([], []))
            pos.append(i)
            rows.append(l)
        n = self.model.num_spins
        out, cards = [], set()
        for d, (pos, rows) in groups.items():
            blk = carry if self.mesh is None else carry.blocks[d]
            out.append((pos, self._retire_block(d, blk, rows)))
            if blk.spins.device.type == "cuda":
                cards.add(blk.spins.device)
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
        spins = np.empty((len(slots), n), np.float32)
        betas = np.empty(len(slots), np.float32)
        for pos, part in out:
            host = part.numpy()
            spins[pos], betas[pos] = host[:, :n], host[:, n]
        return spins, betas

    def _retire_block(self, d: int, blk: SweepCarry, rows: list) -> torch.Tensor:
        """`retire_rows`' part on device block ``d``: the rows' flat spins
        with their betas as a last column, (k, N + 1) float32 on the host
        (on the card in block ``d``'s pinned buffer, the copy in flight)."""
        dev = blk.spins.device
        idx = torch.tensor(rows, dtype=torch.int64)
        if dev.type == "cuda":
            idx = idx.pin_memory().to(dev, non_blocking=True)
        x = blk.spins.index_select(0, idx).reshape(len(rows), -1)
        if self.rung in LANE_RUNGS:
            key = str(dev)
            if key not in self._flat_index:
                perm = reorder.flat_to_lane_perm(self.model.n, self.model.L, self.V)
                self._flat_index[key] = torch.from_numpy(np.argsort(perm)).to(dev)
            x = x.index_select(1, self._flat_index[key])
        x = torch.cat([x, blk.betas.index_select(0, idx)[:, None]], dim=1)
        if dev.type != "cuda":
            return x
        buf = self._retire_bufs.get(d)
        if buf is None or buf.numel() < x.numel():
            buf = self._retire_bufs[d] = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
        host = buf[: x.numel()].view(x.shape)
        host.copy_(x, non_blocking=True)
        return host

    # -- per-slot splice/extract (the serve scheduler's admit/retire API) ------

    def _slot_lanes(self) -> int:
        """Generator columns owned by one slot (one on the flat rungs)."""
        return self.V if self.rung in LANE_RUNGS else 1

    def _check_slot(self, b: int) -> None:
        if not 0 <= b < self.batch:
            raise ValueError(f"slot {b} out of range for batch {self.batch}")

    def slot_device(self, b: int) -> int:
        """Mesh device owning logical slot ``b`` (0 without a mesh): the
        prefix-sum bracket of the capacity vector, which skips devices of
        capacity 0."""
        if self.mesh is None:
            return 0
        return int(np.searchsorted(self._cum, int(b), side="right")) - 1

    def phys_slots(self, slots) -> np.ndarray:
        """Physical rows ``d * B_max + l`` of the given LOGICAL slots (the
        identity unless a mesh's capacities are uneven)."""
        return self._phys_index[np.asarray(slots, np.int64)]

    def _slot_phys(self, b: int) -> int:
        """Physical row of logical slot ``b``."""
        return int(self._phys_index[int(b)])

    def _locate(self, b: int) -> tuple[int, int]:
        """(device, row in its block) of logical slot ``b``."""
        self._check_slot(b)
        return divmod(self._slot_phys(b), self._b_max)

    def slot_row(self, carry, b: int):
        """(the carry, or on a mesh the device block, holding logical slot
        ``b``; its row there)."""
        if self.mesh is None:
            self._check_slot(b)
            return carry, b
        d, l = self._locate(b)
        return carry.blocks[d], l

    def init_slot_carry(
        self,
        seed: int = 0,
        spins: np.ndarray | None = None,
        beta: float | None = None,
        rng_seeds: np.ndarray | None = None,
        model: ising.LayeredModel | None = None,
        rng_state: torch.Tensor | None = None,
    ) -> SweepCarry:
        """A single-slot (batch=1 shaped) carry for `splice_slot`.

        Bit-identical to ``init_carry(seed=seed)`` on a ``batch=1`` engine.
        ``rng_seeds`` overrides the per-lane seeds ((V,) uint32; (1,) on
        the flat rungs).  ``rng_state`` is the slot's generator state
        seeded already (`seed_slot_rngs`, (624, V) on the host) in place of
        seeding it here from ``rng_seeds``.
        ``model`` (multi-tenant engines only) computes the slot's fields and
        default beta from that model; splice its tables into the same slot
        (`set_slot_model`), or the carry will not match what the slot sweeps.
        """
        if model is None:
            m = self.model
        else:
            if not self.multi:
                raise ValueError(
                    "per-slot models need a multi-tenant engine (create it with a model list)"
                )
            self.check_model(model)
            m = model
        if spins is None:
            spins = ising.init_spins(m, seed=seed * 1000)
        else:
            spins = np.asarray(spins, np.float32)
            if spins.ndim != 1:
                raise ValueError(f"slot spins must be flat (N,), got {spins.shape}")
        lanes = self._slot_lanes()
        if rng_state is not None:
            if tuple(rng_state.shape) != (mt.N, lanes):
                raise ValueError(
                    f"rng_state must have shape ({mt.N}, {lanes}), got {tuple(rng_state.shape)}"
                )
            rng = rng_state.to(self.device)
        elif rng_seeds is None:
            rng = mt.mt_init(lane_seeds(1, lanes, seed), self.device)
        else:
            rng_seeds = np.asarray(rng_seeds, np.uint32)
            if rng_seeds.shape != (lanes,):
                raise ValueError(
                    f"rng_seeds must have shape ({lanes},), got {rng_seeds.shape}"
                )
            rng = mt.mt_init(rng_seeds, self.device)
        st = self._slot_state(m, spins)
        beta_arr = torch.full(
            (1,), m.beta if beta is None else beta, dtype=torch.float32, device=self.device
        )
        return SweepCarry(st.spins[None], st.h_space[None], st.h_tau[None], beta_arr, rng)

    def seed_slot_rngs(self, seed_rows) -> list[torch.Tensor]:
        """The generator states of many slots, seeded in one vectorised pass
        on the host: `mt.mt_init` over all their lanes at once, whose
        recurrence runs lane by lane, so each state is the one
        `init_slot_carry` would seed from that slot's seeds alone.
        ``seed_rows`` holds each slot's lane seeds ((V,) uint32; (1,) on the
        flat rungs); returns a (624, V) int32 host tensor a slot, in order,
        for ``init_slot_carry(rng_state=...)``."""
        rows = [np.asarray(r, np.uint32) for r in seed_rows]
        if not rows:
            return []
        state = mt.mt_init(np.concatenate(rows), "cpu")
        ends = np.cumsum([len(r) for r in rows])
        return [state[:, e - len(r) : e].contiguous() for r, e in zip(rows, ends)]

    def splice_slot(self, carry, b: int, slot: SweepCarry):
        """Write a single-slot carry into logical slot ``b``; returns a new
        carry (on a mesh only the owning device's block is rebuilt, on that
        device).  Pure data movement — bit-exact by construction."""
        blk, l = self.slot_row(carry, b)
        dev = blk.spins.device
        V = self._slot_lanes()
        out = [x.clone() for x in blk]
        for i in range(4):
            out[i][l] = slot[i][0].to(dev)
        out[4][:, l * V : (l + 1) * V] = slot.rng.to(dev)
        return self._replace_block(carry, b, SweepCarry(*out))

    def _replace_block(self, carry, b: int, block: SweepCarry):
        if self.mesh is None:
            return block
        d = self._locate(b)[0]
        return MeshCarry(carry.blocks[:d] + (block,) + carry.blocks[d + 1 :])

    def extract_slot(self, carry, b: int) -> SweepCarry:
        """Logical slot ``b`` of a batched carry as a single-slot carry (the
        exact inverse of `splice_slot`; a copy, so later carries never alias
        it), on the device that owns the slot."""
        blk, l = self.slot_row(carry, b)
        V = self._slot_lanes()
        return SweepCarry(
            *(x[l : l + 1].clone() for x in blk[:4]),
            blk.rng[:, l * V : (l + 1) * V].clone(),
        )

    def slot(self, b: int) -> SlotHandle:
        """Handle bundling every per-slot operation on slot ``b``."""
        self._check_slot(b)
        return SlotHandle(self, b)

    def park_slot(self, carry, b: int) -> ParkedSlot:
        """DEPRECATED: use ``engine.slot(b).park(carry)`` (this is it)."""
        warnings.warn(
            "SweepEngine.park_slot is deprecated; use SweepEngine.slot(b).park",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.slot(b).park(carry)

    def resume_slot(self, carry, b: int, parked: ParkedSlot, model=None):
        """DEPRECATED: use ``engine.slot(b).resume(carry, parked)`` (this is
        it; any slot, the one the state was parked from or another)."""
        warnings.warn(
            "SweepEngine.resume_slot is deprecated; use SweepEngine.slot(b).resume",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.slot(b).resume(carry, parked, model=model)

    # -- the whole pool (snapshots), and the mesh's logical <-> block layout ---

    def _pad_template(self) -> dict:
        """One padding row, host numpy: a fixed function of the base model
        (the reference's template), so a pool laid out onto any mesh is
        reproducible.  No API ever reads a padding row."""
        if self._pad_state is None:
            m = self.model
            st = self._slot_state(m, ising.init_spins(m, seed=0), "cpu")
            rng = mt.mt_init(lane_seeds(1, self._slot_lanes(), 0), "cpu")
            self._pad_state = dict(
                spins=st.spins.numpy(), h_space=st.h_space.numpy(), h_tau=st.h_tau.numpy(),
                betas=np.float32(m.beta), rng=rng.numpy().view(np.uint32),
            )
        return self._pad_state

    def _carry_blocks(self, logical: dict) -> MeshCarry:
        """A LOGICAL host carry (numpy leaves, rng uint32) laid out into the
        devices' padded blocks, each in its own device's storage."""
        from repro_torch.core import convert

        pad, lanes, b_max = self._pad_template(), self._slot_lanes(), self._b_max
        blocks = []
        for d, cap in enumerate(self.capacities):
            if not cap:
                blocks.append(None)
                continue
            lo, hi = int(self._cum[d]), int(self._cum[d + 1])
            leaves = {}
            for f in ("spins", "h_space", "h_tau", "betas"):
                x = np.asarray(logical[f])
                out = np.empty((b_max,) + x.shape[1:], x.dtype)
                out[:] = pad[f]
                out[:cap] = x[lo:hi]
                leaves[f] = out
            rng = np.tile(pad["rng"], (1, b_max))
            rng[:, : cap * lanes] = np.asarray(logical["rng"])[:, lo * lanes : hi * lanes]
            leaves["rng"] = rng
            blocks.append(convert.carry_from_numpy(leaves, self.mesh[d]))
        return MeshCarry(tuple(blocks))

    def _logical_rows(self, carry: MeshCarry, field: str) -> np.ndarray:
        """One leaf of a mesh pool in LOGICAL layout, host numpy (rng as
        uint32): each device's first ``capacities[d]`` rows (columns)."""
        from repro_torch.core import convert

        lanes, parts = self._slot_lanes(), []
        for blk, cap in zip(carry.blocks, self.capacities):
            if not cap:
                continue
            x = getattr(blk, field)
            parts.append(convert.host_copy(x[:, : cap * lanes] if field == "rng" else x[:cap]))
        out = np.concatenate(parts, axis=1 if field == "rng" else 0)
        return out.view(np.uint32) if field == "rng" else out

    def _table_blocks(self, logical: dict) -> list:
        """LOGICAL [B, ...] slot tables (numpy) as one padded [B_max, ...]
        dict a device, padding rows on the base model's couplings."""
        fill = _coupling_tables(self.model, "cpu")
        out = []
        for d, cap in enumerate(self.capacities):
            if not cap:
                out.append(None)
                continue
            lo, hi = int(self._cum[d]), int(self._cum[d + 1])
            blk = {}
            for k, v in logical.items():
                v = np.asarray(v, np.float32)
                big = np.empty((self._b_max,) + v.shape[1:], np.float32)
                big[:] = fill[k].numpy()
                big[:cap] = v[lo:hi]
                blk[k] = torch.from_numpy(big).to(self.mesh[d])
            out.append(blk)
        return out

    def extract_pool(self, carry) -> PoolState:
        """The WHOLE pool's resumable state as host numpy copies in LOGICAL
        layout (one copy per leaf, never a view of the carry or the tables:
        a snapshot written in the background while the server steps on must
        hold this boundary's state).  A mesh pool drops its padding rows,
        so the state restores onto any mesh.  Pure read."""
        from repro_torch.core import convert

        if self.mesh is None:
            host = SweepCarry(**convert.carry_to_numpy(carry))
            tables = convert.slot_tables_to_numpy(self) if self.multi else None
            return PoolState(host, tables)
        host = SweepCarry(*(self._logical_rows(carry, f) for f in SweepCarry._fields))
        tables = None
        if self.multi:
            tables = {
                k: np.concatenate([convert.host_copy(t[k][:cap])
                                   for t, cap in zip(self.block_tables, self.capacities) if cap])
                for k in convert.SLOT_TABLE_KEYS
            }
        return PoolState(host, tables)

    def splice_pool(self, pool: PoolState):
        """Install a `PoolState` as this engine's pool (the exact inverse of
        `extract_pool`; also takes the JAX reference's).  The pool is in
        LOGICAL layout, so this engine lays it out for its own mesh,
        whatever device count or capacity vector extracted it.  The carry
        goes to the engine's devices with ``rng`` back in int32 storage; on
        multi-tenant engines the coupling tables are installed too and every
        slot's model provenance resets to None (a raw splice: a later
        `set_slot_model` re-records it).  Returns the new carry."""
        from repro_torch.core import convert

        spins = np.asarray(pool.carry.spins)
        want = (
            (self.batch, self.rows, self.V)
            if self.rung in LANE_RUNGS
            else (self.batch, self.model.num_spins)
        )
        if tuple(spins.shape) != want:
            raise ValueError(
                f"pool spins shape {spins.shape} does not fit this engine "
                f"(want {want}: batch={self.batch}, rung={self.rung!r})"
            )
        rng = np.asarray(pool.carry.rng)
        if rng.shape != (mt.N, self.batch * self._slot_lanes()):
            raise ValueError(
                f"pool rng shape {rng.shape}; this engine needs "
                f"{(mt.N, self.batch * self._slot_lanes())}"
            )
        if self.multi:
            if pool.tables is None:
                raise ValueError("multi-tenant engines need the pool's coupling tables")
            if self.mesh is None:
                self.slot_tables = convert.slot_tables_from_numpy(pool.tables, self.device)
            else:
                missing = [k for k in convert.SLOT_TABLE_KEYS if k not in pool.tables]
                if missing:
                    raise ValueError(f"slot tables miss {missing}")
                self.block_tables = self._table_blocks(
                    {k: pool.tables[k] for k in convert.SLOT_TABLE_KEYS})
            self.models = (None,) * self.batch
        elif pool.tables is not None:
            raise ValueError("pool carries coupling tables but this engine is single-model")
        if self.mesh is None:
            return convert.carry_from_numpy(pool.carry._asdict(), self.device)
        return self._carry_blocks(pool.carry._asdict())

    def set_slot_betas(self, carry, slots, betas):
        """Rewrite the betas of the given logical slots without touching
        spins, fields or RNG; returns a new carry.  ``betas`` may be host
        values or a float32 tensor (a device tensor stays on the device)."""
        if isinstance(betas, torch.Tensor):
            vals = betas.to(dtype=torch.float32)
        else:
            vals = torch.as_tensor(np.asarray(betas, np.float32))
        slots = [int(b) for b in slots]
        if self.mesh is None:
            groups = {0: (list(range(len(slots))), slots)}
        else:
            groups = {}
            for i, b in enumerate(slots):
                d, l = self._locate(b)
                pos, rows = groups.setdefault(d, ([], []))
                pos.append(i)
                rows.append(l)
        for d, (pos, rows) in groups.items():
            blk = carry if self.mesh is None else carry.blocks[d]
            dev = blk.betas.device
            new = blk.betas.clone()
            new[torch.as_tensor(rows, device=dev)] = vals.to(dev)[
                torch.as_tensor(pos, device=dev)]
            if self.mesh is None:
                carry = carry._replace(betas=new)
            else:
                carry = MeshCarry(
                    carry.blocks[:d] + (blk._replace(betas=new),) + carry.blocks[d + 1 :])
        return carry

    def check_model(self, model: ising.LayeredModel) -> None:
        """Raise unless ``model`` is admissible in this engine's slots."""
        check_same_topology(self.model, model)

    # -- per-slot model tables (the multi-tenant admit API) --------------------

    def _check_multi(self, what: str, b: int) -> None:
        if not self.multi:
            raise ValueError(f"{what} needs a multi-tenant engine")
        self._check_slot(b)

    def slot_tables_for(self, model: ising.LayeredModel) -> dict:
        """Single-slot (leading dim 1) coupling tables of ``model`` on the
        engine's device, for `splice_slot_tables`.  Cached per model
        object, so admitting a recurring tenant uploads nothing."""
        hit = self._slot_tables_cache.get(id(model))
        if hit is not None and hit[0] is model:
            return hit[1]
        self.check_model(model)
        tabs = {k: v[None] for k, v in _coupling_tables(model, self.device).items()}
        if len(self._slot_tables_cache) >= self.SLOT_TABLES_CACHE_MAX:
            self._slot_tables_cache.clear()
        self._slot_tables_cache[id(model)] = (model, tabs)
        return tabs

    def splice_slot_tables(self, b: int, slot: dict) -> None:
        """Write single-slot coupling tables into slot ``b``.  Builds new
        `slot_tables` tensors (never writes into ones an earlier launch may
        still read).  The slot's model (`model_of`) becomes None: a raw
        table splice carries no model object, and a stale entry would let a
        later `set_slot_model` wrongly no-op."""
        self._check_multi("splice_slot_tables", b)
        self.models = self.models[:b] + (None,) + self.models[b + 1 :]
        d, l = self._locate(b)
        tables = self.slot_tables if self.mesh is None else self.block_tables[d]
        new = {}
        for k, dst in tables.items():
            t = dst.clone()
            t[l] = slot[k][0].to(t.device)
            new[k] = t
        if self.mesh is None:
            self.slot_tables = new
        else:
            self.block_tables = self.block_tables[:d] + [new] + self.block_tables[d + 1 :]

    def extract_slot_tables(self, b: int) -> dict:
        """Slot ``b``'s coupling tables as single-slot tensors (the exact
        inverse of `splice_slot_tables`; copies, on the owning device)."""
        self._check_multi("extract_slot_tables", b)
        d, l = self._locate(b)
        tables = self.slot_tables if self.mesh is None else self.block_tables[d]
        return {k: v[l : l + 1].clone() for k, v in tables.items()}

    def set_slot_model(self, b: int, model: ising.LayeredModel) -> None:
        """Admit ``model`` into slot ``b``: splice its tables and record it
        as the slot's model.  A no-op when the slot already holds it."""
        self._check_multi("set_slot_model", b)
        if self.models[b] is model:
            return
        self.splice_slot_tables(b, self.slot_tables_for(model))
        self.models = self.models[:b] + (model,) + self.models[b + 1 :]

    def model_of(self, b: int) -> ising.LayeredModel | None:
        """The model slot ``b`` sweeps: the engine's one model, or on a
        multi-tenant engine the slot's (None if its tables were last
        written by a raw `splice_slot_tables`)."""
        self._check_slot(b)
        return self.models[b] if self.multi else self.model


# -----------------------------------------------------------------------------
# Backends.
# -----------------------------------------------------------------------------


def _model_tensors(eng: SweepEngine) -> dict:
    m, dev = eng.model, eng.device
    return dict(
        h=torch.from_numpy(np.asarray(m.h, np.float32)).to(dev),
        base_nbr=torch.from_numpy(np.asarray(m.space_nbr, np.int64)).to(dev),
        base_J=torch.from_numpy(np.asarray(m.space_J, np.float32)).to(dev),
        tau_J=torch.from_numpy(np.asarray(m.tau_J, np.float32)).to(dev),
    )


def _a4_tensors(eng: SweepEngine) -> dict:
    """The a4 sweep's tables: neighbour ids (int32) and the doubled
    couplings, float32 like the reference's ``2.0 * space_J``."""
    m, dev = eng.model, eng.device
    return dict(
        base_nbr=torch.from_numpy(np.asarray(m.space_nbr, np.int32)).to(dev),
        base_J2=torch.from_numpy(np.asarray(2.0 * m.space_J, np.float32)).to(dev),
        tau_J2=torch.from_numpy(np.asarray(2.0 * m.tau_J, np.float32)).to(dev),
    )


def _flat_runner(eng: SweepEngine, sweep) -> Callable:
    """``run`` of a flat rung: per sweep, ``N`` uniforms of each replica's
    scalar generator (one column of the (624, B) state), then
    ``sweep(state, u (B, N), betas)``."""
    N = eng.model.num_spins

    def run(carry: SweepCarry, num_sweeps: int) -> SweepCarry:
        st, rng = metropolis.FlatState(*carry[:3]), carry.rng
        for _ in range(num_sweeps):
            rng, u = mt.mt_uniforms_count(rng, N)
            st = sweep(st, u.T, carry.betas)
        return SweepCarry(*st, carry.betas, rng)

    return run


def _build_torch(eng: SweepEngine) -> Callable:
    from repro_torch.kernels import ref

    m, dev = eng.model, eng.device
    exp_fn = fastexp.exp_fn(eng.exp_flavor)
    if eng.rung == "a1":
        steps = metropolis.original_steps(*ising.original_arrays(m))
        return _flat_runner(
            eng, lambda st, u, beta: metropolis.sweep_original(st, steps, u, beta, exp_fn)
        )
    if eng.rung == "a2":
        targets, J2 = ising.flat_arrays(m)
        targets = torch.from_numpy(targets.astype(np.int64)).to(dev)
        J2 = torch.from_numpy(J2).to(dev)
        return _flat_runner(
            eng, lambda st, u, beta: metropolis.sweep_flat(
                st, targets, J2, u, beta, m.space_degree, exp_fn)
        )
    if eng.rung == "a3":
        tabs = _a4_tensors(eng)

        def run_a3(carry: SweepCarry, num_sweeps: int) -> SweepCarry:
            st, rng = metropolis.LaneState(*carry[:3]), carry.rng
            B, rows, V = st.spins.shape
            for _ in range(num_sweeps):
                rng, u = mt.mt_uniforms_count(rng, rows)
                u = u.reshape(rows, B, V).permute(1, 0, 2)
                st = metropolis.sweep_lane(
                    st, tabs["base_nbr"], tabs["base_J2"], tabs["tau_J2"], u, carry.betas,
                    m.n, exp_fn, scalar_updates=True,
                )
            return SweepCarry(*st, carry.betas, rng)

        return run_a3
    if eng.rung == "a4":
        tabs = _a4_tensors(eng)

        def run_a4(carry: SweepCarry, num_sweeps: int) -> SweepCarry:
            spins, hs, ht, rng = ref.metropolis_multisweep_ref(
                carry.spins, carry.h_space, carry.h_tau, carry.rng, **tabs,
                beta=carry.betas, n=eng.model.n, num_sweeps=num_sweeps,
                exp_flavor=eng.exp_flavor,
            )
            return SweepCarry(spins, hs, ht, carry.betas, rng)

        return run_a4

    classes = metropolis.classes_to(eng.classes, eng.device)
    tabs = _model_tensors(eng)

    def run_cb(carry: SweepCarry, num_sweeps: int) -> SweepCarry:
        spins, hs, ht, rng = ref.colored_multisweep_ref(
            carry.spins, carry.rng, carry.betas, classes, **tabs,
            n=eng.model.n, num_sweeps=num_sweeps, exp_flavor=eng.exp_flavor,
        )
        return SweepCarry(spins, hs, ht, carry.betas, rng)

    return run_cb


def _build_cuda(eng: SweepEngine) -> Callable:
    from repro_torch.kernels import ops

    m = eng.model
    if eng.rung == "a4":
        tabs = _a4_tensors(eng)

        def run_a4(carry: SweepCarry, num_sweeps: int) -> SweepCarry:
            spins, hs, ht, rng = ops.metropolis_multisweep(
                carry.spins, carry.h_space, carry.h_tau, carry.rng, **tabs,
                beta=carry.betas, n=m.n, num_sweeps=num_sweeps, exp_flavor=eng.exp_flavor,
                replica_tile=eng.replica_tile,
            )
            return SweepCarry(spins, hs, ht, carry.betas, rng)

        return run_a4

    colored_fn = ops.make_colored_multisweep(
        eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=m.n,
        exp_flavor=eng.exp_flavor,
    )

    def run_cb(carry: SweepCarry, num_sweeps: int) -> SweepCarry:
        spins, hs, ht, rng = colored_fn(carry.spins, carry.rng, carry.betas, num_sweeps)
        return SweepCarry(spins, hs, ht, carry.betas, rng)

    return run_cb


register_backend("torch", _build_torch)
register_backend("cuda", _build_cuda)


# -----------------------------------------------------------------------------
# Multi-tenant backends: the same sweeps, the coupling tables as arguments.
# With B copies of one model's tables every float is the single-model one.
# -----------------------------------------------------------------------------


def _build_torch_multi(eng: SweepEngine) -> Callable:
    from repro_torch.kernels import ref

    n = eng.model.n
    base_nbr = torch.from_numpy(np.asarray(eng.model.space_nbr, np.int32)).to(eng.device)
    if eng.rung == "a4":

        def run_a4(carry: SweepCarry, tabs: dict, num_sweeps: int) -> SweepCarry:
            spins, hs, ht, rng = ref.metropolis_multisweep_multi_ref(
                carry.spins, carry.h_space, carry.h_tau, carry.rng, base_nbr,
                tabs["base_J2"], tabs["tau_J2"], carry.betas, n, num_sweeps, eng.exp_flavor,
            )
            return SweepCarry(spins, hs, ht, carry.betas, rng)

        return run_a4

    classes = metropolis.classes_to(eng.classes, eng.device)
    base_nbr = base_nbr.long()

    def run_cb(carry: SweepCarry, tabs: dict, num_sweeps: int) -> SweepCarry:
        spins, hs, ht, rng = ref.colored_multisweep_multi_ref(
            carry.spins, carry.rng, carry.betas, classes, tabs["h"], base_nbr,
            tabs["base_J"], tabs["tau_J"], n, num_sweeps, eng.exp_flavor,
        )
        return SweepCarry(spins, hs, ht, carry.betas, rng)

    return run_cb


def _build_cuda_multi(eng: SweepEngine) -> Callable:
    from repro_torch.kernels import ops

    m = eng.model
    if eng.rung == "a4":
        base_nbr = torch.from_numpy(np.asarray(m.space_nbr, np.int32)).to(eng.device)

        def run_a4(carry: SweepCarry, tabs: dict, num_sweeps: int) -> SweepCarry:
            spins, hs, ht, rng = ops.metropolis_multisweep_multi(
                carry.spins, carry.h_space, carry.h_tau, carry.rng, base_nbr,
                tabs["base_J2"], tabs["tau_J2"], carry.betas, n=m.n, num_sweeps=num_sweeps,
                exp_flavor=eng.exp_flavor, replica_tile=eng.replica_tile,
            )
            return SweepCarry(spins, hs, ht, carry.betas, rng)

        return run_a4

    colored_fn = ops.make_colored_multisweep_multi(
        eng.classes, m.space_nbr, n=m.n, exp_flavor=eng.exp_flavor
    )

    def run_cb(carry: SweepCarry, tabs: dict, num_sweeps: int) -> SweepCarry:
        spins, hs, ht, rng = colored_fn(
            carry.spins, carry.rng, carry.betas, tabs["h"], tabs["base_J"], tabs["tau_J"],
            num_sweeps,
        )
        return SweepCarry(spins, hs, ht, carry.betas, rng)

    return run_cb


register_multi_backend("torch", _build_torch_multi)
register_multi_backend("cuda", _build_cuda_multi)
