"""`SweepEngine` — the single construction path for Metropolis sweeps.

One API owns the sweep lifecycle of a batch of replicas:

    eng = SweepEngine.create(model, rung="cb", backend="cuda", batch=8)
    carry = eng.init_carry(seed=0)
    carry = eng.run(carry, num_sweeps)       # one kernel launch
    spins = eng.spins_flat(carry)            # (B, N) layer-major numpy

Carry layout (`SweepCarry`), batched over replicas:

    spins/h_space/h_tau   (B, rows, V) float32
    betas                 (B,) float32       per-replica inverse temperature
    rng                   (624, B*V) int32   V interlaced MT19937 generators
                                             per replica (replica b owns
                                             columns b*V..(b+1)*V), uint32
                                             bits stored as int32

Backends (`register_backend`):

  * ``"torch"`` — the plain PyTorch version (`kernels.ref`), any V, on CPU
    or CUDA tensors; uniforms come from the host-side-formulated blocked
    MT19937, one draw per sweep.
  * ``"cuda"``  — the hand-written kernels: one launch advances every
    replica ``num_sweeps`` sweeps with the MT19937 twist/temper inside the
    kernel (rung "a4": kernels/csrc/metropolis_multisweep.cu, rung "cb":
    kernels/csrc/colored_multisweep.cu).  V must be 128 and the device a
    CUDA device.

Both evaluate the identical twist -> temper -> 24-bit-float pipeline on
the identical per-replica generator columns and the identical row (a4)
or class (cb) visit order, so they are bit-exact with each other and
with the JAX reference's jnp and Pallas backends.

Rungs: "a4", the paper's sequential sweep, carries ``h_space``/``h_tau``
as state and updates them incrementally; "cb", the graph-colored sweep,
recomputes them densely at the end of each run.

This port serves ONE model with the rungs "a4" and "cb" on one device.
Rungs a1-a3, exp flavours other than "fast", ``replica_tile``, device
meshes (``mesh``/``capacities``) and multi-tenant model lists are not
ported yet and raise ValueError naming themselves.

Slots: a batched carry is a row of independent slots; slot b owns row b
of spins/fields/betas and its own generator columns, so a slot's
trajectory is a pure function of its spliced-in state and the sweep
count — the invariant continuous batching rests on.  Carries are
treated as values: every method returns new tensors and never writes
into the carry it was given.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import fastexp, ising, metropolis, mt19937 as mt, reorder

RUNGS = ("a1", "a2", "a3", "a4", "cb")
#: Rungs this port implements.
PORTED_RUNGS = ("a4", "cb")

#: Default exp flavour per rung (every ported rung uses the bit-trick exp).
DEFAULT_EXP = {"a4": "fast", "cb": "fast"}

#: Seed-scrambling multiplier for per-lane MT19937 seeds (Knuth's 2^32/phi).
LANE_SEED_MULT = np.uint32(2654435761)


class SweepCarry(NamedTuple):
    """Batched sweep state: everything `run` needs, nothing it doesn't."""

    spins: torch.Tensor  # (B, rows, V)
    h_space: torch.Tensor  # same shape as spins
    h_tau: torch.Tensor  # same shape as spins
    betas: torch.Tensor  # (B,)
    rng: torch.Tensor  # (624, B*V) int32 holding uint32 bits


class ParkedSlot(NamedTuple):
    """A preempted slot's complete resumable state (`SlotHandle.park`).

    ``carry`` is the single-slot `SweepCarry` at the chunk boundary the
    slot was evicted on; ``tables`` is None on single-model engines (the
    only kind ported).  Re-splicing it continues the slot's trajectory
    bit-exactly: the RNG stream position is a pure function of sweeps
    completed."""

    carry: SweepCarry
    tables: dict | None


class SlotHandle:
    """All per-slot operations on one logical slot (`engine.slot(b)`):
    ``extract()``/``splice()`` and their scheduler names ``park()``/
    ``resume()``.  Cheap value objects — create them on the fly."""

    __slots__ = ("engine", "index")

    def __init__(self, engine: "SweepEngine", index: int):
        self.engine = engine
        self.index = index

    def __repr__(self) -> str:
        return f"SlotHandle(b={self.index}, device={self.device})"

    @property
    def device(self) -> int:
        """Device index owning this slot (always 0: one device)."""
        return 0

    def extract(self, carry: SweepCarry) -> ParkedSlot:
        """This slot's complete resumable state.  Pure read."""
        return ParkedSlot(self.engine.extract_slot(carry, self.index), None)

    def splice(self, carry: SweepCarry, state, model=None) -> SweepCarry:
        """Write ``state`` — a `ParkedSlot` or a bare single-slot
        `SweepCarry` — into this slot; returns the updated carry."""
        if model is not None:
            raise ValueError("per-slot models need multi_tenant, which is not ported")
        if isinstance(state, ParkedSlot):
            state = state.carry
        return self.engine.splice_slot(carry, self.index, state)

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


# -----------------------------------------------------------------------------
# Backend registry.
# -----------------------------------------------------------------------------

_BACKENDS: dict[str, Callable[["SweepEngine"], Callable]] = {}


def register_backend(name: str, builder: Callable[["SweepEngine"], Callable]) -> None:
    """Register ``builder(engine) -> fn(carry, num_sweeps) -> carry``.

    The builder runs once at `SweepEngine.create` time and may close over
    the engine's model tables.
    """
    _BACKENDS[name] = builder


def backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


class SweepEngine:
    """One sweep lifecycle: model tables + backend dispatch."""

    def __init__(
        self,
        model: ising.LayeredModel,
        rung: str,
        backend: str,
        batch: int,
        V: int,
        exp_flavor: str,
        device: torch.device,
    ):
        self.model = model
        self.rung = rung
        self.backend = backend
        self.batch = batch
        self.V = V
        self.exp_flavor = exp_flavor
        self.device = device
        self.rows = reorder.check_lane_shape(model.n, model.L, V)
        self.classes = reorder.colored_classes(model, V) if rung == "cb" else None
        self._run = _BACKENDS[backend](self)

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
        """THE constructor.  ``models`` is one `LayeredModel`; ``batch``
        replica slots (default 1) live on ``device``.  ``backend="cuda"``
        needs ``V=128`` and a CUDA ``device``; ``backend="torch"`` runs the
        plain version on any device and any V."""
        if not isinstance(models, ising.LayeredModel):
            raise ValueError("multi-tenant model lists are not ported to repro_torch yet")
        if replica_tile is not None:
            raise ValueError("replica_tile is not ported to repro_torch")
        if mesh is not None or capacities is not None:
            raise ValueError("device meshes (mesh=/capacities=) are not ported to repro_torch yet")
        if rung not in RUNGS:
            raise ValueError(f"unknown rung {rung!r}; choose from {RUNGS}")
        if rung not in PORTED_RUNGS:
            raise ValueError(
                f"rung {rung!r} is not ported to repro_torch yet; ported: {PORTED_RUNGS}"
            )
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; registered: {backends()}")
        batch = 1 if batch is None else int(batch)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        exp_flavor = exp_flavor or DEFAULT_EXP[rung]
        fastexp.exp_fn(exp_flavor)  # raises for unported flavours
        device = torch.device(device)
        if backend == "cuda":
            from repro_torch.kernels import ops

            if V != ops.LANES:
                raise ValueError(f"backend='cuda' requires V={ops.LANES}; got V={V}")
            if device.type != "cuda":
                raise ValueError(
                    f"backend='cuda' runs on a CUDA device; got device={str(device)!r} "
                    "(use backend='torch' on the CPU)"
                )
        return cls(models, rung, backend, batch, V, exp_flavor, device)

    # -- lifecycle ------------------------------------------------------------

    def init_carry(
        self,
        seed: int = 0,
        spins: np.ndarray | None = None,
        betas: np.ndarray | None = None,
    ) -> SweepCarry:
        """Initial batched carry.

        ``spins`` may be None (per-replica random init from ``seed``), one
        flat (N,) configuration (replicated), or a (B, N) stack.  ``betas``
        defaults to the model beta on every replica.
        """
        m, B = self.model, self.batch
        if spins is None:
            spin_list = [ising.init_spins(m, seed=seed * 1000 + b) for b in range(B)]
        else:
            spins = np.asarray(spins, np.float32)
            if spins.ndim == 1:
                spin_list = [spins] * B
            else:
                if spins.shape[0] != B:
                    raise ValueError(f"spins batch {spins.shape[0]} != {B}")
                spin_list = list(spins)
        if betas is None:
            betas = np.full((B,), m.beta, np.float32)
        states = [metropolis.make_lane_state(m, sp, self.V, self.device) for sp in spin_list]
        stacked = [torch.stack([s[i] for s in states]) for i in range(3)]
        return SweepCarry(
            *stacked,
            betas=torch.as_tensor(np.asarray(betas, np.float32), device=self.device),
            rng=mt.mt_init(lane_seeds(B, self.V, seed), self.device),
        )

    def run(self, carry: SweepCarry, num_sweeps: int) -> SweepCarry:
        """Advance every replica by ``num_sweeps`` Metropolis sweeps (one
        kernel launch on the "cuda" backend).  Returns a new carry."""
        return self._run(carry, int(num_sweeps))

    def run_fn(self, num_sweeps: int) -> Callable[[SweepCarry], SweepCarry]:
        """Steady-state callable for benchmarking: ``fn(carry) -> carry``."""
        n = int(num_sweeps)
        return lambda carry: self._run(carry, n)

    # -- views ----------------------------------------------------------------

    def spins_flat(self, carry: SweepCarry) -> np.ndarray:
        """(B, N) spins in flat layer-major order (host numpy)."""
        m = self.model
        spins = carry.spins.cpu().numpy()
        return np.stack([reorder.from_lane(s, m.n, m.L, self.V) for s in spins])

    def state_of(self, carry: SweepCarry, b: int = 0) -> metropolis.LaneState:
        """Replica ``b`` as a per-replica `LaneState`."""
        return metropolis.LaneState(carry.spins[b], carry.h_space[b], carry.h_tau[b])

    # -- per-slot splice/extract (the serve scheduler's admit/retire API) ------

    def _check_slot(self, b: int) -> None:
        if not 0 <= b < self.batch:
            raise ValueError(f"slot {b} out of range for batch {self.batch}")

    def init_slot_carry(
        self,
        seed: int = 0,
        spins: np.ndarray | None = None,
        beta: float | None = None,
        rng_seeds: np.ndarray | None = None,
        model: ising.LayeredModel | None = None,
    ) -> SweepCarry:
        """A single-slot (batch=1 shaped) carry for `splice_slot`.

        Bit-identical to ``init_carry(seed=seed)`` on a ``batch=1`` engine.
        ``rng_seeds`` overrides the per-lane seeds ((V,) uint32).
        """
        if model is not None:
            raise ValueError("per-slot models need multi_tenant, which is not ported")
        m = self.model
        if spins is None:
            spins = ising.init_spins(m, seed=seed * 1000)
        else:
            spins = np.asarray(spins, np.float32)
            if spins.ndim != 1:
                raise ValueError(f"slot spins must be flat (N,), got {spins.shape}")
        if rng_seeds is None:
            rng_seeds = lane_seeds(1, self.V, seed)
        else:
            rng_seeds = np.asarray(rng_seeds, np.uint32)
            if rng_seeds.shape != (self.V,):
                raise ValueError(
                    f"rng_seeds must have shape ({self.V},), got {rng_seeds.shape}"
                )
        st = metropolis.make_lane_state(m, spins, self.V, self.device)
        beta_arr = torch.full(
            (1,), m.beta if beta is None else beta, dtype=torch.float32, device=self.device
        )
        return SweepCarry(
            st.spins[None], st.h_space[None], st.h_tau[None], beta_arr,
            mt.mt_init(rng_seeds, self.device),
        )

    def splice_slot(self, carry: SweepCarry, b: int, slot: SweepCarry) -> SweepCarry:
        """Write a single-slot carry into slot ``b``; returns a new carry.
        Pure data movement — bit-exact by construction."""
        self._check_slot(b)
        V = self.V
        out = [x.clone() for x in carry]
        for i in range(4):
            out[i][b] = slot[i][0]
        out[4][:, b * V : (b + 1) * V] = slot.rng
        return SweepCarry(*out)

    def extract_slot(self, carry: SweepCarry, b: int) -> SweepCarry:
        """Slot ``b`` of a batched carry as a single-slot carry (the exact
        inverse of `splice_slot`; a copy, so later carries never alias it)."""
        self._check_slot(b)
        V = self.V
        return SweepCarry(
            *(x[b : b + 1].clone() for x in carry[:4]),
            carry.rng[:, b * V : (b + 1) * V].clone(),
        )

    def slot(self, b: int) -> SlotHandle:
        """Handle bundling every per-slot operation on slot ``b``."""
        self._check_slot(b)
        return SlotHandle(self, b)

    def set_slot_betas(self, carry: SweepCarry, slots, betas) -> SweepCarry:
        """Rewrite the betas of the given slots without touching spins,
        fields or RNG; returns a new carry."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=carry.betas.device)
        vals = torch.as_tensor(np.asarray(betas, np.float32), device=carry.betas.device)
        new = carry.betas.clone()
        new[idx] = vals
        return carry._replace(betas=new)

    def check_model(self, model: ising.LayeredModel) -> None:
        """Raise unless ``model`` is admissible in this engine's slots."""
        check_same_topology(self.model, model)

    def model_of(self, b: int) -> ising.LayeredModel:
        """The model slot ``b`` sweeps (the engine's one model)."""
        self._check_slot(b)
        return self.model


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


def _build_torch(eng: SweepEngine) -> Callable:
    from repro_torch.kernels import ref

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
