"""Parallel tempering over a ladder of inverse temperatures (paper §1).

The paper's production context runs 115 replicas of each Ising model at
different temperatures and periodically proposes swaps between adjacent
temperatures.  Replicas are the engine's batch dimension: each round's
sweeps run through `SweepEngine.run`, so with ``backend="cuda"`` the
whole R-replica sweep phase is ONE launch of the rung's fused kernel a
round (rung "a4": kernels/csrc/metropolis_multisweep.cu, rung "cb":
colored_multisweep.cu).  Swaps exchange *betas* (equivalently, replica
labels); spins stay put.

Swap rule for adjacent replicas (a, b): accept with probability
``min(1, exp((beta_a - beta_b) * (E_a - E_b)))``, computed with the same
exp flavour the flips use, clamped to [-20, 0] before the exp.

Swap randomness: exactly ``ceil(R/2)`` fresh uniforms a round
(`draw_swap_uniforms`), one per candidate pair, from one scalar MT19937.

The swap phase is `kernels.ops.pt_swap` over the replicas where they lie:
on the card one host call of csrc/pt_swap.cu (every replica's energy, then
the decisions and the new betas, in two kernels; the reference has no
kernel for it, its swap phase is jnp), on the CPU its plain version
`kernels.ref.pt_swap_ref`, which is `lane_energy` of every replica, then
`_swap_decide`.  The generator and counters stay device tensors, so a
round makes no host round trip of its own.  `lane_energy` sums exact
float64 terms in a fixed pairwise tree of elementwise adds, rounded once
to float32, so its result is the same bits on the CPU and on the card
(the kernel keeps the tree); the reference sums in float32 in XLA's
order, so the two agree within a stated tolerance, not bit for bit
(tests/test_torch_tempering.py).

The pieces are separable: `swap_phase` and `energy_tables` are public so
the serving layer expresses a whole tempering workload as one multi-slot
job (`serve_mc.PTJob`): a round is "one scheduled chunk + this swap
phase", sharing launches with whatever else is resident.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine as sweep_engine
from repro_torch.core import ising, mt19937
from repro_torch.core.fastexp import exp_fn as _exp_fn


class PTState(NamedTuple):
    spins: torch.Tensor  # (R, rows, V)
    h_space: torch.Tensor  # (R, rows, V)
    h_tau: torch.Tensor  # (R, rows, V)
    betas: torch.Tensor  # (R,) current beta per replica slot
    rng: torch.Tensor  # (624, R*V) interlaced generator state (engine layout)
    swap_rng: torch.Tensor  # (624,) scalar generator for swap decisions
    swap_accept: torch.Tensor  # () int32 counter, on the replicas' device
    swap_propose: torch.Tensor  # () int32 counter, on the replicas' device


def make_pt_engine(
    m: ising.LayeredModel,
    num_replicas: int,
    *,
    V: int = 4,
    rung: str = "a4",
    backend: str = "cuda",
    exp_flavor: str = "fast",
    replica_tile: int | None = None,
    device="cuda",
) -> sweep_engine.SweepEngine:
    """The batched lane-rung engine that owns the sweep phase of every PT
    round (``rung="a4"`` sequential order, ``rung="cb"`` colored order).

    ``backend="cuda"`` forces V to the kernels' 128-lane layout (the
    model's L must be a multiple of 2*128); ``backend="torch"`` is the
    plain version on ``device``, any V."""
    if backend == "cuda":
        from repro_torch.kernels import ops

        V = ops.LANES
    return sweep_engine.SweepEngine.create(
        m, rung=rung, backend=backend, batch=num_replicas, V=V, exp_flavor=exp_flavor,
        replica_tile=replica_tile, device=device,
    )


def init_pt(
    m: ising.LayeredModel,
    betas: np.ndarray,
    *,
    V: int = 4,
    seed: int = 0,
    engine: sweep_engine.SweepEngine | None = None,
    device="cuda",
) -> PTState:
    """The initial ladder: replica b starts from ``init_spins(m, seed*1000 +
    b)`` at ``betas[b]``; the swap generator is seeded ``seed + 17``.  The
    state lives on the engine's device (``engine`` defaults to
    `make_pt_engine` on ``device``)."""
    eng = engine or make_pt_engine(m, len(betas), V=V, device=device)
    carry = eng.init_carry(seed=seed, betas=np.asarray(betas, np.float32))
    zero = torch.zeros((), dtype=torch.int32, device=eng.device)
    return PTState(
        carry.spins, carry.h_space, carry.h_tau, carry.betas, carry.rng,
        swap_rng=mt19937.mt_init(seed + 17, eng.device),
        swap_accept=zero,
        swap_propose=zero.clone(),
    )


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed tree of elementwise adds (pairs of
    neighbours, zero-padded to even at each level): the same order, so the
    same bits, on every device."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def lane_energy(
    spins: torch.Tensor,  # (..., rows, V)
    h: torch.Tensor,  # (n,) local fields
    base_nbr: torch.Tensor,  # (n, SD) int64
    base_J: torch.Tensor,  # (n, SD) NOT doubled
    tau_J: torch.Tensor,  # (n,)
    n: int,
) -> torch.Tensor:
    """Energy of lane-layout replicas (any leading batch), float32.

    ``-sum h s - 1/2 sum_d J_d s s_nbr(d) - sum tau s s_up`` as in the
    reference: the next layer of the last row block is the first block of
    lane v+1 (global wrap lane V-1 -> 0).  Each spin's terms are exact in
    float64 (products of float32 couplings and +-1 spins, halved), summed
    per spin in a fixed order and over the spins by `_pairwise_sum`, then
    rounded once to float32: the result does not depend on the device.
    """
    *lead, rows, V = spins.shape
    lpv = rows // n
    s = spins.reshape(*lead, lpv, n, V).double()
    h, base_J, tau_J = (t.double()[:, None] for t in (h, base_J, tau_J))  # (n, 1) / (n, 1, SD)
    nbr = base_nbr.long()
    local = h.expand(s.shape[-3:]).clone()
    for d in range(nbr.shape[1]):
        local = local + 0.5 * base_J[:, :, d] * s[..., nbr[:, d], :]
    up = torch.cat([s[..., 1:, :, :], torch.roll(s[..., :1, :, :], -1, dims=-1)], dim=-3)
    local = local + tau_J * up
    terms = -(s * local)
    return _pairwise_sum(terms.reshape(*lead, -1)).float()


def draw_swap_uniforms(swap_rng: torch.Tensor, num_replicas: int):
    """Exactly ``ceil(R/2)`` fresh uniforms, one per candidate swap pair:
    whole 624-entry MT19937 blocks, the tail discarded, never reused."""
    return mt19937.mt_uniforms_count(swap_rng, (num_replicas + 1) // 2)


def _swap_decide(
    betas: torch.Tensor,  # (R,)
    energies: torch.Tensor,  # (R,)
    swap_rng: torch.Tensor,
    swap_accept: torch.Tensor,
    swap_propose: torch.Tensor,
    swap_parity: int,
    exp_fn,
):
    """The swap decision given per-replica energies: pairs (i, i+1) for i
    of parity ``swap_parity``; each pair shares one fresh uniform.  Every
    step is a tensor op on the replicas' device.  Returns ``(betas,
    swap_rng, swap_accept, swap_propose)``."""
    R = betas.shape[0]
    swap_rng, su = draw_swap_uniforms(swap_rng, R)
    idx = torch.arange(R, device=betas.device)
    parity = int(swap_parity)
    is_left = (idx % 2 == parity) & (idx + 1 < R)
    partner = torch.where(is_left, idx + 1, torch.where(idx % 2 != parity, idx - 1, idx))
    partner = partner.clamp(0, R - 1)
    valid = partner != idx
    d_beta = betas - betas[partner]
    d_e = energies - energies[partner]
    p_acc = exp_fn(torch.clamp(d_beta * d_e, -20.0, 0.0))  # min(1, exp(.))
    u_pair = su[idx // 2]
    u_pair = torch.where(is_left, u_pair, u_pair[partner])  # shared within a pair
    accept = valid & (u_pair < p_acc)
    new_betas = torch.where(accept, betas[partner], betas)
    n_acc = torch.div(accept.sum(dtype=torch.int32), 2, rounding_mode="floor")
    n_prop = (valid & is_left).sum(dtype=torch.int32)
    return new_betas, swap_rng, swap_accept + n_acc, swap_propose + n_prop


def swap_phase(
    state: PTState,
    base_nbr: torch.Tensor,  # (n, SD) int64
    base_J: torch.Tensor,  # (n, SD) NOT doubled
    tau_J: torch.Tensor,  # (n,)
    h: torch.Tensor,
    swap_parity: int,  # 0 or 1: which adjacent pairs are proposed
    n: int,
    exp_flavor: str = "fast",
) -> PTState:
    """One even/odd round of adjacent-temperature swap proposals:
    `kernels.ops.pt_swap` over the state's R replicas (one launch of
    csrc/pt_swap.cu on the card, `kernels.ref.pt_swap_ref` on the CPU)."""
    from repro_torch.kernels import ops

    rows = torch.arange(state.spins.shape[0], dtype=torch.int32, device=state.spins.device)
    _, betas, swap_rng, acc, prop = ops.pt_swap(
        state.spins, state.betas, rows, state.swap_rng, state.swap_accept, state.swap_propose,
        base_nbr, base_J, tau_J, h, n, swap_parity, exp_flavor,
    )
    return state._replace(betas=betas, swap_rng=swap_rng, swap_accept=acc, swap_propose=prop)


def swap_phase_from_energies(
    betas: torch.Tensor,
    energies: torch.Tensor,  # (R,) per-replica energies of the current spins
    swap_rng: torch.Tensor,
    swap_accept: torch.Tensor,
    swap_propose: torch.Tensor,
    swap_parity: int,
    exp_flavor: str = "fast",
):
    """`swap_phase` for callers that already hold per-replica energies: the
    same `_swap_decide` body.  Returns ``(betas, swap_rng, swap_accept,
    swap_propose)``."""
    return _swap_decide(betas, energies, swap_rng, swap_accept, swap_propose, swap_parity,
                        _exp_fn(exp_flavor))


def model_energy_tables(m: ising.LayeredModel, device="cuda"):
    """``(base_nbr, base_J, tau_J, h)`` of ``m`` on ``device`` for
    `lane_energy`: for a consumer whose model is not the engine's (a
    multi-tenant `PTJob` over its own model); build once per job."""
    def dev(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype)).to(device)

    return (dev(m.space_nbr, np.int64), dev(m.space_J, np.float32), dev(m.tau_J, np.float32),
            dev(m.h, np.float32))


def energy_tables(eng: sweep_engine.SweepEngine):
    """`model_energy_tables` of the engine's model on its device, built once
    per engine, so per-round calls upload nothing."""
    return eng.energy_tables_on(eng.device)


def pt_round(
    eng: sweep_engine.SweepEngine,
    state: PTState,
    swap_parity: int,
    sweeps_per_round: int = 1,
) -> PTState:
    """``sweeps_per_round`` engine sweeps on every replica (one launch on the
    "cuda" backend), then one even/odd round of swap proposals."""
    carry = sweep_engine.SweepCarry(
        state.spins, state.h_space, state.h_tau, state.betas, state.rng
    )
    carry = eng.run(carry, sweeps_per_round)
    state = state._replace(
        spins=carry.spins, h_space=carry.h_space, h_tau=carry.h_tau, rng=carry.rng
    )
    return swap_phase(state, *energy_tables(eng), swap_parity, eng.model.n, eng.exp_flavor)


def run_parallel_tempering(
    m: ising.LayeredModel,
    betas: np.ndarray,
    num_rounds: int,
    *,
    V: int = 4,
    seed: int = 0,
    sweeps_per_round: int = 1,
    exp_flavor: str = "fast",
    rung: str = "a4",
    backend: str = "cuda",
    device="cuda",
    replica_tile: int | None = None,
):
    """The whole ladder: returns ``(final PTState, per-replica energies)``, the
    energies as float32 numpy.

    ``backend="cuda"`` (the default, on ``device="cuda"``) runs each
    round's sweep phase as one launch of the rung's fused kernel (V is
    forced to 128, so the model needs L % 256 == 0); ``backend="torch"``
    is the plain version on ``device``.
    """
    eng = make_pt_engine(
        m, len(betas), V=V, rung=rung, backend=backend, exp_flavor=exp_flavor,
        replica_tile=replica_tile, device=device,
    )
    state = init_pt(m, betas, seed=seed, engine=eng)
    for r in range(num_rounds):
        state = pt_round(eng, state, r % 2, sweeps_per_round)
    base_nbr, base_J, tau_J, h = energy_tables(eng)
    energies = lane_energy(state.spins, h, base_nbr, base_J, tau_J, m.n)
    return state, energies.cpu().numpy()
