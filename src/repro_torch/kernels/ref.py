"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function computes exactly what the corresponding CUDA kernel
computes, with plain tensor ops on CPU or CUDA tensors.  The CPU tests
hold them bit-exact against the JAX reference; on the card each kernel is
held bit-exact against them.
"""

from __future__ import annotations

from repro_torch.core import fastexp as fx
from repro_torch.core import metropolis as mp
from repro_torch.core import mt19937 as mt
from repro_torch.core import tempering


#: The flavours of the bit-trick exp (`fastexp_ref` and its kernel): every
#: exp but the exact one, which has no bit trick.
FASTEXP_FLAVORS = tuple(f for f in fx.EXP_FNS if f != "exact")


def check_fastexp_flavor(flavor: str) -> None:
    if flavor not in FASTEXP_FLAVORS:
        raise ValueError(f"fastexp computes the flavours {FASTEXP_FLAVORS}, got {flavor!r}")


def fastexp_ref(x, flavor: str = "fast"):
    """The bit-trick exp ("fast" or "accurate") of every element of ``x``,
    as float32 of the same shape."""
    check_fastexp_flavor(flavor)
    return fx.EXP_FNS[flavor](x)


def mt_next_block_ref(state):
    """One twist of the (624, V) interlaced state; returns ``(new_state,
    tempered words)``, both int32 storage of uint32 bits."""
    new = mt.mt_twist(state)
    return new, mt.mt_temper(new)


def mt_uniforms_ref(state):
    """`mt_next_block_ref` with the 24-bit float conversion: returns
    ``(new_state, uniforms)``, uniforms float32 in [0, 1)."""
    new = mt.mt_twist(state)
    return new, mt.uniforms_from_u32(mt.mt_temper(new))


def metropolis_sweep_ref(
    spins,  # (B, rows, V) f32
    h_space,
    h_tau,
    u,  # (B, rows, V) uniforms
    base_nbr,  # (n, SD) int
    base_J2,  # (n, SD) f32, pre-doubled
    tau_J2,  # (n,) or (n, 1) f32, pre-doubled
    beta,  # (B,) or (B, 1) f32
    n: int,
    exp_flavor: str = "fast",
):
    """One a4 sweep of every replica on the given uniforms.  Returns
    ``(spins, h_space, h_tau)``."""
    st = mp.sweep_lane(
        mp.LaneState(spins, h_space, h_tau), base_nbr, base_J2, tau_J2,
        u, beta.reshape(-1), n, fx.exp_fn(exp_flavor),
    )
    return st.spins, st.h_space, st.h_tau


def metropolis_multisweep_ref(
    spins,  # (B, rows, V) f32
    h_space,
    h_tau,
    rng,  # (624, B*V) int32 — the interlaced MT19937 state, uint32 bits
    base_nbr,
    base_J2,
    tau_J2,
    beta,
    n: int,
    num_sweeps: int,
    exp_flavor: str = "fast",
):
    """``num_sweeps`` a4 sweeps of every replica.  Per sweep,
    ceil(rows/624) fresh generator blocks are drawn and the tail
    discarded; replica b reads lane columns b*V..(b+1)*V.  The fields are
    carried and updated incrementally.  Returns ``(spins, h_space, h_tau,
    rng)``."""
    B, rows, V = spins.shape
    for _ in range(num_sweeps):
        rng, u = mt.mt_uniforms_count(rng, rows)
        u = u.reshape(rows, B, V).permute(1, 0, 2)
        spins, h_space, h_tau = metropolis_sweep_ref(
            spins, h_space, h_tau, u, base_nbr, base_J2, tau_J2, beta, n, exp_flavor
        )
    return spins, h_space, h_tau, rng


def colored_multisweep_ref(
    spins,  # (B, rows, V) f32
    rng,  # (624, B*V) int32 — the interlaced MT19937 state, uint32 bits
    beta,  # (B,) f32
    classes,  # `metropolis.classes_to(reorder.colored_classes(m, V), device)`
    h,  # (n,) f32
    base_nbr,  # (n, SD) int64
    base_J,  # (n, SD) f32, NOT doubled
    tau_J,  # (n,) f32, NOT doubled
    n: int,
    num_sweeps: int,
    exp_flavor: str = "fast",
):
    """``num_sweeps`` colored sweeps of every replica, then one dense field
    refresh.  Per sweep, ceil(rows/624) fresh generator blocks are drawn
    and the tail discarded; replica b reads lane columns b*V..(b+1)*V.
    Returns ``(spins, h_space, h_tau, rng)``."""
    B, rows, V = spins.shape
    exp_fn = fx.exp_fn(exp_flavor)
    beta = beta.reshape(-1)
    for _ in range(num_sweeps):
        rng, u = mt.mt_uniforms_count(rng, rows)
        u = u.reshape(rows, B, V).permute(1, 0, 2)
        spins = mp.colored_flip_spins(spins, u, beta, classes, exp_fn)
    hs, ht = mp.lane_h_eff(spins, h, base_nbr, base_J, tau_J, n)
    return spins, hs, ht, rng


def metropolis_multisweep_multi_ref(
    spins,  # (B, rows, V) f32
    h_space,
    h_tau,
    rng,  # (624, B*V) int32 — the interlaced MT19937 state, uint32 bits
    base_nbr,  # (n, SD) int, shared topology
    base_J2_b,  # (B, n, SD) f32, each slot's own doubled couplings
    tau_J2_b,  # (B, n) or (B, n, 1) f32, each slot's own doubled tau couplings
    beta,
    n: int,
    num_sweeps: int,
    exp_flavor: str = "fast",
):
    """`metropolis_multisweep_ref` with per-slot coupling tables: slot b
    sweeps with ``base_J2_b[b]`` and ``tau_J2_b[b]`` on the shared lattice.
    With B copies of one model's tables each slot equals the single-model
    version bit for bit.  Returns ``(spins, h_space, h_tau, rng)``."""
    B = spins.shape[0]
    if base_J2_b.shape[0] != B or tau_J2_b.shape[0] != B:
        raise ValueError(f"per-slot tables need a leading batch of {B}")
    return metropolis_multisweep_ref(
        spins, h_space, h_tau, rng, base_nbr, base_J2_b, tau_J2_b.reshape(B, n), beta, n,
        num_sweeps, exp_flavor,
    )


def colored_multisweep_multi_ref(
    spins,  # (B, rows, V) f32
    rng,  # (624, B*V) int32 — the interlaced MT19937 state, uint32 bits
    beta,  # (B,) f32
    classes,  # structural `metropolis.classes_to(reorder.colored_classes(m, V), device)`
    h_b,  # (B, n) f32, each slot's own fields
    base_nbr,  # (n, SD) int64, shared topology
    base_J_b,  # (B, n, SD) f32, NOT doubled
    tau_J_b,  # (B, n) f32, NOT doubled
    n: int,
    num_sweeps: int,
    exp_flavor: str = "fast",
):
    """`colored_multisweep_ref` with per-slot coupling tables bound onto
    shared color classes (`metropolis.class_coupling_slices`, gathered once
    per launch); the dense refresh uses each slot's own tables.  With B
    copies of one model's tables each slot equals the single-model version
    bit for bit.  Returns ``(spins, h_space, h_tau, rng)``."""
    B, rows, V = spins.shape
    if h_b.shape[0] != B or base_J_b.shape[0] != B or tau_J_b.shape[0] != B:
        raise ValueError(f"per-slot tables need a leading batch of {B}")
    exp_fn = fx.exp_fn(exp_flavor)
    beta = beta.reshape(-1)
    bound = mp.bind_class_tables(
        classes, mp.class_coupling_slices(classes, h_b, base_J_b, tau_J_b, n)
    )
    for _ in range(num_sweeps):
        rng, u = mt.mt_uniforms_count(rng, rows)
        u = u.reshape(rows, B, V).permute(1, 0, 2)
        spins = mp.colored_flip_spins(spins, u, beta, bound, exp_fn)
    hs, ht = mp.lane_h_eff(spins, h_b, base_nbr, base_J_b, tau_J_b, n)
    return spins, hs, ht, rng


def pt_swap_ref(
    spins,  # (B, rows, V) f32: a block of replica slots
    betas,  # (B,) f32
    rows,  # (R,) int: the ladder's rows of the block, in replica order
    swap_rng,  # (624,) int32: the ladder's scalar MT19937, uint32 bits
    swap_accept,  # () int32
    swap_propose,  # () int32
    base_nbr,  # (n, SD) int
    base_J,  # (n, SD) f32, NOT doubled
    tau_J,  # (n,) f32, NOT doubled
    h,  # (n,) f32
    n: int,
    swap_parity: int,
    exp_flavor: str = "fast",
):
    """`tempering.swap_phase` of the ladder at ``rows`` of the block: the
    replicas' `tempering.lane_energy`, `tempering._swap_decide` on their
    betas, the decided betas written back at ``rows`` of a copy of the
    block's.  Returns ``(energies, betas, swap_rng, swap_accept,
    swap_propose)``."""
    idx = rows.long()
    energies = tempering.lane_energy(spins[idx], h, base_nbr, base_J, tau_J, n)
    new, swap_rng, swap_accept, swap_propose = tempering._swap_decide(
        betas[idx], energies, swap_rng, swap_accept, swap_propose, swap_parity,
        fx.exp_fn(exp_flavor),
    )
    out = betas.clone()
    out[idx] = new
    return energies, out, swap_rng, swap_accept, swap_propose
