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
