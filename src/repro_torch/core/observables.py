"""Scalar observables over final spin configurations.

The serving layer (`repro_torch.serve_mc`) retires a job by extracting its
slot's spins and summarizing them; these are the summaries.  Everything
operates on FLAT layer-major spins (the cross-rung comparable order that
`SweepEngine.spins_flat` returns) and accepts either one configuration
``(N,)`` or a batch ``(B, N)``.

Energies are accumulated in float64 (the same convention as
`ising.energy`, which these reduce to row by row) so job results are
stable against summation order; magnetizations are simple means.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import ising


class Observables(NamedTuple):
    """Per-configuration summary a retired job reports."""

    energy: float
    magnetization: float
    abs_layer_magnetization: float


def magnetization(spins) -> np.ndarray | float:
    """Mean spin; ``(N,) -> float`` or ``(B, N) -> (B,)``."""
    s = np.asarray(spins, np.float64)
    out = s.mean(axis=-1)
    return float(out) if out.ndim == 0 else out


def abs_layer_magnetization(m: ising.LayeredModel, spins) -> np.ndarray | float:
    """Mean over layers of |per-layer magnetization| — the QMC-relevant
    order parameter (layers are Trotter slices of one physical config)."""
    s = np.asarray(spins, np.float64)
    batched = s.ndim == 2
    s = s.reshape((-1, m.L, m.n))
    out = np.abs(s.mean(axis=2)).mean(axis=1)
    return out if batched else float(out[0])


def energies(m: ising.LayeredModel, spins) -> np.ndarray | float:
    """Total cost f = -sum h s - sum_space J s s - sum_tau J s s.

    Vectorized over the batch; each row equals ``ising.energy(m, row)``.
    """
    s = np.asarray(spins, np.float64)
    batched = s.ndim == 2
    s = s.reshape((-1, m.L, m.n))
    h = m.h.astype(np.float64)
    e = -np.sum(h * s, axis=(1, 2))
    for d in range(m.space_degree):
        # Each undirected edge appears in both endpoint lists -> halve.
        e -= 0.5 * np.sum(
            m.space_J[:, d].astype(np.float64) * s * s[:, :, m.space_nbr[:, d]],
            axis=(1, 2),
        )
    e -= np.sum(
        m.tau_J.astype(np.float64) * s * np.roll(s, -1, axis=1), axis=(1, 2)
    )
    return e if batched else float(e[0])


def summarize(m: ising.LayeredModel, spins) -> Observables:
    """All observables of ONE flat (N,) configuration."""
    s = np.asarray(spins)
    if s.ndim != 1:
        raise ValueError(f"summarize takes one (N,) configuration, got {s.shape}")
    return Observables(
        energy=float(energies(m, s)),
        magnetization=float(magnetization(s)),
        abs_layer_magnetization=float(abs_layer_magnetization(m, s)),
    )
