"""Scalar observables over final spin configurations.

The serving layer (`repro_torch.serve_mc`) retires a job by extracting its
slot's spins and summarizing them; these are the summaries.  Everything
operates on FLAT layer-major spins (the cross-rung comparable order that
`SweepEngine.spins_flat` returns) and accepts either one configuration
``(N,)`` or a batch ``(B, N)``.

Energies are accumulated in float64 (the same convention as
`ising.energy`, which these reduce to row by row) so job results are
stable against summation order; magnetizations are simple means.

A batch is evaluated in row blocks (`BLOCK_SPINS`) in float64 workspaces
reused from block to block, so the temporaries stay in a core's cache: a
stack of 115 rows of the paper's 24,576 spins would otherwise build
22.6 MB arrays, and spill.  Each row forms the same float64 terms and
takes the same ``np.sum`` over them as a row evaluated alone, so a row's
bits depend neither on the block nor on what else is in the batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from repro_torch.core import ising

#: Spins one row block holds: its three float64 workspaces (384 KiB) fit a
#: core's cache.  The paper's 24,576 spins take a row a block; a CPU test
#: shape of 128 spins, 128 rows.
BLOCK_SPINS = 1 << 14


class Observables(NamedTuple):
    """Per-configuration summary a retired job reports."""

    energy: float
    magnetization: float
    abs_layer_magnetization: float


def _row_blocks(s: np.ndarray, extra: int = 0):
    """Row blocks of a batch ``s`` (B, ...): yields ``(lo, x, *work)`` with
    ``x`` the block's rows cast to float64 (the values ``np.asarray(s,
    np.float64)`` holds there) and ``extra`` float64 arrays of its shape,
    all C-contiguous views of workspaces reused from block to block."""
    rows = max(1, min(len(s), BLOCK_SPINS // max(1, math.prod(s.shape[1:]))))
    ws = np.empty((1 + extra, rows) + s.shape[1:])
    for lo in range(0, len(s), rows):
        k = min(rows, len(s) - lo)
        np.copyto(ws[0, :k], s[lo : lo + k], casting="unsafe")
        yield (lo, *ws[:, :k])


def magnetization(spins) -> np.ndarray | float:
    """Mean spin; ``(N,) -> float`` or ``(B, N) -> (B,)``."""
    s = np.asarray(spins)
    if s.ndim != 2:
        out = np.asarray(s, np.float64).mean(axis=-1)
        return float(out) if out.ndim == 0 else out
    out = np.empty(len(s))
    for lo, x in _row_blocks(s):
        out[lo : lo + len(x)] = x.mean(axis=-1)
    return out


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

    Vectorized over the batch, in row blocks; each row equals
    ``ising.energy(m, row)``.
    """
    s = np.asarray(spins)
    batched = s.ndim == 2
    s = s.reshape((-1, m.L, m.n))
    h = m.h.astype(np.float64)
    space_J = np.ascontiguousarray(m.space_J.T, np.float64)  # row d: m.space_J[:, d]
    nbr = np.ascontiguousarray(m.space_nbr.T, np.intp)
    # The gathers wrap (no buffered copy); refuse what indexing would refuse.
    if nbr.size and (nbr.min() < -m.n or nbr.max() >= m.n):
        raise IndexError(f"space_nbr holds a neighbour outside [-{m.n}, {m.n})")
    tau_J = m.tau_J.astype(np.float64)
    e = np.empty(len(s))
    for lo, x, nb, t in _row_blocks(s, extra=2):
        eb = -np.sum(np.multiply(h, x, out=t), axis=(1, 2))
        for d in range(m.space_degree):
            # Each undirected edge appears in both endpoint lists -> halve.
            np.take(x, nbr[d], axis=2, out=nb, mode="wrap")
            np.multiply(space_J[d], x, out=t)
            eb -= 0.5 * np.sum(np.multiply(t, nb, out=t), axis=(1, 2))
        nb[:, :-1] = x[:, 1:]  # np.roll(x, -1, axis=1)
        nb[:, -1] = x[:, 0]
        np.multiply(tau_J, x, out=t)
        eb -= np.sum(np.multiply(t, nb, out=t), axis=(1, 2))
        e[lo : lo + len(x)] = eb
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
