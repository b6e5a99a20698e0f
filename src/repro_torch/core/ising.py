"""Layered (QMC path-integral) Ising models: the host-side model tables.

The paper's workload: Ising models built as ``L`` identical layers of a
sparse ``n``-spin base graph, with "space" couplings inside each layer and
two "tau" couplings per spin to the corresponding spin in the adjacent
layers (wrap-around from last to first).  Each spin has 6-8 neighbours.

Everything here is numpy: models, initial spins and the from-scratch
effective fields are built on the host from seeds and copied to the
device by the engine.  Spins are float32 in {-1.0, +1.0}, effective
fields float32; ``h_eff_space`` includes the local field ``h`` so the flip
probability is always ``exp(-2 beta s (h_eff_space + h_eff_tau))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayeredModel:
    """An L-layer QMC Ising model (all layers topologically identical)."""

    n: int  # spins per layer
    L: int  # number of layers (Trotter slices)
    h: np.ndarray  # (n,) local fields, replicated across layers
    space_nbr: np.ndarray  # (n, SD) int32 in-layer neighbour ids, self-padded
    space_J: np.ndarray  # (n, SD) float32 couplings, 0 on padding
    tau_J: np.ndarray  # (n,) float32 inter-layer coupling per spin
    beta: float = 1.0

    @property
    def num_spins(self) -> int:
        return self.n * self.L

    @property
    def space_degree(self) -> int:
        return self.space_nbr.shape[1]

    @property
    def max_degree(self) -> int:
        return self.space_degree + 2  # + two tau edges, as in the paper


def random_layered_model(
    n: int,
    L: int,
    *,
    seed: int = 0,
    target_degree: int = 5,
    beta: float = 1.0,
    j_scale: float = 1.0,
    h_scale: float = 0.3,
    tau_scale: float = 0.5,
) -> LayeredModel:
    """Build a random sparse layered model (in-layer degree 4-6, like the paper).

    The base graph is a ring (guaranteeing connectivity) plus random chords,
    capped so every spin keeps ``space_degree <= target_degree + 1``.
    """
    rng = np.random.default_rng(seed)
    adj = {i: set() for i in range(n)}

    def try_add(a: int, b: int) -> None:
        if a == b or b in adj[a]:
            return
        if len(adj[a]) >= target_degree + 1 or len(adj[b]) >= target_degree + 1:
            return
        adj[a].add(b)
        adj[b].add(a)

    for i in range(n):
        try_add(i, (i + 1) % n)
    num_chords = (target_degree - 2) * n // 2
    for _ in range(num_chords):
        a, b = rng.integers(0, n, size=2)
        try_add(int(a), int(b))

    sd = max(len(v) for v in adj.values())
    space_nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, sd))  # self-pad
    space_J = np.zeros((n, sd), dtype=np.float32)
    # Symmetric couplings: draw one J per undirected edge.
    edge_j = {}
    for i in range(n):
        for j in sorted(adj[i]):
            key = (min(i, j), max(i, j))
            if key not in edge_j:
                edge_j[key] = float(rng.normal() * j_scale)
    for i in range(n):
        for d, j in enumerate(sorted(adj[i])):
            space_nbr[i, d] = j
            space_J[i, d] = edge_j[(min(i, j), max(i, j))]

    h = (rng.normal(size=n) * h_scale).astype(np.float32)
    tau_J = np.full((n,), tau_scale, dtype=np.float32) * (
        1.0 + 0.1 * rng.normal(size=n).astype(np.float32)
    )
    return LayeredModel(
        n=n, L=L, h=h, space_nbr=space_nbr, space_J=space_J, tau_J=tau_J, beta=beta
    )


def reseed_couplings(
    m: LayeredModel,
    seed: int,
    *,
    j_scale: float = 1.0,
    h_scale: float = 0.3,
    tau_scale: float = 0.5,
    beta: float | None = None,
) -> LayeredModel:
    """A fresh disorder realization on the SAME lattice: identical
    ``space_nbr`` topology, new symmetric couplings, fields, and tau links.

    This makes the tenants of a multi-tenant engine (one lattice, many
    instances): slots share the neighbour tables and, on the colored rung,
    the row coloring, while each slot's couplings are its own.
    """
    rng = np.random.default_rng(seed + 1009)
    space_J = np.zeros_like(m.space_J)
    edge_j: dict = {}
    for i in range(m.n):
        for d in range(m.space_degree):
            j = int(m.space_nbr[i, d])
            if j == i:
                continue  # padding slot stays 0
            key = (min(i, j), max(i, j))
            if key not in edge_j:  # one draw per undirected edge: symmetric
                edge_j[key] = float(rng.normal() * j_scale)
            space_J[i, d] = edge_j[key]
    h = (rng.normal(size=m.n) * h_scale).astype(np.float32)
    tau_J = np.full((m.n,), tau_scale, dtype=np.float32) * (
        1.0 + 0.1 * rng.normal(size=m.n).astype(np.float32)
    )
    return dataclasses.replace(
        m,
        space_J=space_J.astype(np.float32),
        h=h,
        tau_J=tau_J,
        beta=m.beta if beta is None else beta,
    )


def init_spins(m: LayeredModel, seed: int = 0) -> np.ndarray:
    """Random +-1 spins, identical convention for every layout (flat order)."""
    rng = np.random.default_rng(seed + 7)
    return np.where(rng.random(m.num_spins) < 0.5, -1.0, 1.0).astype(np.float32)


def h_eff_from_scratch(m: LayeredModel, spins: np.ndarray):
    """O(N*D) recomputation of both effective-field arrays (flat order).

    h_eff_space[s] = h[s] + sum_space J * spin(nbr);  h_eff_tau[s] = sum_tau.
    """
    n, L = m.n, m.L
    s = np.asarray(spins, dtype=np.float32).reshape(L, n)
    hs = np.broadcast_to(m.h, (L, n)).astype(np.float32).copy()
    for d in range(m.space_degree):
        hs += m.space_J[:, d] * s[:, m.space_nbr[:, d]]
    ht = m.tau_J * (np.roll(s, 1, axis=0) + np.roll(s, -1, axis=0))
    return hs.reshape(-1), ht.reshape(-1).astype(np.float32)


def energy(m: LayeredModel, spins) -> float:
    """Total cost f = -sum h s - sum_space J s s - sum_tau J s s."""
    s = np.asarray(spins, dtype=np.float64).reshape(m.L, m.n)
    e = -float(np.sum(m.h.astype(np.float64) * s))
    for d in range(m.space_degree):
        # Each undirected edge appears in both endpoint lists -> halve.
        e -= 0.5 * float(
            np.sum(m.space_J[:, d].astype(np.float64) * s * s[:, m.space_nbr[:, d]])
        )
    e -= float(np.sum(m.tau_J.astype(np.float64) * s * np.roll(s, -1, axis=0)))
    return e


# -----------------------------------------------------------------------------
# Flat (layer-major) layouts for the paper's rungs a1 and a2: spin id = l * n + i.
# -----------------------------------------------------------------------------


def flat_arrays(m: LayeredModel) -> tuple[np.ndarray, np.ndarray]:
    """Per-spin simplified layout (Figure 5/6): (targets, J2) of shape (N, D).

    The last two slots of every row are the tau edges (the paper reorders
    edges ahead of time precisely so ``isATauEdge`` can be deleted).  J is
    pre-doubled (§2.3's "multiply all of the J's by 2 ahead of time").
    """
    n, L, sd = m.n, m.L, m.space_degree
    N, D = n * L, sd + 2
    targets = np.empty((N, D), dtype=np.int32)
    J2 = np.empty((N, D), dtype=np.float32)
    for l in range(L):
        base = l * n
        targets[base : base + n, :sd] = m.space_nbr + base
        J2[base : base + n, :sd] = 2.0 * m.space_J
        targets[base : base + n, sd] = ((l - 1) % L) * n + np.arange(n)
        targets[base : base + n, sd + 1] = ((l + 1) % L) * n + np.arange(n)
        J2[base : base + n, sd] = 2.0 * m.tau_J
        J2[base : base + n, sd + 1] = 2.0 * m.tau_J
    return targets, J2


def original_arrays(m: LayeredModel):
    """Edge-centric layout of Figure 4, for the a1 implementation.

    Returns (graph_edges (E,2) int32, J (E,) f32, is_tau (E,) bool,
    incident (N, D) int32 edge ids).  Padding uses a dummy self-edge with J=0
    per spin so every incident list has exactly D entries (the original code
    had variable-length lists).
    """
    n, L, sd = m.n, m.L, m.space_degree
    N, D = n * L, sd + 2
    edges = []
    js = []
    istau = []
    incident = np.full((N, D), -1, dtype=np.int64)
    counts = np.zeros(N, dtype=np.int64)

    def add_edge(a, b, j, tau):
        eid = len(edges)
        edges.append((a, b))
        js.append(j)
        istau.append(tau)
        for s in (a, b) if a != b else (a,):
            incident[s, counts[s]] = eid
            counts[s] += 1
        return eid

    for l in range(L):
        base = l * n
        for i in range(n):
            for d in range(sd):
                jmate = int(m.space_nbr[i, d])
                if jmate == i:
                    continue  # padding slot
                if jmate > i:  # one edge per undirected pair
                    add_edge(base + i, base + jmate, float(m.space_J[i, d]), False)
        # Tau edges to the next layer (wrap-around covers the previous link).
        nxt = ((l + 1) % L) * n
        for i in range(n):
            add_edge(base + i, nxt + i, float(m.tau_J[i]), True)
    # Pad every incident list to D with per-spin dummy self-edges (J=0).
    for s in range(N):
        dummy = None
        while counts[s] < D:
            if dummy is None:
                dummy = add_edge(s, s, 0.0, False)
                continue  # add_edge already bumped counts[s]
            incident[s, counts[s]] = dummy
            counts[s] += 1
    graph_edges = np.asarray(edges, dtype=np.int32)
    return (
        graph_edges,
        np.asarray(js, dtype=np.float32),
        np.asarray(istau, dtype=bool),
        incident.astype(np.int32),
    )
