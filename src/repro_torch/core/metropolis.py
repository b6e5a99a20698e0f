"""The Metropolis sweep ladder (paper Table 1) as plain PyTorch code.

Every rung of the paper's ladder, and the colored rung beyond it, with
the same semantics over its own memory layout, so rungs compare bit for
bit under the same exp flavour and uniforms:

  a1  `sweep_original`  — the edge-centric structures of Figure 4, the
      neighbour select of Figure 2, 2*S_mul*J recomputed per edge; the
      exact exp by default.
  a2  `sweep_flat`      — the per-spin layout of Figure 5/6 (pre-doubled
      J, tau edges last), one fused update line per spin.
  a3  `sweep_lane(..., scalar_updates=True)` — the lane layout's vector
      flip with its neighbour updates one lane at a time.
  a4  `sweep_lane`      — fully vectorized: whole-row neighbour updates.
  cb  `sweep_colored`   — graph-colored whole-lattice updates.

a4 and cb are the plain versions of the CUDA kernels: `sweep_lane` (a4,
kernels/csrc/metropolis_multisweep.cu, metropolis_multisweep_multi.cu and
metropolis_sweep.cu) and the colored sweep (cb,
kernels/csrc/colored_multisweep.cu and colored_multisweep_multi.cu).  a1-a3
have no kernel: they are the paper's slower rungs, kept as eager loops.
All run on CPU or CUDA tensors and are bit-exact with the reference's jnp
path (a1 under the "exact" exp within its 1-ulp differences).

Replicas are an explicit leading batch dimension: spins, fields and
uniforms are ``(B, N)`` on the flat rungs a1/a2 and ``(B, rows, V)`` on
the lane rungs, betas ``(B,)``.

a4 (the paper's fully vectorized rung, Figure 12b): the rows are walked
in order; all V lanes of a row flip together, and the flip's field
contribution is added row by row into the carried fields — the SD
space-neighbour rows of ``h_space`` and the two tau rows of ``h_tau``,
rolled one lane over at the first and last layer block.  The fields are
state: the incremental sums are the result.

cb: the lane layout's rows are grouped into C conflict-free color classes
(`reorder.colored_classes`); one sweep is C whole-lattice masked updates.
Per class, each row's field is recomputed from the current spins,

    h_eff = (h + sum_d J_d * s[tgt_d]) + tau * (down + up)

where ``down``/``up`` are the previous/next-layer spins, read one lane
over (rolled) at section-start/-end rows; the row flips if
``u[row] < fastexp(((-2 beta) * s) * h_eff)``.  After the last sweep the
carried fields are refreshed densely (`lane_h_eff`).  No scatter-adds:
every float is an elementwise op or a gather with a fixed order.

Multi-tenant engines give every slot its own couplings on one shared
lattice: the coupling tables then carry a leading batch dimension
(``(B, n)``, ``(B, n, SD)``; per class ``(B, k)``, ``(B, k, SD)``) that
maps alongside the replicas.  Each slot's floats are the single-model
path's floats with its own table values, so B copies of one model give
the single-model result bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ising, reorder


class FlatState(NamedTuple):
    spins: torch.Tensor  # (N,) float32 in {-1, +1}, or (B, N) batched
    h_space: torch.Tensor  # includes the local field h
    h_tau: torch.Tensor


class LaneState(NamedTuple):
    spins: torch.Tensor  # (rows, V), or (B, rows, V) batched
    h_space: torch.Tensor
    h_tau: torch.Tensor


def make_flat_state(m: ising.LayeredModel, spins: np.ndarray, device="cuda") -> FlatState:
    """Flat-layout state of one configuration; fields from scratch."""
    hs, ht = ising.h_eff_from_scratch(m, spins)

    def flat(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return FlatState(flat(spins), flat(hs), flat(ht))


def make_lane_state(
    m: ising.LayeredModel, spins: np.ndarray, V: int, device="cuda"
) -> LaneState:
    """Lane-layout state of one flat configuration; fields from scratch."""
    hs, ht = ising.h_eff_from_scratch(m, spins)

    def lane(x):
        return torch.from_numpy(reorder.to_lane(x, m.n, m.L, V)).to(device)

    return LaneState(lane(np.asarray(spins, np.float32)), lane(hs), lane(ht))


def classes_to(classes, device) -> tuple:
    """`reorder.ColorClass` tables as tensors on ``device`` (bool masks
    stay bool, ids int64 for indexing)."""

    def conv(x):
        x = np.asarray(x)
        if x.dtype.kind == "i":
            x = x.astype(np.int64)
        return torch.from_numpy(x).to(device)

    return tuple(reorder.ColorClass(*(conv(leaf) for leaf in cls)) for cls in classes)


def _per_row(x: torch.Tensor) -> torch.Tensor:
    """A per-row table, shared ``(k,)`` or per slot ``(B, k)``, as a column
    that broadcasts against ``(B, k, V)``."""
    return x[None, :, None] if x.dim() == 1 else x[:, :, None]


def _per_site(x: torch.Tensor) -> torch.Tensor:
    """A per-site table, shared ``(n,)`` or per slot ``(B, n)``, shaped to
    broadcast against ``(B, lpv, n, V)``."""
    return x[None, None, :, None] if x.dim() == 1 else x[:, None, :, None]


def _flip(s, h_sum, u, beta, exp_fn):
    """Metropolis accept test; returns (S_mul = s*mask, new spin).

    p = exp(-2 beta s h_eff); accept if u < p.  ``beta`` broadcasts
    against ``s`` (a (B, 1, 1) column for batched spins).
    """
    x = ((-2.0 * beta) * s) * h_sum
    p = exp_fn(x)
    mask = (u < p).to(torch.float32)
    return s * mask, s * (1.0 - 2.0 * mask)


# -----------------------------------------------------------------------------
# a1 — the original edge-centric structures (Figure 2 / Figure 4).
# -----------------------------------------------------------------------------


def original_steps(graph_edges, J, is_tau, incident) -> list:
    """a1's per-spin edge walk as host lists: for spin t, one
    ``(neighbour, J, is_tau)`` per incident edge in the table's order.
    The neighbour is the edge's other end (Figure 3's comparison-as-index
    select); a padding self-edge (J = 0) names the spin itself."""
    ge, inc = np.asarray(graph_edges), np.asarray(incident)
    Jf, tau = np.asarray(J, np.float32), np.asarray(is_tau, bool)
    steps = []
    for t in range(inc.shape[0]):
        edges = []
        for e in inc[t]:
            ends = ge[e]
            edges.append((int(ends[int(ends[0] == t)]), float(Jf[e]), bool(tau[e])))
        steps.append(edges)
    return steps


def sweep_original(
    state: FlatState,  # batched (B, N)
    steps: list,  # `original_steps` of the model's `ising.original_arrays`
    u: torch.Tensor,  # (B, N) uniforms
    beta: torch.Tensor,  # (B,)
    exp_fn,
) -> FlatState:
    """One a1 sweep of every replica; returns a new state.

    Spins are visited in id order.  After spin t's flip test, each of its
    incident edges in turn subtracts ``(2 S_mul) J_e`` from the
    neighbour's space or tau field and adds +0.0 to the other one — the
    reference's ``where(is_tau, 0, -val)`` pair, signed zeros included.
    """
    spins, hs, ht = (x.clone() for x in state)
    for t, edges in enumerate(steps):
        smul, s_new = _flip(spins[:, t], hs[:, t] + ht[:, t], u[:, t], beta, exp_fn)
        two_smul = 2.0 * smul
        for nbr, j, tau in edges:
            val = two_smul * j  # recomputed every edge (a1 style)
            if tau:
                hs[:, nbr] += 0.0
                ht[:, nbr] -= val
            else:
                hs[:, nbr] -= val
                ht[:, nbr] += 0.0
        spins[:, t] = s_new
    return FlatState(spins, hs, ht)


# -----------------------------------------------------------------------------
# a2 — the simplified per-spin layout (Figure 5/6): tau edges are the last
# two slots, J pre-doubled, one fused update line.
# -----------------------------------------------------------------------------


def sweep_flat(
    state: FlatState,  # batched (B, N)
    targets: torch.Tensor,  # (N, D) int64
    J2: torch.Tensor,  # (N, D) float32, pre-doubled
    u: torch.Tensor,  # (B, N) uniforms
    beta: torch.Tensor,  # (B,)
    space_degree: int,
    exp_fn,
) -> FlatState:
    """One a2 sweep of every replica; returns a new state.

    After spin t's flip test, ``-S_mul * J2[t]`` is added at its targets:
    the space slots into ``h_space``, the two tau slots into ``h_tau``.  A
    spin's targets are distinct except its padding slots, which name the
    spin itself and add a zero, so the adds' order cannot change a bit.
    """
    spins, hs, ht = (x.clone() for x in state)
    sd = space_degree
    for t in range(spins.shape[1]):
        smul, s_new = _flip(spins[:, t], hs[:, t] + ht[:, t], u[:, t], beta, exp_fn)
        contrib = -smul[:, None] * J2[t]  # == -= 2*S_mul*J with J pre-doubled
        hs.index_add_(1, targets[t, :sd], contrib[:, :sd])
        ht.index_add_(1, targets[t, sd:], contrib[:, sd:])
        spins[:, t] = s_new
    return FlatState(spins, hs, ht)


# -----------------------------------------------------------------------------
# a3 / a4 — the lane-interlaced sweep (Figure 12b, §3.1).
# -----------------------------------------------------------------------------


def sweep_lane(
    state: LaneState,  # batched (B, rows, V)
    base_nbr,  # (n, SD) in-layer neighbour site ids
    base_J2: torch.Tensor,  # (n, SD) or per slot (B, n, SD) float32, pre-doubled
    tau_J2: torch.Tensor,  # (n,) or per slot (B, n) float32, pre-doubled
    u: torch.Tensor,  # (B, rows, V) uniforms
    beta: torch.Tensor,  # (B,)
    n: int,
    exp_fn,
    scalar_updates: bool = False,
) -> LaneState:
    """One a4 sweep of every replica; returns a new state (the input's
    tensors are not modified).  ``scalar_updates=True`` is the paper's a3
    rung: the same sweep with every neighbour-row update done one lane at
    a time (lanes of a row are distinct elements, so a3 == a4 bit for bit).

    Row ``q`` (site ``i = q % n`` of layer block ``q // n``) flips where
    ``u < exp(-2 beta s h_eff)``; then, in this order, ``h_space`` of
    each space-neighbour row gets ``-S_mul * J2[d]`` (d = 0..SD-1) and
    ``h_tau`` of the two tau rows gets ``tc = -S_mul * tau2``.  In the
    first layer block the down link wraps (row ``rows-n+i`` gets ``tc``
    rolled by -1 lane, before row ``q+n`` gets ``tc``); in the last block
    the up link wraps (row ``q-n`` gets ``tc``, then row ``i`` gets ``tc``
    rolled by +1).  With two layer blocks both adds of a row land in the
    same row, so their order is part of the result.
    """
    spins, hs, ht = (x.clone() for x in state)
    rows = spins.shape[1]
    nbr = torch.as_tensor(base_nbr).tolist()
    j2 = base_J2 if base_J2.dim() == 3 else base_J2[None]  # (B or 1, n, SD)
    t2 = tau_J2.reshape(j2.shape[0], n)
    # Each site's couplings as (B or 1, 1) columns against a row's (B, V).
    j2_col = [[j2[:, i, d, None] for d in range(len(nbr[i]))] for i in range(n)]
    t2_col = [t2[:, i, None] for i in range(n)]
    col = beta.reshape(-1, 1)
    lanes = range(spins.shape[2])

    def add_row(arr, row, c):  # arr[:, row] += c, (B, V)
        if scalar_updates:
            for v in lanes:
                arr[:, row, v] += c[:, v]
        else:
            arr[:, row] += c

    for q in range(rows):
        i = q % n
        base = q - i
        smul, s_new = _flip(spins[:, q], hs[:, q] + ht[:, q], u[:, q], col, exp_fn)
        spins[:, q] = s_new
        for d, t in enumerate(nbr[i]):
            add_row(hs, base + t, -smul * j2_col[i][d])
        tc = -smul * t2_col[i]
        if q < n:  # first layer block: the down link wraps
            add_row(ht, rows - n + i, torch.roll(tc, -1, dims=-1))
            add_row(ht, q + n, tc)
        elif q >= rows - n:  # last layer block: the up link wraps
            add_row(ht, q - n, tc)
            add_row(ht, i, torch.roll(tc, 1, dims=-1))
        else:
            add_row(ht, q - n, tc)
            add_row(ht, q + n, tc)
    return LaneState(spins, hs, ht)


def lane_h_eff(
    spins: torch.Tensor,  # (B, rows, V)
    h: torch.Tensor,  # (n,) or per slot (B, n)
    base_nbr: torch.Tensor,  # (n, SD) int64
    base_J: torch.Tensor,  # (n, SD) or per slot (B, n, SD), NOT doubled
    tau_J: torch.Tensor,  # (n,) or per slot (B, n)
    n: int,
):
    """Dense recomputation of (h_space, h_tau) over the lane layout.

    Section boundaries: the previous layer of a section-start row is the
    section-end row one lane over (roll +1), the next layer of a
    section-end row is the section-start row one lane over (roll -1).
    """
    B, rows, V = spins.shape
    lpv = rows // n
    s = spins.reshape(B, lpv, n, V)
    hs = _per_site(h).expand(s.shape)
    for d in range(base_nbr.shape[1]):
        hs = hs + _per_site(base_J[..., d]) * s[:, :, base_nbr[:, d], :]
    down = torch.cat([torch.roll(s[:, -1:], 1, dims=-1), s[:, :-1]], dim=1)
    up = torch.cat([s[:, 1:], torch.roll(s[:, :1], -1, dims=-1)], dim=1)
    ht = _per_site(tau_J) * (down + up)
    return hs.reshape(B, rows, V), ht.reshape(B, rows, V)


def class_coupling_slices(classes, h_b, space_J_b, tau_J_b, n: int) -> list:
    """Gather each class's coupling tables from per-slot site tables
    ``h_b (B, n)``, ``space_J_b (B, n, SD)``, ``tau_J_b (B, n)``.

    Returns ``[h_0, space_J_0, tau_J_0, h_1, ...]``, one ``(B, k, ...)``
    triple per class, for `bind_class_tables`.  ``classes`` is a
    `classes_to` output.  Called once per launch: the tables do not
    change between sweeps.
    """
    out = []
    for cls in classes:
        i = cls.rows % n  # row (p, i) holds site i of every lane's layer p
        out += [h_b[:, i], space_J_b[:, i], tau_J_b[:, i]]
    return out


def bind_class_tables(classes, cls_tabs) -> tuple:
    """The structural classes (rows, neighbour targets, tau sources, roll
    masks: topology, shared by every tenant) with their ``h``/``space_J``/
    ``tau_J`` replaced by the per-slot slices of `class_coupling_slices`.
    With the tables of the model the classes were built from, the bound
    leaves equal the class's own values, value for value."""
    return tuple(
        cls._replace(h=cls_tabs[3 * c], space_J=cls_tabs[3 * c + 1], tau_J=cls_tabs[3 * c + 2])
        for c, cls in enumerate(classes)
    )


def colored_flip_spins(
    spins: torch.Tensor,  # (B, rows, V)
    u: torch.Tensor,  # (B, rows, V) uniforms, indexed by row id
    beta: torch.Tensor,  # (B,)
    classes,  # `classes_to` output, or `bind_class_tables` of it
    exp_fn,
) -> torch.Tensor:
    """One colored sweep over the spins: C whole-lattice masked updates.
    Returns new spins; the input tensor is not modified."""
    col = beta[:, None, None]
    for cls in classes:
        sc = spins[:, cls.rows]  # (B, k, V)
        hs_c = _per_row(cls.h).expand(sc.shape)
        for d in range(cls.space_tgt.shape[1]):
            hs_c = hs_c + _per_row(cls.space_J[..., d]) * spins[:, cls.space_tgt[:, d]]
        down = spins[:, cls.down_src]
        down = torch.where(cls.down_roll[None, :, None], torch.roll(down, 1, dims=-1), down)
        up = spins[:, cls.up_src]
        up = torch.where(cls.up_roll[None, :, None], torch.roll(up, -1, dims=-1), up)
        ht_c = _per_row(cls.tau_J) * (down + up)
        _, s_new = _flip(sc, hs_c + ht_c, u[:, cls.rows], col, exp_fn)
        spins = spins.index_copy(1, cls.rows, s_new)
    return spins


def sweep_colored(
    state: LaneState,  # batched (B, rows, V)
    classes,  # `classes_to` output
    h: torch.Tensor,
    base_nbr: torch.Tensor,
    base_J: torch.Tensor,
    tau_J: torch.Tensor,
    u: torch.Tensor,  # (B, rows, V) uniforms
    beta: torch.Tensor,  # (B,)
    n: int,
    exp_fn,
) -> LaneState:
    """One colored Metropolis sweep.  The incoming fields are ignored
    (fields are recomputed from spins); the returned ones are the dense
    `lane_h_eff` of the new spins."""
    spins = colored_flip_spins(state.spins, u, beta, classes, exp_fn)
    hs, ht = lane_h_eff(spins, h, base_nbr, base_J, tau_J, n)
    return LaneState(spins, hs, ht)


# -----------------------------------------------------------------------------
# DEPRECATED shims: the sweep loops live in `core.engine.SweepEngine`.  Kept, as
# the reference keeps them, with its semantics: one replica on the plain
# backend ("torch", the reference's "jnp"), spins bit-identical to the
# engine path.
# -----------------------------------------------------------------------------

LADDER = ("a1", "a2", "a3", "a4")  # the paper's rungs; "cb" extends beyond


def make_sweeper(
    m: ising.LayeredModel,
    impl: str,
    *,
    num_sweeps: int = 1,
    seed: int = 1234,
    exp_flavor: str | None = None,
    V: int = 4,
    device="cuda",
):
    """DEPRECATED: use ``SweepEngine.create(...)`` + ``engine.run_fn``.

    ``(fn, initial_carry)`` for steady-state benchmarking: ``fn(carry) ->
    carry`` runs ``num_sweeps`` sweeps of rung ``impl`` on one replica."""
    from repro_torch.core import engine as _engine

    eng = _engine.SweepEngine.create(
        m, rung=impl, backend="torch", batch=1, V=V, exp_flavor=exp_flavor, device=device
    )
    carry0 = eng.init_carry(seed=seed, spins=ising.init_spins(m, seed))
    return eng.run_fn(num_sweeps), carry0


def run_sweeps(
    m: ising.LayeredModel,
    spins: np.ndarray,
    impl: str,
    num_sweeps: int,
    *,
    seed: int = 1234,
    exp_flavor: str | None = None,
    V: int = 4,
    device="cuda",
):
    """DEPRECATED: use ``SweepEngine.create(...)`` + ``engine.run``.

    ``num_sweeps`` sweeps of rung ``impl`` from ``spins``; returns the final
    spins in FLAT (layer-major) order whatever the rung, and the replica's
    state."""
    from repro_torch.core import engine as _engine

    eng = _engine.SweepEngine.create(
        m, rung=impl, backend="torch", batch=1, V=V, exp_flavor=exp_flavor, device=device
    )
    carry = eng.init_carry(seed=seed, spins=np.asarray(spins))
    carry = eng.run(carry, num_sweeps)
    return eng.spins_flat(carry)[0], eng.state_of(carry, 0)
