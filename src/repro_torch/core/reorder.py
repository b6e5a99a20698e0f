"""Spin reordering for conflict-free vector updates (paper §3.1, Figure 12).

The fully-vectorized sweep requires that the V spins processed together
(one per vector lane) are mutually non-adjacent and that their neighbours
again form whole vectors.  The paper achieves this by splitting the L
identical layers into V sections and interlacing them:

    spin (layer l, site i)  ->  row = (l mod L/V) * n + i,   lane = l div L/V

Rows are visited sequentially; all V lanes of a row flip together.  Tau
neighbours live exactly one row-block (n rows) up/down in the SAME lane,
except at section boundaries where the contribution rotates one lane over
(the paper's "first and last layers treated as a special case").

V=4 reproduces the paper's SSE layout (Figure 12b); V=128 is the CUDA
kernel's width — one thread per lane, so a warp reads 32 neighbouring
lanes of a row in one coalesced access (the paper's Figure 12c).
Requires L % V == 0 and L // V >= 2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.core import ising


def check_lane_shape(n: int, L: int, V: int) -> int:
    if L % V != 0:
        raise ValueError(f"L={L} must be a multiple of V={V}")
    lpv = L // V
    if lpv < 2:
        raise ValueError(
            f"L//V={lpv} < 2: spins in a vector would be tau-adjacent "
            "(the paper's reordering requires at least 2 layers per section)"
        )
    return lpv * n  # rows


@functools.lru_cache(maxsize=None)
def flat_to_lane_perm(n: int, L: int, V: int) -> np.ndarray:
    """perm[row * V + lane] = flat spin id (layer-major) occupying that slot.

    Memoized (and returned read-only): the permutation is a pure function
    of the lane shape, and rebuilding it sat on the serving admit fast
    path — every `make_lane_state` of every job admission.
    """
    rows = check_lane_shape(n, L, V)
    lpv = L // V
    perm = np.empty(rows * V, dtype=np.int64)
    for v in range(V):
        for p in range(lpv):
            l = v * lpv + p
            for i in range(n):
                perm[(p * n + i) * V + v] = l * n + i
    perm.setflags(write=False)
    return perm


def to_lane(x_flat: np.ndarray, n: int, L: int, V: int) -> np.ndarray:
    """Gather a flat (N, ...) per-spin array into (rows, V, ...) lane layout."""
    rows = check_lane_shape(n, L, V)
    perm = flat_to_lane_perm(n, L, V)
    return np.asarray(x_flat)[perm].reshape((rows, V) + np.asarray(x_flat).shape[1:])


def from_lane(x_lane: np.ndarray, n: int, L: int, V: int) -> np.ndarray:
    rows = check_lane_shape(n, L, V)
    perm = flat_to_lane_perm(n, L, V)
    out = np.empty((rows * V,) + np.asarray(x_lane).shape[2:], dtype=np.asarray(x_lane).dtype)
    out[perm] = np.asarray(x_lane).reshape((rows * V,) + np.asarray(x_lane).shape[2:])
    # out[perm] = lane-ordered values: out[flat_id] = value at lane slot.
    return out


# -----------------------------------------------------------------------------
# Graph coloring of the lane-layout rows (the "cb" colored-sweep rung).
#
# Two rows conflict iff some spin of one is coupled to some spin of the other,
# in which case they must not flip in the same vector update.  Row (p, i)
# (layer-in-section p, site i) conflicts with (p, j) for every in-layer
# neighbour j of i, and with ((p ± 1) mod lpv, i) through the tau links —
# section boundaries included, because the lane-rotated wrap connects
# (lpv-1, i) back to (0, i) one lane over.  The row conflict graph is thus
# exactly the Cartesian product  C_lpv x G_base  of a cycle over the layer
# blocks and the base space graph, and a proper coloring is
# (cycle_color(p) + base_color(i)) mod C with C = max of the two palette
# sizes (the standard product-coloring construction) — C = 2-4 for the
# paper's production shape.  See DESIGN.md §Coloring.
# -----------------------------------------------------------------------------


def _greedy_color(adj: list[set]) -> np.ndarray:
    """First-fit greedy coloring in natural vertex order; <= maxdeg+1 colors."""
    colors = np.full(len(adj), -1, dtype=np.int32)
    for v in range(len(adj)):
        used = {int(colors[u]) for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


#: Memo of computed row colorings, keyed by the conflict graph's identity
#: (lane shape + base adjacency bytes).  Heterogeneous models served
#: together in one multi-tenant engine share a lattice topology and differ
#: only in couplings/fields, so the (identical) coloring is computed once
#: per lane shape and reused across models and engines.
_PARTITION_CACHE: dict = {}


def colored_partition(
    space_nbr: np.ndarray, n: int, lpv: int
) -> Tuple[np.ndarray, int]:
    """Cached `color_rows`: one coloring per (lane shape, topology).

    The coloring depends only on the base adjacency structure — never on
    coupling values — so every model sharing ``space_nbr`` (e.g. disorder
    realizations on one lattice, the multi-tenant serving case) gets the
    SAME ``(colors, C)`` object back, making the class row-partition
    trivially identical across the slots of a multi-model engine.
    """
    key = (n, lpv, np.asarray(space_nbr, np.int32).tobytes())
    hit = _PARTITION_CACHE.get(key)
    if hit is None:
        hit = _PARTITION_CACHE[key] = color_rows(space_nbr, n, lpv)
    return hit


def color_rows(space_nbr: np.ndarray, n: int, lpv: int) -> Tuple[np.ndarray, int]:
    """Proper coloring of the (lpv * n) lane-layout rows.

    Returns ``(colors, C)`` with ``colors[p * n + i]`` in ``[0, C)`` such
    that no two conflicting rows share a color.  Padding slots
    (``space_nbr[i, d] == i``) are not conflicts.
    """
    adj = [set() for _ in range(n)]
    for i in range(n):
        for j in space_nbr[i]:
            j = int(j)
            if j != i:  # self-entries are padding
                adj[i].add(j)
                adj[j].add(i)
    base = _greedy_color(adj)
    if lpv % 2 == 0:
        cyc = np.arange(lpv, dtype=np.int32) % 2
    else:  # odd cycle needs 3 colors; recolor the last block
        cyc = np.arange(lpv, dtype=np.int32) % 2
        cyc[lpv - 1] = 2
    C = int(max(base.max(), cyc.max())) + 1
    colors = (cyc[:, None] + base[None, :]) % C
    return colors.reshape(-1).astype(np.int32), C


class ColorClass(NamedTuple):
    """Precomputed gather tables for one conflict-free class of lane rows.

    All arrays are host numpy (the engine copies them to the device once).
    ``rows`` is ascending — the class visit order is part of the rung's
    definition, shared by the plain PyTorch path and the CUDA kernel.
    """

    rows: np.ndarray  # (k,) int32 row ids in this class, ascending
    h: np.ndarray  # (k,) f32 local field of each row's site
    space_J: np.ndarray  # (k, SD) f32 couplings (NOT doubled)
    space_tgt: np.ndarray  # (k, SD) int32 absolute neighbour row ids
    tau_J: np.ndarray  # (k,) f32 inter-layer coupling
    down_src: np.ndarray  # (k,) int32 row holding the previous-layer spins
    up_src: np.ndarray  # (k,) int32 row holding the next-layer spins
    down_roll: np.ndarray  # (k,) bool: section-start rows read down_src lane-rolled
    up_roll: np.ndarray  # (k,) bool: section-end rows read up_src lane-rolled


def colored_classes(m: ising.LayeredModel, V: int) -> Tuple[ColorClass, ...]:
    """Group the lane-layout rows of model ``m`` into conflict-free classes.

    Each class can be flipped as ONE whole-lattice masked vector update: no
    two rows in a class interact, and each class carries the gather tables
    needed to recompute its rows' effective fields from the current spins.
    """
    rows_total = check_lane_shape(m.n, m.L, V)
    n, lpv = m.n, rows_total // m.n
    colors, C = colored_partition(m.space_nbr, n, lpv)
    classes = []
    for c in range(C):
        rows_c = np.nonzero(colors == c)[0].astype(np.int32)
        p, i = rows_c // n, rows_c % n
        classes.append(
            ColorClass(
                rows=rows_c,
                h=m.h[i].astype(np.float32),
                space_J=m.space_J[i].astype(np.float32),
                space_tgt=(p[:, None] * n + m.space_nbr[i]).astype(np.int32),
                tau_J=m.tau_J[i].astype(np.float32),
                down_src=np.where(p == 0, (lpv - 1) * n + i, rows_c - n).astype(
                    np.int32
                ),
                up_src=np.where(p == lpv - 1, i, rows_c + n).astype(np.int32),
                down_roll=(p == 0),
                up_roll=(p == lpv - 1),
            )
        )
    return tuple(classes)


def relabeled_flat_arrays(m: ising.LayeredModel, V: int):
    """Flat (targets, J2) arrays for the model with spins RELABELED to lane
    order (new id = row * V + lane).

    Running the sequential sweep (a2) over this relabeled model in natural
    id order visits spins in exactly the order the vectorized sweep (a4)
    processes them — the bit-exact equivalence oracle for a4 and its
    kernels (possible because lanes within a row are mutually non-adjacent).
    """
    targets, J2 = ising.flat_arrays(m)
    perm = flat_to_lane_perm(m.n, m.L, V)  # new -> old
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)  # old -> new
    new_targets = inv[targets[perm]].astype(np.int32)
    new_J2 = J2[perm]
    return new_targets, new_J2
