"""Plain reference of the annealing service: what every served job must return.

The configurations ``ising-qmc-*`` serve Metropolis annealing jobs and
parallel-tempering ladders over layered (QMC) Ising models.  This module
replays a job from what its user submitted (a seed, a beta schedule or a
ladder) and the model's arrays, with plain NumPy and PyTorch operations,
and returns the spins, energies and betas the service has to hand back.
It imports nothing of the program under test.

The semantics it follows, as the service documents them:

* A model is ``L`` identical layers of an ``n``-site graph: in-layer
  couplings ``J`` (a self-padded neighbour table), local fields ``h`` and
  one coupling ``tau`` per site to the same site in the layers above and
  below (layer ``L-1`` wraps to layer 0).  Energy:
  ``-sum h s - 1/2 sum J s s' - sum tau s s_up``.
* Lane layout: with ``V`` lanes and ``lpv = L / V`` layers a lane, spin
  (layer ``l``, site ``i``) sits at row ``(l mod lpv) * n + i``, lane
  ``l div lpv``.
* A job's randomness: lane ``k`` of a slot runs MT19937 seeded
  ``k * 2654435761 + seed`` (mod 2^32); a sweep takes ``ceil(rows/624)``
  fresh blocks of 624 words a lane and uses the first ``rows``, the
  uniform of row ``r`` being ``(word_r >> 8) * 2^-24``.  A job's first spins
  are ``+-1`` from ``numpy.random.default_rng(seed * 1000 + 7)`` (replica
  ``b`` of a ladder: ``seed * 1000 + b + 7``).
* A flip: ``x = ((-2 beta) * s) * (h_space + h_tau)`` in float32; the spin
  flips where ``u < fastexp(x)``, the paper's bit-trick exponential
  ``float_bits(trunc_sat(x * 2^23 log2 e) + 127 * 2^23) * 2 ln^2 2`` with
  subnormal results flushed to zero.
* Rung ``cb``: rows are coloured ``(cycle(p) + greedy(i)) mod C`` (greedy
  first-fit over the base graph in site order; the layer blocks ``p``
  alternate 0, 1, the last one 2 when ``lpv`` is odd); a sweep updates
  the classes in colour order, each from fields recomputed out of the
  current spins: ``(h + sum_d J_d s_d) + tau (s_down + s_up)``.
* Rung ``a4``: rows are walked in order; after each row's flips its
  contribution ``-2 s J`` is added into the carried fields of its
  neighbour rows (space neighbours in table order, then the two tau rows,
  the wrapped one first in the first layer block and last in the last).
  The fields start from ``h + sum_d J_d s_d`` and ``tau (s_down + s_up)``.
* A ladder: ``R`` replicas, each round ``sweeps_per_round`` sweeps of all
  of them at their current betas, then the pairs ``(i, i+1)`` with ``i``
  of the round's parity propose to swap betas, accepted where
  ``u < fastexp(clamp((b_i - b_j)(E_i - E_j), -20, 0))`` with float32
  energies; one uniform a pair, the ``i // 2``-th of a fresh block of a
  scalar MT19937 seeded ``seed + 17``.

``dtype="bfloat16"`` computes every field and exponent argument one
precision lower: the control that a sound comparison has to fail.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MT_N = 624
MATRIX_A, UPPER, LOWER = 0x9908B0DF, 0x80000000, 0x7FFFFFFF
LANE_SEED_MULT = 2654435761
SCALE = np.float32((1 << 23) * math.log2(math.e))
CENTRE = np.float32(2.0 * math.log(2.0) ** 2)
BIAS = 127 << 23
FLT_MIN = float(np.finfo(np.float32).tiny)
#: The largest subnormal float32: ``u < p`` for a normal ``p`` is
#: ``max(u, LARGEST_SUBNORMAL) < p`` for every uniform, and false for a
#: subnormal ``p`` (which the exp flushes to zero).
LARGEST_SUBNORMAL = np.array([0x007FFFFF], np.uint32).view(np.float32)[0]
INT32_TOP_F32 = np.float32(2147483520.0)  # the largest float32 below 2^31


# -----------------------------------------------------------------------------
# Models.
# -----------------------------------------------------------------------------


@dataclass(frozen=True)
class Model:
    n: int
    L: int
    h: np.ndarray  # (n,) float32
    space_nbr: np.ndarray  # (n, SD) int32, self-padded
    space_J: np.ndarray  # (n, SD) float32, 0 on padding
    tau_J: np.ndarray  # (n,) float32


def make_lattice(n: int, L: int, seed: int, target_degree=5, j_scale=1.0, h_scale=0.3,
                 tau_scale=0.5) -> Model:
    """A random layered model: a ring of ``n`` sites plus random chords,
    every site of degree at most ``target_degree + 1``, one normal coupling
    an undirected edge, normal fields, ``tau`` near ``tau_scale``."""
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
    for _ in range((target_degree - 2) * n // 2):
        a, b = rng.integers(0, n, size=2)
        try_add(int(a), int(b))
    sd = max(len(v) for v in adj.values())
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, sd))
    J = np.zeros((n, sd), np.float32)
    edge = {}
    for i in range(n):
        for j in sorted(adj[i]):
            key = (min(i, j), max(i, j))
            if key not in edge:
                edge[key] = float(rng.normal() * j_scale)
    for i in range(n):
        for d, j in enumerate(sorted(adj[i])):
            nbr[i, d] = j
            J[i, d] = edge[(min(i, j), max(i, j))]
    h = (rng.normal(size=n) * h_scale).astype(np.float32)
    tau = np.full((n,), tau_scale, np.float32) * (1.0 + 0.1 * rng.normal(size=n).astype(np.float32))
    return Model(n, L, h, nbr, J, tau)


def reseed(m: Model, seed: int, j_scale=1.0, h_scale=0.3, tau_scale=0.5) -> Model:
    """A new disorder realization on ``m``'s lattice: fresh symmetric
    couplings, fields and tau links drawn from ``seed``."""
    rng = np.random.default_rng(seed + 1009)
    J = np.zeros_like(m.space_J)
    edge = {}
    for i in range(m.n):
        for d in range(m.space_nbr.shape[1]):
            j = int(m.space_nbr[i, d])
            if j == i:
                continue
            key = (min(i, j), max(i, j))
            if key not in edge:
                edge[key] = float(rng.normal() * j_scale)
            J[i, d] = edge[key]
    h = (rng.normal(size=m.n) * h_scale).astype(np.float32)
    tau = np.full((m.n,), tau_scale, np.float32) * (
        1.0 + 0.1 * rng.normal(size=m.n).astype(np.float32))
    return Model(m.n, m.L, h, m.space_nbr, J.astype(np.float32), tau)


def make_model(cfg: dict, seed: int) -> Model:
    """The configuration's lattice (its ``lattice_seed``) with the
    disorder realization of run ``seed``."""
    if cfg["exp_flavor"] != "fast":
        raise ValueError(f"the reference computes the fast exp only, not {cfg['exp_flavor']!r}")
    spec = cfg["model"]
    lattice = make_lattice(
        cfg["spins_per_layer"], cfg["num_layers"], spec["lattice_seed"],
        target_degree=spec["target_degree"], j_scale=spec["j_scale"],
        h_scale=spec["h_scale"], tau_scale=spec["tau_scale"])
    return reseed(lattice, seed % 2**31, j_scale=spec["j_scale"], h_scale=spec["h_scale"],
                  tau_scale=spec["tau_scale"])


def energy(m: Model, spins: np.ndarray) -> np.ndarray:
    """Energies (float64) of flat layer-major configurations ``(..., L*n)``."""
    s = np.asarray(spins, np.float64).reshape(-1, m.L, m.n)
    e = -np.einsum("bln,n->b", s, m.h.astype(np.float64))
    for d in range(m.space_nbr.shape[1]):
        e -= 0.5 * np.einsum("bln,n,bln->b", s, m.space_J[:, d].astype(np.float64),
                             s[:, :, m.space_nbr[:, d]])
    e -= np.einsum("bln,n,bln->b", s, m.tau_J.astype(np.float64), np.roll(s, -1, axis=1))
    return e.reshape(np.shape(spins)[:-1])


# -----------------------------------------------------------------------------
# Layout, first spins, generators.
# -----------------------------------------------------------------------------


def lane_perm(n: int, L: int, V: int) -> np.ndarray:
    """``perm[row * V + lane]`` = the flat (layer-major) id of that spin."""
    lpv = L // V
    if L % V or lpv < 2:
        raise ValueError(f"L={L} needs a multiple of V={V} with at least 2 layers a lane")
    row = np.arange(lpv * n)
    layer = np.arange(V)[None, :] * lpv + (row // n)[:, None]
    return (layer * n + (row % n)[:, None]).reshape(-1)


def to_lane(flat: np.ndarray, n: int, L: int, V: int) -> np.ndarray:
    """``(..., L*n)`` flat configurations as ``(..., rows, V)``."""
    flat = np.asarray(flat)
    return flat[..., lane_perm(n, L, V)].reshape(flat.shape[:-1] + (L // V * n, V))


def to_flat(lane: np.ndarray, n: int, L: int, V: int) -> np.ndarray:
    lane = np.asarray(lane)
    lead = lane.shape[:-2]
    out = np.empty(lead + (n * L,), lane.dtype)
    out[..., lane_perm(n, L, V)] = lane.reshape(lead + (-1,))
    return out


def first_spins(m: Model, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 7)
    return np.where(rng.random(m.n * m.L) < 0.5, -1.0, 1.0).astype(np.float32)


def lane_seeds(count: int, seed: int) -> np.ndarray:
    return ((np.arange(count, dtype=np.uint64) * LANE_SEED_MULT + seed) % 2**32).astype(np.uint32)


def mt_seed(seeds) -> np.ndarray:
    """MT19937 states (624, ...) of the given uint32 seeds."""
    seeds = np.asarray(seeds, np.uint32)
    st = np.empty((MT_N,) + seeds.shape, np.uint32)
    st[0] = seeds
    with np.errstate(over="ignore"):
        for i in range(1, MT_N):
            prev = st[i - 1]
            st[i] = np.uint32(1812433253) * (prev ^ (prev >> np.uint32(30))) + np.uint32(i)
    return st


def _twist_part(u, v, m):
    y = (u & UPPER) | (v & LOWER)
    return m ^ (y >> 1) ^ ((y & 1) * MATRIX_A)


def _cat(parts):
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)


def mt_twist(st):
    """The textbook in-place regeneration of all 624 words, for every
    column at once: int64 tensors of words in [0, 2^32), or uint32 arrays."""
    a = _twist_part(st[0:227], st[1:228], st[397:624])
    b = _twist_part(st[227:454], st[228:455], a)
    c = _twist_part(st[454:623], st[455:624], b[0:169])
    d = _twist_part(st[623:624], a[0:1], b[169:170])
    return _cat([a, b, c, d])


def mt_temper(y):
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def mt_uniforms(st, count: int):
    """``count`` uniforms a column from fresh blocks: ``(state, (count, ...))``."""
    words = []
    for _ in range(-(-count // MT_N)):
        st = mt_twist(st)
        words.append(mt_temper(st))
    top = _cat(words)[:count] >> 8
    if isinstance(top, torch.Tensor):
        return st, top.to(torch.float32) * (1.0 / (1 << 24))
    return st, top.astype(np.float32) * np.float32(1.0 / (1 << 24))


def fastexp(x: torch.Tensor) -> torch.Tensor:
    """The bit-trick exponential of float32 ``x``, with saturation and the
    flush of subnormal results."""
    y = x.to(torch.float32) * torch.tensor(SCALE, device=x.device)
    i = y.double().nan_to_num(0.0).trunc().clamp(-(2**31), 2**31 - 1).to(torch.int64)
    w = (i + BIAS) & 0xFFFFFFFF
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    r = w.view(torch.float32) * torch.tensor(CENTRE, device=x.device)
    return torch.where(r.abs() < FLT_MIN, r * 0.0, r)


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), in place."""
    b = a.view(np.uint32)
    b += np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    b &= np.uint32(0xFFFF0000)
    return a


# -----------------------------------------------------------------------------
# Rung cb: the coloured sweep (PyTorch, any device).
# -----------------------------------------------------------------------------


def row_colours(m: Model, V: int) -> tuple[np.ndarray, int]:
    n, lpv = m.n, m.L // V
    adj = [set() for _ in range(n)]
    for i in range(n):
        for j in m.space_nbr[i]:
            if int(j) != i:
                adj[i].add(int(j))
                adj[int(j)].add(i)
    base = np.zeros(n, np.int64)
    for v in range(n):
        used = {int(base[u]) for u in adj[v] if u < v}
        c = 0
        while c in used:
            c += 1
        base[v] = c
    cyc = np.arange(lpv) % 2
    if lpv % 2:
        cyc[-1] = 2
    C = int(max(base.max(), cyc.max())) + 1
    return ((cyc[:, None] + base[None, :]) % C).reshape(-1), C


class Coloured:
    """The class tables of rung cb for one model, on one device."""

    def __init__(self, m: Model, V: int, device):
        n, lpv = m.n, m.L // V
        colours, C = row_colours(m, V)
        self.classes = []
        for c in range(C):
            rows = np.nonzero(colours == c)[0]
            p, i = rows // n, rows % n
            t = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
            self.classes.append(dict(
                rows=t(rows), h=t(m.h[i], torch.float32), J=t(m.space_J[i], torch.float32),
                tgt=t(p[:, None] * n + m.space_nbr[i]), tau=t(m.tau_J[i], torch.float32),
                down=t(np.where(p == 0, (lpv - 1) * n + i, rows - n)),
                up=t(np.where(p == lpv - 1, i, rows + n)),
                droll=t(p == 0, torch.bool), uroll=t(p == lpv - 1, torch.bool)))

    def sweep(self, s: torch.Tensor, u: torch.Tensor, beta: torch.Tensor, dtype) -> torch.Tensor:
        """One sweep of spins ``s`` (B, rows, V) on uniforms ``u`` at ``beta`` (B,)."""
        m2b = (-2.0 * beta).to(dtype)[:, None, None]
        for cl in self.classes:
            rows = cl["rows"]
            sc = s[:, rows]
            hs = cl["h"].to(dtype)[None, :, None].expand(sc.shape)
            for d in range(cl["tgt"].shape[1]):
                hs = hs + cl["J"][:, d].to(dtype)[None, :, None] * s[:, cl["tgt"][:, d]].to(dtype)
            down = s[:, cl["down"]]
            down = torch.where(cl["droll"][None, :, None], torch.roll(down, 1, -1), down)
            up = s[:, cl["up"]]
            up = torch.where(cl["uroll"][None, :, None], torch.roll(up, -1, -1), up)
            ht = cl["tau"].to(dtype)[None, :, None] * (down + up).to(dtype)
            x = (m2b * sc.to(dtype)) * (hs + ht)
            flip = u[:, rows] < fastexp(x.to(torch.float32))
            s = s.index_copy(1, rows, torch.where(flip, -sc, sc))
        return s


# -----------------------------------------------------------------------------
# Rung a4: the row walk (NumPy on the host).
# -----------------------------------------------------------------------------


def start_fields(m: Model, flat: np.ndarray, V: int):
    """``(h_space, h_tau)`` of flat configurations ``(K, N)`` in lane layout."""
    s = flat.reshape(-1, m.L, m.n).astype(np.float32)
    hs = np.broadcast_to(m.h, s.shape).astype(np.float32).copy()
    for d in range(m.space_nbr.shape[1]):
        hs += m.space_J[:, d] * s[:, :, m.space_nbr[:, d]]
    ht = m.tau_J * (np.roll(s, 1, axis=1) + np.roll(s, -1, axis=1))
    K = s.shape[0]
    return (to_lane(hs.reshape(K, -1), m.n, m.L, V), to_lane(ht.reshape(K, -1), m.n, m.L, V))


class RowWalk:
    """Rung a4 over ``K`` jobs at once; arrays are ``(rows, K, V)``."""

    def __init__(self, m: Model, V: int, bf16: bool = False):
        self.m, self.V, self.bf16 = m, V, bf16
        n = m.n
        self.rows = m.L // V * n
        self.steps = []
        J2 = (2.0 * m.space_J).astype(np.float32)
        t2 = (2.0 * m.tau_J).astype(np.float32)
        for q in range(self.rows):
            i = q % n
            real = [d for d in range(m.space_nbr.shape[1]) if int(m.space_nbr[i, d]) != i]
            tgt = np.asarray([q - i + int(m.space_nbr[i, d]) for d in real], np.int64)
            self.steps.append((tgt, J2[i, real][:, None, None], t2[i]))
        #: A bound of |h_space + h_tau| at any site.
        self.field_bound = float(np.max(np.abs(m.h) + np.abs(m.space_J).sum(axis=1)
                                        + 2 * np.abs(m.tau_J))) * 1.001

    def sweep(self, s, hs, ht, u, m2b):
        """One sweep in place; ``u`` the sweep's uniforms (rows, K, V) with
        ``max(u, LARGEST_SUBNORMAL)`` taken, ``m2b`` the (K, 1) values of
        ``-2 beta``."""
        if self.bf16:
            return self._sweep_bf16(s, hs, ht, u, m2b)
        n, rows = self.m.n, self.rows
        # The exponent argument cannot reach the int32 range where the exp
        # saturates unless the fields can: skip the clamp when they cannot.
        clamp = float(np.abs(m2b).max()) * self.field_bound * float(SCALE) >= 2.0**31 - 2**8
        shape = s.shape[1:]
        x, y, p, sm, tc = (np.empty(shape, np.float32) for _ in range(5))
        w = np.empty(shape, np.int32)
        wf = w.view(np.float32)
        mask = np.empty(shape, bool)
        add, sub, mul, less, neg = np.add, np.subtract, np.multiply, np.less, np.negative
        S, HS, HT, U = list(s), list(hs), list(ht), list(u)
        for q in range(rows):
            tgt, j2, t2 = self.steps[q]
            i, sq = q % n, S[q]
            add(HS[q], HT[q], out=x)
            mul(m2b, sq, out=y)
            mul(y, x, out=x)
            mul(x, SCALE, out=x)
            if clamp:
                np.maximum(x, -2147483648.0, out=x)
                np.minimum(x, INT32_TOP_F32, out=x)
            np.copyto(w, x, casting="unsafe")  # truncation toward zero
            add(w, BIAS, out=w)  # wraps like an int32 add
            mul(wf, CENTRE, out=p)
            less(U[q], p, out=mask)
            mul(sq, mask, out=sm)  # the flipped spins' old values, else 0
            neg(sq, out=sq, where=mask)
            if len(tgt):
                hs[tgt] -= sm * j2
            mul(sm, t2, out=tc)
            if q < n:  # first layer block: the down link wraps one lane over
                r = HT[rows - n + i]
                sub(r[:, :-1], tc[:, 1:], out=r[:, :-1])
                sub(r[:, -1], tc[:, 0], out=r[:, -1])
                sub(HT[q + n], tc, out=HT[q + n])
            elif q >= rows - n:  # last layer block: the up link wraps
                sub(HT[q - n], tc, out=HT[q - n])
                r = HT[i]
                sub(r[:, 1:], tc[:, :-1], out=r[:, 1:])
                sub(r[:, 0], tc[:, -1], out=r[:, 0])
            else:
                sub(HT[q - n], tc, out=HT[q - n])
                sub(HT[q + n], tc, out=HT[q + n])

    def _sweep_bf16(self, s, hs, ht, u, m2b):
        """`sweep` with every field, product and exponent argument rounded
        to bfloat16."""
        n, rows, rnd = self.m.n, self.rows, round_bf16
        shape = s.shape[1:]
        x = np.empty(shape, np.float32)
        w = np.empty(shape, np.int32)
        p = np.empty(shape, np.float32)
        mask = np.empty(shape, bool)
        neg = np.empty(shape, np.float32)
        tc = np.empty(shape, np.float32)
        roll = np.empty(shape, np.float32)

        def add_tau(r, v):
            ht[r] += v
            rnd(ht[r])

        for q in range(rows):
            tgt, j2, t2 = self.steps[q]
            i, sq = q % n, s[q]
            rnd(np.add(hs[q], ht[q], out=x))
            rnd(np.multiply(x, rnd(m2b * sq), out=x))
            np.multiply(x, SCALE, out=x)
            np.clip(x, -2147483648.0, INT32_TOP_F32, out=x)
            w[...] = x
            w += BIAS
            np.multiply(w.view(np.float32), CENTRE, out=p)
            np.less(u[q], p, out=mask)
            np.multiply(sq, mask, out=neg)
            np.negative(neg, out=neg)
            sq += neg
            sq += neg
            if len(tgt):
                hs[tgt] = rnd(hs[tgt] + rnd(neg[None] * j2))
            rnd(np.multiply(neg, t2, out=tc))
            if q < n:
                roll[:, :-1], roll[:, -1] = tc[:, 1:], tc[:, 0]
                add_tau(rows - n + i, roll)
                add_tau(q + n, tc)
            elif q >= rows - n:
                add_tau(q - n, tc)
                roll[:, 1:], roll[:, 0] = tc[:, :-1], tc[:, -1]
                add_tau(i, roll)
            else:
                add_tau(q - n, tc)
                add_tau(q + n, tc)


# -----------------------------------------------------------------------------
# Replays.
# -----------------------------------------------------------------------------


def _job_betas(schedule) -> np.ndarray:
    """A schedule ``[(sweeps, beta), ...]`` as one float32 beta a sweep."""
    return np.concatenate([np.full(int(k), b, np.float32) for k, b in schedule])


class _Sweeper:
    """Sweeps of ``B`` replicas of one model, each on its own ``V`` generator
    columns: rung cb on ``device`` (PyTorch), rung a4 on the host (NumPy)."""

    def __init__(self, m: Model, V: int, rung: str, device, dtype: str, flat: np.ndarray,
                 seeds: np.ndarray):
        if rung not in ("cb", "a4"):
            raise ValueError(f"no reference for rung {rung!r}")
        self.m, self.V, self.rung, self.device = m, V, rung, torch.device(device)
        self.rows = m.L // V * m.n
        self.bf16 = dtype == "bfloat16"
        self.B = flat.shape[0]
        dev = self.device if rung == "cb" else torch.device("cpu")
        st = mt_seed(seeds)  # (624, B*V)
        self.rng = torch.as_tensor(st.astype(np.int64), device=dev) if rung == "cb" else st
        lane = to_lane(flat, m.n, m.L, V)  # (B, rows, V)
        if rung == "cb":
            self.col = Coloured(m, V, dev)
            self.s = torch.as_tensor(lane, device=dev)
            self.dtype = torch.bfloat16 if self.bf16 else torch.float32
        else:
            self.walk = RowWalk(m, V, bf16=self.bf16)
            hs, ht = start_fields(m, flat, V)
            if self.bf16:
                round_bf16(hs), round_bf16(ht)
            self.s, self.hs, self.ht = (np.ascontiguousarray(a.transpose(1, 0, 2))
                                        for a in (lane, hs, ht))

    def sweep(self, betas: np.ndarray) -> None:
        """One sweep of every replica; ``betas`` (B,) float32."""
        self.rng, u = mt_uniforms(self.rng, self.rows)
        u = u.reshape(self.rows, self.B, self.V)
        if self.rung == "cb":
            beta = torch.as_tensor(betas, device=self.device)
            self.s = self.col.sweep(self.s, u.permute(1, 0, 2), beta, self.dtype)
            return
        u = np.maximum(u, LARGEST_SUBNORMAL)
        m2b = (np.float32(-2.0) * betas.astype(np.float32))[:, None]
        if self.bf16:
            round_bf16(m2b)
        self.walk.sweep(self.s, self.hs, self.ht, u, m2b)

    def flat(self, idx=None) -> np.ndarray:
        """The current spins (B, N) in flat layer-major order."""
        s = self.s.cpu().numpy() if self.rung == "cb" else self.s.transpose(1, 0, 2)
        if idx is not None:
            s = s[idx]
        return to_flat(np.ascontiguousarray(s), self.m.n, self.m.L, self.V)


def anneal(m: Model, V: int, rung: str, jobs: list[dict], device="cpu",
           dtype: str = "float32") -> list[dict]:
    """Replay annealing jobs ``{"seed", "schedule": [(sweeps, beta), ...]}``
    side by side; each returns ``{"spins" (N,), "energy", "final_beta"}``."""
    if not jobs:
        return []
    betas = [_job_betas(j["schedule"]) for j in jobs]
    flat = np.stack([first_spins(m, j["seed"] * 1000) for j in jobs])
    seeds = np.concatenate([lane_seeds(V, j["seed"]) for j in jobs])
    sw = _Sweeper(m, V, rung, device, dtype, flat, seeds)
    T = max(len(b) for b in betas)
    out: list = [None] * len(jobs)
    for t in range(T):
        sw.sweep(np.asarray([b[min(t, len(b) - 1)] for b in betas], np.float32))
        done = [k for k, b in enumerate(betas) if len(b) == t + 1]
        if done:
            spins = sw.flat(done)
            for k, sp in zip(done, spins):
                out[k] = {"spins": sp, "final_beta": float(betas[k][-1])}
    en = energy(m, np.stack([o["spins"] for o in out]))
    for o, e in zip(out, en):
        o["energy"] = float(e)
    return out


def lane_energy(m: Model, s: torch.Tensor) -> torch.Tensor:
    """Energies (float64) of lane-layout replicas ``s`` (B, rows, V) on
    their own device: the next layer of the last layer block is the first
    block one lane over."""
    B, rows, V = s.shape
    lpv = rows // m.n
    x = s.reshape(B, lpv, m.n, V).double()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=s.device)  # noqa: E731
    local = t(m.h)[:, None].expand(x.shape[1:]).clone()
    for d in range(m.space_nbr.shape[1]):
        local = local + 0.5 * t(m.space_J[:, d])[:, None] * x[:, :, m.space_nbr[:, d]]
    up = torch.cat([x[:, 1:], torch.roll(x[:, :1], -1, dims=-1)], dim=1)
    local = local + t(m.tau_J)[:, None] * up
    return -(x * local).sum(dim=(1, 2, 3))


def _energies32(m: Model, sw: _Sweeper, dtype: str) -> np.ndarray:
    """The swap phase's float32 energies of every replica."""
    s = sw.s if sw.rung == "cb" else torch.as_tensor(sw.s.transpose(1, 0, 2))
    e = lane_energy(m, s).float().cpu().numpy()
    return round_bf16(e) if dtype == "bfloat16" else e


def ladders(m: Model, V: int, rung: str, jobs: list[dict], device="cpu",
            dtype: str = "float32") -> list[dict]:
    """Replay parallel-tempering ladders ``{"seed", "betas" (R,),
    "rounds", "sweeps_per_round"}`` of one shape side by side; each
    returns ``{"spins" (R, N), "energy" (R,), "betas" (R,), "accept",
    "propose"}``."""
    if not jobs:
        return []
    R, rounds, spr = len(jobs[0]["betas"]), jobs[0]["rounds"], jobs[0]["sweeps_per_round"]
    if any((len(j["betas"]), j["rounds"], j["sweeps_per_round"]) != (R, rounds, spr)
           for j in jobs):
        raise ValueError("ladders replayed together need one shape")
    G = len(jobs)
    flat = np.stack([first_spins(m, j["seed"] * 1000 + b) for j in jobs for b in range(R)])
    seeds = np.concatenate([lane_seeds(R * V, j["seed"]) for j in jobs])
    sw = _Sweeper(m, V, rung, device, dtype, flat, seeds)
    betas = np.stack([np.asarray(j["betas"], np.float32) for j in jobs])  # (G, R)
    swap_rng = torch.as_tensor(
        mt_seed(np.asarray([(j["seed"] + 17) % 2**32 for j in jobs], np.uint32)).astype(np.int64))
    accept, propose = np.zeros(G, np.int64), np.zeros(G, np.int64)
    for r in range(rounds):
        for _ in range(spr):
            sw.sweep(betas.reshape(-1))
        swap_rng, su = mt_uniforms(swap_rng, (R + 1) // 2)
        su = su.numpy().T  # (G, ceil(R/2))
        e = _energies32(m, sw, dtype).reshape(G, R)
        left = np.arange(r % 2, R - 1, 2)
        right = left + 1
        arg = (betas[:, left] - betas[:, right]) * (e[:, left] - e[:, right])
        if dtype == "bfloat16":
            round_bf16(arg)
        p = fastexp(torch.as_tensor(np.clip(arg, -20.0, 0.0))).numpy()
        acc = su[:, left // 2] < p
        bl, br = betas[:, left].copy(), betas[:, right].copy()
        betas[:, left] = np.where(acc, br, bl)
        betas[:, right] = np.where(acc, bl, br)
        accept += acc.sum(axis=1)
        propose += len(left)
    spins = sw.flat().reshape(G, R, -1)
    return [{"spins": spins[g], "energy": energy(m, spins[g]), "betas": betas[g].copy(),
             "accept": int(accept[g]), "propose": int(propose[g])} for g in range(G)]
