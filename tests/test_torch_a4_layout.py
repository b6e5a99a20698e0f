"""The premise of the a4 kernels' layout (csrc/a4_sweep.cuh), on the CPU.

The kernels walk a replica's rows with 4 warps, a lane a thread, stage
each site's neighbour entries sorted by target with a mask of the entries
that hit the same cell as the entry before them, and take the lane roll of
a wrap row's tau add from the neighbouring thread.  Here a plain emulation
of exactly that walk (`_walk`) is held bit pattern for bit pattern against
the port's plain version (`ref.metropolis_multisweep_ref`) and the
reference's jnp engine: at two layer blocks (both tau adds of a wrap row in
one cell), at three, on the random models' self-padded neighbour lists and
on a model whose lists repeat real neighbours out of order.  The staged
tables (`_table_layout`, as csrc/a4_sweep.cuh's a4_stage_tables builds
them) are held to the reference's add order on cells that include signed
zeros, and the shared-memory plan to its limits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import ising as jis
from repro_torch.core import convert, ising
from repro_torch.core import fastexp as fx
from repro_torch.core import mt19937 as tmt
from repro_torch.kernels import ops, ref

SIGN = torch.tensor(-(2**31), dtype=torch.int32)
ONE = 0x3F800000


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _table_layout(base_nbr, base_J2, tau_J2) -> np.ndarray:
    """The staged a4 tables of one model as the kernels build them in
    shared memory (csrc/a4_sweep.cuh: a4_stage_tables), (n, sd+1, 2) int32:
    per site its entries sorted stably by target, each (the target row's
    byte offset in its layer block, target * 128 * 4, J2 bits), then (tau2
    bits, mask of the entries whose target is that of the entry before
    them)."""
    nbr = np.asarray(base_nbr, np.int64)
    j2 = np.asarray(base_J2, np.float32)
    tau2 = np.asarray(tau_J2, np.float32).reshape(-1)
    n, sd = nbr.shape
    out = np.zeros((n, sd + 1, 2), np.int32)
    for i in range(n):
        order = np.argsort(nbr[i], kind="stable")
        tg = nbr[i][order]
        out[i, :sd, 0] = tg * ops.LANES * 4
        out[i, :sd, 1] = j2[i][order].view(np.int32)
        dup = sum(1 << d for d in range(1, sd) if tg[d] == tg[d - 1])
        out[i, sd] = (tau2[i:i + 1].view(np.int32)[0], dup)
    return out


def _walk(spins, hs, ht, u, tab, beta, n: int):
    """One a4 sweep as the kernel walks it: thread t of 128 owns lane t of
    every row; a row loads every cell before it stores any; the space adds
    follow the staged entries, an entry flagged in the mask reading the
    previous entry's store back; the rolled tc of a wrap row comes from
    thread t+1 (first block) or t-1 (last block), a ring.  Floats as the
    kernel builds them: -2 beta with the spin's sign, -S_mul from the sign
    and the accept bit."""
    B, rows, V = spins.shape
    sp, hsf, htf = (x.clone() for x in (spins, hs, ht))
    m2b = (-2.0 * beta).reshape(B, 1).contiguous().view(torch.int32)
    lpv, sd = rows // n, tab.shape[1] - 1
    for q in range(rows):
        p, i = divmod(q, n)
        base = q - i
        off = [int(x) // (4 * ops.LANES) for x in tab[i, :sd, 0]]
        J = torch.from_numpy(tab[i, :sd, 1].copy()).view(torch.float32)
        tau = torch.from_numpy(tab[i, sd:, 0].copy()).view(torch.float32)[0]
        dup = int(tab[i, sd, 1])
        first, last = p == 0, p == lpv - 1
        ta = rows - n + i if first else q - n
        tb = i if last else q + n
        same = ta == tb
        s, a, b = sp[:, q], hsf[:, q].clone(), htf[:, q].clone()
        v = [hsf[:, base + o].clone() for o in off]
        wa = htf[:, ta].clone()
        wb = None if same else htf[:, tb].clone()
        sg = s.contiguous().view(torch.int32) & SIGN
        x = (m2b ^ sg).view(torch.float32) * (a + b)
        acc = u[:, q] < fx.fastexp_fast(x)
        ns = (torch.where(acc, ONE, 0).to(torch.int32) | (sg ^ SIGN)).view(torch.float32)
        sp[:, q] = torch.where(acc, -s, s)
        for d in range(sd):
            if d > 0 and (dup >> d) & 1:  # the previous entry's store, read back
                v[d] = hsf[:, base + off[d]].clone()
            v[d] = v[d] + ns * J[d]
            hsf[:, base + off[d]] = v[d]
        tc = ns * tau
        if first:  # thread t gets thread t+1's tc
            rl = torch.roll(tc, -1, dims=-1)
        elif last:  # thread t gets thread t-1's
            rl = torch.roll(tc, 1, dims=-1)
        else:
            rl = tc
        ca, cb = (rl if first else tc), (rl if last else tc)
        if same:
            htf[:, ta] = (wa + ca) + cb
        else:
            htf[:, ta] = wa + ca
            htf[:, tb] = wb + cb
    return sp, hsf, htf


def _walk_multisweep(spins, hs, ht, rng, tab, beta, n: int, sweeps: int):
    B, rows, V = spins.shape
    for _ in range(sweeps):
        rng, u = tmt.mt_uniforms_count(rng, rows)
        u = u.reshape(rows, B, V).permute(1, 0, 2)
        spins, hs, ht = _walk(spins, hs, ht, u, tab, beta, n)
    return spins, hs, ht, rng


def _tables(m):
    return (torch.from_numpy(m.space_nbr.astype(np.int32)),
            torch.from_numpy((2.0 * m.space_J).astype(np.float32)),
            torch.from_numpy((2.0 * m.tau_J).astype(np.float32)))


def _repeating_model(jis_or_ising, n: int = 6, L: int = 256):
    """A model whose neighbour lists repeat real neighbours out of order,
    with distinct couplings, beside self pads: entry order decides bits."""
    base = ising.random_layered_model(n=n, L=L, seed=3, beta=1.1)
    nbr = np.array(base.space_nbr)
    J = np.array(base.space_J)
    rng = np.random.default_rng(5)
    for i in range(n):
        j = (i + 1) % n
        nbr[i] = [j, i, (i + 2) % n, j][: nbr.shape[1]]
        J[i] = rng.normal(size=nbr.shape[1]).astype(np.float32)
    arrays = dict(n=n, L=L, h=np.array(base.h), space_nbr=nbr.astype(np.int32),
                  space_J=J.astype(np.float32), tau_J=np.array(base.tau_J), beta=1.1)
    return jis_or_ising.LayeredModel(**arrays)


# n, L (V=128): two layer blocks with self pads (n=6, sd=4), three layer
# blocks, the paper's degree.
SHAPES = [(6, 256), (6, 384), (16, 256)]
SHAPE_IDS = ["lpv2-pads", "lpv3", "sd6"]


@pytest.mark.parametrize("n,L", SHAPES, ids=SHAPE_IDS)
def test_emulated_walk_equals_plain_and_jax(n, L):
    jm = jis.random_layered_model(n=n, L=L, seed=n, beta=1.1)
    tm = convert.model_from_arrays(dataclasses.asdict(jm))
    B, S = 2, 3
    je = jeng.SweepEngine.create(jm, rung="a4", backend="jnp", batch=B, V=128)
    jc = je.init_carry(seed=7, betas=np.linspace(0.4, 1.6, B, dtype=np.float32))
    tc = convert.carry_from_numpy({f: np.asarray(getattr(jc, f)) for f in jc._fields}, "cpu")
    tab = _table_layout(tm.space_nbr, 2.0 * tm.space_J, 2.0 * tm.tau_J)
    if n == 6:  # the self-padded lists put several entries on one cell
        assert (tab[:, -1, 1] != 0).any()
    got = _walk_multisweep(tc.spins, tc.h_space, tc.h_tau, tc.rng, tab, tc.betas, n, S)
    want = ref.metropolis_multisweep_ref(tc.spins, tc.h_space, tc.h_tau, tc.rng, *_tables(tm),
                                         tc.betas, n, S)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    jc = je.run(jc, S)
    for a, f in zip(got, ("spins", "h_space", "h_tau", "rng")):
        np.testing.assert_array_equal(_bits(a), np.asarray(getattr(jc, f)).view(np.int32))
    assert not torch.equal(got[0], tc.spins)  # the sweeps flipped spins


def test_emulated_walk_keeps_the_order_of_repeated_neighbours():
    """Repeated real neighbours with distinct couplings: the staged sort
    brings one cell's entries together in their order, and the chained
    adds reproduce the reference's in-order adds bit for bit."""
    tm, jm = _repeating_model(ising), _repeating_model(jis)
    tab = _table_layout(tm.space_nbr, 2.0 * tm.space_J, 2.0 * tm.tau_J)
    assert (tab[:, -1, 1] != 0).all()
    B, S = 2, 3
    je = jeng.SweepEngine.create(jm, rung="a4", backend="jnp", batch=B, V=128)
    jc = je.init_carry(seed=2, betas=np.array([0.5, 1.5], np.float32))
    tc = convert.carry_from_numpy({f: np.asarray(getattr(jc, f)) for f in jc._fields}, "cpu")
    got = _walk_multisweep(tc.spins, tc.h_space, tc.h_tau, tc.rng, tab, tc.betas, tm.n, S)
    want = ref.metropolis_multisweep_ref(tc.spins, tc.h_space, tc.h_tau, tc.rng, *_tables(tm),
                                         tc.betas, tm.n, S)
    jc = je.run(jc, S)
    for a, b, f in zip(got, want, ("spins", "h_space", "h_tau", "rng")):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), np.asarray(getattr(jc, f)).view(np.int32))


@pytest.mark.parametrize("model", ["random", "repeating"])
def test_staged_tables_hold_what_the_walk_reads(model):
    """Per site: entries sorted by target, stably; the mask flags exactly
    the entries on the previous entry's cell; tau2 and every J2 are the
    doubled couplings' bits; and the chained adds on the staged entries
    equal the reference's adds in entry order on cells that include signed
    zeros, for every -S_mul in {-1, -0, +0, +1}."""
    m = (ising.random_layered_model(n=12, L=256, seed=4, beta=1.0) if model == "random"
         else _repeating_model(ising))
    nbr, J2, tau2 = (t.numpy() for t in _tables(m))
    tab = _table_layout(nbr, J2, tau2)
    n, sd = nbr.shape
    assert tab.shape == (n, sd + 1, 2) and tab.dtype == np.int32
    rng = np.random.default_rng(0)
    for i in range(n):
        order = np.argsort(nbr[i], kind="stable")
        np.testing.assert_array_equal(tab[i, :sd, 0], nbr[i][order] * 4 * ops.LANES)
        np.testing.assert_array_equal(tab[i, :sd, 1], J2[i][order].view(np.int32))
        assert tab[i, sd, 0] == tau2[i:i + 1].view(np.int32)[0]
        tg = tab[i, :sd, 0]
        assert tab[i, sd, 1] == sum(1 << d for d in range(1, sd) if tg[d] == tg[d - 1])
        for ns in (np.float32(-1.0), np.float32(-0.0), np.float32(0.0), np.float32(1.0)):
            cells = rng.normal(size=n).astype(np.float32)
            cells[rng.random(n) < 0.3] = np.float32(-0.0)
            cells[rng.random(n) < 0.2] = np.float32(0.0)
            want = cells.copy()
            for d in range(sd):  # the reference: cell + (-S_mul) * J2, entry order
                want[nbr[i, d]] = want[nbr[i, d]] + ns * J2[i, d]
            got = cells.copy()
            v = [got[t // (4 * ops.LANES)] for t in tg]  # every load before any store
            for d in range(sd):
                jd = tab[i, d, 1:2].view(np.float32)[0]
                if (tab[i, sd, 1] >> d) & 1:  # the previous entry's store, read back
                    v[d] = got[tg[d] // (4 * ops.LANES)]
                v[d] = v[d] + ns * jd
                got[tg[d] // (4 * ops.LANES)] = v[d]
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_shared_memory_plan_and_limits():
    """At the paper's shape a CTA keeps the fields in shared memory beside
    the int8 spins, the staged tables, the uniform ring and the exchange
    buffers: 231,680 B of 232,448; rows=640 keeps the fields in device
    memory.  A replica tile of 2 does not fit at rows=192 or 96 but does at
    rows 32 and 64, and no CTA leaves room for the 12 walker warps of a
    tile of 3; past the limits each plan raises naming the largest rows,
    and `check_kernel_rows` returns them."""
    assert ops.a4_table_bytes(96, 6) == 96 * 7 * 8
    ring = (ops.A4_URING + 2) * 128 * 4
    assert ops.a4_smem_plan(192, 96, 6) == (
        2 * 192 * 128 * 4 + 192 * 128 + 96 * 7 * 8 + ring, True) == (231_680, True)
    assert ops.a4_smem_plan(640, 320, 6) == (640 * 128 + 320 * 7 * 8 + ring, False)
    with pytest.raises(ValueError, match="replica_tile 2 at rows=192 .* at most 94 rows"):
        ops.a4_smem_plan(192, 96, 6, tile=2)
    with pytest.raises(ValueError, match="replica_tile 2 at rows=96 .* at most 94 rows"):
        ops.a4_smem_plan(96, 48, 6, tile=2, multi=True)
    assert ops.a4_smem_plan(32, 16, 6, tile=2, multi=True)[1]
    assert ops.a4_smem_plan(64, 32, 6, tile=2, multi=True)[1]
    assert ops.check_kernel_rows("a4", 1734, 96, 6) == 1734
    assert ops.check_kernel_rows("cb", 1152, 576, 6, 5) == 1162
    with pytest.raises(ValueError, match="the a4 kernels hold at most 1734 rows"):
        ops.check_kernel_rows("a4", 1776, 96, 6)
    with pytest.raises(ValueError, match="the colored kernels hold at most 1162 rows"):
        ops.check_kernel_rows("cb", 1536, 768, 6, 5)
    with pytest.raises(ValueError, match="at most 8 space neighbours"):
        ops.a4_smem_plan(192, 96, 9)
    with pytest.raises(ValueError, match="replica_tile 3 leaves no generator warp"):
        ops.a4_smem_plan(16, 8, 2, tile=3)
