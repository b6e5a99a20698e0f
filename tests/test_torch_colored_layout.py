"""The premise of the colored kernels' layout (kernels #1 and #2), on the CPU.

The kernels (csrc/colored_sweep.cuh) update the rows of a color class in
any order, many at once, reading and writing one shared spin tile; each
row's uniform is fixed by its row id.  That is bit-exact only if

* no class reads a row it writes: on the packed tables the kernels read
  (`ops._class_tables`), every neighbour target of an entry is either a
  row outside its class or the entry's own row (a padding slot, same lane,
  coupling 0), and every tau source row lies outside the class, rolled
  lanes included;
* a colored sweep that visits each class's rows one at a time, in any
  order, equals `ref.colored_multisweep_ref` (and so the reference's
  `colored_flip_spins`) bit for bit.

The host side of the layout, `ops.colored_smem_plan`, is held here too:
what fits in shared memory, where the uniforms go, and the ValueError
that names the largest rows a launch takes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import ising as jis
from repro.core import metropolis as jmp
from repro.core import reorder as jro
from repro.core.fastexp import EXP_FNS as JEXP
from repro_torch.core import engine, fastexp, ising, metropolis, reorder
from repro_torch.core import mt19937 as mt
from repro_torch.kernels import ops, ref

#: (n, L) at V=128: the paper's shape, the tests' small shapes (n=6 L=384
#: has three layer blocks and classes of 4-5 rows), and two generator
#: blocks a sweep (rows=640).
SHAPES = [(96, 256), (4, 256), (6, 384), (8, 256), (320, 256)]
SHAPE_IDS = ["paper", "tiny", "lpv3", "n8", "two-blocks"]


def _tables(n, L, seed=None):
    m = ising.random_layered_model(n=n, L=L, seed=n if seed is None else seed, beta=1.0)
    classes = reorder.colored_classes(m, ops.LANES)
    return m, classes, ops._class_tables(classes, n)


@pytest.mark.parametrize("n,L", SHAPES, ids=SHAPE_IDS)
def test_no_class_reads_a_row_it_writes(n, L):
    m, classes, t = _tables(n, L)
    rows = m.n * m.L // ops.LANES
    sd = m.space_degree
    off, row = t["off"], t["row"]
    # Every row is exactly one entry: the kernels stage the tables by entry.
    np.testing.assert_array_equal(np.sort(row), np.arange(rows))
    assert off[0] == 0 and off[-1] == rows and len(off) == len(classes) + 1
    tgt = t["tgt"].reshape(rows, sd)
    for c in range(len(classes)):
        ks = np.arange(off[c], off[c + 1])
        own = set(row[ks].tolist())
        for k in ks:
            for d in range(sd):
                target = int(tgt[k, d])
                if target == row[k]:  # a padding slot: own row, own lane
                    assert m.space_nbr[row[k] % n, d] == row[k] % n
                else:
                    assert target not in own, (c, k, d)
            # Tau sources, whether read in the own lane or one lane over.
            assert int(t["down"][k]) not in own and int(t["up"][k]) not in own, (c, k)
        # The roll masks mark exactly the section-wrap rows.
        p = row[ks] // n
        lpv = rows // n
        np.testing.assert_array_equal(t["roll"][ks] & 1, (p == 0).astype(np.int32))
        np.testing.assert_array_equal(t["roll"][ks] >> 1, (p == lpv - 1).astype(np.int32))


@pytest.mark.parametrize("n,L", SHAPES, ids=SHAPE_IDS)
def test_padding_targets_carry_zero_coupling(n, L):
    """A class entry that reads its own row does so through a padding slot
    of coupling 0: the value it adds is a signed zero of the spin it reads
    before its own update, in the kernel as in the reference."""
    m, classes, t = _tables(n, L)
    sd = m.space_degree
    J = np.concatenate([c.space_J for c in classes])
    tgt = t["tgt"].reshape(-1, sd)
    self_read = tgt == t["row"][:, None]
    assert np.all(J[self_read] == 0.0)


def _row_by_row_sweeps(spins, rng, beta, classes, coef, n, sweeps, order, seed=0):
    """Colored sweeps that visit each class's rows one at a time, in
    ``order`` ("ascending", "reversed", "shuffled"), on the spins as the
    earlier rows of the class left them: the kernels' walk, in plain
    PyTorch.  ``coef(b)`` gives replica b's per-entry (h, J, tau) of every
    class.  Returns ``(spins, rng)``."""
    B, rows, V = spins.shape
    perm = np.random.default_rng(seed)
    spins = spins.clone()
    col = torch.arange(V)
    for _ in range(sweeps):
        rng, u = mt.mt_uniforms_count(rng, rows)
        u = u.reshape(rows, B, V).permute(1, 0, 2)
        for c, cls in enumerate(classes):
            ks = np.arange(len(cls.rows))
            if order == "reversed":
                ks = ks[::-1]
            elif order == "shuffled":
                ks = perm.permutation(ks)
            for k in ks:
                r = int(cls.rows[k])
                for b in range(B):
                    h_e, J_e, tau_e = coef(b)
                    s = spins[b, r]
                    hs = torch.full((V,), float(h_e[c][k]), dtype=torch.float32)
                    for d in range(cls.space_tgt.shape[1]):
                        hs = hs + torch.tensor(J_e[c][k, d]) * spins[b, int(cls.space_tgt[k, d])]
                    down = spins[b, int(cls.down_src[k])]
                    if cls.down_roll[k]:
                        down = down[(col - 1) % V]
                    up = spins[b, int(cls.up_src[k])]
                    if cls.up_roll[k]:
                        up = up[(col + 1) % V]
                    ht = torch.tensor(tau_e[c][k]) * (down + up)
                    x = ((-2.0 * beta[b]) * s) * (hs + ht)
                    flip = u[b, r] < fastexp.fastexp_fast(x)
                    spins[b, r] = torch.where(flip, -s, s)
    return spins, rng


def _case(n, L, B, seed=1):
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    eng = engine.SweepEngine.create(m, rung="cb", backend="torch", batch=B, V=ops.LANES,
                                    device="cpu")
    carry = eng.init_carry(seed=seed)
    betas = torch.linspace(0.3, 1.6, B, dtype=torch.float32)
    return m, eng.classes, carry.spins, carry.rng, betas


def _single_coef(classes):
    tabs = ([c.h for c in classes], [c.space_J for c in classes], [c.tau_J for c in classes])
    return lambda b: tabs


@pytest.mark.parametrize("order", ["ascending", "reversed", "shuffled"])
@pytest.mark.parametrize("n,L,B,S", [(6, 384, 2, 3), (4, 256, 2, 2), (8, 256, 1, 2)],
                         ids=["lpv3", "tiny", "n8"])
def test_row_by_row_in_any_order_equals_plain(n, L, B, S, order):
    m, classes, spins, rng, betas = _case(n, L, B)
    got, got_rng = _row_by_row_sweeps(spins, rng, betas, classes, _single_coef(classes), n, S,
                                      order)
    want = ref.colored_multisweep_ref(
        spins, rng, betas, metropolis.classes_to(classes, "cpu"),
        h=torch.from_numpy(m.h), base_nbr=torch.from_numpy(m.space_nbr.astype(np.int64)),
        base_J=torch.from_numpy(m.space_J), tau_J=torch.from_numpy(m.tau_J), n=n, num_sweeps=S,
    )
    assert torch.equal(got, want[0])
    assert torch.equal(got_rng, want[3])
    assert not torch.equal(got, spins)  # the sweeps flipped something


def test_row_by_row_at_the_paper_shape_equals_plain():
    """One sweep at n=96, L=256 (rows=192, classes of 4-69 rows), rows of
    each class in a shuffled order."""
    m, classes, spins, rng, betas = _case(96, 256, 1, seed=3)
    got, _ = _row_by_row_sweeps(spins, rng, betas, classes, _single_coef(classes), 96, 1,
                                "shuffled", seed=5)
    want = ref.colored_multisweep_ref(
        spins, rng, betas, metropolis.classes_to(classes, "cpu"),
        h=torch.from_numpy(m.h), base_nbr=torch.from_numpy(m.space_nbr.astype(np.int64)),
        base_J=torch.from_numpy(m.space_J), tau_J=torch.from_numpy(m.tau_J), n=96, num_sweeps=1,
    )
    assert torch.equal(got, want[0])


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_row_by_row_equals_reference_colored_flip_spins(order):
    """One sweep, row by row in ``order``, against the JAX reference's
    `colored_flip_spins` on the same spins and uniforms, replica by
    replica."""
    n, L, B = 6, 384, 2
    m, classes, spins, rng, betas = _case(n, L, B, seed=4)
    got, _ = _row_by_row_sweeps(spins, rng, betas, classes, _single_coef(classes), n, 1, order)
    _, u = mt.mt_uniforms_count(rng, spins.shape[1])
    u = u.reshape(-1, B, ops.LANES).permute(1, 0, 2).numpy()
    jm = jis.random_layered_model(n=n, L=L, seed=n, beta=1.0)  # the same model as `m`
    np.testing.assert_array_equal(jm.space_J, m.space_J)
    jclasses = jro.colored_classes(jm, ops.LANES)
    for b in range(B):
        want = jmp.colored_flip_spins(jnp.asarray(spins[b].numpy()), jnp.asarray(u[b]),
                                      jnp.float32(betas[b].item()), jclasses, JEXP["fast"])
        np.testing.assert_array_equal(np.asarray(want), got[b].numpy())


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_row_by_row_multi_tenant_equals_plain(order):
    """The multi-tenant kernel's walk: each slot's coefficients gathered
    per entry through the entry's site, rows visited in ``order``, against
    `ref.colored_multisweep_multi_ref`."""
    n, L, B, S = 6, 384, 3, 2
    base = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    tenants = [ising.reseed_couplings(base, seed=100 + k) for k in range(B)]
    eng = engine.SweepEngine.create(tenants, rung="cb", backend="torch", V=ops.LANES,
                                    device="cpu")
    carry = eng.init_carry(seed=2)
    betas = torch.linspace(0.3, 1.6, B, dtype=torch.float32)
    classes = eng.classes
    t = eng.slot_tables

    def coef(b):
        sites = [c.rows % n for c in classes]
        return ([t["h"][b].numpy()[s] for s in sites],
                [t["base_J"][b].numpy()[s] for s in sites],
                [t["tau_J"][b].numpy()[s] for s in sites])

    got, got_rng = _row_by_row_sweeps(carry.spins, carry.rng, betas, classes, coef, n, S, order)
    want = ref.colored_multisweep_multi_ref(
        carry.spins, carry.rng, betas, metropolis.classes_to(classes, "cpu"), t["h"],
        torch.from_numpy(base.space_nbr.astype(np.int64)), t["base_J"], t["tau_J"], n, S,
    )
    assert torch.equal(got, want[0])
    assert torch.equal(got_rng, want[3])


# -- the shared-memory plan of the colored kernels ------------------------------


@pytest.mark.parametrize("n,L", SHAPES, ids=SHAPE_IDS)
def test_smem_plan_of_the_test_shapes(n, L):
    m, classes, _ = _tables(n, L)
    rows, sd, C = n * L // ops.LANES, m.space_degree, len(classes)
    nbytes, u_in_smem = ops.colored_smem_plan(rows, sd, C)
    assert nbytes <= ops.MAX_SMEM
    # Uniforms live in shared memory up to ~300 rows; rows=640 (two
    # generator blocks a sweep) keeps them in the device-memory scratch.
    assert u_in_smem == (rows <= 300)
    assert nbytes == ops.colored_smem_bytes(rows, sd, C, uniforms=u_in_smem)
    # Spin tile, C+1 offsets and 2*sd + 6 words an entry, each part rounded
    # up to 16 bytes, then the uniforms.
    tile, tables = rows * ops.LANES, 4 * ((C + 1) + rows * (2 * sd + 6))
    assert tile + tables <= nbytes - (tile * 4 if u_in_smem else 0) < tile + tables + 32
    assert nbytes % 16 == 0
    # A launch of 0 sweeps draws no uniforms.
    assert ops.colored_smem_plan(rows, sd, C, num_sweeps=0) == (
        ops.colored_smem_bytes(rows, sd, C, uniforms=False), False)


def test_smem_plan_refuses_rows_past_its_limit():
    sd, C = 6, 5
    most = max(r for r in range(1, 4000)
               if ops.colored_smem_bytes(r, sd, C, uniforms=False) <= ops.MAX_SMEM)
    assert ops.colored_smem_plan(most, sd, C) == (
        ops.colored_smem_bytes(most, sd, C, uniforms=False), False)
    with pytest.raises(ValueError, match=f"at most {most} rows"):
        ops.colored_smem_plan(most + 1, sd, C)
    # The first design held 1816 rows (the spin tile alone); the staged
    # tables lower that limit, and the refusal names it.
    assert most < ops.MAX_SMEM // ops.LANES
    with pytest.raises(ValueError, match="rows=1816 needs"):
        ops.colored_smem_plan(1816, sd, C)


def test_smem_plan_puts_uniforms_where_they_fit():
    sd, C = 6, 5
    fits = [r for r in range(2, 700)
            if ops.colored_smem_bytes(r, sd, C, uniforms=True) <= ops.MAX_SMEM]
    last = fits[-1]
    assert fits == list(range(2, last + 1))
    assert ops.colored_smem_plan(last, sd, C) == (
        ops.colored_smem_bytes(last, sd, C, uniforms=True), True)
    assert ops.colored_smem_plan(last + 1, sd, C)[1] is False
    # The paper's shape keeps its uniforms in shared memory: 96 KiB beside
    # the 24 KiB spin tile and the tables.
    assert ops.colored_smem_plan(192, sd, C) == (
        ops.colored_smem_bytes(192, sd, C, uniforms=True), True)


def test_uniform_without_conversion_is_exact():
    """The colored kernels turn a tempered word's 24 high bits k into the
    uniform k * 2^-24 without an int->float conversion (colored_sweep.cuh:
    uniform_of): the float with bits 0x4b000000 + k is 2^23 + k for
    k < 2^23 and 2k above.  Both branches equal the conversion's float(k)
    * 2^-24 bit for bit over all 2^24 values of k."""
    k = np.arange(2**24, dtype=np.uint32)
    want = k.astype(np.float32) * np.float32(1.0 / 16777216.0)
    f = (k + np.uint32(0x4B000000)).view(np.float32)
    got = np.where(k < 0x800000, (f - np.float32(8388608.0)) * np.float32(2.0**-24),
                   f * np.float32(2.0**-25)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # And that is what the plain generator draws: mt.uniforms_from_u32.
    words = torch.from_numpy((k[::4099] << np.uint32(8)).view(np.int32))
    np.testing.assert_array_equal(mt.uniforms_from_u32(words).numpy(), want[::4099])
    src = (ops._build.CSRC / "mt19937.cuh").read_text()
    assert "__uint_as_float(k + 0x4b000000u)" in src
    assert "(f - 8388608.0f) * 0x1p-24f : f * 0x1p-25f" in src


def test_spin_sign_flip_equals_the_product():
    """times_spin / spin_of (colored_sweep.cuh): J * s for a spin s = +-1
    is J with its sign bit flipped where s = -1, bit for bit, for every
    non-NaN float32 J (zeros, subnormals and infinities included)."""
    rng = np.random.default_rng(0)
    J = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, 3.4e38], np.float32),
    ])
    for s in (1.0, -1.0):
        want = (J * np.float32(s)).view(np.uint32)
        sign = np.uint32(0x80000000 if s < 0 else 0)
        np.testing.assert_array_equal(J.view(np.uint32) ^ sign, want)
    # The int8 spin bytes: +1 is 0x01, -1 is 0xFF; bit 7 is the sign.
    for q in range(4):
        word = np.uint32(0xFF << (8 * q))
        assert (word << np.uint32(24 - 8 * q)) & np.uint32(0x80000000) == 0x80000000
        word = np.uint32(0x01 << (8 * q))
        assert (word << np.uint32(24 - 8 * q)) & np.uint32(0x80000000) == 0


def test_warp_groups_within_the_kernels_limit():
    src = (ops._build.CSRC / "colored_sweep.cuh").read_text()
    assert "constexpr int CB_MAX_GROUPS = 8;" in src
    assert 1 <= ops.COLORED_WARP_GROUPS <= 8
