"""The port's slot pool over several devices, at the engine level.

A `SweepEngine` with ``mesh=`` lays its slots out in per-device blocks and
launches the unmodified single-device body once per device; slots are
independent, so D devices must equal one device bit for bit.  On the CPU
a mesh of D logical devices is D entries of ``cpu`` (the counterpart of
the reference's forced host devices, which the port does not need).
Held here, on rungs a4 and cb, single-model and multi-tenant:

* D=4 (equal split) and the ragged capacities [4, 2, 1, 1] and
  [3, 3, 2, 0] equal D=1 and the reference's jnp engine: the whole pool in
  logical layout (spins, fields, betas, raw MT19937 state), the slot APIs
  across device boundaries, a tenant admitted onto one device, and a pool
  moved between meshes;
* `slot_energies` equals D=1 bit for bit and the reference's within
  rtol 1e-5 (its float32 sums in XLA's order, ROADMAP §3d/§3o);
* `retire_rows` (a retirement pass's read) equals each slot's
  ``spins_flat(extract_slot)`` and `gather_betas`, one gather and copy a
  device block, on one device and every mesh layout;
* `normalize_capacities` and the mesh checks raise the reference's
  messages.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import ising as jis
from repro_torch.core import engine, ising
from repro_torch.launch.mesh import SlotMesh, make_slot_mesh

MODEL = ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)
JMODEL = jis.random_layered_model(n=5, L=8, seed=1, beta=1.0)
CAPS = {"d4": None, "ragged": (4, 2, 1, 1), "zero": (3, 3, 2, 0)}


def _pool_equal(a, b, what):
    for f, x, y in zip(engine.SweepCarry._fields, a.carry, b.carry):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what}: {f}")
    assert (a.tables is None) == (b.tables is None)
    for k in a.tables or ():
        np.testing.assert_array_equal(np.asarray(a.tables[k]), np.asarray(b.tables[k]),
                                      err_msg=f"{what}: table {k}")


def _engines(rung, caps, multi):
    models = [MODEL] + [ising.reseed_couplings(MODEL, s) for s in range(7)]
    jmodels = [JMODEL] + [jis.reseed_couplings(JMODEL, s) for s in range(7)]
    kw = dict(rung=rung, backend="torch", V=4, device="cpu")
    if multi:
        one = engine.SweepEngine.create(models, **kw)
        four = engine.SweepEngine.create(models, mesh=make_slot_mesh(4, "cpu"),
                                         capacities=caps, **kw)
        ref = jengine.SweepEngine.create(jmodels, rung=rung, backend="jnp", V=4)
    else:
        one = engine.SweepEngine.create(MODEL, batch=8, **kw)
        four = engine.SweepEngine.create(MODEL, batch=8, mesh=make_slot_mesh(4, "cpu"),
                                         capacities=caps, **kw)
        ref = jengine.SweepEngine.create(JMODEL, rung=rung, backend="jnp", batch=8, V=4)
    return one, four, ref


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("caps", list(CAPS), ids=list(CAPS))
@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_mesh_engine_equals_one_device_and_the_reference(rung, caps, multi):
    one, four, ref = _engines(rung, CAPS[caps], multi)
    assert four.capacities == (CAPS[caps] or (2, 2, 2, 2))
    c1, c4, cj = (e.run(e.init_carry(seed=5), 6) for e in (one, four, ref))
    assert isinstance(c4, engine.MeshCarry) and len(c4.blocks) == 4
    if caps == "zero":
        assert c4.blocks[3] is None  # capacity 0: no block, no launch
    p1, p4, pj = (e.extract_pool(c) for e, c in ((one, c1), (four, c4), (ref, cj)))
    _pool_equal(p4, p1, "D=4 vs D=1")
    _pool_equal(p4, pj, "D=4 vs the reference")
    np.testing.assert_array_equal(four.spins_flat(c4), ref.spins_flat(cj))
    e1, e4 = one.slot_energies(c1).numpy(), four.slot_energies(c4).numpy()
    np.testing.assert_array_equal(e4, e1)
    np.testing.assert_allclose(e4, np.asarray(ref.slot_energies(cj)), rtol=1e-5)

    # The slot APIs with GLOBAL slots on different devices: splice, park on
    # one device and resume on another, betas on two devices, a new tenant.
    slot = four.init_slot_carry(seed=77)
    jslot = ref.init_slot_carry(seed=77)
    for b in (0, 5, 7):
        c1, c4 = one.splice_slot(c1, b, slot), four.splice_slot(c4, b, slot)
        cj = ref.splice_slot(cj, b, jslot)
    assert four.slot(6).device == four.slot_device(6) == {"d4": 3, "ragged": 2, "zero": 2}[caps]
    c1 = one.slot(1).resume(c1, one.slot(6).park(c1))
    c4 = four.slot(1).resume(c4, four.slot(6).park(c4))
    cj = ref.slot(1).resume(cj, ref.slot(6).park(cj))
    c1, c4 = (e.set_slot_betas(c, [2, 7], [0.25, 0.75]) for e, c in ((one, c1), (four, c4)))
    cj = ref.set_slot_betas(cj, [2, 7], [0.25, 0.75])
    if multi:
        for e, m in ((one, ising), (four, ising), (ref, jis)):
            e.set_slot_model(5, m.reseed_couplings(MODEL if m is ising else JMODEL, 99))
    c1, c4, cj = one.run(c1, 3), four.run(c4, 3), ref.run(cj, 3)
    p4 = four.extract_pool(c4)
    _pool_equal(p4, one.extract_pool(c1), "after the slot APIs, D=1")
    _pool_equal(p4, ref.extract_pool(cj), "after the slot APIs, the reference")
    for b in (0, 3, 6, 7):
        for got, want in zip(four.extract_slot(c4, b), one.extract_slot(c1, b)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(four.gather_betas(c4, [7, 2]).numpy(),
                                  one.gather_betas(c1, [7, 2]).numpy())


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_pool_moves_between_meshes(rung, multi):
    """A pool extracted under [4, 2, 1, 1] splices onto D=1, onto the equal
    split and onto [3, 3, 2, 0], and all continue alike (the padding rows
    never show)."""
    one, four, _ = _engines(rung, (4, 2, 1, 1), multi)
    c4 = four.run(four.init_carry(seed=3), 4)
    pool = four.extract_pool(c4)
    want = one.run(one.splice_pool(pool), 5)
    for caps in (None, (3, 3, 2, 0), (4, 2, 1, 1)):
        _, other, _ = _engines(rung, caps, multi)
        got = other.run(other.splice_pool(pool), 5)
        _pool_equal(other.extract_pool(got), one.extract_pool(want), f"onto {caps}")


RETIRE = [("a2", "one")] + [(r, c) for r in ("a4", "cb") for c in ["one"] + list(CAPS)]


@pytest.mark.parametrize("rung,layout", RETIRE, ids=[f"{r}-{c}" for r, c in RETIRE])
def test_retire_rows_reads_what_extract_slot_reads(rung, layout):
    """`retire_rows` makes one gather and copy a device block holding asked
    slots and equals each slot's ``spins_flat(extract_slot)`` and
    `gather_betas` bit for bit, float32, in the order asked (slots on
    several devices, shuffled; a2 has no lane permutation); the carry is
    left as it was."""
    kw = dict(rung=rung, backend="torch", batch=8, V=4, device="cpu")
    if layout != "one":
        kw.update(mesh=make_slot_mesh(4, "cpu"), capacities=CAPS[layout])
    eng = engine.SweepEngine.create(MODEL, **kw)
    carry = eng.set_slot_betas(eng.init_carry(seed=4), range(8), np.linspace(0.3, 1.7, 8))
    carry = eng.run(carry, 3)
    before = eng.extract_pool(carry)
    blocks = []
    eng._retire_block = lambda d, blk, rows, _f=eng._retire_block: (
        blocks.append(d), _f(d, blk, rows))[1]
    slots = [6, 0, 3, 7, 1]
    spins, betas = eng.retire_rows(carry, slots)
    assert sorted(blocks) == sorted({eng._locate(b)[0] for b in slots})
    assert spins.dtype == betas.dtype == np.float32
    assert spins.shape == (len(slots), MODEL.num_spins) and betas.shape == (len(slots),)
    for i, b in enumerate(slots):
        np.testing.assert_array_equal(spins[i], eng.spins_flat(eng.extract_slot(carry, b))[0])
    np.testing.assert_array_equal(betas, eng.gather_betas(carry, slots).numpy())
    _pool_equal(eng.extract_pool(carry), before, "the carry after retire_rows")
    assert eng.retire_rows(carry, [])[0].shape == (0, MODEL.num_spins)


def test_normalize_capacities_equals_the_reference():
    grid = [(4, 8, None), (4, 6, None), (4, 8, (4, 2, 1, 1)), (4, 8, [3, 3, 2, 0]),
            (4, 8, (1, 2, 3)), (4, 8, (5, -1, 2, 2)), (3, 0, (0, 0, 0)), (2, 5, (3, 3)),
            (1, 5, None), (1, 5, (5,)), (2, 4, ("2", 2))]
    for devices, batch, caps in grid:
        try:
            want = jengine.normalize_capacities(devices, batch, caps)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                engine.normalize_capacities(devices, batch, caps)
            assert str(got.value) == str(e)
        else:
            assert engine.normalize_capacities(devices, batch, caps) == want


def test_mesh_checks_raise_the_references_messages():
    cases = [
        (types.SimpleNamespace(shape={"model": 4}), 8, None, None),
        (types.SimpleNamespace(shape={"data": 4, "model": 2}), 8, None, None),
        (types.SimpleNamespace(shape={"data": 4, "model": 1}, devices=("cpu",) * 4), 6, None, None),
        (types.SimpleNamespace(shape={"data": 4}, devices=("cpu",) * 4), 8, 3, None),
        (types.SimpleNamespace(shape={"data": 4}, devices=("cpu",) * 4), 8, 3, (4, 2, 1, 1)),
    ]
    for mesh, batch, tile, caps in cases:
        with pytest.raises(ValueError) as want:
            jengine.SweepEngine._validate_mesh(mesh, batch, tile, caps)
        with pytest.raises(ValueError) as got:
            engine._validate_mesh(mesh, batch, tile, caps)
        assert str(got.value) == str(want.value)
    mesh, caps = engine._validate_mesh(
        types.SimpleNamespace(shape={"data": 4}, devices=("cpu",) * 4), 8, 2, (4, 2, 2, 0))
    assert isinstance(mesh, SlotMesh) and caps == (4, 2, 2, 0)
    kw = dict(backend="torch", V=4, device="cpu", batch=8)
    with pytest.raises(ValueError, match=r"capacities need a mesh-sharded engine \(mesh=\.\.\.\)"):
        engine.SweepEngine.create(MODEL, capacities=(8,), **kw)
    with pytest.raises(ValueError, match='engine meshes need a "data" axis'):
        engine.SweepEngine.create(MODEL, mesh=object(), **kw)
    with pytest.raises(ValueError, match="the mesh's devices are cpu"):
        engine.SweepEngine.create(MODEL, mesh=make_slot_mesh(4, "cpu"),
                                  **{**kw, "device": "cuda"})


def test_make_slot_mesh():
    """The host gives as many logical devices as asked; the card counts
    its visible devices and refuses more with the reference's message."""
    mesh = make_slot_mesh(4, device="cpu")
    assert mesh == SlotMesh(["cpu"] * 4) and mesh.shape == {"data": 4}
    assert make_slot_mesh(device="cpu").shape == {"data": 1}
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"make_slot_mesh: {n + 1} devices requested, "
                                         f"{n} visible"):
        make_slot_mesh(n + 1)
    with pytest.raises(ValueError, match="at least one device"):
        SlotMesh(())
    with pytest.raises(ValueError, match="share one type"):
        SlotMesh(["cpu", "cuda:0"])


def test_device_ready_times_and_one_device_refusals():
    _, four, _ = _engines("cb", (3, 3, 2, 0), False)
    carry = four.init_carry(seed=1)
    t0 = __import__("time").perf_counter()
    carry = four.run(carry, 2)
    times = four.device_ready_times(carry, t0)
    assert times.shape == (4,) and np.all(times >= 0)
    # On the host the blocks run one after another: ready times ascend.
    assert times[0] <= times[1] <= times[2]
    one = engine.SweepEngine.create(MODEL, batch=2, backend="torch", V=4, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh-sharded engine"):
        one.device_ready_times(one.init_carry(), t0)
    flat = engine.SweepEngine.create(MODEL, rung="a2", batch=2, backend="torch", V=4,
                                     device="cpu")
    with pytest.raises(ValueError, match="slot_energies is defined for lane rungs"):
        flat.slot_energies(flat.init_carry())
