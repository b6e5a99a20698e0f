"""The deprecated shims, with the reference's semantics.

* `metropolis.make_sweeper` / `run_sweeps`: one replica on the plain
  backend ("torch", the reference's "jnp"), equal to the `create` path
  and to the reference's shims bit for bit, on every rung.
* `SweepEngine.build` / `build_multi` warn with the reference's text and
  are `create`, bit for bit; `park_slot` / `resume_slot` warn and are
  ``slot(b).park`` / ``slot(b).resume``, on one device and across mesh
  devices.
* `ops.make_kernel_inputs` builds the reference's inputs from the same
  seeds.
"""

import numpy as np
import pytest

from repro.core import ising as jis
from repro.core import metropolis as jmetropolis
from repro.kernels import ops as jops
from repro_torch.core import engine, ising, metropolis
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_slot_mesh

MODEL = ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)
JMODEL = jis.random_layered_model(n=5, L=8, seed=1, beta=1.0)


@pytest.mark.parametrize("impl", ["a1", "a2", "a3", "a4", "cb"])
def test_run_sweeps_equals_create_and_the_reference(impl):
    spins0 = ising.init_spins(MODEL, seed=3)
    got, state = metropolis.run_sweeps(MODEL, spins0, impl, 4, seed=42, V=4, device="cpu")
    want, jstate = jmetropolis.run_sweeps(JMODEL, spins0, impl, 4, seed=42, V=4)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(state, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eng = engine.SweepEngine.create(MODEL, rung=impl, backend="torch", V=4, device="cpu")
    carry = eng.run(eng.init_carry(seed=42, spins=spins0), 4)
    np.testing.assert_array_equal(got, eng.spins_flat(carry)[0])


@pytest.mark.parametrize("impl", ["a2", "a4", "cb"])
def test_make_sweeper_equals_the_reference(impl):
    fn, carry = metropolis.make_sweeper(MODEL, impl, num_sweeps=3, seed=7, V=4, device="cpu")
    jfn, jcarry = jmetropolis.make_sweeper(JMODEL, impl, num_sweeps=3, seed=7, V=4)
    for _ in range(2):
        carry, jcarry = fn(carry), jfn(jcarry)
    for f in engine.SweepCarry._fields:
        a = getattr(carry, f).numpy()
        b = np.asarray(getattr(jcarry, f))
        np.testing.assert_array_equal(a.view(np.uint32) if f == "rng" else a, b, err_msg=f)


def test_build_shims_warn_and_are_create():
    kw = dict(backend="torch", V=4, device="cpu")
    with pytest.warns(DeprecationWarning, match="SweepEngine.build is deprecated; use "
                                                "SweepEngine.create"):
        old = engine.SweepEngine.build(MODEL, rung="a4", batch=2, **kw)
    new = engine.SweepEngine.create(MODEL, rung="a4", batch=2, **kw)
    for a, b in zip(old.run(old.init_carry(seed=3), 5), new.run(new.init_carry(seed=3), 5)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    variants = [MODEL, ising.reseed_couplings(MODEL, 7)]
    with pytest.warns(DeprecationWarning, match="build_multi is deprecated"):
        old_m = engine.SweepEngine.build_multi(variants, rung="cb", **kw)
    new_m = engine.SweepEngine.create(variants, rung="cb", **kw)
    for a, b in zip(old_m.run(old_m.init_carry(seed=3), 5), new_m.run(new_m.init_carry(seed=3), 5)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="at least one"):
        engine.SweepEngine.build_multi([], **kw)


@pytest.mark.parametrize("mesh", [False, True], ids=["one-device", "mesh"])
def test_park_and_resume_slot_shims(mesh):
    kw = dict(backend="torch", V=4, device="cpu")
    if mesh:
        kw.update(mesh=make_slot_mesh(4, "cpu"), capacities=(4, 2, 1, 1))
    eng = engine.SweepEngine.create(MODEL, rung="a4", batch=8, **kw)
    carry = eng.run(eng.init_carry(seed=1), 3)
    with pytest.warns(DeprecationWarning, match="park_slot is deprecated"):
        parked = eng.park_slot(carry, 6)
    want = eng.slot(6).park(carry)
    for a, b in zip(parked.carry, want.carry):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.warns(DeprecationWarning, match="resume_slot is deprecated"):
        moved = eng.resume_slot(carry, 1, parked)
    for a, b in zip(eng.extract_slot(moved, 1), parked.carry):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("batch,seed", [(2, 9), (1, 0), (3, 4)])
def test_make_kernel_inputs_equal_the_references(batch, seed):
    m = ising.random_layered_model(n=6, L=256, seed=5, beta=1.1)
    jm = jis.random_layered_model(n=6, L=256, seed=5, beta=1.1)
    got = ops.make_kernel_inputs(m, batch=batch, seed=seed, device="cpu")
    want = jops.make_kernel_inputs(jm, batch=batch, seed=seed)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4].dtype.is_floating_point is False and got[5].dtype == got[0].dtype
