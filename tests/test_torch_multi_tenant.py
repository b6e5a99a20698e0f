"""Multi-tenant engines and serving, port vs JAX reference.

A multi-tenant engine gives every slot its own model on one shared
lattice: the coupling tables ride as ``[B, ...]`` tensors (`slot_tables`)
beside the carry.  Held here, on the rungs "cb" and "a4":

* B copies of one model == the single-model engine (port, "torch");
* heterogeneous port engine == the reference's jnp multi engine, and each
  slot == the solo run of its own model;
* the plain `colored_multisweep_multi_ref` == the reference's multi
  Pallas kernel in interpret mode; `metropolis_multisweep_multi_ref` ==
  the reference's jnp multi engine (the reference's a4 Pallas kernel does
  not run on the installed JAX); both kernel wrappers take their plain
  version on CPU tensors and count no launch;
* slot tables == the reference's through `convert`; splice/extract round
  trips; a raw splice forgets the slot's model; the validation errors;
* served multi-tenant jobs == the reference's `SampleServer(multi_tenant=
  True)` under fifo/backfill/fair, and a model-less job after a tenant
  sweeps the server's model.

Every comparison is bit-exact (`assert_array_equal`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import ising as jis
from repro.core import reorder as jro
from repro.kernels import ops as jops
from repro.serve_mc import AnnealJob as JAnneal
from repro.serve_mc import SampleServer as JServer
from repro_torch.core import convert, engine, ising, metropolis, observables, reorder
from repro_torch.kernels import ops, ref
from repro_torch.serve_mc import AnnealJob, SampleServer

RUNGS = ["cb", "a4"]


def _pair(n, L, seed=1, beta=1.0):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=beta)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _tenants(jm, tm, seeds, betas=None):
    """The same reseeded tenants in both packages."""
    betas = betas or [None] * len(seeds)
    js = [jis.reseed_couplings(jm, seed=s, beta=b) for s, b in zip(seeds, betas)]
    ts = [ising.reseed_couplings(tm, seed=s, beta=b) for s, b in zip(seeds, betas)]
    return js, ts


def _np(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _carry_equal(jc, tc, msg=""):
    host = convert.carry_to_numpy(tc)
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), host[f], err_msg=f"{msg} {f}")


def _torch_equal(a, b, msg=""):
    for f in a._fields:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f"{msg} {f}")


# -----------------------------------------------------------------------------
# Engines.
# -----------------------------------------------------------------------------


def test_reseed_couplings_matches_reference():
    jm, tm = _pair(7, 8, seed=3)
    for seed, beta in ((5, None), (9, 0.6)):
        a = jis.reseed_couplings(jm, seed=seed, beta=beta)
        b = ising.reseed_couplings(tm, seed=seed, beta=beta)
        for f in ("h", "space_nbr", "space_J", "tau_J"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.beta == b.beta and b.space_nbr is tm.space_nbr


@pytest.mark.parametrize("rung", RUNGS)
def test_multi_equals_single(rung):
    _, tm = _pair(5, 8)
    single = engine.SweepEngine.create(tm, rung=rung, backend="torch", batch=3, V=4, device="cpu")
    multi = engine.SweepEngine.create([tm] * 3, rung=rung, backend="torch", V=4, device="cpu")
    assert multi.multi and multi.batch == 3 and not single.multi
    cs, cm = single.init_carry(seed=3), multi.init_carry(seed=3)
    _torch_equal(cs, cm, "init")
    for k in (4, 3):  # the second run continues the same stream
        cs, cm = single.run(cs, k), multi.run(cm, k)
        _torch_equal(cs, cm, f"{rung} after run({k})")


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("n,L,V", [(5, 8, 4), (160, 16, 4), (4, 256, 128)],
                         ids=["V4", "V4-two-blocks", "V128"])
def test_hetero_engine_matches_jax(n, L, V, rung):
    jm, tm = _pair(n, L, seed=2)
    jt, tt = _tenants(jm, tm, [7, 9], betas=[0.8, 1.3])
    je = jeng.SweepEngine.create([jm, jt[0], jt[1]], rung=rung, backend="jnp", V=V)
    te = engine.SweepEngine.create([tm, tt[0], tt[1]], rung=rung, backend="torch", V=V,
                                   device="cpu")
    jc, tc = je.init_carry(seed=4), te.init_carry(seed=4)
    _carry_equal(jc, tc, "init")  # each slot's own fields and beta
    for k in (3, 2):
        jc, tc = je.run(jc, k), te.run(tc, k)
        _carry_equal(jc, tc, f"{rung} after run({k})")


def test_cb_plain_multi_matches_pallas_interpret():
    jm, tm = _pair(4, 256, seed=4)
    jt, tt = _tenants(jm, tm, [9, 11, 3])
    je = jeng.SweepEngine.create([jm, *jt], rung="cb", backend="jnp", V=128)
    jc = je.init_carry(seed=5)
    jc = jc._replace(betas=jc.betas * np.float32(1.25))
    classes_j = jro.colored_classes(jm, 128)
    fn = jops.make_colored_multisweep_multi(classes_j, jm.space_nbr, n=4, interpret=True)
    jtabs = je.slot_tables
    want = fn(jc.spins, jc.rng, jc.betas, jtabs["h"], jtabs["base_J"], jtabs["tau_J"], 3)
    tc = convert.carry_from_numpy({f: np.asarray(getattr(jc, f)) for f in jc._fields}, "cpu")
    tabs = convert.slot_tables_from_numpy({k: np.asarray(v) for k, v in jtabs.items()}, "cpu")
    classes = metropolis.classes_to(reorder.colored_classes(tm, 128), "cpu")
    nbr = torch.from_numpy(tm.space_nbr.astype(np.int64))
    got = ref.colored_multisweep_multi_ref(
        tc.spins, tc.rng, tc.betas, classes, tabs["h"], nbr, tabs["base_J"], tabs["tau_J"],
        n=4, num_sweeps=3,
    )
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    # The kernel's wrapper takes the plain version on CPU tensors.
    ops.reset_launches()
    wrapper = ops.make_colored_multisweep_multi(reorder.colored_classes(tt[0], 128),
                                                tm.space_nbr, n=4)
    for a, b in zip(got, wrapper(tc.spins, tc.rng, tc.betas, tabs["h"], tabs["base_J"],
                                 tabs["tau_J"], 3)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert ops.launches["colored_multisweep_multi"] == 0


@pytest.mark.parametrize("n,L,V,S", [(5, 8, 4, 3), (160, 16, 4, 2), (4, 256, 128, 3)],
                         ids=["V4", "V4-two-blocks", "V128"])
def test_a4_plain_multi_matches_jnp_multi_engine(n, L, V, S):
    jm, tm = _pair(n, L, seed=6)
    jt, _ = _tenants(jm, tm, [2, 5])
    je = jeng.SweepEngine.create([jt[0], jm, jt[1]], rung="a4", backend="jnp", V=V)
    jc = je.init_carry(seed=8)
    want = je.run(jc, S)
    tc = convert.carry_from_numpy({f: np.asarray(getattr(jc, f)) for f in jc._fields}, "cpu")
    tabs = convert.slot_tables_from_numpy(
        {k: np.asarray(v) for k, v in je.slot_tables.items()}, "cpu")
    nbr = torch.from_numpy(tm.space_nbr.astype(np.int32))
    args = (tc.spins, tc.h_space, tc.h_tau, tc.rng, nbr, tabs["base_J2"], tabs["tau_J2"],
            tc.betas, n, S)
    got = ref.metropolis_multisweep_multi_ref(*args)
    ops.reset_launches()
    wrapped = ops.metropolis_multisweep_multi(*args)
    assert ops.launches["metropolis_multisweep_multi"] == 0
    for f, a, b, c in zip(("spins", "h_space", "h_tau", "rng"), (want.spins, want.h_space,
                          want.h_tau, want.rng), got, wrapped):
        np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=f)
        np.testing.assert_array_equal(_np(b), _np(c), err_msg=f)


@pytest.mark.parametrize("rung", RUNGS)
def test_multi_refs_equal_single_refs_on_copies(rung):
    """With B copies of one model's tables the multi plain versions are the
    single-model plain versions, bit for bit (V=128, as the kernels run)."""
    _, tm = _pair(4, 256, seed=12)
    B = 3
    eng = engine.SweepEngine.create([tm] * B, rung=rung, backend="torch", V=128, device="cpu")
    c = eng.init_carry(seed=2)
    c = c._replace(betas=torch.tensor([0.5, 1.0, 1.7]))
    tabs = eng.slot_tables
    if rung == "cb":
        classes = metropolis.classes_to(eng.classes, "cpu")
        nbr = torch.from_numpy(tm.space_nbr.astype(np.int64))
        got = ref.colored_multisweep_multi_ref(c.spins, c.rng, c.betas, classes, tabs["h"], nbr,
                                               tabs["base_J"], tabs["tau_J"], 4, 3)
        want = ref.colored_multisweep_ref(c.spins, c.rng, c.betas, classes, tabs["h"][0], nbr,
                                          tabs["base_J"][0], tabs["tau_J"][0], 4, 3)
    else:
        nbr = torch.from_numpy(tm.space_nbr.astype(np.int32))
        args = (c.spins, c.h_space, c.h_tau, c.rng, nbr)
        got = ref.metropolis_multisweep_multi_ref(*args, tabs["base_J2"], tabs["tau_J2"],
                                                  c.betas, 4, 3)
        want = ref.metropolis_multisweep_ref(*args, tabs["base_J2"][0], tabs["tau_J2"][0],
                                             c.betas, 4, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rung", RUNGS)
def test_hetero_slot_equals_solo_run(rung):
    _, tm = _pair(5, 8)
    variant = ising.reseed_couplings(tm, seed=7, beta=0.8)
    multi = engine.SweepEngine.create([tm, tm], rung=rung, backend="torch", V=4, device="cpu")
    carry = multi.init_carry(seed=3)
    slot = multi.init_slot_carry(seed=11, model=variant)
    carry = multi.slot(1).splice(carry, slot, model=variant)  # tables, then carry
    assert multi.model_of(1) is variant and multi.model_of(0) is tm
    got = multi.extract_slot(multi.run(carry, 4), 1)
    solo = engine.SweepEngine.create(variant, rung=rung, backend="torch", V=4, device="cpu")
    want = solo.run(solo.init_slot_carry(seed=11), 4)
    _torch_equal(got, want, f"{rung} hetero slot vs solo")


@pytest.mark.parametrize("rung", RUNGS)
def test_park_resume_carries_tables(rung):
    """A parked multi-tenant slot takes its tables along; resumed into
    another slot it continues bit for bit, and records the given model."""
    _, tm = _pair(5, 8)
    variant = ising.reseed_couplings(tm, seed=4)
    multi = engine.SweepEngine.create([tm, variant, tm], rung=rung, backend="torch", V=4,
                                      device="cpu")
    c = multi.run(multi.init_carry(seed=1), 2)
    parked = multi.slot(1).park(c)
    assert parked.tables is not None
    straight = multi.extract_slot(multi.run(c, 3), 1)
    multi.set_slot_model(1, tm)
    c = multi.slot(2).resume(c, parked, model=variant)
    assert multi.model_of(2) is variant
    _torch_equal(multi.extract_slot(multi.run(c, 3), 2), straight, "resumed")


def test_slot_tables_match_jax_and_round_trip():
    jm, tm = _pair(5, 8)
    jt, tt = _tenants(jm, tm, [7])
    je = jeng.SweepEngine.create([jm, jm, jm], rung="a4", backend="jnp", V=4)
    te = engine.SweepEngine.create([tm, tm, tm], rung="a4", backend="torch", V=4, device="cpu")
    je.set_slot_model(1, jt[0])
    te.set_slot_model(1, tt[0])
    want = {k: np.asarray(v) for k, v in je.slot_tables.items()}
    got = convert.slot_tables_to_numpy(te)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    back = convert.slot_tables_from_numpy(got, "cpu")
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)
    # extract is the exact inverse of splice; neighbours keep the base model.
    ex = te.extract_slot_tables(1)
    before = {k: v.clone() for k, v in te.slot_tables.items()}
    te.splice_slot_tables(1, ex)
    for k, v in te.slot_tables.items():
        assert torch.equal(v, before[k]) and v is not before[k]
    base = te.slot_tables_for(tm)
    assert te.slot_tables_for(tm) is base  # cached per model object
    for b in (0, 2):
        for k, v in te.extract_slot_tables(b).items():
            assert torch.equal(v, base[k])
    with pytest.raises(ValueError, match="multi-tenant"):
        convert.slot_tables_to_numpy(engine.SweepEngine.create(tm, backend="torch", V=4,
                                                               device="cpu"))


def test_splice_builds_new_tables():
    """Slot tables are values: a splice never writes into tensors an
    earlier launch may still read."""
    _, tm = _pair(5, 8)
    multi = engine.SweepEngine.create([tm, tm], rung="cb", backend="torch", V=4, device="cpu")
    old = multi.slot_tables
    snapshot = {k: v.clone() for k, v in old.items()}
    multi.set_slot_model(0, ising.reseed_couplings(tm, seed=3))
    assert multi.slot_tables is not old
    for k in old:
        assert torch.equal(old[k], snapshot[k])


def test_raw_table_splice_forgets_slot_model():
    _, tm = _pair(5, 8)
    variant = ising.reseed_couplings(tm, seed=7)
    multi = engine.SweepEngine.create([tm, tm], rung="a4", backend="torch", V=4, device="cpu")
    multi.splice_slot_tables(1, multi.slot_tables_for(variant))
    assert multi.model_of(1) is None
    multi.set_slot_model(1, tm)  # must re-splice, not no-op
    assert multi.model_of(1) is tm
    for k, v in multi.extract_slot_tables(1).items():
        assert torch.equal(v, multi.slot_tables_for(tm)[k])


@pytest.mark.parametrize("rung", RUNGS)
def test_set_slot_model_changes_physics(rung):
    _, tm = _pair(5, 8)
    multi = engine.SweepEngine.create([tm, tm], rung=rung, backend="torch", V=4, device="cpu")
    c0 = multi.init_carry(seed=3)
    plain = multi.run(c0, 4)
    multi.set_slot_model(1, ising.reseed_couplings(tm, seed=7))
    mixed = multi.run(c0, 4)
    assert torch.equal(plain.spins[0], mixed.spins[0])  # slot 0 untouched
    assert not torch.equal(plain.spins[1], mixed.spins[1])


def test_multi_validation():
    _, tm = _pair(5, 8)
    other_topology = ising.random_layered_model(n=5, L=8, seed=99)
    wrong_shape = ising.random_layered_model(n=4, L=8, seed=1)
    kw = dict(backend="torch", V=4, device="cpu")
    with pytest.raises(ValueError, match="space_nbr"):
        engine.SweepEngine.create([tm, other_topology], rung="a4", **kw)
    with pytest.raises(ValueError, match="lane shape"):
        engine.SweepEngine.create([tm, wrong_shape], rung="a4", **kw)
    with pytest.raises(ValueError, match="multi-tenant engines implement rungs"):
        engine.SweepEngine.create([tm], rung="a2", **kw)
    with pytest.raises(ValueError, match="at least one"):
        engine.SweepEngine.create([], rung="a4", **kw)
    with pytest.raises(ValueError, match="len\\(models\\)"):
        engine.SweepEngine.create([tm, tm], rung="cb", batch=3, **kw)
    multi = engine.SweepEngine.create([tm] * 2, rung="a4", **kw)
    with pytest.raises(ValueError, match="space_nbr"):
        multi.set_slot_model(0, other_topology)
    with pytest.raises(ValueError, match="space_nbr"):
        multi.init_slot_carry(seed=0, model=other_topology)
    with pytest.raises(ValueError, match="out of range"):
        multi.splice_slot_tables(5, multi.slot_tables_for(tm))
    single = engine.SweepEngine.create(tm, rung="a4", **kw)
    for call in (lambda: single.splice_slot_tables(0, {}), lambda: single.extract_slot_tables(0),
                 lambda: single.set_slot_model(0, tm),
                 lambda: single.init_slot_carry(seed=0, model=tm),
                 lambda: single.slot(0).splice(single.init_carry(), single.init_slot_carry(),
                                               model=tm)):
        with pytest.raises(ValueError, match="multi-tenant"):
            call()


def test_multi_wrappers_refuse_other_devices():
    _, tm = _pair(4, 256)
    fn = ops.make_colored_multisweep_multi(reorder.colored_classes(tm, 128), tm.space_nbr, n=4)
    meta = torch.empty((1, 8, 128), device="meta")
    tabs = [torch.empty(s, device="meta") for s in ((1, 4), (1, 4, 3), (1, 4))]
    with pytest.raises(ValueError, match="cuda"):
        fn(meta, meta, meta, *tabs, 1)
    with pytest.raises(ValueError, match="num_sweeps"):
        fn(meta, meta, meta, *tabs, -1)
    with pytest.raises(ValueError, match="cuda"):
        ops.metropolis_multisweep_multi(meta, meta, meta, meta, meta, meta, meta, meta, n=4,
                                        num_sweeps=1)
    with pytest.raises(ValueError, match="cuda"):
        ops.metropolis_multisweep_multi(meta, meta, meta, meta, meta, meta, meta, meta, n=4,
                                        num_sweeps=1, exp_flavor="accurate")


# -----------------------------------------------------------------------------
# Serving.
# -----------------------------------------------------------------------------

N, L, V, SLOTS, CHUNK = 5, 16, 4, 3, 4


def _jobs(Anneal, tenants):
    """Constants and ramps over three users and two priority classes; job i
    takes tenants[i % len], except every fourth job, which is model-less."""
    rng = np.random.default_rng(1)
    jobs = []
    for i in range(10):
        budget = int(rng.integers(4, 18))
        kw = dict(user=f"u{i % 3}", priority=int(i % 4 == 2),
                  model=None if i % 4 == 3 else tenants[i % len(tenants)])
        if i % 3 == 2:
            jobs.append(Anneal.ramp(seed=20 + i, beta_start=0.3, beta_end=1.4, steps=3,
                                    sweeps_per_step=max(1, budget // 3), **kw))
        else:
            jobs.append(Anneal.constant(seed=20 + i, sweeps=budget, **kw))
    return jobs


def _serve(server, Anneal, tenants):
    """Submit the mix, step twice, submit an urgent tenant job, drain."""
    for job in _jobs(Anneal, tenants):
        server.submit(job)
    results = server.step() + server.step()
    server.submit(Anneal.constant(seed=99, sweeps=6, beta=1.2, priority=2, user="urgent",
                                  model=tenants[-1]))
    return {r.jid: r for r in results + server.drain()}


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("policy", ["fifo", "backfill", "fair"])
def test_served_multi_tenant_matches_reference(policy, rung):
    jm, tm = _pair(N, L, seed=4, beta=1.1)
    jt, tt = _tenants(jm, tm, [100, 101, 102], betas=[0.9, None, 1.4])
    js = JServer(jm, slots=SLOTS, chunk_sweeps=CHUNK, rung=rung, backend="jnp", V=V,
                 policy=policy, multi_tenant=True)
    ts = SampleServer(tm, slots=SLOTS, chunk_sweeps=CHUNK, rung=rung, backend="torch", V=V,
                      device="cpu", policy=policy, multi_tenant=True)
    want, got = _serve(js, JAnneal, jt), _serve(ts, AnnealJob, tt)
    assert sorted(want) == sorted(got) == list(range(11))
    for jid, a in want.items():
        b = got[jid]
        np.testing.assert_array_equal(a.spins, b.spins, err_msg=f"job {jid}")
        assert a.energy == b.energy, jid
        assert a.magnetization == b.magnetization, jid
        assert (a.sweeps_done, a.chunks) == (b.sweeps_done, b.chunks), jid
        assert a.extras["final_beta"] == b.extras["final_beta"], jid
    assert list(js._retired) == list(ts._retired)
    if policy != "fifo":
        assert ts.stats()["preemptions"] > 0  # the urgent job evicted someone
    _carry_equal(js.carry, ts.carry, "final pool")
    for k, v in js.engine.slot_tables.items():
        np.testing.assert_array_equal(np.asarray(v), ts.engine.slot_tables[k].numpy(), err_msg=k)


@pytest.mark.parametrize("rung", RUNGS)
def test_served_tenant_equals_solo_and_never_leaks(rung):
    """One slot: a tenant's job, then a model-less job.  Each equals the
    solo run of its own model, so the tenant's tables did not survive its
    retirement; the energies are those of each job's own model."""
    _, tm = _pair(N, L, seed=4, beta=1.1)
    tenant = ising.reseed_couplings(tm, seed=5, beta=0.7)
    server = SampleServer(tm, slots=1, chunk_sweeps=3, rung=rung, backend="torch", V=V,
                          device="cpu", multi_tenant=True)
    server.submit(AnnealJob.constant(seed=1, sweeps=7, model=tenant))
    server.submit(AnnealJob.constant(seed=2, sweeps=5))
    res = {r.jid: r for r in server.drain()}
    assert server.engine.model_of(0) is tm
    for jid, (m, seed, sweeps) in enumerate(((tenant, 1, 7), (tm, 2, 5))):
        solo = engine.SweepEngine.create(m, rung=rung, backend="torch", V=V, device="cpu")
        spins = solo.spins_flat(solo.run(solo.init_slot_carry(seed=seed), sweeps))[0]
        np.testing.assert_array_equal(res[jid].spins, spins, err_msg=f"job {jid}")
        assert res[jid].energy == observables.energies(m, spins)
        assert res[jid].extras["final_beta"] == np.float32(m.beta)


def test_multi_tenant_server_with_one_model_equals_single_model_server():
    _, tm = _pair(N, L, seed=4, beta=1.1)
    out = []
    for multi in (False, True):
        server = SampleServer(tm, slots=SLOTS, chunk_sweeps=CHUNK, rung="cb", backend="torch",
                              V=V, device="cpu", multi_tenant=multi)
        out.append(_serve(server, AnnealJob, [None]))
        assert server.multi_tenant is multi and server.engine.multi is multi
    for jid, r in out[0].items():
        np.testing.assert_array_equal(r.spins, out[1][jid].spins)
        assert r.energy == out[1][jid].energy


def test_server_model_checks():
    _, tm = _pair(N, L, seed=4)
    tenant = ising.reseed_couplings(tm, seed=5)
    single = SampleServer(tm, slots=2, backend="torch", V=V, device="cpu")
    with pytest.raises(ValueError, match="multi_tenant"):
        single.submit(AnnealJob.constant(seed=1, sweeps=4, model=tenant))
    multi = SampleServer(tm, slots=2, backend="torch", V=V, device="cpu", multi_tenant=True)
    other = ising.random_layered_model(n=N, L=L, seed=77)
    with pytest.raises(ValueError, match="space_nbr"):
        multi.submit(AnnealJob.constant(seed=1, sweeps=4, model=other))
    with pytest.raises(ValueError, match="lane shape"):
        multi.submit(AnnealJob.constant(seed=1, sweeps=4,
                                        model=ising.random_layered_model(n=4, L=L, seed=1)))
    assert multi.num_queued == 0
