"""Parallel tempering, port vs JAX reference, and PT as a served job.

`repro_torch.core.tempering` against `repro.core.tempering` with the jnp
backend (the reference's a4 Pallas path does not run on the installed
JAX), on the CPU:

* `draw_swap_uniforms` and `_swap_decide` (fed the same energies, "fast")
  bit for bit;
* `lane_energy` within a stated tolerance: the port sums exact float64
  terms in a fixed tree rounded once to float32 (the same bits on every
  device), the reference sums float32 in XLA's order;
* `run_parallel_tempering` on rungs a4 and cb: spins, betas, the swap
  generator and both counters equal, energies within the tolerance.  A
  round whose swap decision differs would be reported with its ``u`` and
  ``p_acc`` (none does on the seeds below).

And `PTJob` against the port's own `run_parallel_tempering`, bit for bit: rounds
split across chunks, a job waiting for free slots, mixed anneal and PT
jobs on different models of a multi-tenant server, a preempted PT job,
and a job's snapshot round trip (also from the reference's snapshot).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jis
from repro.core import mt19937 as jmt
from repro.core import tempering as jt
from repro.core.fastexp import EXP_FNS as JEXP
from repro_torch.core import convert, engine, ising, observables, reorder
from repro_torch.core import fastexp as fx
from repro_torch.core import mt19937 as tmt
from repro_torch.core import tempering as tt
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

#: The energy tolerance against the reference: its float32 sum in XLA's
#: order against the port's float64 tree rounded once; both within a few
#: float32 ulps of |E| for these sizes.
E_RTOL, E_ATOL = 1e-5, 1e-4


def _pair(n, L, seed=1, beta=1.0):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=beta)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _u32(t):
    return np.asarray(t).view(np.uint32) if np.asarray(t).dtype == np.int32 else np.asarray(t)


def _tables(m):
    return tt.model_energy_tables(m, "cpu")


def _jtables(m):
    return jt.model_energy_tables(m)


@pytest.mark.parametrize("n,L,V,seed", [(6, 8, 4, 3), (16, 32, 4, 5), (96, 256, 128, 0)],
                         ids=["small", "medium", "paper-width"])
def test_lane_energy_within_tolerance_of_jax(n, L, V, seed):
    jm, tm = _pair(n, L, seed=seed)
    rng = np.random.default_rng(seed)
    rows = n * L // V
    spins = rng.choice(np.array([-1.0, 1.0], np.float32), size=(4, rows, V))
    base_nbr, base_J, tau_J, h = _tables(tm)
    got = tt.lane_energy(torch.from_numpy(spins), h, base_nbr, base_J, tau_J, n).numpy()
    jb, jJ, jtau, jh = _jtables(jm)
    want = np.array([float(jt.lane_energy(jnp.asarray(s), jh, jb, jJ, jtau, n)) for s in spins])
    np.testing.assert_allclose(got, want, rtol=E_RTOL, atol=E_ATOL)
    # The port's sum is the exact one rounded once (to within its float64
    # tree's rounding): equal to float64 `observables.energies` in float32.
    flat = np.stack([reorder.from_lane(s, n, L, V) for s in spins])
    np.testing.assert_array_equal(got, observables.energies(tm, flat).astype(np.float32))
    # A batch is each replica alone.
    one = [tt.lane_energy(torch.from_numpy(s), h, base_nbr, base_J, tau_J, n) for s in spins]
    np.testing.assert_array_equal(got, torch.stack(one).numpy())


@pytest.mark.parametrize("R", [7, 8, 2000])
def test_draw_swap_uniforms_bit_equal(R):
    jrng, trng = jmt.mt_init(123), tmt.mt_init(123, "cpu")
    for _ in range(2):
        jrng, ju = jt.draw_swap_uniforms(jrng, R)
        trng, tu = tt.draw_swap_uniforms(trng, R)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        np.testing.assert_array_equal(_u32(jrng), _u32(trng.numpy()))
    assert tu.shape == ((R + 1) // 2,)


@pytest.mark.parametrize("R,parity", [(8, 0), (8, 1), (7, 0), (7, 1), (115, 1)])
def test_swap_decide_bit_equal_given_energies(R, parity):
    rng = np.random.default_rng(R + parity)
    betas = np.sort(rng.uniform(0.1, 3.0, R)).astype(np.float32)
    energies = rng.normal(-50.0, 3.0, R).astype(np.float32)
    jrng, trng = jmt.mt_init(9), tmt.mt_init(9, "cpu")
    jout = jt._swap_decide(jnp.asarray(betas), jnp.asarray(energies), jrng, jnp.int32(2),
                           jnp.int32(5), jnp.int32(parity), JEXP["fast"])
    zero = torch.zeros((), dtype=torch.int32)
    tout = tt._swap_decide(torch.from_numpy(betas), torch.from_numpy(energies), trng, zero + 2,
                           zero + 5, parity, fx.exp_fn("fast"))
    np.testing.assert_array_equal(np.asarray(jout[0]), tout[0].numpy())
    np.testing.assert_array_equal(_u32(jout[1]), _u32(tout[1].numpy()))
    assert int(jout[2]) == int(tout[2]) and int(jout[3]) == int(tout[3])
    assert tout[2].dtype == tout[3].dtype == torch.int32
    assert int(tout[3]) - 5 == sum(1 for i in range(R - 1) if i % 2 == parity)


def _first_divergence(jm, tm, betas, rounds, spr, rung, seed):
    """Round by round, the first round whose swap decisions differ between
    the packages (its pairs' u and p_acc), or None."""
    V = 4
    jeng = jt.make_pt_engine(jm, len(betas), V=V, rung=rung, backend="jnp")
    jst = jt.init_pt(jm, betas, seed=seed, engine=jeng)
    teng = tt.make_pt_engine(tm, len(betas), V=V, rung=rung, backend="torch", device="cpu")
    tst = tt.init_pt(tm, betas, seed=seed, engine=teng)
    for r in range(rounds):
        jnext = jt.pt_round(jeng, jst, r % 2, spr)
        tnext = tt.pt_round(teng, tst, r % 2, spr)
        if not np.array_equal(np.asarray(jnext.betas), tnext.betas.numpy()):
            _, u = tt.draw_swap_uniforms(tst.swap_rng, len(betas))
            tb, tJ, ttau, th = tt.energy_tables(teng)
            e = tt.lane_energy(tnext.spins, th, tb, tJ, ttau, tm.n).numpy()
            b = tst.betas.numpy()
            left = np.arange(r % 2, len(b) - 1, 2)
            p_acc = fx.fastexp_fast(torch.from_numpy(
                np.clip((b[left] - b[left + 1]) * (e[left] - e[left + 1]), -20.0, 0.0)))
            return dict(round=r, pairs=left, u=u.numpy()[left // 2], p_acc=p_acc.numpy())
        jst, tst = jnext, tnext
    return None


@pytest.mark.parametrize("rung", ["a4", "cb"])
@pytest.mark.parametrize("seed", [2, 5])
def test_run_parallel_tempering_matches_jax(rung, seed):
    jm, tm = _pair(6, 8, seed=3)
    betas = np.linspace(0.2, 2.5, 8).astype(np.float32)
    rounds, spr = 6, 2
    js, je = jt.run_parallel_tempering(jm, betas, rounds, V=4, seed=seed, sweeps_per_round=spr,
                                       rung=rung, backend="jnp")
    ts, te = tt.run_parallel_tempering(tm, betas, rounds, V=4, seed=seed, sweeps_per_round=spr,
                                       rung=rung, backend="torch", device="cpu")
    if not np.array_equal(np.asarray(js.betas), ts.betas.numpy()):
        where = _first_divergence(jm, tm, betas, rounds, spr, rung, seed)
        pytest.fail(f"swap decisions differ: {where}")
    for f in ("spins", "h_space", "h_tau", "betas"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(_u32(js.rng), _u32(ts.rng.numpy()))
    np.testing.assert_array_equal(_u32(js.swap_rng), _u32(ts.swap_rng.numpy()))
    assert int(js.swap_accept) == int(ts.swap_accept)
    assert int(js.swap_propose) == int(ts.swap_propose)
    assert int(ts.swap_propose) > 0
    np.testing.assert_allclose(te, je, rtol=E_RTOL, atol=E_ATOL)


def test_pt_round_keeps_the_beta_multiset():
    _, tm = _pair(6, 8, seed=3)
    betas = np.linspace(0.2, 2.5, 8).astype(np.float32)
    st, energies = tt.run_parallel_tempering(tm, betas, 8, V=4, seed=2, backend="torch",
                                             device="cpu")
    np.testing.assert_array_equal(np.sort(st.betas.numpy()), betas)
    assert energies.shape == (8,) and energies.dtype == np.float32
    assert st.swap_accept.dtype == torch.int32 and st.swap_accept.device.type == "cpu"


# -----------------------------------------------------------------------------
# PT as a served job.
# -----------------------------------------------------------------------------


def _solo_spins(state, m, V=4):
    return np.stack([reorder.from_lane(s.numpy(), m.n, m.L, V) for s in state.spins])


@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_pt_job_equals_standalone_run(rung):
    """A PTJob packed beside an anneal job whose segments do NOT align with
    its rounds (rounds split across chunks) reproduces the port's
    `run_parallel_tempering` bit for bit."""
    _, m = _pair(4, 8, seed=2)
    betas = np.linspace(0.4, 1.4, 4).astype(np.float32)
    rounds, spr = 3, 2
    state, energies = tt.run_parallel_tempering(m, betas, rounds, V=4, seed=5,
                                                sweeps_per_round=spr, rung=rung,
                                                backend="torch", device="cpu")
    srv = SampleServer(m, slots=6, chunk_sweeps=4, rung=rung, backend="torch", V=4, device="cpu")
    srv.submit(AnnealJob.constant(seed=99, sweeps=5, beta=0.8))  # chunks 2, 2, 1, ...
    pt = PTJob(seed=5, betas=betas, num_rounds=rounds, sweeps_per_round=spr)
    srv.submit(pt)
    r = {r.jid: r for r in srv.drain()}[pt.jid]
    np.testing.assert_array_equal(r.spins, _solo_spins(state, m))
    np.testing.assert_array_equal(r.extras["betas"], state.betas.numpy())
    np.testing.assert_allclose(r.energy, energies, rtol=E_RTOL, atol=E_ATOL)
    assert r.extras["swap_propose"] == int(state.swap_propose)
    assert r.extras["swap_accept"] == int(state.swap_accept)
    assert r.sweeps_done == rounds * spr and r.chunks > rounds
    np.testing.assert_array_equal(_u32(pt.swap_rng.numpy()), _u32(state.swap_rng.numpy()))


def test_pt_job_waits_for_enough_free_slots():
    """FIFO admission: a 3-slot PT job queues until 3 slots free up."""
    _, m = _pair(4, 8, seed=3)
    srv = SampleServer(m, slots=3, chunk_sweeps=2, rung="a4", backend="torch", V=4,
                       device="cpu", policy="fifo")
    srv.submit(AnnealJob.constant(seed=1, sweeps=2, beta=1.0))
    pt = PTJob(seed=9, betas=np.array([0.5, 1.0, 1.5], np.float32), num_rounds=2)
    srv.submit(pt)
    results = srv.step()  # the anneal job runs alone; PT blocked (needs 3, 2 free)
    assert pt.jid not in srv._active and srv.num_queued == 1
    results += srv.drain()
    assert {r.jid for r in results} == {0, pt.jid}
    with pytest.raises(ValueError, match="job needs 4 slots, server has 3"):
        srv.submit(PTJob(seed=1, betas=np.ones(4, np.float32), num_rounds=1))


_BASE = _pair(5, 8, seed=1)[1]
_VARIANTS = [None, ising.reseed_couplings(_BASE, seed=31, beta=0.9),
             ising.reseed_couplings(_BASE, seed=32, beta=1.1)]


def _random_specs(rng, num_jobs):
    specs = []
    for i in range(num_jobs):
        mi = int(rng.integers(0, len(_VARIANTS)))
        if i % 4 == 2:
            specs.append(("pt", 300 + i, mi, int(rng.integers(1, 4)), 2))
        else:
            specs.append(("anneal", 300 + i, mi, int(rng.integers(2, 11)),
                          float(rng.uniform(0.5, 1.5))))
    return specs


def _make_job(spec):
    kind, seed, mi, a, b = spec
    if kind == "pt":
        return PTJob(seed=seed, betas=np.linspace(0.5, 1.3, 2).astype(np.float32),
                     num_rounds=a, sweeps_per_round=b, model=_VARIANTS[mi])
    return AnnealJob.constant(seed=seed, sweeps=a, beta=b, model=_VARIANTS[mi])


@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_mixed_jobs_on_different_models_equal_solo_runs(rung):
    """A seeded random admit/retire/chunk schedule over anneal and PT jobs
    on different models of one lattice: every job equals its solo run."""
    rng = np.random.default_rng(2024)
    specs = _random_specs(rng, 9)
    jobs = [_make_job(s) for s in specs]
    srv = SampleServer(_BASE, slots=4, chunk_sweeps=3, rung=rung, backend="torch", V=4,
                       device="cpu", multi_tenant=True)
    results, pending = [], list(jobs)
    while pending or srv.num_active or srv.num_queued:
        if pending and rng.random() < 0.6:
            srv.submit(pending.pop(0))
        if srv.num_active or srv.num_queued:
            results.extend(srv.step())
    got = {r.jid: r for r in results}
    assert sorted(got) == sorted(j.jid for j in jobs)
    assert any(s[0] == "pt" for s in specs)
    for (kind, seed, mi, a, b), job in zip(specs, jobs):
        model = _VARIANTS[mi] or _BASE
        r = got[job.jid]
        if kind == "pt":
            state, energies = tt.run_parallel_tempering(
                model, np.linspace(0.5, 1.3, 2).astype(np.float32), a, V=4, seed=seed,
                sweeps_per_round=b, rung=rung, backend="torch", device="cpu")
            np.testing.assert_array_equal(r.spins, _solo_spins(state, model))
            np.testing.assert_array_equal(r.extras["betas"], state.betas.numpy())
            assert r.extras["swap_propose"] == int(state.swap_propose)
            assert r.extras["swap_accept"] == int(state.swap_accept)
            np.testing.assert_array_equal(r.energy, observables.energies(model, r.spins))
        else:
            eng = engine.SweepEngine.create(model, rung=rung, backend="torch", V=4, device="cpu")
            carry = eng.run(eng.init_slot_carry(seed=seed, beta=b), a)
            np.testing.assert_array_equal(r.spins, eng.spins_flat(carry)[0])


@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_preempted_pt_job_resumes_bit_exactly(rung):
    """A low-priority PT job evicted by a wide urgent job mid-ladder (parked
    between chunks of a round) finishes bit-equal to the standalone run."""
    _, m = _pair(4, 8, seed=4)
    betas = np.linspace(0.5, 1.5, 2).astype(np.float32)
    state, _ = tt.run_parallel_tempering(m, betas, 3, V=4, seed=7, sweeps_per_round=3,
                                         rung=rung, backend="torch", device="cpu")
    srv = SampleServer(m, slots=3, chunk_sweeps=2, rung=rung, backend="torch", V=4,
                       device="cpu", policy="backfill")
    low = PTJob(seed=7, betas=betas, num_rounds=3, sweeps_per_round=3)
    srv.submit(low)
    srv.step()  # 2 of round 0's 3 sweeps
    hi = AnnealJob.constant(seed=1, sweeps=4, beta=1.0, priority=3)
    wide = PTJob(seed=2, betas=np.ones(3, np.float32), num_rounds=1, sweeps_per_round=2,
                 priority=3)
    srv.submit(hi)
    srv.submit(wide)
    res = {r.jid: r for r in srv.drain()}
    r = res[low.jid]
    assert r.extras["preemptions"] >= 1
    np.testing.assert_array_equal(r.spins, _solo_spins(state, m))
    np.testing.assert_array_equal(r.extras["betas"], state.betas.numpy())
    assert r.extras["swap_accept"] == int(state.swap_accept)
    assert r.extras["swap_propose"] == int(state.swap_propose)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_pt_job_snapshot_round_trip(source):
    """`PTJob.snapshot_state` -> `from_snapshot` mid-ladder (a round split
    across chunks) continues bit-exactly: the restored job, swapped into
    the server in place of the live one, finishes equal to the standalone
    run.  A job restored from the reference's `PTJob.snapshot_state` (its
    server at the same boundary) does too, and both snapshots hold the same
    meta and arrays."""
    from repro.serve_mc import PTJob as JPTJob
    from repro.serve_mc import SampleServer as JServer

    jm, m = _pair(4, 8, seed=6)
    betas = np.linspace(0.5, 1.5, 3).astype(np.float32)
    state, _ = tt.run_parallel_tempering(m, betas, 4, V=4, seed=8, sweeps_per_round=3,
                                         rung="cb", backend="torch", device="cpu")
    kw = dict(slots=4, chunk_sweeps=2, rung="cb", V=4)
    srv = SampleServer(m, backend="torch", device="cpu", **kw)
    job = PTJob(seed=8, betas=betas, num_rounds=4, sweeps_per_round=3)
    srv.submit(job)
    jsrv = JServer(jm, backend="jnp", **kw)
    jjob = JPTJob(seed=8, betas=betas, num_rounds=4, sweeps_per_round=3)
    jsrv.submit(jjob)
    for _ in range(3):  # chunks of 2 and 1 (round 0), then 2 of round 1's 3
        srv.step()
        jsrv.step()
    meta, arrays = job.snapshot_state()
    jmeta, jarrays = jjob.snapshot_state()
    assert meta.pop("waited_s") is None and jmeta.pop("waited_s") is None
    assert meta == jmeta and list(arrays) == list(jarrays) == ["betas", "swap_rng"]
    for k in arrays:
        assert arrays[k].dtype == np.asarray(jarrays[k]).dtype, k
        np.testing.assert_array_equal(arrays[k], np.asarray(jarrays[k]), err_msg=k)
    assert meta["swap_propose"] > 0 and meta["in_seg"] == 2
    meta, arrays = (meta, arrays) if source == "port" else (jmeta, jarrays)
    restored = PTJob.from_snapshot(meta, arrays)
    assert restored.swap_rng.device.type == "cpu"
    _, slots = srv._active.pop(job.jid)
    srv._active[restored.jid] = (restored, slots)
    (r,) = srv.drain()
    assert r.jid == restored.jid == job.jid
    np.testing.assert_array_equal(r.spins, _solo_spins(state, m))
    np.testing.assert_array_equal(r.extras["betas"], state.betas.numpy())
    assert r.extras["swap_accept"] == int(state.swap_accept)
    assert r.extras["swap_propose"] == int(state.swap_propose)
    np.testing.assert_array_equal(_u32(restored.swap_rng.numpy()), _u32(state.swap_rng.numpy()))
    with pytest.raises(ValueError, match="num_rounds"):
        PTJob(seed=1, betas=np.ones(2, np.float32), num_rounds=0)
