"""The paper's optimization ladder, rungs a1-a3, port vs JAX reference.

* within the port: a1 == a2 under "fast" (the data-structure change of
  Figure 4 -> Figure 5/6 changes no bit), a3 == a4 (per-lane updates ==
  whole-row updates), and a4 == a2 over the relabeled model (the
  sequential oracle of the vectorized sweep);
* the port's a1/a2/a3 engines (backend "torch", CPU) at B=3 against the
  reference's jnp engines: spins, fields, betas and generator state,
  bit for bit, under "fast" (and a3 under "accurate");
* a1 under its default "exact" exp: a statistical check (see the test);
* flat-rung slot splice/extract/park/resume and a flat carry through
  `convert`;
* served a1-a3 jobs against the reference's `SampleServer(rung=...)`
  under fifo and fair;
* the CLI with ``--rung a2 --backend torch``, and the refusals: the
  "cuda" backend refuses a1-a3, in the engine, the server and the CLI.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import engine as jeng
from repro.core import ising as jis
from repro.core import metropolis as jmp
from repro.core import reorder as jro
from repro.serve_mc import AnnealJob as JAnneal
from repro.serve_mc import SampleServer as JServer
from repro_torch.core import convert, engine, fastexp, ising, metropolis, observables, reorder
from repro_torch.core import mt19937 as tmt
from repro_torch.launch import anneal_serve
from repro_torch.serve_mc import AnnealJob, SampleServer

FLAT = ("a1", "a2", "a3")


def _pair(n, L, seed=1, beta=1.1):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=beta)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _carry_equal(jc, tc, msg=""):
    host = convert.carry_to_numpy(tc)
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), host[f], err_msg=f"{msg} {f}")


def _torch_engine(tm, rung, **kw):
    kw = dict(dict(backend="torch", batch=3, V=4, device="cpu"), **kw)
    return engine.SweepEngine.create(tm, rung=rung, **kw)


# -----------------------------------------------------------------------------
# Rung equivalences inside the port.
# -----------------------------------------------------------------------------


def test_a1_equals_a2_bit_exact():
    """Same exp flavour, same generator -> the same spins, fields, state."""
    _, tm = _pair(6, 8, seed=3, beta=0.7)
    e1, e2 = (_torch_engine(tm, r, exp_flavor="fast") for r in ("a1", "a2"))
    c1, c2 = e1.run(e1.init_carry(seed=99), 3), e2.run(e2.init_carry(seed=99), 3)
    for a, b in zip(c1, c2):
        assert torch.equal(a, b)
    assert not np.array_equal(e2.spins_flat(c2), e2.spins_flat(e2.init_carry(seed=99)))


@pytest.mark.parametrize("n,L,V", [(6, 8, 4), (5, 12, 4), (4, 256, 128)],
                         ids=["V4-lpv2", "V4-lpv3", "V128"])
def test_a3_equals_a4(n, L, V):
    _, tm = _pair(n, L, seed=2, beta=0.9)
    e3, e4 = (_torch_engine(tm, r, V=V, batch=2) for r in ("a3", "a4"))
    c3, c4 = e3.run(e3.init_carry(seed=5), 2), e4.run(e4.init_carry(seed=5), 2)
    for a, b in zip(c3, c4):
        assert torch.equal(a, b)


@pytest.mark.parametrize("V", [2, 4])
def test_vectorized_equals_sequential_oracle(V):
    """One a4 lane sweep == one a2 sweep over the model relabeled to lane
    order (`reorder.relabeled_flat_arrays`), on the same uniforms."""
    _, m = _pair(6, 8, seed=3, beta=0.7)
    rows = reorder.check_lane_shape(m.n, m.L, V)
    spins0 = ising.init_spins(m, 7)
    rng = tmt.mt_init(np.arange(V, dtype=np.uint32) * 2654435761 + 1234, "cpu")
    _, u = tmt.mt_uniforms_count(rng, rows)
    lane = metropolis.make_lane_state(m, spins0, V, "cpu")
    lane = metropolis.sweep_lane(
        metropolis.LaneState(*(x[None] for x in lane)),
        torch.from_numpy(m.space_nbr), torch.from_numpy(2.0 * m.space_J),
        torch.from_numpy(2.0 * m.tau_J), u[None], torch.tensor([m.beta], dtype=torch.float32),
        m.n, fastexp.fastexp_fast,
    )
    tgt, J2 = reorder.relabeled_flat_arrays(m, V)
    perm = reorder.flat_to_lane_perm(m.n, m.L, V)
    hs0, ht0 = ising.h_eff_from_scratch(m, spins0)
    flat = metropolis.FlatState(*(torch.from_numpy(x[perm].copy())[None]
                                  for x in (spins0, hs0, ht0)))
    flat = metropolis.sweep_flat(
        flat, torch.from_numpy(tgt.astype(np.int64)), torch.from_numpy(J2), u.reshape(1, -1),
        torch.tensor([m.beta], dtype=torch.float32), m.space_degree, fastexp.fastexp_fast,
    )
    for a, b in zip(lane, flat):
        np.testing.assert_array_equal(a.reshape(-1).numpy(), b.reshape(-1).numpy())


def test_flat_layouts_match_reference():
    jm, tm = _pair(6, 8, seed=3)
    for a, b in zip(jis.flat_arrays(jm), ising.flat_arrays(tm)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jis.original_arrays(jm), ising.original_arrays(tm)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jro.relabeled_flat_arrays(jm, 4), reorder.relabeled_flat_arrays(tm, 4)):
        np.testing.assert_array_equal(a, b)


def test_flat_sweeps_match_reference_functions():
    """One batched a1 and a2 sweep against the reference's per-replica
    functions on arbitrary fields and the same uniforms."""
    jm, tm = _pair(5, 8, seed=4)
    B, N = 2, 40
    rng = np.random.default_rng(0)
    spins = np.where(rng.random((B, N)) < 0.5, -1.0, 1.0).astype(np.float32)
    hs = rng.normal(0.0, 1.5, (B, N)).astype(np.float32)
    ht = rng.normal(0.0, 0.5, (B, N)).astype(np.float32)
    u = rng.random((B, N), dtype=np.float32)
    betas = np.array([0.5, 1.7], np.float32)
    state = metropolis.FlatState(*(torch.from_numpy(x) for x in (spins, hs, ht)))
    tb = torch.from_numpy(betas)
    steps = metropolis.original_steps(*ising.original_arrays(tm))
    tgt, J2 = ising.flat_arrays(tm)
    got = {
        "a1": metropolis.sweep_original(state, steps, torch.from_numpy(u), tb,
                                        fastexp.fastexp_fast),
        "a2": metropolis.sweep_flat(state, torch.from_numpy(tgt.astype(np.int64)),
                                    torch.from_numpy(J2), torch.from_numpy(u), tb,
                                    tm.space_degree, fastexp.fastexp_fast),
    }
    for x, orig in zip(state, (spins, hs, ht)):  # states are values
        np.testing.assert_array_equal(x.numpy(), orig)
    ge, J, istau, inc = (jnp.asarray(a) for a in jis.original_arrays(jm))
    for b in range(B):
        st = jmp.FlatState(*(jnp.asarray(x[b]) for x in (spins, hs, ht)))
        want = {
            "a1": jmp.sweep_original(st, ge, J, istau, inc, jnp.asarray(u[b]),
                                     jnp.float32(betas[b]), "fast"),
            "a2": jmp.sweep_flat(st, *(jnp.asarray(a) for a in jis.flat_arrays(jm)),
                                 jnp.asarray(u[b]), jnp.float32(betas[b]),
                                 jm.space_degree, "fast"),
        }
        for rung in ("a1", "a2"):
            for a, c in zip(want[rung], got[rung]):
                np.testing.assert_array_equal(np.asarray(a), c[b].numpy(), err_msg=rung)


# -----------------------------------------------------------------------------
# Engines against the reference's jnp engines.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize(
    "rung,flavor", [("a1", "fast"), ("a2", "fast"), ("a3", "fast"), ("a2", "accurate"),
                    ("a3", "accurate")],
)
def test_engine_matches_jax_engine(rung, flavor):
    """"accurate" agrees here too: no accept test of these runs falls
    between the two packages' roots, which differ by at most 2 ulp."""
    jm, tm = _pair(5, 16, seed=2)
    je = jeng.SweepEngine.create(jm, rung=rung, backend="jnp", batch=3, V=4, exp_flavor=flavor)
    te = _torch_engine(tm, rung, exp_flavor=flavor)
    jc, tc = je.init_carry(seed=4), te.init_carry(seed=4)
    _carry_equal(jc, tc, "init")
    assert tuple(tc.rng.shape) == (624, 3 if rung != "a3" else 12)
    for k in (3, 1, 2):  # consecutive runs of different lengths
        jc, tc = je.run(jc, k), te.run(tc, k)
        _carry_equal(jc, tc, f"after run({k})")
    np.testing.assert_array_equal(je.spins_flat(jc), te.spins_flat(tc))
    for a, b in zip(je.state_of(jc, 2), te.state_of(tc, 2)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert type(te.state_of(tc, 2)).__name__ == ("LaneState" if rung == "a3" else "FlatState")


def test_a1_exact_is_statistically_the_reference():
    """a1's default "exact" exp is within 1 ulp of the reference's, not
    equal to it: where a uniform falls between the two values an accept
    differs and the chains part.  So the port's a1 is held to the
    reference's statistically: 64 replicas of a small model, 40 sweeps at
    beta 0.8 from the same starts and seeds, and the mean final energy per
    replica must agree within 4 standard errors; and a1 "exact" samples
    the two-spin Boltzmann distribution (the reference's own check)."""
    jm, tm = _pair(6, 8, seed=5, beta=0.8)
    B = 64
    je = jeng.SweepEngine.create(jm, rung="a1", backend="jnp", batch=B, V=4)
    te = _torch_engine(tm, "a1", batch=B)
    assert te.exp_flavor == "exact"
    ej = np.array([jis.energy(jm, s) for s in je.spins_flat(je.run(je.init_carry(seed=1), 40))])
    et = np.array([observables.energies(tm, s) for s in te.spins_flat(te.run(te.init_carry(seed=1), 40))])
    se = np.sqrt(ej.var(ddof=1) / B + et.var(ddof=1) / B)
    assert abs(ej.mean() - et.mean()) <= 4 * se + 1e-9, (ej.mean(), et.mean(), se)
    # Two coupled spins (n=1, L=2: both tau edges join the same pair).
    m2 = ising.LayeredModel(
        n=1, L=2, h=np.array([0.3], np.float32), space_nbr=np.zeros((1, 1), np.int32),
        space_J=np.zeros((1, 1), np.float32), tau_J=np.array([0.5], np.float32), beta=1.0,
    )
    R = 1200
    eng = _torch_engine(m2, "a1", batch=R)
    spins = eng.spins_flat(eng.run(eng.init_carry(seed=3), 20))
    keys, counts = np.unique(spins, axis=0, return_counts=True)
    e = np.array([ising.energy(m2, k) for k in keys])
    expected = np.exp(-m2.beta * e)
    expected /= np.exp(-m2.beta * np.array(
        [ising.energy(m2, np.array(s, np.float32)) for s in ((-1, -1), (-1, 1), (1, -1), (1, 1))]
    )).sum()
    assert np.abs(counts / R - expected).max() < 0.05, (keys, counts / R, expected)


# -----------------------------------------------------------------------------
# Slots and carries on the flat rungs.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("rung", ["a1", "a2"])
def test_flat_slot_round_trips_match_jax(rung):
    jm, tm = _pair(5, 16, seed=6)
    kw = dict(exp_flavor="fast")
    je = jeng.SweepEngine.create(jm, rung=rung, backend="jnp", batch=3, V=4, **kw)
    te = _torch_engine(tm, rung, **kw)
    jc, tc = je.run(je.init_carry(seed=2), 2), te.run(te.init_carry(seed=2), 2)
    js, ts = je.init_slot_carry(seed=9, beta=0.8), te.init_slot_carry(seed=9, beta=0.8)
    _carry_equal(js, ts, "slot carry")
    assert tuple(ts.rng.shape) == (624, 1)
    rngs = te.seed_slot_rngs([engine.lane_seeds(1, 1, s) for s in (9, 2)])
    _carry_equal(js, te.init_slot_carry(seed=9, beta=0.8, rng_state=rngs[0]), "batch-seeded")
    jc, tc = je.splice_slot(jc, 1, js), te.slot(1).splice(tc, ts)
    jc, tc = je.set_slot_betas(jc, [2], [1.7]), te.set_slot_betas(tc, [2], [1.7])
    _carry_equal(jc, tc, "spliced")
    jp, tp = je.slot(0).park(jc), te.slot(0).park(tc)
    _carry_equal(jp.carry, tp.carry, "parked")
    jc, tc = je.run(jc, 3), te.run(tc, 3)
    jc, tc = je.slot(2).resume(jc, jp), te.slot(2).resume(tc, tp)
    jc, tc = je.run(jc, 2), te.run(tc, 2)
    _carry_equal(jc, tc, "resumed")
    before = convert.carry_to_numpy(tc)
    back = te.splice_slot(tc, 1, te.extract_slot(tc, 1))
    for f, v in convert.carry_to_numpy(back).items():
        np.testing.assert_array_equal(v, before[f])
    with pytest.raises(ValueError, match="rng_seeds"):
        te.init_slot_carry(seed=1, rng_seeds=np.zeros(4, np.uint32))


def test_flat_carry_conversion_round_trips():
    """A reference flat carry ((B, N) state, (624, B) generators) crosses
    into the port through `convert` and back, and continues bit-exactly."""
    jm, tm = _pair(5, 16)
    je = jeng.SweepEngine.create(jm, rung="a2", backend="jnp", batch=2, V=4)
    te = _torch_engine(tm, "a2", batch=2)
    jc = je.run(je.init_carry(seed=3), 2)
    host = {f: np.asarray(getattr(jc, f)) for f in jc._fields}
    tc = convert.carry_from_numpy(host, device="cpu")
    assert tc.rng.dtype == torch.int32 and tuple(tc.spins.shape) == (2, 80)
    for f, v in convert.carry_to_numpy(tc).items():
        assert v.dtype == host[f].dtype, f
        np.testing.assert_array_equal(v, host[f])
    _carry_equal(je.run(jc, 2), te.run(tc, 2), "continued")


# -----------------------------------------------------------------------------
# Serving.
# -----------------------------------------------------------------------------

N, L, V, SLOTS, CHUNK = 5, 16, 4, 3, 4


def _jobs(Anneal):
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(7):
        budget = int(rng.integers(3, 12))
        kw = dict(user=f"u{i % 3}", priority=int(i % 4 == 3))
        if i % 3 == 2:
            jobs.append(Anneal.ramp(seed=10 + i, beta_start=0.3, beta_end=1.4, steps=3,
                                    sweeps_per_step=max(1, budget // 3), **kw))
        else:
            jobs.append(Anneal.constant(seed=10 + i, sweeps=budget,
                                        beta=float(rng.uniform(0.5, 1.5)), **kw))
    return jobs


def _serve(server, Anneal):
    for job in _jobs(Anneal):
        server.submit(job)
    results = server.step()
    server.submit(Anneal.constant(seed=99, sweeps=5, beta=1.2, priority=2, user="urgent"))
    return {r.jid: r for r in results + server.drain()}


@pytest.mark.parametrize("rung", FLAT)
@pytest.mark.parametrize("policy", ["fifo", "fair"])
def test_served_results_match_reference(policy, rung):
    jm, tm = _pair(N, L, seed=4)
    kw = dict(slots=SLOTS, chunk_sweeps=CHUNK, rung=rung, V=V, policy=policy, exp_flavor="fast")
    want = _serve(JServer(jm, backend="jnp", **kw), JAnneal)
    ts = SampleServer(tm, backend="torch", device="cpu", **kw)
    got = _serve(ts, AnnealJob)
    assert sorted(want) == sorted(got) == list(range(8))
    for jid, a in want.items():
        b = got[jid]
        np.testing.assert_array_equal(a.spins, b.spins, err_msg=f"job {jid}")
        assert a.energy == b.energy, jid
        assert (a.sweeps_done, a.chunks) == (b.sweeps_done, b.chunks), jid
        assert a.extras["final_beta"] == b.extras["final_beta"], jid
    assert ts.engine.rung == rung and ts.engine.exp_flavor == "fast"


def test_server_accepts_every_flavour_on_torch():
    _, tm = _pair(N, L, seed=4)
    for flavor in ("exact", "accurate", "fast"):
        server = SampleServer(tm, slots=2, chunk_sweeps=2, rung="a2", backend="torch", V=V,
                              device="cpu", exp_flavor=flavor)
        server.submit(AnnealJob.constant(seed=1, sweeps=3, beta=1.0))
        (r,) = server.drain()
        assert server.engine.exp_flavor == flavor and r.sweeps_done == 3
        assert r.energy == observables.energies(tm, r.spins)


def test_cli_serves_a2_with_the_plain_backend(capsys):
    report = anneal_serve.main([
        "--rung", "a2", "--backend", "torch", "--device", "cpu", "--jobs", "4", "--slots", "2",
        "--chunk", "4", "--n", "5", "--L", "16",
    ])
    assert report.server.engine.rung == "a2" and report.server.engine.backend == "torch"
    assert len(report.results) == 4
    for r in report.results:
        assert r.energy == observables.energies(report.model, r.spins)
    assert "served 4 jobs" in capsys.readouterr().out


@pytest.mark.parametrize("rung", FLAT)
def test_cuda_backend_refuses_the_slower_rungs(rung):
    """The kernels compute a4 and cb; the engine, the server and the CLI
    say so rather than quietly running the plain version."""
    _, tm = _pair(4, 256)
    with pytest.raises(ValueError, match="\\('a4', 'cb'\\)"):
        engine.SweepEngine.create(tm, rung=rung, backend="cuda", V=128, device="cuda")
    with pytest.raises(ValueError, match="\\('a4', 'cb'\\)"):
        SampleServer(tm, slots=2, rung=rung, backend="cuda", V=128, device="cuda")
    # The CLI's backend defaults to cuda on a CUDA device (off it to torch,
    # which serves these rungs).
    for extra in (["--device", "cuda"], ["--device", "cpu", "--backend", "cuda"]):
        with pytest.raises(ValueError, match="--backend torch"):
            anneal_serve.main(["--rung", rung] + extra)
