"""Served results, port vs JAX reference, under every admission policy.

The same anneal job list — constants and ramps over three users, two
priority classes, plus an urgent job submitted mid-drain so the priority
policies checkpoint-preempt — is served by the reference
(``backend="jnp"``) and by the port (``backend="torch"``, CPU).  Per-job
spins, energies, ``sweeps_done``, ``chunks``, ``final_beta``, the
retirement order and the slot-sweep counters of ``stats()`` must be
identical, on the rungs "cb" and "a4" (whose final pool also carries the
incrementally updated fields).  Anneals and a PT ladder retiring in one
step share one retirement pass (one `SweepEngine.retire_rows`).
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from repro.core import ising as jis
from repro.launch import anneal_serve as jas
from repro.serve_mc import AnnealJob as JAnneal
from repro.serve_mc import PTJob as JPT
from repro.serve_mc import SampleServer as JServer
from repro.serve_mc.scheduler import SlotPool as JSlotPool
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import convert, engine, observables
from repro_torch.launch import anneal_serve
from repro_torch.obs.trace import validate_events
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer, SlotPool

N, L, V, SLOTS, CHUNK = 5, 16, 4, 3, 4
COUNTERS = ("launches", "busy_slot_sweeps", "total_slot_sweeps", "sweeps_elapsed",
            "preemptions", "useful_slot_sweeps", "idle_resweep_slot_sweeps", "spin_flips")


def _jobs(Anneal):
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(9):
        budget = int(rng.integers(4, 18))
        kw = dict(user=f"u{i % 3}", priority=int(i % 4 == 3))
        if i % 3 == 2:
            jobs.append(Anneal.ramp(seed=10 + i, beta_start=0.3, beta_end=1.4, steps=3,
                                    sweeps_per_step=max(1, budget // 3), **kw))
        else:
            jobs.append(Anneal.constant(seed=10 + i, sweeps=budget,
                                        beta=float(rng.uniform(0.5, 1.5)), **kw))
    return jobs


def _serve(server, Anneal):
    """Submit the mix, step twice, submit an urgent wide-priority job, drain."""
    for job in _jobs(Anneal):
        server.submit(job)
    results = server.step() + server.step()
    server.submit(Anneal.constant(seed=99, sweeps=6, beta=1.2, priority=2, user="urgent"))
    return {r.jid: r for r in results + server.drain()}


def _models():
    jm = jis.random_layered_model(n=N, L=L, seed=4, beta=1.1)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


@pytest.mark.parametrize("rung", ["cb", "a4"])
@pytest.mark.parametrize("policy", ["fifo", "backfill", "fair"])
def test_served_results_match_reference(policy, rung):
    jm, tm = _models()
    js = JServer(jm, slots=SLOTS, chunk_sweeps=CHUNK, rung=rung, backend="jnp", V=V, policy=policy)
    ts = SampleServer(tm, slots=SLOTS, chunk_sweeps=CHUNK, rung=rung, backend="torch", V=V,
                      device="cpu", policy=policy)
    want, got = _serve(js, JAnneal), _serve(ts, AnnealJob)
    assert sorted(want) == sorted(got) == list(range(10))
    for jid, a in want.items():
        b = got[jid]
        np.testing.assert_array_equal(a.spins, b.spins, err_msg=f"job {jid}")
        assert a.energy == b.energy, jid
        assert a.magnetization == b.magnetization, jid
        assert (a.sweeps_done, a.chunks) == (b.sweeps_done, b.chunks), jid
        assert a.extras["final_beta"] == b.extras["final_beta"], jid
        assert a.extras["preemptions"] == b.extras["preemptions"], jid
    assert list(js._retired) == list(ts._retired)
    sa, sb = js.stats(), ts.stats()
    for key in COUNTERS:
        assert sa[key] == sb[key], key
    if policy != "fifo":
        assert sb["preemptions"] > 0  # the urgent job evicted someone
    # Final pools agree too: idle slots' stale state is part of the run.
    host = convert.carry_to_numpy(ts.carry)
    for f in js.carry._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js.carry, f)), host[f], err_msg=f)


def test_served_equals_solo_engine_run():
    """Packing is invisible: a served ramp equals the same schedule run
    alone on a batch-1 engine."""
    _, tm = _models()
    server = SampleServer(tm, slots=SLOTS, chunk_sweeps=3, backend="torch", V=V, device="cpu")
    for job in _jobs(AnnealJob):
        server.submit(job)
    res = {r.jid: r for r in server.drain()}
    job = _jobs(AnnealJob)[2]  # a ramp: seed 12, three segments
    eng = engine.SweepEngine.create(tm, backend="torch", batch=1, V=V, device="cpu")
    carry = eng.init_slot_carry(seed=job.seed, beta=job._betas[0])
    for seg, beta in zip(job._segments, job._betas):
        carry = eng.run(eng.set_slot_betas(carry, [0], [beta]), seg)
    spins = eng.spins_flat(carry)[0]
    np.testing.assert_array_equal(res[2].spins, spins)
    assert res[2].energy == observables.energies(tm, spins)


def test_a_step_seeds_and_rewrites_betas_once_for_all_its_jobs():
    """An admission round seeds every fresh slot's generators in one
    `seed_slot_rngs` call and a step writes every anneal job's segment
    betas in one `set_slot_betas` call, and the ramps served so equal the
    reference's bit for bit."""
    jm, tm = _models()
    ramps = [dict(seed=40 + i, beta_start=0.2 + 0.1 * i, beta_end=1.5, steps=4,
                  sweeps_per_step=CHUNK * (1 + i % 2)) for i in range(5)]
    js = JServer(jm, slots=SLOTS, chunk_sweeps=CHUNK, backend="jnp", V=V)
    ts = SampleServer(tm, slots=SLOTS, chunk_sweeps=CHUNK, backend="torch", V=V, device="cpu")
    eng, calls = ts.engine, []
    for name in ("seed_slot_rngs", "set_slot_betas"):
        def counted(*a, _f=getattr(eng, name), _name=name):
            calls.append((_name, len(a[0] if _name == "seed_slot_rngs" else a[1])))
            return _f(*a)
        setattr(eng, name, counted)
    for kw in ramps:
        js.submit(JAnneal.ramp(**kw))
        ts.submit(AnnealJob.ramp(**kw))
    want, got, per_step = {}, {}, []
    while ts.num_active or ts.num_queued:
        del calls[:]
        got.update({r.jid: r for r in ts.step()})
        per_step.append(list(calls))
    want = {r.jid: r for r in js.drain()}
    for step in per_step:
        assert [n for n, _ in step].count("seed_slot_rngs") <= 1
        assert [n for n, _ in step].count("set_slot_betas") <= 1
    assert per_step[0][0] == ("seed_slot_rngs", SLOTS)
    assert max(k for step in per_step for n, k in step if n == "set_slot_betas") == SLOTS
    assert sorted(want) == sorted(got) == list(range(len(ramps)))
    for jid, a in want.items():
        np.testing.assert_array_equal(a.spins, got[jid].spins, err_msg=f"job {jid}")
        assert a.energy == got[jid].energy, jid
        assert a.extras["final_beta"] == got[jid].extras["final_beta"], jid


@pytest.mark.parametrize("case", ["cb", "a4", "cb-multi"])
def test_one_retirement_pass_retires_anneals_and_a_ladder_together(case):
    """Three anneals and a PT ladder of three replicas retire in one step:
    one `retire_rows` call, one gather and copy on the one device, the
    counters at the stack's height (6 slots, 1 pass), and every
    `JobResult` equal field for field to the reference server's, in the
    reference's retirement order.  On a multi-tenant server the jobs
    sample three models, so the observables run a group a model."""
    rung, multi = case[:2], case.endswith("multi")
    jm, tm = _models()
    jt = [None, jis.reseed_couplings(jm, 31), jis.reseed_couplings(jm, 32)]
    tt = [None] + [convert.model_from_arrays(dataclasses.asdict(m)) for m in jt[1:]]
    kw = dict(slots=6, chunk_sweeps=CHUNK, rung=rung, V=V, policy="fifo", multi_tenant=multi)
    js = JServer(jm, backend="jnp", **kw)
    ts = SampleServer(tm, backend="torch", device="cpu", **kw)
    eng, calls = ts.engine, []
    eng.retire_rows = lambda c, slots, _f=eng.retire_rows: (calls.append(["rows", slots]),
                                                            _f(c, slots))[1]
    eng._retire_block = lambda d, blk, rows, _f=eng._retire_block: (
        calls[-1].append(d), _f(d, blk, rows))[1]
    for srv, Anneal, PT, models in ((js, JAnneal, JPT, jt), (ts, AnnealJob, PTJob, tt)):
        for i in range(3):
            model = models[i] if multi else None
            srv.submit(Anneal.constant(seed=60 + i, sweeps=2 * CHUNK, beta=0.6 + 0.3 * i,
                                       model=model))
        srv.submit(PT(seed=70, betas=np.linspace(0.5, 1.5, 3).astype(np.float32),
                      num_rounds=2, sweeps_per_round=CHUNK, model=models[1] if multi else None))
    assert ts.step() == []
    got = {r.jid: r for r in ts.step()}
    assert calls == [["rows", [0, 1, 2, 3, 4, 5], 0]]
    tel = ts.telemetry
    assert (tel.value("serve.retire_passes"), tel.value("serve.retired_slots")) == (1, 6)
    want = {r.jid: r for r in js.drain()}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert list(ts._retired) == list(js._retired)
    for jid, a in want.items():
        b = got[jid]
        for f in ("spins", "energy", "magnetization", "sweeps_done", "chunks"):
            x, y = getattr(a, f), getattr(b, f)
            assert type(np.asarray(x).item(0)) is type(np.asarray(y).item(0)), (jid, f)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{jid} {f}")
        assert np.asarray(b.spins).dtype == np.float32, jid
        assert sorted(a.extras) == sorted(b.extras), jid
        for k in a.extras:
            np.testing.assert_array_equal(np.asarray(a.extras[k]), np.asarray(b.extras[k]),
                                          err_msg=f"{jid} {k}")
    assert isinstance(got[0].energy, float) and got[3].energy.shape == (3,)
    # Each job holds its own arrays, not views of the pass's stack.
    assert not any(np.shares_memory(got[i].spins, got[j].spins)
                   for i in got for j in got if i < j)


def test_telemetry_never_changes_results():
    _, tm = _models()
    out = []
    for tel in (True, False):
        server = SampleServer(tm, slots=SLOTS, chunk_sweeps=CHUNK, backend="torch", V=V,
                              device="cpu", telemetry=tel)
        out.append(_serve(server, AnnealJob))
        if tel:
            validate_events(server.telemetry.chrome_trace()["traceEvents"])
    for jid in out[0]:
        np.testing.assert_array_equal(out[0][jid].spins, out[1][jid].spins)


def test_adaptive_chunks_keep_results():
    _, tm = _models()
    fixed = SampleServer(tm, slots=SLOTS, chunk_sweeps=CHUNK, backend="torch", V=V, device="cpu")
    adaptive = SampleServer(tm, slots=SLOTS, chunk_sweeps="adaptive", backend="torch", V=V,
                            device="cpu")
    a, b = _serve(fixed, AnnealJob), _serve(adaptive, AnnealJob)
    for jid in a:
        np.testing.assert_array_equal(a[jid].spins, b[jid].spins)


def test_slot_pool_guards():
    pool = SlotPool(4)
    assert pool.alloc(2) == (0, 1)
    pool.take([3])
    with pytest.raises(RuntimeError, match="not free"):
        pool.take([1])
    pool.release(0)
    with pytest.raises(RuntimeError, match="double-free"):
        pool.release(0)
    with pytest.raises(ValueError, match="outside"):
        pool.release(4)
    with pytest.raises(RuntimeError, match="only 2 slots free"):
        pool.alloc(3)
    assert pool.alloc(2) == (0, 2)


def test_slot_pool_matches_reference_one_device():
    """Allocation order equals the reference pool's on one device."""
    rng = np.random.default_rng(3)
    ours, ref = SlotPool(8), JSlotPool(8)
    held = []
    for _ in range(200):
        if held and (rng.random() < 0.5 or ours.total_free == 0):
            slots = held.pop(int(rng.integers(len(held))))
            ours.release_all(slots)
            ref.release_all(slots)
        else:
            n = int(rng.integers(1, ours.total_free + 1))
            got = ours.alloc(n)
            assert got == ref.alloc(n)
            held.append(got)
        assert ours.total_free == ref.total_free


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_cli_serves_on_cpu(tmp_path, capsys, rung):
    trace = tmp_path / "trace.json"
    report = anneal_serve.main([
        "--device", "cpu", "--jobs", "6", "--slots", "3", "--chunk", "4", "--n", "5",
        "--L", "16", "--V", "4", "--trace", str(trace), "--metrics", "--rung", rung,
    ])
    assert report.server.engine.backend == "torch"
    assert report.server.engine.rung == rung
    assert len(report.results) == 6 and report.seconds > 0
    for r in report.results:
        assert r.energy == observables.energies(report.model, r.spins)
    out = capsys.readouterr().out
    assert "served 6 jobs" in out and "repro_serve_launches" in out
    validate_events(json.loads(trace.read_text())["traceEvents"])


@pytest.mark.parametrize("flag", [["--devices", "3"]], ids=["devices"])
def test_cli_rejects_unported_flags(flag):
    """``--devices`` is served (tests/test_torch_mesh_serve.py); its misuse
    raises the reference's messages: 8 slots do not split over 3 devices,
    and the card refuses more devices than it can see."""
    with pytest.raises(ValueError, match="batch 8 must divide evenly over 3 devices"):
        anneal_serve.main(["--device", "cpu", "--V", "4", "--L", "16"] + flag)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{n + 1} devices requested, {n} visible"):
        anneal_serve.main(["--V", "4", "--L", "16", "--devices", str(n + 1)])


def test_cli_smoke_on_the_cpu_equals_the_references(tmp_path, capsys):
    """``--smoke --device cpu``: the reference's smoke workload and shape
    through serve -> snapshot -> abandon -> restore -> finish; every job's
    result equals the reference CLI's ``--smoke`` job for job."""
    want = jas.main(["--smoke", "--trace", str(tmp_path / "jax.json")])
    capsys.readouterr()
    report = anneal_serve.main(["--smoke", "--device", "cpu", "--trace", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "smoke: simulated crash" in out and "smoke: resumed" in out
    assert "model n=8 L=16 V=4" in out and "backend=torch" in out
    assert report.server.engine.backend == "torch"
    got = {r.jid: r for r in report.results}
    assert sorted(got) == [r.jid for r in want] == list(range(8))
    for a in want:
        b = got[a.jid]
        np.testing.assert_array_equal(np.asarray(a.spins), b.spins, err_msg=f"job {a.jid}")
        np.testing.assert_array_equal(np.asarray(a.energy), b.energy, err_msg=f"job {a.jid}")
        assert a.sweeps_done == b.sweeps_done
    validate_events(json.loads((tmp_path / "t.json").read_text())["traceEvents"])


def test_cli_snapshots_then_resumes_the_recorded_jobs(tmp_path, capsys):
    """``--snapshot-dir --snapshot-every`` leaves periodic snapshots; a
    ``--resume`` from one of them finishes the jobs it recorded, equal to
    the uninterrupted run's."""
    snaps = tmp_path / "snaps"
    argv = ["--device", "cpu", "--jobs", "6", "--slots", "3", "--chunk", "4", "--n", "5",
            "--L", "16", "--V", "4", "--quiet"]
    full = anneal_serve.main(argv + ["--snapshot-dir", str(snaps), "--snapshot-every", "8"])
    steps = CheckpointManager(str(snaps)).valid_steps()
    assert len(steps) >= 2 and steps[-1] <= full.server.sweeps_elapsed
    # Resume from the oldest snapshot kept (keep-N leaves the newest ones).
    for s in steps[1:]:
        shutil.rmtree(snaps / f"step_{s:010d}")
    resumed = anneal_serve.main(["--device", "cpu", "--resume", "--snapshot-dir", str(snaps)])
    assert "resumed from" in capsys.readouterr().out
    want = {r.jid: r for r in full.results}
    done_before = set(resumed.server._retired) - {r.jid for r in resumed.results}
    assert done_before | {r.jid for r in resumed.results} == set(want)
    assert resumed.results and not done_before & {r.jid for r in resumed.results}
    for r in resumed.results:
        np.testing.assert_array_equal(r.spins, want[r.jid].spins, err_msg=f"job {r.jid}")
    assert list(resumed.server._retired) == list(full.server._retired)


def test_cli_resume_needs_a_snapshot_dir():
    with pytest.raises(SystemExit):  # argparse's error, as in the reference
        anneal_serve.main(["--device", "cpu", "--resume"])


def test_cli_snapshot_every_needs_a_snapshot_dir():
    with pytest.raises(SystemExit):
        anneal_serve.main(["--device", "cpu", "--V", "4", "--L", "16", "--snapshot-every", "8"])


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_cli_serves_a_pt_job_as_the_reference_does(capsys, rung):
    """``--pt-replicas 3 --pt-rounds 3`` adds the reference's PT job to the
    mix (`build_job_mix`); every job's result equals the JAX CLI's."""
    argv = ["--jobs", "5", "--slots", "4", "--chunk", "4", "--n", "5", "--L", "16", "--V", "4",
            "--pt-replicas", "3", "--pt-rounds", "3", "--rung", rung, "--seed", "1"]
    want = {r.jid: r for r in jas.main(argv + ["--backend", "jnp"])}
    report = anneal_serve.main(argv + ["--device", "cpu"])
    got = {r.jid: r for r in report.results}
    assert sorted(got) == sorted(want) == list(range(6))
    pt = [jid for jid, r in got.items() if r.spins.ndim == 2]
    assert pt == [5] and got[5].spins.shape == (3, 5 * 16)
    for jid, a in want.items():
        b = got[jid]
        np.testing.assert_array_equal(a.spins, b.spins, err_msg=f"job {jid}")
        np.testing.assert_array_equal(a.energy, b.energy, err_msg=f"job {jid}")
        assert (a.sweeps_done, a.chunks) == (b.sweeps_done, b.chunks), jid
    for key in ("swap_accept", "swap_propose", "preemptions"):
        assert want[5].extras[key] == got[5].extras[key], key
    np.testing.assert_array_equal(want[5].extras["betas"], got[5].extras["betas"])
    assert "[pt]" in capsys.readouterr().out
