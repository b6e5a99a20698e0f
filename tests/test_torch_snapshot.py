"""Whole-server snapshots in the port: bit-exact resume, in the port and
across the two packages.

A snapshot taken at a step boundary captures the whole `SampleServer`
(queued and active jobs, parked slots, the slot pool with its MT19937
columns, multi-tenant coupling tables, the policy's bookkeeping, the
counters); a server restored from it continues exactly as the
uninterrupted run: spins, energies, raw RNG and retirement order.  The
port's snapshots use the JAX reference's layout, so on the CPU:

* the port resumes bit-exactly, on rungs a4 and cb, single-model and
  multi-tenant, with a PT ladder in flight, and the result equals the
  reference's ``backend="jnp"`` run;
* a snapshot written by the reference's server restores in the port and
  finishes equal to the reference's uninterrupted run, and the reverse;
* a graceful drain with a parked job, periodic snapshots and a
  non-blocking snapshot taken while the server steps on change nothing;
* a worker SIGKILLed mid-drain is restored from its last periodic
  snapshot;
* a wrong version, a backend the port does not have and a mesh are
  refused.
"""

import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.core import ising as jis
from repro.serve_mc import AnnealJob as JAnnealJob
from repro.serve_mc import PTJob as JPTJob
from repro.serve_mc import SampleServer as JSampleServer
from repro.serve_mc import snapshot_state as jsnapshot_state
from repro_torch.core import ising
from repro_torch.runtime.ft import PreemptionHandler
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer, snapshot_state

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

PORT = types.SimpleNamespace(AnnealJob=AnnealJob, PTJob=PTJob, ising=ising,
                             model=ising.random_layered_model(n=8, L=16, seed=0, beta=1.0))
JAX = types.SimpleNamespace(AnnealJob=JAnnealJob, PTJob=JPTJob, ising=jis,
                            model=jis.random_layered_model(n=8, L=16, seed=0, beta=1.0))
MODEL = PORT.model
SERVE = dict(V=4, slots=4, chunk_sweeps=4, policy="fair")
#: Steps served before the mid-drain snapshot: the PT ladder is active then.
STEPS = 2


def _port_server(**kw):
    return SampleServer(MODEL, backend="torch", device="cpu", **{**SERVE, **kw})


def _jax_server(**kw):
    return JSampleServer(JAX.model, backend="jnp", **{**SERVE, **kw})


def _mixed_jobs(pkg, multi):
    """The reference's mix (tests/test_snapshot.py): constants, a ramp, a
    3-replica PT ladder and, multi-tenant only, a job on reseeded
    couplings of the lattice."""
    A, P = pkg.AnnealJob, pkg.PTJob
    jobs = [
        A.constant(seed=11, sweeps=10, beta=0.9, user="u0"),
        A.constant(seed=12, sweeps=18, beta=1.1, user="u1", priority=1),
        A.ramp(seed=13, beta_start=0.4, beta_end=1.2, steps=3, sweeps_per_step=4, user="u0"),
        P(seed=14, betas=np.array([0.5, 0.8, 1.2], np.float32), num_rounds=3,
          sweeps_per_round=2, user="ladder"),
        A.constant(seed=15, sweeps=14, beta=1.0, user="u1"),
    ]
    if multi:
        jobs.append(A.constant(seed=16, sweeps=12, beta=1.0, user="u2",
                               model=pkg.ising.reseed_couplings(pkg.model, 7)))
    return jobs


def _submit(server, jobs):
    for j in jobs:
        server.submit(j)
    return server


def _final_rng(server):
    return np.asarray(server.engine.extract_pool(server.carry).carry.rng)


def _assert_results_equal(got, want, what=""):
    assert got.jid == want.jid
    for field in ("spins", "energy", "magnetization"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
            err_msg=f"{what}: jid {got.jid} {field}",
        )
    assert got.sweeps_done == want.sweeps_done, f"{what}: jid {got.jid}"


def _assert_run_equal(results, retired, rng, want, what):
    """``results`` cover the workload once each, equal to the uninterrupted
    run ``want`` (results by jid, retirement order, final pool rng)."""
    want_results, want_order, want_rng = want
    assert set(results) == set(want_results), what
    for jid, r in results.items():
        _assert_results_equal(r, want_results[jid], what)
    assert list(retired) == want_order, what
    np.testing.assert_array_equal(rng, want_rng, err_msg=what)


def _uninterrupted(server):
    results = {r.jid: r for r in server.drain()}
    return results, list(server._retired), _final_rng(server)


_JAX_RUNS: dict = {}


def _jax_run(rung, multi):
    """The reference's uninterrupted jnp run of the mix (once per case)."""
    key = (rung, multi)
    if key not in _JAX_RUNS:
        srv = _submit(_jax_server(rung=rung, multi_tenant=multi), _mixed_jobs(JAX, multi))
        _JAX_RUNS[key] = _uninterrupted(srv)
    return _JAX_RUNS[key]


def _snapshot_mid_drain(server, steps=STEPS):
    """Serve ``steps`` rounds, check a PT ladder is in flight, snapshot."""
    pre = []
    for _ in range(steps):
        pre.extend(server.step())
    assert any(isinstance(j, (PTJob, JPTJob)) for j, _ in server._active.values())
    server.snapshot()
    return pre


CASES = pytest.mark.parametrize(
    "rung,multi", [("a4", False), ("a4", True), ("cb", False), ("cb", True)],
    ids=["a4", "a4-multi", "cb", "cb-multi"],
)


# -----------------------------------------------------------------------------
# Resume parity inside the port.
# -----------------------------------------------------------------------------


@CASES
def test_resume_bitexact(tmp_path, rung, multi):
    ref = _uninterrupted(_submit(_port_server(rung=rung, multi_tenant=multi),
                                 _mixed_jobs(PORT, multi)))
    # The port's uninterrupted run is the reference's, bit for bit.
    _assert_run_equal(*ref, _jax_run(rung, multi), f"port vs jnp {rung}")

    srv = _submit(_port_server(rung=rung, multi_tenant=multi, snapshot_manager=str(tmp_path)),
                  _mixed_jobs(PORT, multi))
    pre = _snapshot_mid_drain(srv)
    step = srv.sweeps_elapsed
    del srv  # lose the process

    srv2 = SampleServer.restore(str(tmp_path), device="cpu")
    assert srv2.sweeps_elapsed == step
    post = srv2.drain()
    # No job is served twice, every job once, bit-identically.
    assert not {r.jid for r in pre} & {r.jid for r in post}
    _assert_run_equal({r.jid: r for r in pre + post}, srv2._retired, _final_rng(srv2), ref,
                      f"resume {rung}")


def test_extract_pool_and_job_arrays_are_copies():
    """On the CPU a tensor's numpy view shares its storage, so the
    snapshot's arrays must be copies of the carry, the tables, parked
    slots and the PT swap generator — never views."""
    srv = _submit(_port_server(rung="cb", multi_tenant=True, policy="backfill"),
                  [PTJob(seed=3, betas=np.array([0.5, 0.8, 1.2], np.float32), num_rounds=6,
                         sweeps_per_round=2)])
    srv.step()
    for i in range(3):
        srv.submit(AnnealJob.constant(seed=20 + i, sweeps=6, beta=1.1, priority=3))
    srv.step()  # the ladder parks
    (pt,) = [j for j in srv.policy.jobs() if j.kind == "pt"]
    assert pt.parked is not None
    pool = srv.engine.extract_pool(srv.carry)
    live = [t.numpy() for t in srv.carry] + [t.numpy() for t in srv.engine.slot_tables.values()]
    saved = list(pool.carry) + list(pool.tables.values())
    _, job_arrays = pt.snapshot_state()
    live += [t.numpy() for p in pt.parked for t in p.carry] + [pt.swap_rng.numpy()]
    live += [t.numpy() for p in pt.parked for t in p.tables.values()]
    saved += list(job_arrays.values())
    for a in saved:
        assert not any(np.shares_memory(a, b) for b in live)


def test_nonblocking_snapshot_while_stepping(tmp_path):
    """A background write started at a boundary saves THAT boundary, however
    far the server steps on before the write ends: restored, it
    equals a server restored from a blocking snapshot at the same point."""
    dirs = {b: tmp_path / f"blocking-{b}" for b in (True, False)}
    servers = {}
    for blocking, d in dirs.items():
        srv = _submit(_port_server(rung="cb", multi_tenant=True, snapshot_manager=str(d)),
                      _mixed_jobs(PORT, True))
        for _ in range(STEPS):
            srv.step()
        srv.snapshot(blocking=blocking)
        servers[blocking] = srv
    for _ in range(3):  # step on while the writer may still be writing
        servers[False].step()
    servers[False].wait_snapshots()
    saved = {b: servers[b].snapshot_manager.restore_latest_named()[1] for b in dirs}
    assert list(saved[True]) == list(saved[False])
    for k in saved[True]:
        np.testing.assert_array_equal(saved[True][k], saved[False][k], err_msg=k)
    runs = {}
    for blocking, d in dirs.items():
        srv = SampleServer.restore(str(d), device="cpu")
        runs[blocking] = ({r.jid: r for r in srv.drain()}, list(srv._retired), _final_rng(srv))
    _assert_run_equal(*runs[False], runs[True], "non-blocking vs blocking")


# -----------------------------------------------------------------------------
# Across the packages.
# -----------------------------------------------------------------------------


@CASES
def test_jax_snapshot_restores_in_the_port(tmp_path, rung, multi):
    srv = _submit(_jax_server(rung=rung, multi_tenant=multi, snapshot_manager=str(tmp_path)),
                  _mixed_jobs(JAX, multi))
    pre = _snapshot_mid_drain(srv)
    del srv
    # The recorded backend is the reference's: refused unless overridden.
    with pytest.raises(ValueError, match="backend 'jnp'"):
        SampleServer.restore(str(tmp_path), device="cpu")
    port = SampleServer.restore(str(tmp_path), backend="torch", device="cpu")
    assert port.engine.backend == "torch" and port.engine.device.type == "cpu"
    post = port.drain()
    _assert_run_equal({r.jid: r for r in pre + post}, port._retired, _final_rng(port),
                      _jax_run(rung, multi), f"jax -> port {rung}")


@CASES
def test_port_snapshot_restores_in_the_reference(tmp_path, rung, multi):
    srv = _submit(_port_server(rung=rung, multi_tenant=multi, snapshot_manager=str(tmp_path)),
                  _mixed_jobs(PORT, multi))
    pre = _snapshot_mid_drain(srv)
    del srv
    with pytest.raises(ValueError):  # the reference has no backend "torch"
        JSampleServer.restore(str(tmp_path))
    ref = JSampleServer.restore(str(tmp_path), backend="jnp")
    post = ref.drain()
    _assert_run_equal({r.jid: r for r in pre + post}, ref._retired, _final_rng(ref),
                      _jax_run(rung, multi), f"port -> jax {rung}")


def _mix_at_boundary(pkg, server, multi):
    """The mixed jobs after `STEPS` rounds (a PT ladder active)."""
    return _run_steps(_submit(server, _mixed_jobs(pkg, multi)))


def _parked_at_boundary(pkg, server, multi):
    """The preemption sequence: the PT ladder parked."""
    _preempt_sequence(server, pkg)
    return server


@pytest.mark.parametrize(
    "scenario,multi,kw",
    [(_mix_at_boundary, False, {}), (_mix_at_boundary, True, {}),
     (_parked_at_boundary, True, {"policy": "backfill"})],
    ids=["single", "multi", "parked-multi"],
)
def test_snapshot_layout_is_the_references(scenario, multi, kw):
    """Name for name and key for key: the same jobs at the same boundary
    give the same arrays (bit for bit) and the same manifest, but for the
    backend's name, ``interpret`` (the reference's jnp engine records null,
    the port false: it has no interpret mode) and the wall-clock entries."""
    kw = dict(kw, rung="cb", multi_tenant=multi)
    got_a, got_x = snapshot_state(scenario(PORT, _port_server(**kw), multi))
    want_a, want_x = jsnapshot_state(scenario(JAX, _jax_server(**kw), multi))
    assert list(got_a) == list(want_a)
    for k in want_a:
        assert got_a[k].dtype == np.asarray(want_a[k]).dtype, k
        np.testing.assert_array_equal(got_a[k], np.asarray(want_a[k]), err_msg=k)

    def scrub(x):
        x = json.loads(json.dumps(x))
        x["config"]["backend"] = x["config"]["interpret"] = None
        x["wait_records"] = [r[:2] + r[3:] for r in x["wait_records"]]  # drop wait_s
        x["wait_recent"] = [r[1:] for r in x["wait_recent"]]
        for entry in x["jobs"]:
            entry["meta"]["waited_s"] = None
        return x

    assert got_x["config"]["interpret"] is False
    assert scrub(got_x) == scrub(want_x)


def _run_steps(server, steps=STEPS):
    for _ in range(steps):
        server.step()
    return server


def _preempt_sequence(server, pkg):
    """A wide low-priority PT + filler, one step, then three vip jobs that
    preempt the ladder (it parks).  Returns the results retired so far."""
    server.submit(pkg.PTJob(seed=3, betas=np.array([0.5, 0.8, 1.2], np.float32), num_rounds=6,
                            sweeps_per_round=2, user="ladder"))
    server.submit(pkg.AnnealJob.constant(seed=4, sweeps=30, beta=1.0, user="u0"))
    out = list(server.step())
    for i in range(3):
        server.submit(pkg.AnnealJob.constant(seed=20 + i, sweeps=6, beta=1.1, priority=3,
                                             user="vip"))
    out.extend(server.step())
    return out


def test_jax_snapshot_with_a_parked_job_restores_in_the_port(tmp_path):
    kw = dict(rung="cb", policy="backfill")
    ref = _jax_server(**kw)
    pre_ref = _preempt_sequence(ref, JAX)
    want = ({r.jid: r for r in pre_ref + ref.drain()}, list(ref._retired), _final_rng(ref))

    srv = _jax_server(snapshot_manager=str(tmp_path), **kw)
    pre = _preempt_sequence(srv, JAX)
    assert any("/parked/" in k for k in jsnapshot_state(srv)[0])
    srv.snapshot()
    port = SampleServer.restore(str(tmp_path), backend="torch", device="cpu")
    post = port.drain()
    _assert_run_equal({r.jid: r for r in pre + post}, port._retired, _final_rng(port), want,
                      "parked jax -> port")


# -----------------------------------------------------------------------------
# Graceful drain, periodic snapshots.
# -----------------------------------------------------------------------------


def test_graceful_drain_parked_job_bitexact(tmp_path):
    kw = dict(rung="cb", policy="backfill")
    ref = _port_server(**kw)
    pre_ref = _preempt_sequence(ref, PORT)
    want = ({r.jid: r for r in pre_ref + ref.drain()}, list(ref._retired), _final_rng(ref))

    handler = PreemptionHandler(install=False)  # trigger() stands in for SIGTERM
    srv = _port_server(snapshot_manager=str(tmp_path), preemption=handler, **kw)
    pre = _preempt_sequence(srv, PORT)
    assert srv.preemptions >= 1
    arrays, _ = snapshot_state(srv)
    assert any("/parked/" in k for k in arrays), "scenario must snapshot a parked job"
    handler.trigger()
    pre.extend(srv.drain())  # returns early: snapshot + preempted flag
    assert srv.preempted
    assert srv.snapshot_manager.latest_step() is not None
    assert any(e["name"] == "sched.preempt_drain" for e in srv.telemetry.events())
    del srv

    srv2 = SampleServer.restore(str(tmp_path), device="cpu")
    post = srv2.drain()
    assert not srv2.preempted
    _assert_run_equal({r.jid: r for r in pre + post}, srv2._retired, _final_rng(srv2), want,
                      "graceful drain")


def test_periodic_snapshots_do_not_change_results(tmp_path):
    kw = dict(rung="cb", multi_tenant=True)
    want = _uninterrupted(_submit(_port_server(**kw), _mixed_jobs(PORT, True)))
    srv = _submit(_port_server(snapshot_manager=str(tmp_path), snapshot_every_sweeps=8, **kw),
                  _mixed_jobs(PORT, True))
    got = _uninterrupted(srv)
    assert len(srv.snapshot_manager.valid_steps()) >= 2, "no periodic snapshots landed"
    assert srv.telemetry.value("serve.snapshots") >= 2
    _assert_run_equal(*got, want, "periodic")


# -----------------------------------------------------------------------------
# Kill-and-restore: a worker SIGKILLed mid-drain, restored from its last
# PERIODIC snapshot.
# -----------------------------------------------------------------------------


def _kill_jobs():
    jobs = [
        AnnealJob.constant(seed=100 + i, sweeps=s, beta=0.7 + 0.05 * i, user=f"u{i % 3}",
                           priority=1 if i == 4 else 0)
        for i, s in enumerate([12, 20, 28, 16, 24, 40, 36, 18])
    ]
    jobs.append(PTJob(seed=99, betas=np.array([0.5, 0.9, 1.3], np.float32), num_rounds=5,
                      sweeps_per_round=2, user="ladder"))
    jobs.append(AnnealJob.constant(seed=42, sweeps=22, beta=1.0, user="u2",
                                   model=ising.reseed_couplings(MODEL, 7)))
    return jobs


_KILL_KW = dict(rung="cb", multi_tenant=True)


def _kill_worker(snap_dir):
    """Child: serve with periodic snapshots, then SIGKILL itself at the
    first step boundary where a complete snapshot exists, some jobs have
    retired and work remains — a crash mid-drain, no goodbye snapshot."""
    server = _submit(_port_server(snapshot_manager=snap_dir, snapshot_every_sweeps=8,
                                  **_KILL_KW), _kill_jobs())
    while len(server.policy) or server._active:
        server.step()
        server.wait_snapshots()
        if (server.snapshot_manager.latest_step() is not None and server._retired
                and (len(server.policy) or server._active)):
            os.kill(os.getpid(), signal.SIGKILL)
    sys.exit(3)  # drained without crashing: workload too small


def test_kill_and_restore_bitexact(tmp_path):
    snap = str(tmp_path / "snaps")
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", snap],
        env=env, capture_output=True, timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, (
        f"worker exited {proc.returncode}, wanted SIGKILL:\n{proc.stderr.decode()[-2000:]}"
    )
    want_results, want_order, _ = _uninterrupted(_submit(_port_server(**_KILL_KW), _kill_jobs()))

    server = SampleServer.restore(snap, device="cpu")
    already = set(server._retired)  # retired before the snapshot: done
    got = {r.jid: r for r in server.drain()}
    # Jobs retired between the snapshot and the kill are re-run (their
    # results died with the child); the union covers the workload.
    assert already | set(got) == set(want_results)
    for jid, r in got.items():
        _assert_results_equal(r, want_results[jid], "kill")
    assert list(server._retired) == want_order


# -----------------------------------------------------------------------------
# Refusals.
# -----------------------------------------------------------------------------


def _one_snapshot(tmp_path):
    srv = _submit(_port_server(snapshot_manager=str(tmp_path)), _mixed_jobs(PORT, False))
    srv.step()
    step = srv.snapshot()
    return os.path.join(str(tmp_path), f"step_{step:010d}", "manifest.json")


def _edit_extra(path, edit):
    manifest = json.loads(open(path).read())
    edit(manifest["extra"])
    with open(path, "w") as f:
        json.dump(manifest, f)


def test_restore_refuses_another_snapshot_version(tmp_path):
    _edit_extra(_one_snapshot(tmp_path), lambda x: x.update(version=2))
    with pytest.raises(ValueError, match="snapshot version 2"):
        SampleServer.restore(str(tmp_path), device="cpu")


def test_restore_refuses_a_backend_it_does_not_have(tmp_path):
    _edit_extra(_one_snapshot(tmp_path), lambda x: x["config"].update(backend="pallas"))
    with pytest.raises(ValueError, match="backend 'pallas'"):
        SampleServer.restore(str(tmp_path), device="cpu")
    srv = SampleServer.restore(str(tmp_path), backend="torch", device="cpu")
    assert srv.engine.backend == "torch"


def test_restore_refuses_a_plain_snapshot_on_the_card_unless_asked(tmp_path):
    """A snapshot of the plain backend ("torch") restored with the defaults
    (on the card) is refused before anything touches the card: the plain
    version never runs there unless ``backend=`` asks for it."""
    _one_snapshot(tmp_path)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="backend 'torch' .* needs backend="):
            SampleServer.restore(str(tmp_path), device=device)
    with pytest.raises(ValueError, match="needs backend="):
        SampleServer.restore(str(tmp_path))
    srv = SampleServer.restore(str(tmp_path), device="cpu")
    assert srv.engine.backend == "torch"


@pytest.mark.parametrize("name", ["mesh", "capacities"])
def test_restore_and_server_refuse_a_mesh(tmp_path, name):
    """A restore lays the pool out over any mesh (tests/test_torch_mesh_serve.py);
    what is refused is a ``mesh`` that is not one and ``capacities``
    without a mesh, with the reference's messages."""
    _one_snapshot(tmp_path)
    match = {"mesh": 'engine meshes need a "data" axis',
             "capacities": "capacities need a mesh-sharded engine"}[name]
    with pytest.raises(ValueError, match=match):
        SampleServer.restore(str(tmp_path), device="cpu", **{name: (1,)})
    with pytest.raises(ValueError, match=match):
        _port_server(**{name: (1,)})


def test_snapshot_needs_a_manager(tmp_path):
    srv = _port_server()
    with pytest.raises(ValueError, match="no snapshot manager"):
        srv.snapshot()
    with pytest.raises(ValueError, match="needs a snapshot_manager"):
        _port_server(snapshot_every_sweeps=8)
    with pytest.raises(ValueError, match="snapshot_every_sweeps must be >= 0"):
        _port_server(snapshot_manager=str(tmp_path), snapshot_every_sweeps=-1)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        _kill_worker(sys.argv[2])
    raise SystemExit(f"unknown argv: {sys.argv[1:]}")
