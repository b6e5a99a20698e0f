"""Serving over a slot mesh, held against the reference's D=4 servers.

The reference needs forced host devices for a mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), which must be
set before JAX starts, so ONE module-scoped fixture runs every reference
scenario in one child process (this file run as a script) and writes the
outcomes to a temporary file.  The port needs no flag: its D=4 is four
logical ``cpu`` devices.  Each scenario is the same function of either
package (`_scenarios`), the counterparts of the reference's
test_sharded.py, test_placement.py and test_hetero.py cases:

* served results, retirement order, every job's slots at every step
  (admission, preemption, rebalancer migrations), ``stats()["placement"]``
  and the final pool (raw MT19937 state included) equal the reference's,
  on a4 and cb, equal split and [4, 2, 1, 1], affine and flat, a ladder
  forced to span devices, a preempted job resumed on another device, a
  multi-tenant server;
* a snapshot taken by the reference's server at D=4 under [4, 2, 1, 1]
  finishes in the port at D=4, D=1 and [4, 2, 1, 1] equal to the
  reference's uninterrupted run, and a port snapshot finishes in the
  reference (at D=4, D=1 and [4, 2, 1, 1]) equal to the port's;
* the CLI's ``--devices 4 --device cpu`` serves the reference CLI's
  ``--devices 4`` job for job;
* a step's retirement pass gathers and copies once on each device holding
  a retiring slot.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

SCENARIOS = ("sharded-a4", "sharded-cb", "wide-ladder", "rebalance", "ragged-a4",
             "ragged-cb", "mix-affine", "mix-flat", "preempt", "multi")
RESTORES = {"d4": (4, None), "d1": (None, None), "ragged": (4, (4, 2, 1, 1))}


def _pkg(name):
    """Either package's serving API, with its plain backend on the host."""
    if name == "jax":
        from repro.ckpt.manager import CheckpointManager
        from repro.core import ising
        from repro.launch import anneal_serve
        from repro.launch.mesh import make_slot_mesh
        from repro.serve_mc import AnnealJob, PTJob, SampleServer, restore_server, save_snapshot

        return types.SimpleNamespace(
            ising=ising, AnnealJob=AnnealJob, PTJob=PTJob, SampleServer=SampleServer,
            restore_server=restore_server, save_snapshot=save_snapshot, Manager=CheckpointManager,
            mesh=lambda d: make_slot_mesh(d), kw=dict(backend="jnp", V=4), restore_kw={},
            cli=lambda argv: anneal_serve.main(argv),
        )
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import ising
    from repro_torch.launch import anneal_serve
    from repro_torch.launch.mesh import make_slot_mesh
    from repro_torch.serve_mc import (AnnealJob, PTJob, SampleServer, restore_server,
                                      save_snapshot)

    return types.SimpleNamespace(
        ising=ising, AnnealJob=AnnealJob, PTJob=PTJob, SampleServer=SampleServer,
        restore_server=restore_server, save_snapshot=save_snapshot, Manager=CheckpointManager,
        mesh=lambda d: make_slot_mesh(d, device="cpu"),
        kw=dict(backend="torch", V=4, device="cpu"), restore_kw=dict(device="cpu"),
        cli=lambda argv: anneal_serve.main(argv + ["--device", "cpu", "--quiet"]).results,
    )


def _outcome(srv, results, history):
    pool = srv.engine.extract_pool(srv.carry)
    return {
        "results": {
            r.jid: (np.asarray(r.spins), np.asarray(r.energy), r.sweeps_done, r.chunks,
                    {k: np.asarray(v) for k, v in r.extras.items()})
            for r in results
        },
        "retired": list(srv._retired),
        "slots": history,
        "placement": srv.stats()["placement"],
        "pool": [np.asarray(x) for x in pool.carry],
    }


def _drain(srv):
    """Drain, recording every job's slots after each step."""
    results, history = [], []
    while len(srv.policy) or srv._active:
        results += srv.step()
        history.append(sorted((jid, tuple(s)) for jid, (_, s) in srv._active.items()))
    return results, history


def _scenarios(P, which):
    model = P.ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)
    A, T = P.AnnealJob, P.PTJob

    def server(mesh, **kw):
        return P.SampleServer(model, chunk_sweeps=2, mesh=mesh, **{**P.kw, **kw})

    def mixed(srv):
        for s, b in [(10, 3), (11, 7), (12, 5), (13, 4), (14, 9)]:
            srv.submit(A.constant(seed=s, sweeps=b, beta=1.0))
        srv.submit(T(seed=5, betas=np.linspace(0.5, 1.5, 6).astype(np.float32),
                     num_rounds=3, sweeps_per_round=2))
        return srv

    if which in ("sharded-a4", "sharded-cb"):
        srv = mixed(server(P.mesh(4), slots=8, rung=which[-2:]))
    elif which in ("ragged-a4", "ragged-cb"):
        srv = mixed(server(P.mesh(4), slots=8, rung=which[-2:], capacities=(4, 2, 1, 1),
                           policy="backfill"))
    elif which == "wide-ladder":
        srv = server(P.mesh(4), slots=8, rung="a4", policy="fifo")
        srv.submit(T(seed=70, betas=np.linspace(0.5, 1.5, 3).astype(np.float32),
                     num_rounds=3, sweeps_per_round=2))
    elif which == "rebalance":
        srv = server(P.mesh(4), slots=8, rung="cb", policy="fifo")
        for i, s in enumerate([4, 20, 4, 20, 20, 20, 20, 20]):
            srv.submit(A.constant(seed=50 + i, sweeps=s, beta=1.0))
        pre = srv.step() + srv.step()
        srv.submit(T(seed=77, betas=np.array([0.6, 1.2], np.float32), num_rounds=3,
                     sweeps_per_round=2))
        results, history = _drain(srv)
        return _outcome(srv, pre + results, history)
    elif which in ("mix-affine", "mix-flat"):
        srv = server(P.mesh(4), slots=8, rung="cb", policy="fifo", placement=which[4:])
        for j in [A.constant(seed=60, sweeps=5, beta=1.0),
                  T(seed=61, betas=np.array([0.6, 1.2], np.float32), num_rounds=3,
                    sweeps_per_round=2),
                  A.constant(seed=62, sweeps=3, beta=0.9),
                  A.constant(seed=64, sweeps=9, beta=1.1),
                  T(seed=63, betas=np.array([0.7, 1.1], np.float32), num_rounds=4,
                    sweeps_per_round=2),
                  A.constant(seed=65, sweeps=7, beta=0.8)]:
            srv.submit(j)
    elif which == "preempt":
        srv = server(P.mesh(4), slots=4, rung="a4", policy="backfill")
        srv.submit(A.constant(seed=7, sweeps=10, beta=1.1))
        pre = srv.step()
        srv.submit(T(seed=9, betas=np.linspace(0.5, 1.5, 4).astype(np.float32), num_rounds=2,
                     sweeps_per_round=2, priority=5))
        results, history = _drain(srv)
        return _outcome(srv, pre + results, history)
    elif which == "multi":
        srv = server(P.mesh(4), slots=4, rung="cb", multi_tenant=True)
        for i, v in enumerate([None, P.ising.reseed_couplings(model, 21),
                               P.ising.reseed_couplings(model, 22)]):
            srv.submit(A.constant(seed=40 + i, sweeps=4 + 2 * i, beta=1.0, model=v))
    else:
        raise KeyError(which)
    results, history = _drain(srv)
    return _outcome(srv, results, history)


def _snapshot_server(P, snap=None):
    """The reference's capacity-migration case: [4, 2, 1, 1], a4, backfill."""
    model = P.ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)
    srv = P.SampleServer(model, slots=8, chunk_sweeps=4, rung="a4", policy="backfill",
                         mesh=P.mesh(4), capacities=(4, 2, 1, 1), snapshot_manager=snap,
                         **P.kw)
    srv.submit(P.PTJob(seed=11, betas=[0.6, 0.8, 1.0], num_rounds=8, sweeps_per_round=4))
    for seed, sweeps, beta in [(3, 60, 1.1), (4, 40, 0.9), (5, 30, 1.0)]:
        srv.submit(P.AnnealJob.constant(seed=seed, sweeps=sweeps, beta=beta))
    return srv


def _write_snapshot(P, directory):
    """Serve 4 steps and snapshot; returns the uninterrupted run's outcome."""
    full = _snapshot_server(P)
    want = _outcome(full, *_drain(full))
    srv = _snapshot_server(P)
    for _ in range(4):
        srv.step()
    P.save_snapshot(srv, P.Manager(directory))
    return want


def _restore_all(P, directory, backend):
    out = {}
    for name, (d, caps) in RESTORES.items():
        srv = P.restore_server(P.Manager(directory), mesh=P.mesh(d) if d else None,
                               capacities=caps, backend=backend, **P.restore_kw)
        results, _ = _drain(srv)
        out[name] = {r.jid: (np.asarray(r.spins), np.asarray(r.energy)) for r in results}
        out[name + "/devices"] = srv.devices
    return out


CLI = ["--devices", "4", "--jobs", "8", "--slots", "8", "--chunk", "4", "--n", "8", "--L", "16",
       "--V", "4", "--pt-replicas", "3", "--pt-rounds", "3"]


def _child(out_path, port_snapshot):
    """The reference's side, run with four forced host devices."""
    import jax

    assert len(jax.devices()) == 4, jax.devices()
    P = _pkg("jax")
    out = {name: _scenarios(P, name) for name in SCENARIOS}
    out["snapshot"] = _write_snapshot(P, os.path.join(os.path.dirname(out_path), "jax_snap"))
    out["restore_port"] = _restore_all(P, port_snapshot, "jnp")
    out["cli"] = {r.jid: (np.asarray(r.spins), np.asarray(r.energy)) for r in P.cli(CLI)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    port_snap = str(tmp / "port_snap")
    port_want = _write_snapshot(_pkg("port"), port_snap)
    out = str(tmp / "reference.pkl")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, __file__, out, port_snap], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        data = pickle.load(f)
    data["port_snapshot_want"] = port_want
    data["jax_snap_dir"] = str(tmp / "jax_snap")
    return data


def _assert_results_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for jid in want:
        for i, (a, b) in enumerate(zip(got[jid], want[jid])):
            if isinstance(b, dict):
                assert sorted(a) == sorted(b), f"{what} job {jid}"
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} job {jid} {k}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{what} job {jid} field {i}")


@pytest.mark.parametrize("name", SCENARIOS)
def test_mesh_server_equals_the_references(ref, name):
    got, want = _scenarios(_pkg("port"), name), ref[name]
    _assert_results_equal(got["results"], want["results"], name)
    assert got["retired"] == want["retired"]
    assert got["slots"] == want["slots"]  # every placement and migration
    placement = dict(got["placement"])
    assert placement.pop("pt_swap_fused") == 0  # the port's own count; the CPU runs no kernel
    assert placement == want["placement"]
    for a, b in zip(got["pool"], want["pool"]):
        np.testing.assert_array_equal(a, b)
    st = got["placement"]
    if name == "wide-ladder":
        assert st["spanning"] == 1 and st["pt_swap_cross"] == 3
    if name == "rebalance":
        assert st["rebalance_migrations"] == 1 and st["pt_swap_local"] == 3
    if name == "mix-flat":
        assert st["pt_swap_cross"] == 7 and st["spanning"] >= 2
    if name.startswith("ragged"):
        assert st["spanning"] > 0 and st["pt_swap_cross"] > 0


@pytest.mark.parametrize("name", ["sharded-a4", "sharded-cb", "ragged-cb", "multi"])
def test_a_retirement_pass_gathers_once_a_device(ref, monkeypatch, name):
    """On four logical host devices each step's retirement pass makes one
    gather and copy on each device holding a retiring slot, and no other;
    ``serve.retire_passes`` and ``serve.retired_slots`` count the passes
    and the slots they retired; the results are the reference's."""
    from repro_torch.core.engine import SweepEngine
    from repro_torch.serve_mc import SampleServer

    passes, servers = [], []
    rows, block, retire = SweepEngine.retire_rows, SweepEngine._retire_block, \
        SampleServer._retire

    def counted_rows(eng, carry, slots):
        passes.append(({eng.slot_device(b) for b in slots}, []))
        return rows(eng, carry, slots)

    def counted_block(eng, d, blk, at):
        passes[-1][1].append(d)
        return block(eng, d, blk, at)

    def counted_retire(srv, retiring):
        servers.append(srv)
        return retire(srv, retiring)

    monkeypatch.setattr(SweepEngine, "retire_rows", counted_rows)
    monkeypatch.setattr(SweepEngine, "_retire_block", counted_block)
    monkeypatch.setattr(SampleServer, "_retire", counted_retire)
    got = _scenarios(_pkg("port"), name)
    _assert_results_equal(got["results"], ref[name]["results"], name)
    assert got["retired"] == ref[name]["retired"]
    assert len(passes) == len(servers) > 0
    for devices, gathered in passes:
        assert sorted(gathered) == sorted(devices)
    # A pass spanning devices (the multi scenario's jobs retire apart).
    assert max(len(g) for _, g in passes) > 1 or name == "multi"
    tel, n = servers[0].telemetry, 5 * 8
    assert tel.value("serve.retire_passes") == len(passes)
    assert tel.value("serve.retired_slots") == sum(
        np.asarray(r[0]).size // n for r in got["results"].values())


@pytest.mark.parametrize("name", SCENARIOS[:2] + SCENARIOS[4:6])
def test_mesh_server_equals_one_device(ref, name):
    """D devices are one device: the same workload without a mesh gives
    every job's result bit for bit (placement differs, results do not)."""
    P = _pkg("port")
    rung = name[-2:]
    kw = dict(capacities=None) if name.startswith("sharded") else dict(policy="backfill")
    model = P.ising.random_layered_model(n=5, L=8, seed=1, beta=1.0)
    srv = P.SampleServer(model, slots=8, chunk_sweeps=2, rung=rung, **kw, **P.kw)
    for s, b in [(10, 3), (11, 7), (12, 5), (13, 4), (14, 9)]:
        srv.submit(P.AnnealJob.constant(seed=s, sweeps=b, beta=1.0))
    srv.submit(P.PTJob(seed=5, betas=np.linspace(0.5, 1.5, 6).astype(np.float32),
                       num_rounds=3, sweeps_per_round=2))
    one = {r.jid: (r.spins, r.energy) for r in srv.drain()}
    want = {j: v[:2] for j, v in ref[name]["results"].items()}
    _assert_results_equal(one, want, name)


@pytest.mark.parametrize("restore", list(RESTORES))
def test_a_jax_mesh_snapshot_finishes_in_the_port(ref, restore):
    d, caps = RESTORES[restore]
    P = _pkg("port")
    srv = P.restore_server(ref["jax_snap_dir"], mesh=P.mesh(d) if d else None, capacities=caps,
                           backend="torch", device="cpu")
    assert srv.devices == (d or 1)
    results, _ = _drain(srv)
    got = {r.jid: (np.asarray(r.spins), np.asarray(r.energy)) for r in results}
    want = {j: v[:2] for j, v in ref["snapshot"]["results"].items()}
    _assert_results_equal(got, want, f"JAX snapshot onto {restore}")


@pytest.mark.parametrize("restore", list(RESTORES))
def test_a_port_mesh_snapshot_finishes_in_the_reference(ref, restore):
    want = {j: v[:2] for j, v in ref["port_snapshot_want"]["results"].items()}
    _assert_results_equal(ref["restore_port"][restore], want, f"port snapshot onto {restore}")
    assert ref["restore_port"][restore + "/devices"] == (RESTORES[restore][0] or 1)
    # The port's own uninterrupted run is the reference's, too.
    _assert_results_equal(want, {j: v[:2] for j, v in ref["snapshot"]["results"].items()},
                          "uninterrupted")


def test_cli_devices_equals_the_references(ref):
    got = {r.jid: (np.asarray(r.spins), np.asarray(r.energy)) for r in _pkg("port").cli(CLI)}
    assert len(got) == 9  # 8 anneal jobs and the PT ladder
    _assert_results_equal(got, ref["cli"], "--devices 4")


if __name__ == "__main__":
    sys.path.insert(0, _SRC)
    _child(sys.argv[1], sys.argv[2])
