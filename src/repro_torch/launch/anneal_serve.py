"""Annealing-as-a-service CLI: a job mix through one resident SampleServer.

Packs annealing jobs (seed + beta schedule + sweep budget) and, with
``--pt-replicas R``, one parallel-tempering job of R slots into the
replica batch of ONE resident `SweepEngine`, advancing everyone by fused
chunks — one launch of a multisweep CUDA kernel per chunk: the colored
kernel for ``--rung cb`` (the default), the paper's sequential a4 kernel
for ``--rung a4`` — and retiring/admitting between chunks.  The paper's
slower rungs ``--rung a1|a2|a3`` have no kernel: they serve only with the
plain version, ``--backend torch`` (the default off the card; on a CUDA
device it must be asked for).

  PYTHONPATH=src python -m repro_torch.launch.anneal_serve            # on the card
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve --rung a4  # a4, on the card
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve \\
      --device cpu --jobs 8 --slots 4 --chunk 4 --n 8 --L 16 --V 4 [--rung a4]
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve \\
      --rung a2 --device cpu --jobs 4 --slots 2 --n 8 --L 16
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve \\
      --device cpu --jobs 4 --slots 4 --n 8 --L 16 --V 4 --pt-replicas 3 --pt-rounds 3

``--device cpu`` serves with the plain PyTorch version (``--backend``
defaults to ``cuda`` on a CUDA device and to ``torch`` elsewhere).
Admission defaults to the weighted-fair priority scheduler
(``--policy fair``); results are bit-identical under every policy.
``--trace PATH`` writes the run's Chrome-trace-event JSON; ``--metrics``
prints the Prometheus text exposition of the server's registry.

``--pt-replicas R`` adds one `PTJob` to the mix: betas
``linspace(0.4, --beta, R)``, seed ``--seed + 77``, ``--pt-rounds`` rounds
(default 4) of ``max(1, --chunk // 2)`` sweeps, priority 1, user
"ladder"; the server needs at least R slots.  The report marks it
``[pt]``.

CRASH SAFETY: ``--snapshot-dir DIR`` arms whole-server snapshots —
``--snapshot-every K`` writes one every K sweeps off the serving path, and
SIGTERM triggers a graceful drain (finish the in-flight chunk, snapshot,
return).  ``--resume`` restores the newest valid snapshot from DIR (the
JAX reference CLI's included) and finishes its recorded jobs instead of
submitting a fresh mix; results are bit-identical to the uninterrupted
run.  ``--smoke`` runs the reference's smoke workload through the whole
cycle: 7 anneal jobs and a 3-replica PT job on 4 slots, chunks of 4,
budgets 4-24, a snapshot every 16 sweeps, trace and metrics on; it serves
until one snapshot has landed and one job has retired, abandons the
server (a kill: no goodbye snapshot), restores from the snapshot and
finishes, printing ``smoke:`` lines.  With ``--device cpu`` it serves the
reference's shape (n=8, L=16, V=4, backend torch), so its results equal
``python -m repro.launch.anneal_serve --smoke`` job for job; on the card
it serves n=8, L=256, V=128 on backend cuda.

MESH: ``--devices D`` lays the slot pool out over the first D visible
devices of ``--device`` (`launch.mesh.make_slot_mesh`): D cards, or with
``--device cpu`` D logical host devices.  Each chunk launches once per
device; results are bit-identical to one device.  More devices than are
visible raise the reference's ``"D devices requested, n visible"``.

  PYTHONPATH=src python -m repro_torch.launch.anneal_serve --smoke             # on the card
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve \
      --snapshot-dir snaps --snapshot-every 16 [--resume]
  PYTHONPATH=src python -m repro_torch.launch.anneal_serve --device cpu --devices 4 \
      --jobs 8 --slots 8 --chunk 4 --n 8 --L 16 --V 4
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import NamedTuple

import numpy as np

from repro_torch.core import ising
from repro_torch.launch.mesh import make_slot_mesh
from repro_torch.runtime.ft import PreemptionHandler
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer


class ServeReport(NamedTuple):
    """What one CLI run served: the results, the drained server, the
    model it served and the drain's wall seconds (synchronized)."""

    results: list
    server: SampleServer
    model: ising.LayeredModel
    seconds: float


def build_job_mix(args) -> list:
    """A deterministic workload: constant-beta jobs with scattered budgets,
    every 4th job a linear beta ramp, three users, every 5th job expedited
    (priority 1), plus one PT job when ``--pt-replicas`` > 0."""
    rng = np.random.default_rng(args.seed)
    jobs = []
    for i in range(args.jobs):
        budget = int(rng.integers(args.budget_min, args.budget_max + 1))
        user = f"user{i % 3}"
        priority = 1 if i % 5 == 4 else 0
        if i % 4 == 3:
            steps = max(2, budget // max(1, args.chunk))
            jobs.append(
                AnnealJob.ramp(
                    seed=args.seed * 1000 + i,
                    beta_start=0.3,
                    beta_end=float(args.beta),
                    steps=steps,
                    sweeps_per_step=max(1, budget // steps),
                    user=user,
                    priority=priority,
                )
            )
        else:
            jobs.append(
                AnnealJob.constant(
                    seed=args.seed * 1000 + i,
                    sweeps=budget,
                    beta=float(rng.uniform(0.5, 1.5)),
                    user=user,
                    priority=priority,
                )
            )
    if args.pt_replicas > 0:
        betas = np.linspace(0.4, args.beta, args.pt_replicas).astype(np.float32)
        jobs.append(
            PTJob(
                seed=args.seed + 77,
                betas=betas,
                num_rounds=args.pt_rounds,
                sweeps_per_round=max(1, args.chunk // 2),
                user="ladder",
                priority=1,  # the wide job: exercises preemption/backfill
            )
        )
    return jobs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"],
                    help="cuda = the hand-written kernel, torch = the plain "
                         "version; default cuda on a CUDA device, else torch")
    ap.add_argument("--rung", default="cb",
                    help="sweep rung: cb (graph-colored, the default), a4 (the "
                         "paper's sequential order) or the paper's slower rungs "
                         "a1-a3 (plain version only: --backend torch, the "
                         "default off the card)")
    ap.add_argument("--policy", default="fair", choices=["fifo", "backfill", "fair"])
    ap.add_argument("--V", type=int, default=128)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--L", type=int, default=256)
    ap.add_argument("--beta", type=float, default=1.2)
    ap.add_argument("--budget-min", type=int, default=8)
    ap.add_argument("--budget-max", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace-event JSON of the run")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus text exposition after the drain")
    ap.add_argument("--quiet", action="store_true", help="print nothing")
    ap.add_argument("--pt-replicas", type=int, default=0,
                    help="add one parallel-tempering job of this many replicas (slots)")
    ap.add_argument("--pt-rounds", type=int, default=4,
                    help="rounds of the PT job (each max(1, --chunk // 2) sweeps)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke workload through serve -> snapshot -> kill -> restore")
    ap.add_argument("--snapshot-dir", metavar="DIR", default=None,
                    help="arm crash safety: periodic snapshots land here and SIGTERM "
                         "drains gracefully (finish the chunk, snapshot, return)")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                    help="write a background snapshot every K sweeps (0 = only on "
                         "SIGTERM; needs --snapshot-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid snapshot from --snapshot-dir and "
                         "finish its recorded jobs instead of submitting a fresh mix")
    ap.add_argument("--devices", type=int, default=0,
                    help="lay the slot pool out over this many devices of --device "
                         "(a ('data',) slot mesh); 0 = one device, no mesh. Results "
                         "are bit-identical either way")
    args = ap.parse_args(argv)
    on_card = args.device.startswith("cuda")
    if args.backend is None:
        args.backend = "cuda" if on_card else "torch"
    if args.smoke:
        # 7 anneal jobs + 1 three-replica PT job = 8 jobs on 4 slots.
        args.jobs, args.slots, args.chunk = 7, 4, 4
        args.n, args.L, args.V = (8, 256, 128) if on_card else (8, 16, 4)
        args.budget_min, args.budget_max = 4, 24
        args.pt_replicas, args.pt_rounds = 3, 3
        if args.trace is None:
            args.trace = "serve_smoke_trace.json"
        args.metrics = True
        if args.snapshot_every == 0:
            args.snapshot_every = 16  # at least one periodic snapshot before the "crash"
    if args.resume and args.snapshot_dir is None:
        ap.error("--resume needs --snapshot-dir")
    if args.snapshot_every and args.snapshot_dir is None and not args.smoke:
        ap.error("--snapshot-every needs --snapshot-dir")
    if args.rung in ("a1", "a2", "a3") and args.backend != "torch":
        raise ValueError(
            f"--rung {args.rung} has no kernel: it serves with the plain version only; "
            "pass --backend torch"
        )
    return args


def main(argv=None) -> ServeReport:
    args = parse_args(argv)
    snap_tmp = None
    snap_dir = args.snapshot_dir
    if args.smoke and snap_dir is None:
        snap_tmp = tempfile.TemporaryDirectory(prefix="serve_smoke_snap_")
        snap_dir = snap_tmp.name
    # SIGTERM -> graceful drain, while this call serves.
    preemption = PreemptionHandler() if snap_dir is not None else None
    mesh = make_slot_mesh(args.devices, device=args.device) if args.devices > 0 else None
    try:
        return _serve(args, snap_dir, preemption, mesh)
    finally:
        if preemption is not None:
            preemption.uninstall()
        if snap_tmp is not None:
            snap_tmp.cleanup()


def _smoke_cycle(server, say, restore):
    """Serve until a periodic snapshot has landed and a job has retired,
    abandon the server (a stand-in for SIGKILL: no goodbye snapshot),
    restore from the snapshot and finish.  Returns (results, server)."""
    pre = []
    while len(server.policy) or server._active:
        pre.extend(server.step())
        server.wait_snapshots()
        if server.snapshot_manager.latest_step() is not None and pre:
            break
    if not (len(server.policy) or server._active):
        return pre, server
    say(
        f"smoke: simulated crash at {server.sweeps_elapsed} sweeps ({len(pre)} jobs "
        f"already retired, last snapshot at sweep {server.snapshot_manager.latest_step()})"
    )
    del server  # the "kill": in-flight state is gone
    server = restore()
    post = server.drain()
    # Jobs retired between the snapshot and the crash are re-run by the
    # restored server; their results are bit-identical, keep one per jid.
    by_jid = {r.jid: r for r in pre}
    by_jid.update({r.jid: r for r in post})
    say(f"smoke: resumed from snapshot, {len(post)} jobs finished after restore")
    return [by_jid[j] for j in sorted(by_jid)], server


def _serve(args, snap_dir, preemption, mesh) -> ServeReport:
    say = (lambda *a, **k: None) if args.quiet else print

    def restore():
        return SampleServer.restore(
            snap_dir,
            backend=args.backend,
            device=args.device,
            mesh=mesh,
            snapshot_every_sweeps=args.snapshot_every or None,
            preemption=preemption,
        )

    if args.resume:
        server = restore()
        model = server.engine.model
        jobs = []  # the snapshot's recorded jobs are the workload
        say(
            f"resumed from {snap_dir} at {server.sweeps_elapsed} sweeps "
            f"({len(server.policy)} queued, {len(server._active)} active, "
            f"{len(server._retired)} already retired; backend={args.backend}, "
            f"device={args.device})"
        )
    else:
        model = ising.random_layered_model(n=args.n, L=args.L, seed=args.seed, beta=args.beta)
        server = SampleServer(
            model,
            slots=args.slots,
            chunk_sweeps=args.chunk,
            rung=args.rung,
            backend=args.backend,
            V=args.V,
            device=args.device,
            policy=args.policy,
            mesh=mesh,
            snapshot_manager=snap_dir,
            snapshot_every_sweeps=args.snapshot_every if snap_dir else 0,
            preemption=preemption,
        )
        jobs = build_job_mix(args)
        for job in jobs:
            server.submit(job)
        snp = f", snapshots every {args.snapshot_every} sweeps -> {snap_dir}" if snap_dir else ""
        dev = f", mesh={args.devices} devices" if mesh is not None else ""
        say(
            f"serving {len(jobs)} jobs on {args.slots} slots (chunk={args.chunk} "
            f"sweeps, backend={args.backend}, device={args.device}, "
            f"policy={args.policy}, model n={args.n} L={args.L} V={args.V}{dev}{snp})"
        )
    t0 = time.perf_counter()
    if args.smoke and not args.resume:
        results, server = _smoke_cycle(server, say, restore)
    else:
        results = server.drain()
    if server.engine.device.type == "cuda":
        import torch

        for dev in {str(d) for d in (server.engine.mesh or (server.engine.device,))}:
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if server.preempted:
        say(
            f"preempted: drained gracefully after {len(results)} jobs, snapshot at step "
            f"{server.snapshot_manager.latest_step()} in {snap_dir} (resume with --resume)"
        )
        return ServeReport(results, server, model, dt)
    if jobs and len(results) != len(jobs):
        raise RuntimeError(f"served {len(results)} of {len(jobs)} jobs")

    shown = sorted(results, key=lambda r: r.jid)
    for r in shown[:8] + [r for r in shown[8:] if r.spins.ndim == 2]:
        e = r.energy if np.ndim(r.energy) == 0 else float(np.min(r.energy))
        kind = "pt" if r.spins.ndim == 2 else "anneal"
        say(
            f"  job {r.jid:3d} [{kind}] {r.sweeps_done:4d} sweeps in {r.chunks:3d} chunks  "
            f"E={e:9.2f}  m={np.mean(r.magnetization):+.3f}"
        )
    st = server.stats()
    say(
        f"served {len(results)} jobs in {dt:.3f}s: {len(results) / dt:.1f} jobs/s, "
        f"{st['busy_slot_sweeps'] / dt:.0f} sweeps/s, "
        f"{st['spin_flips'] / dt / 1e6:.2f}M spin-flips/s, "
        f"{st['launches']} launches, utilization {st['utilization']:.0%} "
        f"({st['useful_slot_sweeps']} useful / "
        f"{st['idle_resweep_slot_sweeps']} idle-resweep slot-sweeps), "
        f"{st['preemptions']} preemptions"
    )
    qw = st["queue_wait"]["overall"]
    if qw["count"]:
        say(f"queue wait p50={qw['p50_s'] * 1e3:.0f}ms p95={qw['p95_s'] * 1e3:.0f}ms")
    if args.trace:
        from repro_torch.obs.trace import validate_events

        path = server.telemetry.write_chrome_trace(args.trace)
        trace = server.telemetry.chrome_trace()
        validate_events(trace["traceEvents"])  # a broken trace fails the run
        say(f"trace: {len(trace['traceEvents'])} events -> {path}")
    if args.metrics:
        say("-- metrics (Prometheus text exposition) --")
        say(server.telemetry.prometheus_text(), end="")
    return ServeReport(results, server, model, dt)


if __name__ == "__main__":
    main()
