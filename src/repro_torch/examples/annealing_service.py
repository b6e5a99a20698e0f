"""Sampling-as-a-service: one resident engine, many users' jobs.

Submits a mixed workload to a `SampleServer` — constant-temperature
sampling jobs (one over a tenant's OWN spin-glass instance), an annealing
ramp, and a whole parallel-tempering ladder as one multi-slot job — and
drains it.  Every chunk of sweeps advances ALL resident jobs as one
launch (on the card, of the multi-tenant colored kernel
kernels/csrc/colored_multisweep_multi.cu); jobs retire and admit between
chunks.  Sweeps run the graph-colored "cb" rung, the serving default.

Admission runs the weighted-fair priority policy: mid-drain an URGENT
wide ladder arrives and checkpoint-preempts running low-priority jobs —
their slots are parked bit-exactly and resumed when the urgent work
retires, so the preempted jobs lose placement time but not one sweep.

On the CPU (``--device cpu``) the server takes the reference example's
shape (n=12 L=16, V=4, backend torch); on the card backend cuda at V=128,
with L raised to 256 because the lane layout needs L % (2 * 128) == 0.

  PYTHONPATH=src python -m repro_torch.examples.annealing_service              # on the card
  PYTHONPATH=src python -m repro_torch.examples.annealing_service --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.core import ising
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        L, V, backend = 256, 128, "cuda"
    else:
        L, V, backend = 16, 4, "torch"
    model = ising.random_layered_model(n=12, L=L, seed=3, beta=1.2)
    server = SampleServer(model, slots=6, chunk_sweeps=4, backend=backend, V=V,
                          device=args.device, rung="cb", multi_tenant=True, policy="fair",
                          user_weights={"alice": 2.0})

    print(f"model: {model.num_spins} spins; server: {server.slots} slots, "
          f"policy={server.policy.name}")
    if args.device == "cuda":  # the reference's shape does not fit the lane layout
        print(f"shape: n={model.n} L={model.L} V={V}, backend={backend}")
    # Three users sampling at their own temperatures — one of them over
    # their OWN instance (same lattice, different couplings/fields):
    tenant_model = ising.reseed_couplings(model, seed=42)
    for user, seed, beta, m_user in [
        ("alice", 10, 0.8, None),
        ("bob", 11, 1.2, tenant_model),
        ("carol", 12, 1.6, None),
    ]:
        jid = server.submit(
            AnnealJob.constant(seed=seed, sweeps=24, beta=beta, model=m_user, user=user)
        )
        tag = " (own model)" if m_user is not None else ""
        print(f"  submitted job {jid}: {user}, constant beta={beta}{tag}")
    # ...one annealing from hot to cold...
    jid = server.submit(
        AnnealJob.ramp(seed=20, beta_start=0.3, beta_end=2.0, steps=6,
                       sweeps_per_step=4, user="alice")
    )
    print(f"  submitted job {jid}: alice, ramp 0.3 -> 2.0")
    # ...and one whole tempering ladder occupying 4 slots.
    pt = PTJob(seed=30, betas=np.linspace(0.5, 1.5, 4), num_rounds=6,
               sweeps_per_round=2, user="bob")
    jid = server.submit(pt)
    print(f"  submitted job {jid}: bob, 4-replica PT ladder, 6 rounds")

    t0 = time.perf_counter()
    results = server.step()  # a few chunks in, every slot is occupied...
    results += server.step()
    # ...when an URGENT wide ladder arrives: priority 2 outranks all the
    # resident work, so the fair policy checkpoint-preempts enough
    # low-priority slots to start it NOW (they resume bit-exactly later).
    urgent = PTJob(seed=40, betas=np.linspace(0.6, 1.4, 4), num_rounds=2,
                   sweeps_per_round=2, user="dave", priority=2)
    server.submit(urgent)
    print(f"  submitted job {urgent.jid}: dave, URGENT 4-replica ladder "
          "(priority 2) — watch the preemptions")
    results += server.drain()
    dt = time.perf_counter() - t0

    for r in sorted(results, key=lambda r: r.jid):
        pre = (f", preempted x{r.extras['preemptions']}"
               if r.extras.get("preemptions") else "")
        if np.ndim(r.spins) == 2:  # tempering job: per-replica results
            acc = r.extras["swap_accept"] / max(1, r.extras["swap_propose"])
            print(f"  job {r.jid} [pt]     E_min={np.min(r.energy):9.2f} "
                  f"swap-accept {acc:.0%}{pre}")
        else:
            print(f"  job {r.jid} [anneal] E={r.energy:9.2f} "
                  f"m={r.magnetization:+.3f} "
                  f"beta={r.extras['final_beta']:.2f}{pre}")
    st = server.stats()
    qw = st["queue_wait"]["by_user"]
    print(f"drained in {dt:.2f}s: {st['launches']} launches, "
          f"utilization {st['utilization']:.0%}, "
          f"{st['preemptions']} preemptions, "
          f"{st['spin_flips'] / dt / 1e3:.0f}k spin-flips/s")
    print("  queue wait p95 by user: "
          + ", ".join(f"{u}={agg['p95_s'] * 1e3:.0f}ms"
                      for u, agg in sorted(qw.items())))
    # The urgent ladder must have jumped the whole backlog.
    assert urgent.preemptions == 0 and st["preemptions"] > 0
    assert len(results) == 6
    return results, server


if __name__ == "__main__":
    main()
