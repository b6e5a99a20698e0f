"""Parallel tempering across a temperature ladder (paper §1 context).

Runs replicas of one Ising model at a ladder of temperatures with periodic
adjacent-temperature swap proposals (the paper's 115-model production
setup, scaled down), showing that tempering finds lower energies than
independent quenches.

Replicas are the SweepEngine's batch dimension, so the sweep phase of each
round is one batched engine call; with ``--backend cuda`` (the default on
the card) it is one launch of the fused a4 kernel
(kernels/csrc/metropolis_multisweep.cu) at the reference's kernel shape,
n=8 L=256 V=128.  ``--device cpu`` runs the reference's jnp shape (n=16
L=16 V=4) on the plain backend.

  PYTHONPATH=src python -m repro_torch.examples.parallel_tempering              # on the card
  PYTHONPATH=src python -m repro_torch.examples.parallel_tempering --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import ising, metropolis, tempering


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("cuda", "torch"), default=None,
                    help="cuda = the kernel (the default on the card), torch = the "
                         "plain version (the default on the CPU)")
    args = ap.parse_args(argv)
    backend = args.backend or ("cuda" if args.device == "cuda" else "torch")

    if backend == "cuda":
        # The kernel's lane layout needs L to be a multiple of 2 * 128 lanes.
        m = ising.random_layered_model(n=8, L=256, seed=3, beta=1.0)
        V, rounds, quench_v = 128, 10, 128
    else:
        m = ising.random_layered_model(n=16, L=16, seed=3, beta=1.0)
        V, rounds, quench_v = 4, 30, 4
    betas = np.geomspace(0.2, 4.0, 10)

    state, energies = tempering.run_parallel_tempering(
        m, betas, num_rounds=rounds, V=V, seed=0, sweeps_per_round=2,
        backend=backend, device=args.device,
    )
    acc = int(state.swap_accept)
    prop = int(state.swap_propose)
    cold_slot = int(state.betas.cpu().numpy().argmax())
    print(f"backend: {backend} ({len(betas)} replicas batched per round)")
    print(f"swap acceptance: {acc}/{prop} = {acc/max(prop,1):.2%}")
    print(f"energies per slot: {np.round(energies, 1)}")
    print(f"coldest replica energy: {energies[cold_slot]:.2f}")

    # Baseline: independent quench at the coldest temperature only.
    mq = ising.random_layered_model(n=m.n, L=m.L, seed=3, beta=float(betas[-1]))
    sq = ising.init_spins(mq, seed=0)
    sq, _ = metropolis.run_sweeps(mq, sq, "a4", 2 * rounds, seed=1, V=quench_v,
                                  device=args.device)
    e_quench = ising.energy(mq, sq)
    print(f"independent quench at beta={betas[-1]:.1f}: {e_quench:.2f}")
    print("tempering <= quench + tolerance:",
          energies[cold_slot] <= e_quench + abs(e_quench) * 0.1)
    return state, energies


if __name__ == "__main__":
    main()
