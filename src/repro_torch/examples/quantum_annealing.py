"""Simulated quantum annealing — the paper's production context (AQUA@Home).

Path-integral QMC of a transverse-field Ising problem: the transverse field
Gamma anneals down while the layered classical model (L Trotter slices) is
swept with the vectorized a4 Metropolis sweep (the `run_sweeps` shim, as
the reference drives it).  The final layer-majority state is the
annealer's answer; its problem energy is compared against random
assignments.

  PYTHONPATH=src python -m repro_torch.examples.quantum_annealing              # on the card
  PYTHONPATH=src python -m repro_torch.examples.quantum_annealing --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import ising, metropolis, qmc


def problem_energy(pb: qmc.QMCProblem, assign: np.ndarray) -> float:
    e = -float(np.sum(pb.h * assign))
    for d in range(pb.space_nbr.shape[1]):
        e -= 0.5 * float(np.sum(pb.space_J[:, d] * assign * assign[pb.space_nbr[:, d]]))
    return e


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    pb = qmc.random_problem(n=24, L=32, seed=7)
    beta = 2.0
    spins = ising.init_spins(pb.layered_model(beta, 3.0), seed=0)

    print("annealing Gamma 3.0 -> 0.05 over 12 steps, 4 sweeps each")
    for step, (b, gamma) in enumerate(qmc.anneal_schedule(12, beta=beta)):
        m = pb.layered_model(b, gamma)
        spins, _ = metropolis.run_sweeps(m, spins, "a4", 4, seed=100 + step, V=4,
                                         device=args.device)
        if step % 3 == 0:
            e = ising.energy(m, spins)
            print(f"  step {step:2d} Gamma={gamma:5.2f} J_tau={m.tau_J[0]:6.3f} "
                  f"layered energy {e:9.2f}")

    # Project: majority vote across Trotter slices.
    layers = spins.reshape(pb.L, -1)
    assign = np.where(layers.mean(axis=0) >= 0, 1.0, -1.0).astype(np.float32)
    e_anneal = problem_energy(pb, assign)
    rng = np.random.default_rng(0)
    e_random = np.mean([
        problem_energy(pb, rng.choice([-1.0, 1.0], size=pb.h.shape[0]))
        for _ in range(200)
    ])
    print(f"problem energy: annealed {e_anneal:.2f} vs random mean {e_random:.2f}")
    assert e_anneal < e_random, "annealing should beat random assignment"
    print("OK: annealed state beats random baseline")
    return spins


if __name__ == "__main__":
    main()
