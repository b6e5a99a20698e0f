"""Path-integral QMC context for the layered models (paper §1, refs [15][16]).

The paper's Ising models arise from Suzuki-Trotter decomposition of a
transverse-field Ising Hamiltonian: L identical "Trotter slices" of the
problem graph, coupled spin-to-spin between adjacent slices.  The tau
coupling strength follows from the transverse field Gamma:

    K_tau = (1/2) ln coth(beta * Gamma / L)        (dimensionless, per slice)
    J_tau = K_tau / beta                           (energy units)

As Gamma -> 0 the slices lock together (J_tau -> inf); as Gamma grows the
slices decouple.  ``anneal_schedule`` produces the (Gamma, beta) ladder used
by the quantum-annealing example (`repro_torch.examples.quantum_annealing`).
Plain numpy over the port's `ising`, equal to the JAX package's module.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import ising


def tau_coupling(beta: float, gamma: float, L: int) -> float:
    """J_tau in energy units for transverse field ``gamma`` at inverse
    temperature ``beta`` with ``L`` Trotter slices."""
    x = beta * gamma / L
    if x <= 0:
        raise ValueError("beta * gamma must be positive")
    k_tau = 0.5 * math.log(1.0 / math.tanh(x))
    return k_tau / beta


@dataclasses.dataclass(frozen=True)
class QMCProblem:
    """A transverse-field Ising problem to be simulated by PIMC."""

    h: np.ndarray  # (n,) fields of the problem Hamiltonian
    space_nbr: np.ndarray  # (n, SD)
    space_J: np.ndarray  # (n, SD)
    L: int  # Trotter slices

    def layered_model(self, beta: float, gamma: float) -> ising.LayeredModel:
        """Instantiate the classical layered model for one (beta, gamma).

        Per Suzuki-Trotter, classical couplings/fields are scaled by 1/L and
        the tau coupling comes from ``tau_coupling``.  The sweep then operates
        on the classical cost directly (beta enters through the model's beta).
        """
        n = self.h.shape[0]
        jt = tau_coupling(beta, gamma, self.L)
        return ising.LayeredModel(
            n=n,
            L=self.L,
            h=(self.h / self.L).astype(np.float32),
            space_nbr=self.space_nbr,
            space_J=(self.space_J / self.L).astype(np.float32),
            tau_J=np.full((n,), jt, dtype=np.float32),
            beta=float(beta),
        )


def random_problem(n: int, L: int, *, seed: int = 0, degree: int = 5) -> QMCProblem:
    base = ising.random_layered_model(n, L, seed=seed, target_degree=degree)
    return QMCProblem(h=base.h, space_nbr=base.space_nbr, space_J=base.space_J, L=L)


def anneal_schedule(
    num_steps: int,
    *,
    gamma_start: float = 3.0,
    gamma_end: float = 0.05,
    beta: float = 2.0,
) -> list:
    """Linear transverse-field ramp, the standard simulated-quantum-annealing
    schedule (paper context: AQUA@Home quantum annealing simulations)."""
    gammas = np.linspace(gamma_start, gamma_end, num_steps)
    return [(float(beta), float(g)) for g in gammas]
