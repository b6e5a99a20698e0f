"""`repro_torch.core.qmc` (the path-integral QMC context) equals the
reference's `repro.core.qmc`: the tau coupling, the layered model of a
(beta, Gamma) pair field by field, the random problem and the anneal
schedule; the refusal of a non-positive beta * Gamma too."""

import dataclasses

import numpy as np
import pytest

from repro.core import qmc as jqmc
from repro_torch.core import ising, qmc


@pytest.mark.parametrize("beta,gamma,L", [(2.0, 3.0, 32), (0.5, 0.05, 16), (1.0, 1.0, 1),
                                          (4.0, 10.0, 256)])
def test_tau_coupling_equals_the_references(beta, gamma, L):
    assert qmc.tau_coupling(beta, gamma, L) == jqmc.tau_coupling(beta, gamma, L)


def test_tau_coupling_refusal():
    for args in ((0.0, 1.0, 8), (1.0, -1.0, 8)):
        with pytest.raises(ValueError, match="must be positive"):
            qmc.tau_coupling(*args)
        with pytest.raises(ValueError, match="must be positive"):
            jqmc.tau_coupling(*args)


@pytest.mark.parametrize("n,L,seed,degree", [(24, 32, 7, 5), (6, 256, 1, 3), (96, 8, 2, 6)])
def test_problem_and_layered_model_equal_the_references(n, L, seed, degree):
    pb = qmc.random_problem(n=n, L=L, seed=seed, degree=degree)
    jpb = jqmc.random_problem(n=n, L=L, seed=seed, degree=degree)
    for f in ("h", "space_nbr", "space_J"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(jpb, f))
    assert pb.L == jpb.L
    for beta, gamma in [(2.0, 3.0), (2.0, 0.05), (0.7, 1.3)]:
        m, jm = pb.layered_model(beta, gamma), jpb.layered_model(beta, gamma)
        assert isinstance(m, ising.LayeredModel)
        for f in dataclasses.fields(m):
            a, b = getattr(m, f.name), getattr(jm, f.name)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


@pytest.mark.parametrize("kw", [dict(num_steps=12, beta=2.0), dict(num_steps=1),
                                dict(num_steps=5, gamma_start=1.0, gamma_end=0.5, beta=0.3)])
def test_anneal_schedule_equals_the_references(kw):
    assert qmc.anneal_schedule(**kw) == jqmc.anneal_schedule(**kw)
