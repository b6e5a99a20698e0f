"""The port's host observables against the JAX reference's, bit for bit.

`repro_torch.core.observables` evaluates a batch in row blocks of float64
workspaces (`observables.BLOCK_SPINS`).  Each row's energy and
magnetization must keep the bits of the reference's stacked call
(`repro.core.observables`), compared as int64 patterns: stacks of the
paper's shape (96 x 256) as a retirement pass makes them, a CPU rehearsal
shape, a tenant's couplings (`reseed_couplings`), one (N,) configuration,
spins off +-1, and block heights from one row to the whole stack.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import ising as jis
from repro.core import observables as jobs
from repro_torch.core import convert, observables

PAPER, REHEARSAL = (96, 256), (8, 16)

#: name -> ((n, L), rows (None: one (N,) configuration), spins, tenant seed)
CASES = {
    "paper-1": (PAPER, 1, "pm1", None),
    "paper-7": (PAPER, 7, "pm1", None),
    "paper-115": (PAPER, 115, "pm1", None),
    "paper-180": (PAPER, 180, "pm1", None),
    "rehearsal-6": (REHEARSAL, 6, "pm1", None),
    "rehearsal-300": (REHEARSAL, 300, "pm1", None),
    "tenant-rehearsal": (REHEARSAL, 40, "pm1", 21),
    "tenant-paper": (PAPER, 5, "pm1", 22),
    "one-config-paper": (PAPER, None, "pm1", None),
    "one-config-rehearsal": (REHEARSAL, None, "normal", None),
    "off-pm1-paper": (PAPER, 4, "normal", None),
    "off-pm1-rehearsal": (REHEARSAL, 50, "normal", None),
    "int8-rehearsal": (REHEARSAL, 9, "int8", None),
}


def _models(n, L, tenant):
    jm = jis.random_layered_model(n=n, L=L, seed=0, beta=1.0)
    if tenant is not None:
        jm = jis.reseed_couplings(jm, tenant)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _spins(n, L, rows, kind, seed=5):
    rng = np.random.default_rng(seed)
    shape = (n * L,) if rows is None else (rows, n * L)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    s = np.where(rng.random(shape) < 0.5, -1, 1)
    return s.astype(np.int8 if kind == "int8" else np.float32)


def _same_bits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("name", list(CASES))
def test_observables_equal_the_references_bit_for_bit(name):
    (n, L), rows, kind, tenant = CASES[name]
    jm, tm = _models(n, L, tenant)
    s = _spins(n, L, rows, kind)
    e, want_e = observables.energies(tm, s), jobs.energies(jm, s)
    m, want_m = observables.magnetization(s), jobs.magnetization(s)
    assert type(e) is type(want_e) and type(m) is type(want_m)
    if rows is None:
        assert type(e) is float and type(m) is float
    assert _same_bits(e, want_e) and _same_bits(m, want_m)


@pytest.mark.parametrize("block", [1, 4, 16, 1000])
@pytest.mark.parametrize("shape", [PAPER, REHEARSAL], ids=["paper", "rehearsal"])
def test_a_rows_bits_do_not_depend_on_its_block(monkeypatch, shape, block):
    """The same stack at blocks of 1, 4, 16 and all rows: every row equals
    the reference's stacked call and the row evaluated alone."""
    n, L = shape
    jm, tm = _models(n, L, None)
    s = _spins(n, L, 20, "pm1", seed=9)
    monkeypatch.setattr(observables, "BLOCK_SPINS", block * n * L)
    e, m = observables.energies(tm, s), observables.magnetization(s)
    assert _same_bits(e, jobs.energies(jm, s)) and _same_bits(m, jobs.magnetization(s))
    alone = [jobs.energies(jm, row) for row in s[:3]]
    assert _same_bits(e[:3], alone)


def test_energies_refuse_a_neighbour_indexing_refuses():
    _, tm = _models(*REHEARSAL, None)
    bad = dataclasses.replace(tm, space_nbr=tm.space_nbr + tm.n)
    with pytest.raises(IndexError):
        observables.energies(bad, _spins(*REHEARSAL, 2, "pm1"))
