"""The port's model tables, lane layout, color classes, fields and
observables against the JAX reference, array for array.

Shapes cover lpv = L/V in {2, 3, 4}: lpv=2 makes every row a section
wrap row, lpv=3 needs a third cycle color.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import ising as jis
from repro.core import metropolis as jmp
from repro.core import observables as jobs
from repro.core import reorder as jro
from repro_torch.core import convert, ising, metropolis, observables, reorder

V = 4
CASES = [(5, 2 * V), (6, 3 * V), (7, 4 * V)]  # (n, L) with lpv = 2, 3, 4
IDS = ["lpv2", "lpv3", "lpv4"]


def _models(n, L, seed=3):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=1.3)
    tm = ising.random_layered_model(n=n, L=L, seed=seed, beta=1.3)
    return jm, tm


def _spins(n, L, B, seed=11):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((B, n * L)) < 0.5, -1.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("n,L", CASES, ids=IDS)
def test_random_model_and_init_spins_match(n, L):
    jm, tm = _models(n, L)
    for f in ("h", "space_nbr", "space_J", "tau_J"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f), err_msg=f)
    assert (jm.n, jm.L, jm.beta) == (tm.n, tm.L, tm.beta)
    np.testing.assert_array_equal(jis.init_spins(jm, 9), ising.init_spins(tm, 9))
    # convert round-trips the model's arrays exactly.
    back = convert.model_from_arrays(convert.model_to_arrays(tm))
    via_ref = convert.model_from_arrays(dataclasses.asdict(jm))
    for f in ("h", "space_nbr", "space_J", "tau_J"):
        np.testing.assert_array_equal(getattr(back, f), getattr(tm, f))
        np.testing.assert_array_equal(getattr(via_ref, f), getattr(tm, f))


@pytest.mark.parametrize("n,L", CASES, ids=IDS)
def test_fields_and_energy_match(n, L):
    jm, tm = _models(n, L)
    s = _spins(n, L, 1)[0]
    for a, b in zip(jis.h_eff_from_scratch(jm, s), ising.h_eff_from_scratch(tm, s)):
        np.testing.assert_array_equal(a, b)
    assert jis.energy(jm, s) == ising.energy(tm, s)


@pytest.mark.parametrize("n,L", CASES, ids=IDS)
def test_lane_layout_matches_and_round_trips(n, L):
    rows = reorder.check_lane_shape(n, L, V)
    assert rows == jro.check_lane_shape(n, L, V)
    np.testing.assert_array_equal(jro.flat_to_lane_perm(n, L, V), reorder.flat_to_lane_perm(n, L, V))
    s = _spins(n, L, 1)[0]
    lane = reorder.to_lane(s, n, L, V)
    np.testing.assert_array_equal(jro.to_lane(s, n, L, V), lane)
    np.testing.assert_array_equal(reorder.from_lane(lane, n, L, V), s)
    jm, tm = _models(n, L)
    a = jmp.make_lane_state(jm, s, V)
    b = metropolis.make_lane_state(tm, s, V, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("n,L", CASES, ids=IDS)
def test_color_classes_match_leaf_by_leaf(n, L):
    jm, tm = _models(n, L)
    jc, tc = jro.colored_classes(jm, V), reorder.colored_classes(tm, V)
    assert len(jc) == len(tc)
    for c, (a, b) in enumerate(zip(jc, tc)):
        assert a._fields == b._fields
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, (c, f)
            np.testing.assert_array_equal(x, y, err_msg=f"class {c} leaf {f}")
    assert jro.color_rows(jm.space_nbr, n, L // V)[1] == len(tc)


@pytest.mark.parametrize("n,L", CASES, ids=IDS)
def test_lane_h_eff_matches(n, L):
    """The dense field refresh, batched, against the reference's per-replica
    function on the same spins."""
    jm, tm = _models(n, L)
    B = 3
    lanes = np.stack([reorder.to_lane(s, n, L, V) for s in _spins(n, L, B)])
    hs, ht = metropolis.lane_h_eff(
        torch.from_numpy(lanes), torch.from_numpy(tm.h),
        torch.from_numpy(tm.space_nbr.astype(np.int64)),
        torch.from_numpy(tm.space_J), torch.from_numpy(tm.tau_J), n,
    )
    for b in range(B):
        ja, jb = jmp.lane_h_eff(
            jnp.asarray(lanes[b]), jnp.asarray(jm.h), jnp.asarray(jm.space_nbr),
            jnp.asarray(jm.space_J), jnp.asarray(jm.tau_J), n,
        )
        np.testing.assert_array_equal(np.asarray(ja), hs[b].numpy())
        np.testing.assert_array_equal(np.asarray(jb), ht[b].numpy())


@pytest.mark.parametrize("n,L", CASES, ids=IDS)
def test_observables_match(n, L):
    jm, tm = _models(n, L)
    s = _spins(n, L, 4)
    np.testing.assert_array_equal(jobs.energies(jm, s), observables.energies(tm, s))
    np.testing.assert_array_equal(jobs.magnetization(s), observables.magnetization(s))
    np.testing.assert_array_equal(
        jobs.abs_layer_magnetization(jm, s), observables.abs_layer_magnetization(tm, s)
    )
    assert jobs.summarize(jm, s[0]) == observables.summarize(tm, s[0])
    assert observables.energies(tm, s[1]) == ising.energy(tm, s[1])


def test_lane_shape_errors_match():
    for n, L, Vb in [(4, 10, 4), (4, 4, 4)]:
        with pytest.raises(ValueError):
            jro.check_lane_shape(n, L, Vb)
        with pytest.raises(ValueError):
            reorder.check_lane_shape(n, L, Vb)
