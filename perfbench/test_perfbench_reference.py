"""The benchmark's frozen pieces against the program they measure, on the CPU.

The reference and the frozen counts live in ``perfbench/`` so that a
later change to the program cannot move them; these tests hold them to
the program as it stands: the model generator to `core/ising.py`, the
replays to the port's plain backend (bit for bit, both rungs, anneal
jobs and a ladder, served through `SampleServer`), the counts to
``chip_smoke.py``'s.
"""

from pathlib import Path

import numpy as np
import pytest

from pbench import spec as specmod, yardstick

ROOT = Path(__file__).resolve().parent.parent
REF = specmod.load_module(Path(__file__).resolve().parent / "reference" / "ising_qmc.py",
                          "pb_reference_ising_qmc")


def _port_model(m):
    from repro_torch.core import ising

    return ising.LayeredModel(n=m.n, L=m.L, h=m.h, space_nbr=m.space_nbr, space_J=m.space_J,
                              tau_J=m.tau_J)


@pytest.mark.parametrize("n,L,seed", [(8, 16, 0), (96, 256, 0), (12, 24, 5)])
def test_model_generator_is_the_programs(n, L, seed):
    from repro_torch.core import ising

    lat = REF.make_lattice(n, L, seed)
    pm = ising.random_layered_model(n, L, seed=seed)
    for name in ("h", "space_nbr", "space_J", "tau_J"):
        np.testing.assert_array_equal(getattr(lat, name), getattr(pm, name))
    for run_seed in (3, 2**31 + 7):
        mine = REF.reseed(lat, run_seed % 2**31)
        theirs = ising.reseed_couplings(pm, run_seed % 2**31)
        for name in ("h", "space_J", "tau_J"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))


def test_lattice_colours_are_the_programs():
    from repro_torch.core import ising, reorder

    for seed in range(4):
        pm = ising.random_layered_model(96, 256, seed=seed)
        m = REF.make_lattice(96, 256, seed)
        colours, C = REF.row_colours(m, 128)
        want, want_c = reorder.color_rows(pm.space_nbr, 96, 2)
        assert C == want_c
        np.testing.assert_array_equal(colours, want)


@pytest.mark.parametrize("rung", ["cb", "a4"])
@pytest.mark.parametrize("shape", [(8, 16, 4), (6, 24, 4)])
def test_reference_equals_the_served_jobs(rung, shape):
    """Anneal jobs (constant and ramped, chunks cut across segments) and a
    PT ladder, served side by side on the plain backend, equal the
    reference's replays bit for bit."""
    from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

    n, L, V = shape
    m = REF.reseed(REF.make_lattice(n, L, 0), 11)
    server = SampleServer(_port_model(m), slots=6, chunk_sweeps=3, rung=rung, backend="torch",
                          device="cpu", V=V)
    jobs = [dict(seed=11, schedule=[(7, 1.3)]), dict(seed=12, schedule=[(3, 0.3), (4, 0.75), (2, 1.2)]),
            dict(seed=2**31 - 5, schedule=[(5, 2.9)])]
    for j in jobs:
        server.submit(AnnealJob(j["seed"], j["schedule"]))
    betas = np.linspace(0.1, 3.0, 3).astype(np.float32)
    server.submit(PTJob(77, betas, 5, 2))
    served = {r.jid: r for r in server.drain()}
    for k, want in enumerate(REF.anneal(m, V, rung, jobs)):
        np.testing.assert_array_equal(served[k].spins, want["spins"])
        assert served[k].extras["final_beta"] == np.float32(want["final_beta"])
        assert abs(served[k].energy - want["energy"]) < 1e-9
    (ladder,) = REF.ladders(m, V, rung, [dict(seed=77, betas=betas, rounds=5, sweeps_per_round=2)])
    got = served[3]
    np.testing.assert_array_equal(got.spins, ladder["spins"])
    np.testing.assert_array_equal(got.extras["betas"], ladder["betas"])
    assert (got.extras["swap_accept"], got.extras["swap_propose"]) == (ladder["accept"], ladder["propose"])
    np.testing.assert_allclose(got.energy, ladder["energy"], rtol=0, atol=1e-9)


def test_reference_uniforms_and_exp_are_the_programs():
    import torch
    from repro_torch.core import fastexp, mt19937

    seeds = REF.lane_seeds(8, 2**31 + 99)
    st = torch.as_tensor(REF.mt_seed(seeds).astype(np.int64))
    theirs = mt19937.mt_init(seeds, "cpu")
    np.testing.assert_array_equal(st.numpy().astype(np.uint32), theirs.numpy().view(np.uint32))
    for count in (192, 700):
        st2, u = REF.mt_uniforms(st, count)
        theirs2, v = mt19937.mt_uniforms_count(theirs, count)
        np.testing.assert_array_equal(u.numpy(), v.numpy())
        np.testing.assert_array_equal(st2.numpy().astype(np.uint32), theirs2.numpy().view(np.uint32))
    x = torch.cat([torch.linspace(-200, 200, 40001), torch.tensor([-87.5, -87.9, -88.1, 0.0, -0.0])])
    np.testing.assert_array_equal(REF.fastexp(x).numpy().view(np.int32),
                                  fastexp.fastexp_fast(x).numpy().view(np.int32))


def test_bf16_rounding_is_torchs():
    import torch

    x = np.random.default_rng(0).normal(size=10000).astype(np.float32) * 37
    want = torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(REF.round_bf16(x.copy()), want)


@pytest.mark.parametrize("B", [1, 8, 115])
@pytest.mark.parametrize("sweeps", [0, 1, 8, 64])
def test_frozen_counts_are_chip_smokes(B, sweeps):
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for rung, fn in (("cb", chip_smoke.colored_counts), ("a4", chip_smoke.a4_counts)):
        for rows, sd in ((192, 6), (32, 5), (640, 6)):
            assert yardstick.COUNTS[rung](B, rows, sd, sweeps) == fn(B, rows, sd, sweeps)
            counts = fn(B, rows, sd, sweeps)
            assert yardstick.bound_s(counts) * 1e3 == pytest.approx(chip_smoke.bound(counts)[0], rel=1e-12)
    assert (yardstick.HBM_BYTES_PER_S, yardstick.FP32_OPS_PER_S, yardstick.INT32_OPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_OPS_PER_S, chip_smoke.INT32_OPS_PER_S)
