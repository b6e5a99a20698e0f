"""The swap phase of a PT ladder as the kernel computes it, on the CPU.

`kernels.ops.pt_swap` takes a block of slots and the ladder's rows in it;
on the card it launches csrc/pt_swap.cu, on the CPU it runs
`kernels.ref.pt_swap_ref`.  Here:

* the plain version on scattered rows of a block equals
  `tempering.swap_phase` on the replicas gathered into their own state,
  and the gathered energies through `swap_phase_from_energies` (the
  mesh-spanning route), over chained rounds: energies, the block's betas,
  the generator and both counters, for both parities, odd and even R and
  every exp flavour;
* a torch model of the kernel's blocked sum (tasks of 128 terms, a
  thread's 4, five shuffle levels, the task sums zero-filled to a power of
  two and added in place) equals `tempering._pairwise_sum` bit for bit,
  so the tree the kernel must keep is written down and held;
* a server on the CPU takes the plain version: its ladders report no
  fused swap and equal the standalone run.

The kernel against the plain version runs in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine, fastexp, ising, tempering
from repro_torch.core import mt19937 as mt
from repro_torch.kernels import ops
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

N_SITES, L, V = 8, 16, 4  # 32 lane rows of 4 lanes: 128 spins a replica


def _block(R, seed):
    """A block of B > R slots of random spins and betas, and R scattered
    rows in it, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    B = R + 5
    rows = torch.randperm(B, generator=g)[:R].to(torch.int32)
    spins = torch.where(torch.rand(B, N_SITES * L // V, V, generator=g) < 0.5, -1.0, 1.0)
    betas = 0.1 + 2.9 * torch.rand(B, generator=g)
    return spins, betas, rows


def _flip(spins, seed):
    """Flip a tenth of the spins, as a round's sweeps would move them."""
    g = torch.Generator().manual_seed(seed)
    return torch.where(torch.rand(spins.shape, generator=g) < 0.1, -spins, spins)


@pytest.mark.parametrize("flavor", sorted(fastexp.EXP_FNS))
@pytest.mark.parametrize("R", [2, 3, 7, 115])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_swap_equals_the_gathered_swap_phase(parity, R, flavor):
    m = ising.random_layered_model(n=N_SITES, L=L, seed=R, beta=1.0)
    tables = tempering.model_energy_tables(m, "cpu")
    nbr, J, tau, h = tables
    spins, betas, rows = _block(R, seed=R + 10 * parity)
    idx = rows.long()
    outside = torch.ones(len(betas), dtype=torch.bool)
    outside[idx] = False
    start = (mt.mt_init(R + 17, "cpu"), torch.zeros((), dtype=torch.int32),
             torch.zeros((), dtype=torch.int32))
    block = (betas, *start)  # ops.pt_swap on the block's rows
    gathered = (betas[idx], *start)  # tempering.swap_phase on the gathered ladder
    from_e = (betas[idx], *start)  # the gathered energies, then the decision
    for r in range(12):
        p = (parity + r) % 2
        spins = _flip(spins, seed=r)
        e, *block = ops.pt_swap(spins, block[0], rows, *block[1:], *tables, N_SITES, p, flavor)
        state = tempering.PTState(spins[idx], None, None, gathered[0], None, *gathered[1:])
        state = tempering.swap_phase(state, *tables, p, N_SITES, flavor)
        gathered = (state.betas, state.swap_rng, state.swap_accept, state.swap_propose)
        want_e = tempering.lane_energy(spins[idx], h, nbr, J, tau, N_SITES)
        from_e = tempering.swap_phase_from_energies(from_e[0], want_e, *from_e[1:], p, flavor)
        assert torch.equal(e, want_e)
        assert torch.equal(block[0][outside], betas[outside])  # the other slots untouched
        for a, b, c in zip((block[0][idx], *block[1:]), gathered, from_e):
            assert torch.equal(a, b) and torch.equal(a, c)
    accepted, proposed = int(block[2]), int(block[3])
    assert proposed == sum((R - (parity + r) % 2) // 2 for r in range(12))
    if R > 3:  # the data decides both ways
        assert 0 < accepted < proposed


def _kernel_sum(terms: torch.Tensor) -> torch.Tensor:
    """csrc/pt_swap.cu's sum of one replica's float64 terms, step for step:
    tasks of 128 terms, zero-filled past the last term; a thread's 4 as
    (t0 + t1) + (t2 + t3), then shuffle-down levels 1, 2, 4, 8, 16 over the
    warp's 32 lanes (a lane past the warp adds its own value), both cut at
    the padded width when it is under 128; the task sums (lane 0) zero-filled
    to a power of two P2 and added in place, part[p] += part[p + o] for p a
    multiple of 2o."""
    N = terms.numel()
    span, tasks = 1 << (N - 1).bit_length(), -(-N // ops.PT_SWAP_TASK)
    x = torch.cat([terms, terms.new_zeros(tasks * ops.PT_SWAP_TASK - N)]).reshape(tasks, 32, 4)
    a = x[..., 0]
    if span > 1:
        a = a + x[..., 1]
    if span > 2:
        a = a + (x[..., 2] + x[..., 3])
    lanes, o = torch.arange(32), 1
    while o < 32 and 4 * o < span:
        a = a + a[:, torch.where(lanes + o < 32, lanes + o, lanes)]
        o *= 2
    P2 = 1 << (tasks - 1).bit_length()
    assert 8 * P2 == ops.pt_swap_smem_bytes(N, 1)
    part, o = torch.cat([a[:, 0], a.new_zeros(P2 - tasks)]), 1
    while o < P2:
        p = torch.arange(0, P2, 2 * o)
        part[p] = part[p] + part[p + o]
        o *= 2
    return part[0]


def _bits(x: torch.Tensor) -> int:
    return int(x.reshape(1).view(torch.int64))


@pytest.mark.parametrize("N", [24_576, 128 * 640, 1, 2, 3, 5, 7, 63, 64, 65, 127, 129, 1_001,
                               4_097, 128 * 3 + 1])
def test_kernel_blocking_equals_pairwise_sum(N):
    """Terms spread over 30 binades, so another tree rounds differently
    (checked on the paper's 24,576 against a sequential sum)."""
    g = torch.Generator().manual_seed(N)
    terms = torch.randn(N, generator=g, dtype=torch.float64) * 10.0 ** (
        30 * torch.rand(N, generator=g, dtype=torch.float64) - 15)
    assert _bits(_kernel_sum(terms)) == _bits(tempering._pairwise_sum(terms))
    if N == 24_576:
        assert _bits(terms.cumsum(0)[-1]) != _bits(tempering._pairwise_sum(terms))


@pytest.mark.parametrize("N", [1, 2, 3, 64, 128, 24_576])
def test_kernel_blocking_keeps_the_sign_of_an_all_negative_zero_sum(N):
    terms = torch.full((N,), -0.0, dtype=torch.float64)
    want = tempering._pairwise_sum(terms)
    assert _bits(_kernel_sum(terms)) == _bits(want)
    mixed = terms.clone()
    mixed[-1] = 0.0
    assert _bits(_kernel_sum(mixed)) == _bits(tempering._pairwise_sum(mixed))


def test_pt_swap_refuses_a_bad_parity_or_flavour():
    m = ising.random_layered_model(n=N_SITES, L=L, seed=1, beta=1.0)
    spins, betas, rows = _block(3, seed=1)
    args = (spins, betas, rows, mt.mt_init(1, "cpu"), torch.zeros((), dtype=torch.int32),
            torch.zeros((), dtype=torch.int32), *tempering.model_energy_tables(m, "cpu"),
            N_SITES)
    with pytest.raises(ValueError, match="swap_parity must be 0 or 1"):
        ops.pt_swap(*args, 2)
    with pytest.raises(ValueError, match="unknown exp flavour 'zz'"):
        ops.pt_swap(*args, 0, "zz")


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_cpu_server_takes_the_plain_swap(rung):
    """A server on the CPU: its ladders report no fused swap, launch no
    kernel, and equal the standalone run."""
    m = ising.random_layered_model(n=N_SITES, L=L, seed=2, beta=1.0)
    betas = np.geomspace(0.2, 2.5, 5).astype(np.float32)
    state, energies = tempering.run_parallel_tempering(
        m, betas, 6, seed=4, sweeps_per_round=3, rung=rung, backend="torch", device="cpu", V=V)
    before = dict(ops.launches)
    server = SampleServer(m, slots=9, chunk_sweeps=2, rung=rung, backend="torch",
                          device="cpu", V=V)
    server.submit(AnnealJob.constant(seed=1, sweeps=5, beta=0.9))
    job = PTJob(seed=4, betas=betas, num_rounds=6, sweeps_per_round=3)
    server.submit(job)
    r = {r.jid: r for r in server.drain()}[job.jid]
    assert server.stats()["placement"]["pt_swap_fused"] == 0
    assert ops.launches == before
    np.testing.assert_array_equal(r.extras["betas"], state.betas.numpy())
    assert r.extras["swap_accept"] == int(state.swap_accept)
    assert r.extras["swap_propose"] == int(state.swap_propose)
    eng = tempering.make_pt_engine(m, len(betas), rung=rung, backend="torch", V=V,
                                   device="cpu")
    np.testing.assert_array_equal(r.spins, eng.spins_flat(engine.SweepCarry(*state[:5])))
    np.testing.assert_array_equal(np.asarray(r.energy).astype(np.float32), energies)

