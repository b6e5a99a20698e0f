"""Tests that need a CUDA card: each kernel against its plain version,
and the server on the card on both rungs.  Marked ``cuda``; each test
checks for a card in its own body and skips without one (run them on the
card with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine, ising, metropolis, tempering
from repro_torch.core import mt19937 as mt
from repro_torch.kernels import ops, ref
from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize(
    "n,L,B,S",
    [(96, 256, 8, 8), (4, 256, 3, 5), (320, 256, 2, 2), (6, 384, 2, 0), (96, 256, 1, 8),
     (96, 256, 115, 2), (6, 384, 3, 5), (96, 256, 8, 0)],
    ids=["main", "tiny", "two-blocks", "zero-sweeps", "B1", "B115", "lpv3", "main-zero-sweeps"],
)
def test_kernel_bit_equals_plain(n, L, B, S):
    _need_card()
    dev = torch.device("cuda")
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    eng = engine.SweepEngine.create(m, backend="torch", batch=B, V=128, device=dev)
    carry = eng.init_carry(seed=1)
    betas = torch.linspace(0.2, 2.0, B, device=dev)
    fn = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=n)
    before = ops.launches["colored_multisweep"]
    got = fn(carry.spins, carry.rng, betas, S)
    torch.cuda.synchronize()
    assert ops.launches["colored_multisweep"] == before + 1
    want = ref.colored_multisweep_ref(
        carry.spins, carry.rng, betas, metropolis.classes_to(eng.classes, dev),
        h=torch.as_tensor(m.h, device=dev),
        base_nbr=torch.as_tensor(m.space_nbr, dtype=torch.int64, device=dev),
        base_J=torch.as_tensor(m.space_J, device=dev),
        tau_J=torch.as_tensor(m.tau_J, device=dev), n=n, num_sweeps=S,
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _a4_case(n, L, B, dev):
    """An a4 engine's carry with spread betas, and its tables on ``dev``."""
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    eng = engine.SweepEngine.create(m, rung="a4", backend="torch", batch=B, V=128, device=dev)
    carry = eng.init_carry(seed=1)._replace(betas=torch.linspace(0.2, 2.0, B, device=dev))
    return carry, engine._a4_tensors(eng)


@pytest.mark.parametrize(
    "n,L,B,S", [(96, 256, 8, 8), (6, 384, 2, 3), (320, 256, 2, 2), (96, 256, 2, 0)],
    ids=["main", "lpv3", "two-blocks", "zero-sweeps"],
)
def test_a4_multisweep_kernel_bit_equals_plain(n, L, B, S):
    _need_card()
    dev = torch.device("cuda")
    c, tabs = _a4_case(n, L, B, dev)
    args = (c.spins, c.h_space, c.h_tau, c.rng)
    before = ops.launches["metropolis_multisweep"]
    got = ops.metropolis_multisweep(*args, **tabs, beta=c.betas, n=n, num_sweeps=S)
    torch.cuda.synchronize()
    assert ops.launches["metropolis_multisweep"] == before + 1
    want = ref.metropolis_multisweep_ref(*args, **tabs, beta=c.betas, n=n, num_sweeps=S)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,L,B", [(96, 256, 4), (6, 384, 2), (320, 256, 2)],
                         ids=["main", "lpv3", "two-blocks"])
def test_a4_sweep_kernel_bit_equals_plain(n, L, B):
    _need_card()
    dev = torch.device("cuda")
    c, tabs = _a4_case(n, L, B, dev)
    rows = c.spins.shape[1]
    _, u = mt.mt_uniforms_count(c.rng, rows)
    u = u.reshape(rows, B, 128).permute(1, 0, 2).contiguous()
    args = (c.spins, c.h_space, c.h_tau, u)
    got = ops.metropolis_sweep(*args, **tabs, beta=c.betas, n=n)
    want = ref.metropolis_sweep_ref(*args, **tabs, beta=c.betas, n=n)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


#: Generator columns #6 is checked at: a partial tile of 16 columns,
#: odd counts (word-by-word stores), whole tiles, B=8 and B=115 lanes.
MT_V = [1, 31, 32, 33, 128, 200, 1024, 14720]


@pytest.mark.parametrize("V", MT_V)
def test_mt_block_kernel_bit_equals_plain(V):
    _need_card()
    state = mt.mt_init(np.arange(V, dtype=np.uint32) * 2654435761 + 5, "cuda")
    for kernel, plain in ((ops.mt_next_block, ref.mt_next_block_ref),
                          (ops.mt_uniforms, ref.mt_uniforms_ref)):
        for a, b in zip(kernel(state), plain(state)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    s1, u1 = ops.mt_uniforms_count(state, 1300)
    s2, u2 = mt.mt_uniforms_count(state, 1300)
    assert torch.equal(s1, s2) and torch.equal(u1, u2)


@pytest.mark.parametrize("V", MT_V)
def test_mt_block_kernel_bit_equals_plain_after_chained_blocks(V):
    """Five blocks chained through the kernel's own state, both flavours,
    each block's state and output bit pattern for bit pattern."""
    _need_card()
    start = mt.mt_init(np.arange(V, dtype=np.uint32) * 2654435761 + 11, "cuda")
    for kernel, plain in ((ops.mt_next_block, ref.mt_next_block_ref),
                          (ops.mt_uniforms, ref.mt_uniforms_ref)):
        got = want = start
        for _ in range(5):
            (got, got_out), (want, want_out) = kernel(got), plain(want)
            assert torch.equal(got, want)
            assert torch.equal(got_out.view(torch.int32), want_out.view(torch.int32))


def test_mt_block_kernel_takes_a_state_off_a_16_byte_boundary():
    """A state view that starts 4 bytes into its storage goes word by
    word and gives the same bits."""
    _need_card()
    V = 128
    base = mt.mt_init(np.arange(V + 1, dtype=np.uint32) * 2654435761 + 3, "cuda").reshape(-1)
    state = base[1:1 + mt.N * V].view(mt.N, V)
    assert state.data_ptr() % 16 == 4 and state.is_contiguous()
    for kernel, plain in ((ops.mt_next_block, ref.mt_next_block_ref),
                          (ops.mt_uniforms, ref.mt_uniforms_ref)):
        for a, b in zip(kernel(state), plain(state)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_server_on_card_matches_plain(rung):
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=0, beta=1.2)
    out = []
    for backend in ("cuda", "torch"):
        server = SampleServer(m, slots=4, chunk_sweeps=4, rung=rung, backend=backend,
                              device="cuda")
        for i in range(6):
            server.submit(AnnealJob.constant(seed=i, sweeps=5 + 3 * i, beta=0.5 + 0.2 * i))
        out.append({r.jid: r for r in server.drain()})
    for jid, r in out[0].items():
        np.testing.assert_array_equal(r.spins, out[1][jid].spins)
        assert r.energy == out[1][jid].energy


_MULTI_KERNEL = {"cb": "colored_multisweep_multi", "a4": "metropolis_multisweep_multi"}


@pytest.mark.parametrize("rung", ["cb", "a4"])
@pytest.mark.parametrize(
    "n,L,B,S",
    [(96, 256, 8, 8), (320, 256, 2, 2), (96, 256, 2, 0), (96, 256, 1, 8), (96, 256, 115, 2),
     (6, 384, 3, 5)],
    ids=["main", "two-blocks", "zero-sweeps", "B1", "B115", "lpv3"],
)
def test_multi_kernel_bit_equals_plain(rung, n, L, B, S):
    """Kernels #2 and #4 on distinct tenants against the plain multi
    versions, through the multi-tenant engine's two backends."""
    _need_card()
    dev = torch.device("cuda")
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    tenants = [ising.reseed_couplings(m, seed=100 + k) for k in range(B)]
    plain = engine.SweepEngine.create(tenants, rung=rung, backend="torch", V=128, device=dev)
    kernel = engine.SweepEngine.create(tenants, rung=rung, backend="cuda", V=128, device=dev)
    carry = plain.init_carry(seed=1)._replace(betas=torch.linspace(0.2, 2.0, B, device=dev))
    before = ops.launches[_MULTI_KERNEL[rung]]
    got = kernel.run(carry, S)
    torch.cuda.synchronize()
    assert ops.launches[_MULTI_KERNEL[rung]] == before + 1
    for a, b in zip(got, plain.run(carry, S)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_multi_kernel_on_copies_equals_single_kernel(rung):
    _need_card()
    dev = torch.device("cuda")
    m = ising.random_layered_model(n=96, L=256, seed=3, beta=1.0)
    multi = engine.SweepEngine.create([m] * 4, rung=rung, backend="cuda", V=128, device=dev)
    single = engine.SweepEngine.create(m, rung=rung, backend="cuda", batch=4, V=128, device=dev)
    carry = single.init_carry(seed=2)
    for a, b in zip(multi.run(carry, 5), single.run(carry, 5)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("n,L,B,S", [(96, 256, 8, 4), (6, 384, 3, 5), (320, 256, 2, 2)],
                         ids=["main", "lpv3", "two-blocks"])
def test_colored_kernels_bit_equal_at_every_warp_group_count(n, L, B, S, W, monkeypatch):
    """#1 and #2 spread a class's rows and the generator's phase runs over
    W warp groups; the bits must not depend on W (classes smaller than the
    CTA's warps included, id "lpv3")."""
    _need_card()
    dev = torch.device("cuda")
    monkeypatch.setattr(ops, "COLORED_WARP_GROUPS", W)
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    tenants = [ising.reseed_couplings(m, seed=100 + k) for k in range(B)]
    for models in (m, tenants):
        kw = dict(batch=B) if models is m else {}
        plain = engine.SweepEngine.create(models, rung="cb", backend="torch", V=128, device=dev,
                                          **kw)
        kernel = engine.SweepEngine.create(models, rung="cb", backend="cuda", V=128, device=dev,
                                           **kw)
        carry = plain.init_carry(seed=3)._replace(betas=torch.linspace(0.2, 2.0, B, device=dev))
        for a, b in zip(kernel.run(carry, S), plain.run(carry, S)):
            assert torch.equal(a, b)


def test_colored_kernels_take_inputs_off_a_16_byte_boundary():
    """#1 and #2 read spins and generator state in 16-byte words; an input
    view that starts 4 bytes in is copied by the wrapper, and the results
    stay bit-equal."""
    _need_card()
    dev = torch.device("cuda")
    n, L, B, S = 6, 384, 2, 3
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    eng = engine.SweepEngine.create(m, rung="cb", backend="torch", batch=B, V=128, device=dev)
    carry = eng.init_carry(seed=1)
    betas = torch.linspace(0.2, 2.0, B, device=dev)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4
        return out

    spins, rng = shifted(carry.spins), shifted(carry.rng)
    fn = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=n)
    want = fn(carry.spins, carry.rng, betas, S)
    for a, b in zip(fn(spins, rng, betas, S), want):
        assert torch.equal(a, b)
    multi = ops.make_colored_multisweep_multi(eng.classes, m.space_nbr, n=n)
    tabs = [torch.as_tensor(np.stack([x] * B), device=dev) for x in (m.h, m.space_J, m.tau_J)]
    for a, b in zip(multi(spins, rng, betas, *tabs, S), want):
        assert torch.equal(a, b)


def test_colored_kernel_refuses_rows_past_its_shared_memory():
    """The staged class tables lower the largest rows a colored launch
    takes; past it the wrapper raises before launching."""
    _need_card()
    dev = torch.device("cuda")
    m = ising.random_layered_model(n=600, L=256, seed=1, beta=1.0)  # rows=1200
    eng = engine.SweepEngine.create(m, rung="cb", backend="torch", batch=1, V=128, device=dev)
    fn = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=600)
    carry = eng.init_carry(seed=1)
    before = ops.launches["colored_multisweep"]
    with pytest.raises(ValueError, match="the colored kernels hold at most"):
        fn(carry.spins, carry.rng, carry.betas, 1)
    assert ops.launches["colored_multisweep"] == before


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_multi_tenant_server_on_card_matches_plain(rung):
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=0, beta=1.2)
    tenants = [ising.reseed_couplings(m, seed=k) for k in range(3)]
    out = []
    for backend in ("cuda", "torch"):
        server = SampleServer(m, slots=4, chunk_sweeps=4, rung=rung, backend=backend,
                              device="cuda", multi_tenant=True)
        for i in range(6):
            server.submit(AnnealJob.constant(seed=i, sweeps=5 + 3 * i, beta=0.5 + 0.2 * i,
                                             model=None if i % 4 == 3 else tenants[i % 3]))
        out.append({r.jid: r for r in server.drain()})
    for jid, r in out[0].items():
        np.testing.assert_array_equal(r.spins, out[1][jid].spins)
        assert r.energy == out[1][jid].energy


_EXP_INPUTS = {
    "random": lambda: np.random.default_rng(0).uniform(-200, 200, 2**20).astype(np.float32),
    "grid": lambda: np.linspace(-180, -80, 200_001).astype(np.float32),
    "special": lambda: np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-45, 1.1e-38, 1e10, -1e10, 88.7,
         89.5, -87.5, -21.834, 22.18], np.float32),
}


def _one_nan(t):
    return torch.where(t.isnan(), torch.full_like(t, float("nan")), t)


@pytest.mark.parametrize("flavor", ["fast", "accurate"])
@pytest.mark.parametrize("inputs", list(_EXP_INPUTS))
def test_fastexp_kernel_bit_equals_plain(flavor, inputs):
    """Kernel #7 against its plain version on the card and on the CPU."""
    _need_card()
    x = torch.from_numpy(_EXP_INPUTS[inputs]())
    xd = x.cuda()
    before = ops.launches["fastexp_2d"]
    got = ops.fastexp(xd, flavor)
    torch.cuda.synchronize()
    assert ops.launches["fastexp_2d"] == before + 1
    want = ref.fastexp_ref(xd, flavor)
    cpu = ref.fastexp_ref(x, flavor)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # The card's float multiply makes NaNs without payload, the CPU's keeps
    # the input's (IEEE 754 allows both): every other bit must agree.
    assert torch.equal(_one_nan(want.cpu()).view(torch.int32), _one_nan(cpu).view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7,), (1000,), (3, 5, 11), (1, 4099)])
def test_fastexp_kernel_shapes_and_dtypes(shape, dtype):
    _need_card()
    x = (torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 60 - 30).to(dtype)
    for flavor in ("fast", "accurate"):
        got = ops.fastexp(x.cuda(), flavor)
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert torch.equal(got.view(torch.int32), ref.fastexp_ref(x.cuda(), flavor).view(torch.int32))
        assert torch.equal(_one_nan(got.cpu()).view(torch.int32),
                           _one_nan(ref.fastexp_ref(x, flavor)).view(torch.int32))
    # A view that starts off a 16-byte boundary takes the element-wise path.
    xd = x.cuda().reshape(-1)[1:]
    assert torch.equal(ops.fastexp(xd).view(torch.int32), ref.fastexp_ref(xd).view(torch.int32))


@pytest.mark.parametrize("flavor", ["fast", "accurate"])
def test_fastexp_kernel_bit_equals_plain_on_every_float32(flavor):
    """Kernel #7 against its plain version on the card over all 2^32
    float32 bit patterns (NaNs unified): "accurate" rounds its fourth
    root's two reciprocal square roots in float32 arithmetic, the plain
    version in float64."""
    _need_card()
    nan = torch.tensor(0x7FC00000, dtype=torch.int32, device="cuda")
    chunk = 2**28
    for lo in range(-(2**31), 2**31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32, device="cuda").view(torch.float32)
        got, want = ops.fastexp(x, flavor), ref.fastexp_ref(x, flavor)
        g, w = (torch.where(t.isnan(), nan, t.view(torch.int32)) for t in (got, want))
        assert torch.equal(g, w), f"from {lo:#x}: {int((g != w).sum())} differ"


@pytest.mark.parametrize("B", [1, 8, 115])
@pytest.mark.parametrize("flavor", ["fast", "accurate", "exact"])
def test_sweep_kernels_run_every_flavour_bit_equal_to_plain(flavor, B):
    """#1-#5 on each exp flavour (a template instantiation of each kernel)
    against their plain versions on the card, bit pattern for bit pattern
    (#2 and #4 on B distinct tenants, #5 one sweep on given uniforms)."""
    _need_card()
    dev = torch.device("cuda")
    n, L, S = 96, 256, 4
    m = ising.random_layered_model(n=n, L=L, seed=B, beta=1.0)
    tenants = [ising.reseed_couplings(m, seed=100 + k) for k in range(B)]
    betas = torch.linspace(0.2, 2.0, B, device=dev)
    for rung in ("cb", "a4"):
        for models in (m, tenants):
            kw = dict(rung=rung, V=128, device=dev, exp_flavor=flavor)
            if models is m:
                kw["batch"] = B
            kern = engine.SweepEngine.create(models, backend="cuda", **kw)
            plain = engine.SweepEngine.create(models, backend="torch", **kw)
            carry = plain.init_carry(seed=3)._replace(betas=betas)
            _bits_equal(kern.run(carry, S), plain.run(carry, S))
    c, tabs = _a4_case(n, L, B, dev)
    rows = c.spins.shape[1]
    u = mt.mt_uniforms_count(c.rng, rows)[1].reshape(rows, B, 128).permute(1, 0, 2).contiguous()
    args = (c.spins, c.h_space, c.h_tau, u)
    _bits_equal(ops.metropolis_sweep(*args, **tabs, beta=c.betas, n=n, exp_flavor=flavor),
                ref.metropolis_sweep_ref(*args, **tabs, beta=c.betas, n=n, exp_flavor=flavor))


@pytest.mark.parametrize("flavor", ["exact", "accurate"])
def test_sweep_exp_bit_equals_plain_on_every_float32(flavor):
    """The sweep kernels' exp (csrc/sweep_exp_check.cu) against the plain
    exp on the card over all 2^32 float32 bit patterns, NaNs unified:
    "exact" is `torch.exp` with the flush, "accurate" `fastexp_accurate`."""
    _need_card()
    from repro_torch.core import fastexp

    nan = torch.tensor(0x7FC00000, dtype=torch.int32, device="cuda")
    chunk = 2**28
    for lo in range(-(2**31), 2**31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32, device="cuda").view(torch.float32)
        got, want = ops._sweep_exp_check(x, flavor), fastexp.EXP_FNS[flavor](x)
        g, w = (torch.where(t.isnan(), nan, t.view(torch.int32)) for t in (got, want))
        assert torch.equal(g, w), f"from {lo:#x}: {int((g != w).sum())} differ"


@pytest.mark.parametrize("flavor", ["fast", "accurate"])
@pytest.mark.parametrize("rung", ["a4", "cb"])
def test_parallel_tempering_on_the_card_equals_the_plain_backend(rung, flavor):
    """`run_parallel_tempering` with backend "cuda" (one kernel launch a
    round) equals backend "torch" on the card bit for bit, and a served
    PTJob (rounds split across chunks) equals the standalone run."""
    _need_card()
    from repro_torch.core import tempering
    from repro_torch.serve_mc import PTJob

    m = ising.random_layered_model(n=8, L=256, seed=4, beta=1.0)
    betas = np.geomspace(0.1, 3.0, 8).astype(np.float32)
    kw = dict(seed=3, sweeps_per_round=3, rung=rung, exp_flavor=flavor)
    got, e_got = tempering.run_parallel_tempering(m, betas, 6, backend="cuda", **kw)
    want, e_want = tempering.run_parallel_tempering(m, betas, 6, backend="torch", V=128, **kw)
    for f in tempering.PTState._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), f
    np.testing.assert_array_equal(e_got, e_want)
    server = SampleServer(m, slots=12, chunk_sweeps=2, rung=rung, backend="cuda",
                          exp_flavor=flavor)
    server.submit(AnnealJob.constant(seed=1, sweeps=7, beta=0.9))
    job = PTJob(seed=3, betas=betas, num_rounds=6, sweeps_per_round=3)
    server.submit(job)
    r = {r.jid: r for r in server.drain()}[job.jid]
    np.testing.assert_array_equal(r.extras["betas"], got.betas.cpu().numpy())
    assert r.extras["swap_accept"] == int(got.swap_accept)
    assert r.extras["swap_propose"] == int(got.swap_propose)
    eng = tempering.make_pt_engine(m, len(betas), rung=rung)
    spins = eng.spins_flat(engine.SweepCarry(got.spins, got.h_space, got.h_tau, got.betas,
                                             got.rng))
    np.testing.assert_array_equal(r.spins, spins)


# -- the a4 kernels (#3, #4, #5), bit pattern for bit pattern -------------------

_A4_PLAIN = {}


def _bits_equal(got, want):
    for a, b in zip(got, want, strict=True):
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)


def _a4_plain(n, L, B, S):
    """The plain versions of #3, #4 (B distinct tenants) and #5 at one
    shape, on the card, computed once: (inputs, multi tables, outputs)."""
    key = (n, L, B, S)
    if key not in _A4_PLAIN:
        dev = torch.device("cuda")
        c, tabs = _a4_case(n, L, B, dev)
        m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
        tenants = engine.SweepEngine.create(
            [ising.reseed_couplings(m, seed=100 + k) for k in range(B)], rung="a4",
            backend="torch", V=128, device=dev).slot_tables
        args = (c.spins, c.h_space, c.h_tau, c.rng)
        rows = c.spins.shape[1]
        u = mt.mt_uniforms_count(c.rng, rows)[1].reshape(rows, B, 128).permute(1, 0, 2)
        u = u.contiguous()
        _A4_PLAIN[key] = (c, tabs, tenants, u, (
            ref.metropolis_multisweep_ref(*args, **tabs, beta=c.betas, n=n, num_sweeps=S),
            ref.metropolis_multisweep_multi_ref(*args, tabs["base_nbr"], tenants["base_J2"],
                                                tenants["tau_J2"], c.betas, n, S),
            ref.metropolis_sweep_ref(*args[:3], u, **tabs, beta=c.betas, n=n)))
    return _A4_PLAIN[key]


@pytest.mark.parametrize(
    "n,L,B,S",
    [(96, 256, 8, 8), (96, 256, 1, 8), (96, 256, 115, 2), (6, 384, 3, 5), (320, 256, 4, 3),
     (96, 256, 8, 0)],
    ids=["main", "B1", "B115", "lpv3", "rows640", "zero-sweeps"],
)
def test_a4_kernels_bit_patterns(n, L, B, S):
    """#3, #4 on distinct tenants and #5 against their plain versions, bit
    pattern for bit pattern (-0.0 != +0.0)."""
    _need_card()
    c, tabs, tenants, u, (want3, want4, want5) = _a4_plain(n, L, B, S)
    args = (c.spins, c.h_space, c.h_tau, c.rng)
    _bits_equal(ops.metropolis_multisweep(*args, **tabs, beta=c.betas, n=n, num_sweeps=S), want3)
    _bits_equal(ops.metropolis_multisweep_multi(*args, tabs["base_nbr"], tenants["base_J2"],
                                                tenants["tau_J2"], c.betas, n, S), want4)
    _bits_equal(ops.metropolis_sweep(*args[:3], u, **tabs, beta=c.betas, n=n), want5)


@pytest.mark.parametrize("n", [16, 32], ids=["rows32", "rows64"])
def test_a4_kernels_bit_patterns_at_every_accepted_tile(n):
    """#3 and #4 with several replicas a CTA (sharing its generator warps)
    equal their plain versions at every tile the CTA takes, and the engine
    takes the knob."""
    _need_card()
    B, S = 8, 3
    c, tabs, tenants, _, (want3, want4, _) = _a4_plain(n, 256, B, S)
    rows, sd = c.spins.shape[1], tabs["base_nbr"].shape[1]
    args = (c.spins, c.h_space, c.h_tau, c.rng)
    checked = []
    for tile in (2, 4, 8):
        for multi, want in ((False, want3), (True, want4)):
            try:
                ops.a4_smem_plan(rows, n, sd, tile, multi)
            except ValueError:
                continue
            checked.append((tile, multi))
            if multi:
                got = ops.metropolis_multisweep_multi(*args, tabs["base_nbr"], tenants["base_J2"],
                                                      tenants["tau_J2"], c.betas, n, S,
                                                      replica_tile=tile)
            else:
                got = ops.metropolis_multisweep(*args, **tabs, beta=c.betas, n=n, num_sweeps=S,
                                                replica_tile=tile)
            _bits_equal(got, want)
    assert checked
    if (2, False) not in checked:
        return
    m = ising.random_layered_model(n=n, L=256, seed=n, beta=1.0)
    tiled = engine.SweepEngine.create(m, rung="a4", backend="cuda", batch=B, replica_tile=2,
                                      device="cuda")
    plain = engine.SweepEngine.create(m, rung="a4", backend="torch", batch=B, device="cuda")
    carry = plain.init_carry(seed=5)
    _bits_equal(tiled.run(carry, S), plain.run(carry, S))


def test_a4_server_with_a_replica_tile_matches_plain():
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=0, beta=1.2)
    out = []
    for backend, tile in (("cuda", 2), ("torch", None)):
        server = SampleServer(m, slots=4, chunk_sweeps=4, rung="a4", backend=backend,
                              device="cuda", replica_tile=tile)
        for i in range(6):
            server.submit(AnnealJob.constant(seed=i, sweeps=5 + 3 * i, beta=0.5 + 0.2 * i))
        out.append({r.jid: r for r in server.drain()})
    for jid, r in out[0].items():
        np.testing.assert_array_equal(r.spins, out[1][jid].spins)
        assert r.energy == out[1][jid].energy


def _recovery_jobs(m, multi):
    jobs = [AnnealJob.constant(seed=30 + i, sweeps=6 + 4 * i, beta=0.6 + 0.1 * i, user=f"u{i % 2}")
            for i in range(5)]
    jobs.append(PTJob(seed=9, betas=np.array([0.5, 0.9, 1.3], np.float32), num_rounds=4,
                      sweeps_per_round=2, user="ladder"))
    if multi:
        jobs.append(AnnealJob.constant(seed=77, sweeps=14, beta=1.0,
                                       model=ising.reseed_couplings(m, 3)))
    return jobs


def _serve(server, jobs, steps=None, snap=None):
    """Submit ``jobs``; drain, or serve ``steps`` rounds and snapshot into
    ``snap``.  Returns (results by jid, retirement order, final pool rng)."""
    for j in jobs:
        server.submit(j)
    if steps is None:
        out = {r.jid: r for r in server.drain()}
    else:
        out = {}
        for _ in range(steps):
            out.update({r.jid: r for r in server.step()})
        server.snapshot(str(snap))
    return out, list(server._retired), server.engine.extract_pool(server.carry).carry.rng


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_restore_on_the_card_is_bit_exact(tmp_path, rung, multi):
    """A card server's snapshot, restored on the card (#1-#4), finishes equal
    to the uninterrupted card run; restored on the CPU with the plain
    backend, equal too ("fast")."""
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=4, beta=1.0)
    kw = dict(slots=4, chunk_sweeps=4, rung=rung, multi_tenant=multi)
    want, order, rng = _serve(SampleServer(m, **kw), _recovery_jobs(m, multi))
    pre, _, _ = _serve(SampleServer(m, **kw), _recovery_jobs(m, multi), steps=3, snap=tmp_path)
    for restore in (dict(), dict(backend="torch", device="cpu")):
        server = SampleServer.restore(str(tmp_path), **restore)
        got, got_order, got_rng = _serve(server, [])
        got.update({jid: r for jid, r in pre.items() if jid not in got})
        assert set(got) == set(want) and got_order == order
        for jid, r in got.items():
            np.testing.assert_array_equal(r.spins, want[jid].spins, err_msg=f"job {jid}")
        np.testing.assert_array_equal(got_rng, rng)


def test_cpu_snapshot_restores_on_the_card(tmp_path):
    """A plain-backend snapshot taken on the CPU is refused on the card with
    the defaults, and continues there with ``backend="cuda"`` bit-equal to
    the CPU's uninterrupted run."""
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=5, beta=1.0)
    kw = dict(slots=4, chunk_sweeps=4, rung="cb", backend="torch", device="cpu")
    want, order, rng = _serve(SampleServer(m, **kw), _recovery_jobs(m, False))
    pre, _, _ = _serve(SampleServer(m, **kw), _recovery_jobs(m, False), steps=3, snap=tmp_path)
    with pytest.raises(ValueError, match="needs backend="):
        SampleServer.restore(str(tmp_path))  # the plain version on the card, unasked
    server = SampleServer.restore(str(tmp_path), backend="cuda")
    assert server.engine.device.type == "cuda"
    got, got_order, got_rng = _serve(server, [])
    got.update({jid: r for jid, r in pre.items() if jid not in got})
    assert set(got) == set(want) and got_order == order
    for jid, r in got.items():
        np.testing.assert_array_equal(r.spins, want[jid].spins, err_msg=f"job {jid}")
    np.testing.assert_array_equal(got_rng, rng)


@pytest.mark.parametrize("caps", [None, (4, 2, 1, 1), (3, 3, 2, 0)], ids=["d4", "ragged", "zero"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_mesh_of_logical_devices_on_the_card_equals_one_device(rung, multi, caps):
    """Four logical devices of the card (a block and a stream each) equal
    one device bit for bit through the kernels, a park on one device and a
    resume on another included; a device of capacity 0 launches nothing."""
    _need_card()
    from repro_torch.launch.mesh import SlotMesh

    m = ising.random_layered_model(n=8, L=256, seed=3, beta=1.0)
    models = [ising.reseed_couplings(m, seed=k) for k in range(8)]

    def make(**kw):
        if multi:
            return engine.SweepEngine.create(models, rung=rung, **kw)
        return engine.SweepEngine.create(m, rung=rung, batch=8, **kw)

    def drive(eng):
        c = eng.run(eng.init_carry(seed=2), 5)
        c = eng.slot(1).resume(c, eng.slot(6).park(c))
        c = eng.set_slot_betas(c, [2, 7], [0.5, 1.5])
        return eng.extract_pool(eng.run(c, 3))

    kernel = {("cb", False): "colored_multisweep", ("cb", True): "colored_multisweep_multi",
              ("a4", False): "metropolis_multisweep",
              ("a4", True): "metropolis_multisweep_multi"}[rung, multi]
    want = drive(make())
    four = make(mesh=SlotMesh(["cuda:0"] * 4), capacities=caps)
    before = ops.launches[kernel]
    got = drive(four)
    assert ops.launches[kernel] - before == 2 * sum(1 for c in four.capacities if c)
    for a, b in zip(got.carry, want.carry):
        np.testing.assert_array_equal(a, b)
    for k in want.tables or ():
        np.testing.assert_array_equal(got.tables[k], want.tables[k])


def test_mesh_server_on_the_card_equals_one_device():
    """A served drain with a PT ladder over four logical devices of the
    card, affine and flat, equals one device job for job."""
    _need_card()
    from repro_torch.launch.mesh import SlotMesh

    m = ising.random_layered_model(n=8, L=256, seed=5, beta=1.0)

    def serve(**kw):
        srv = SampleServer(m, slots=8, chunk_sweeps=4, policy="fifo", **kw)
        for s, b in [(10, 8), (11, 12), (12, 4), (13, 16)]:
            srv.submit(AnnealJob.constant(seed=s, sweeps=b, beta=1.0))
        srv.submit(PTJob(seed=3, betas=np.linspace(0.5, 1.5, 3).astype(np.float32),
                         num_rounds=3, sweeps_per_round=4))
        return {r.jid: r for r in srv.drain()}

    want = serve()
    for placement in ("affine", "flat"):
        got = serve(mesh=SlotMesh(["cuda:0"] * 4), capacities=(4, 2, 1, 1), placement=placement)
        assert sorted(got) == sorted(want)
        for jid, r in got.items():
            np.testing.assert_array_equal(r.spins, want[jid].spins, err_msg=f"job {jid}")


@pytest.mark.parametrize("layout", ["one", "logical"])
def test_retire_rows_on_the_card_equals_spins_flat(layout):
    """`retire_rows` on the card (a gather a device block, a non-blocking
    copy into pinned memory, one wait) crosses as float32 and equals each
    slot's ``spins_flat(extract_slot)`` and `gather_betas` bit for bit: the
    paper's 115 slots on one device, four logical devices of the card; a
    later, smaller call reuses the pinned buffers and leaves the first
    call's arrays as they were."""
    _need_card()
    from repro_torch.launch.mesh import SlotMesh

    m = ising.random_layered_model(n=96, L=256, seed=0, beta=1.0)
    if layout == "one":
        eng = engine.SweepEngine.create(m, rung="cb", batch=115, V=128, device="cuda")
    else:
        eng = engine.SweepEngine.create(m, rung="cb", batch=8, V=128, device="cuda",
                                        mesh=SlotMesh(["cuda:0"] * 4), capacities=(4, 2, 1, 1))
    B = eng.batch
    carry = eng.set_slot_betas(eng.init_carry(seed=3), range(B), np.linspace(0.1, 3.0, B))
    carry = eng.run(carry, 8)
    slots = list(np.random.default_rng(1).permutation(B))
    spins, betas = eng.retire_rows(carry, slots)
    kept = spins.copy()
    few = eng.retire_rows(carry, slots[:2])
    assert spins.dtype == betas.dtype == np.float32
    np.testing.assert_array_equal(spins, kept)
    for i, b in enumerate(slots):
        np.testing.assert_array_equal(spins[i], eng.spins_flat(eng.extract_slot(carry, b))[0])
    np.testing.assert_array_equal(betas, eng.gather_betas(carry, slots).cpu().numpy())
    np.testing.assert_array_equal(few[0], spins[:2])
    np.testing.assert_array_equal(few[1], betas[:2])


@pytest.mark.parametrize("cards", [1, 4], ids=["logical", "cards"])
def test_mesh_launches_timed_per_device_by_events_without_a_wait(monkeypatch, cards):
    """A served mesh of four devices (four logical devices of the card, or
    four cards) with the kernels and a static chunk takes the event-timed
    path: a step that retires nothing neither synchronizes a card nor waits
    for an event; each device counts its own launches; each device's
    launch boxes sit on its own track "device <d>" of the exported trace;
    the jobs, ramped schedules among them, equal one device's bit for bit."""
    _need_card()
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    from repro_torch.launch.mesh import SlotMesh, make_slot_mesh
    from repro_torch.obs import validate_events

    mesh = SlotMesh(["cuda:0"] * 4) if cards == 1 else make_slot_mesh(4)
    m = ising.random_layered_model(n=8, L=256, seed=5, beta=1.0)
    srv = SampleServer(m, slots=8, chunk_sweeps=4, mesh=mesh)
    one = SampleServer(m, slots=8, chunk_sweeps=4, telemetry=False)
    assert srv._event_timing and srv.engine.backend == "cuda"
    for s in (srv, one):
        for i in range(12):
            s.submit(AnnealJob(20 + i, [(4 * (1 + i % 3), 0.1 + 0.4 * k) for k in range(1 + i % 4)]))
    calls = []
    real_sync, real_wait = torch.cuda.synchronize, torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append("synchronize"), real_sync(*a, **k))[1])
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda ev: (calls.append("event"), real_wait(ev))[1])
    got, quiet = [], 0
    while srv.num_active or srv.num_queued:
        before = len(calls)
        done = srv.step()
        got.extend(done)
        if not done:
            quiet += 1
            assert calls[before:] == []
    monkeypatch.undo()
    assert quiet > 0 and len(got) == 12
    want = {r.jid: r for r in one.drain()}
    for r in got:
        np.testing.assert_array_equal(r.spins, want[r.jid].spins)
        np.testing.assert_array_equal(r.energy, want[r.jid].energy)
        assert r.extras["final_beta"] == want[r.jid].extras["final_beta"]
    tel = srv.telemetry
    srv.stats()  # resolves what is still queued
    assert len(tel._pending) == 0 and tel.value("serve.launches_timed") == srv.launches
    for d in range(4):
        assert tel.value("serve.launches_timed", device=d) == srv.engine.device_launches[d] \
            == srv.launches
        assert tel.value("serve.launch_device_s", device=d) > 0
    events = tel.chrome_trace()["traceEvents"]
    validate_events(events)
    tracks = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    boxes = [e for e in events if e["name"] == "engine.launch"]
    for d in range(4):
        assert tracks[1 + d] == f"device {d}"
        assert sum(e["tid"] == 1 + d and e["args"]["device"] == d for e in boxes) == srv.launches


# -- the LM server (chip_smoke.py phase 10's twins, at the smoke sizes) -------------

LM_DENSE = ["qwen2.5-14b", "deepseek-coder-33b", "gemma-2b", "command-r-35b", "internvl2-26b"]


def _lm(arch, dtype, device):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, decoder.init_params(gen, cfg, device=device)


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_decode_on_the_card_matches_teacher_forcing(arch):
    """Prefill 8 tokens and decode 8 on the card, served dtype (bf16),
    against one forward pass: the reference's bound of 0.06."""
    _need_card()
    from repro_torch.models import decoder
    from test_torch_lm_trap import scaled_error

    cfg, model = _lm(arch, "bfloat16", "cuda")
    model.hold_compute_dtype()
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)).cuda()
    with torch.inference_mode():
        lg_tf, _ = decoder.apply(model, toks, cfg)
        lg, caches, _ = decoder.prefill(model, toks[:, :8], cfg, max_len=16)
        assert scaled_error(lg_tf[:, :8].float().cpu().numpy(), lg.float().cpu().numpy()) < 0.06
        for t in range(8, 16):
            lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
            err = scaled_error(lg_tf[:, t].float().cpu().numpy(), lg[:, 0].float().cpu().numpy())
            assert err < 0.06, (arch, t, err)


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_float32_prefill_on_the_card_equals_the_cpu(arch):
    """The same weights' float32 prefill on the card and on the CPU, within
    ROADMAP §3w's F32_LOGITS."""
    _need_card()
    from repro_torch.models import decoder
    from test_torch_lm_trap import F32_LOGITS, scaled_error

    cfg, model = _lm(arch, "float32", "cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = decoder.prefill(model, toks.cuda(), cfg, max_len=16)[0].cpu()
        model.to("cpu")
        with torch.inference_mode():
            cpu = decoder.prefill(model, toks, cfg, max_len=16)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert scaled_error(cpu.numpy(), card.numpy()) <= F32_LOGITS


def test_lm_server_cli_on_the_card(capsys):
    _need_card()
    from repro_torch.launch import serve

    finished = serve.main(["--requests", "6", "--slots", "4", "--max-new", "10"])
    assert len(finished) == 6 and all(len(r.out) == 10 for r in finished)
    assert "served 6 requests, 60 tokens" in capsys.readouterr().out


# -- the other LM families (chip_smoke.py phase 10b's twins, at the smoke sizes) -----

LM_RECURRENT = ["zamba2-1.2b", "rwkv6-1.6b"]


@pytest.mark.parametrize("arch", LM_RECURRENT + ["deepseek-v3-671b", "llama4-scout-17b-a16e"])
def test_lm_family_float32_forward_on_the_card_equals_the_cpu(arch):
    """The same weights' float32 forward on the card and on the CPU (TF32
    off), within ROADMAP §3w's F32_LOGITS."""
    _need_card()
    from repro_torch.models import decoder
    from test_torch_lm_trap import F32_LOGITS, scaled_error

    cfg, model = _lm(arch, "float32", "cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = decoder.apply(model, toks.cuda(), cfg)[0].cpu()
        model.to("cpu")
        with torch.inference_mode():
            cpu = decoder.apply(model, toks, cfg)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert scaled_error(cpu.numpy(), card.numpy()) <= F32_LOGITS


@pytest.mark.parametrize("arch", LM_RECURRENT)
def test_lm_recurrent_decode_on_the_card_matches_teacher_forcing(arch):
    """16 decode steps from empty caches on the card, float32 (TF32 off),
    against one forward pass: the reference's bound of 0.06."""
    _need_card()
    from repro_torch.models import decoder
    from test_torch_lm_trap import scaled_error

    cfg, model = _lm(arch, "float32", "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
                            .astype(np.int32)).cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            lg_tf, _ = decoder.apply(model, toks, cfg)
            caches = decoder.init_decode_caches(cfg, 4, 16, device="cuda")
            for t in range(16):
                lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
                err = scaled_error(lg_tf[:, t].cpu().numpy(), lg[:, 0].cpu().numpy())
                assert err < 0.06, (arch, t, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_lm_encdec_on_the_card_equals_the_cpu():
    """whisper-tiny's smoke encoder-decoder, float32: the card's decode
    logits equal the CPU's within F32_LOGITS."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec
    from test_torch_lm_trap import F32_LOGITS, scaled_error

    cfg = dataclasses.replace(get_config("whisper-tiny", smoke=True), dtype="float32")
    model = encdec.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq, cfg.d_model))
                              .astype(np.float32))

    def decode(device):
        caches = encdec.init_decode_caches(model, frames.to(device), cfg, 8)
        out = []
        for t in range(8):
            lg, caches = encdec.decode_step(model, toks[:, t:t + 1].to(device), caches, t, cfg)
            out.append(lg[:, 0].cpu())
        return torch.stack(out, 1)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = decode("cuda")
            model.to("cpu")
            cpu = decode("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert scaled_error(cpu.numpy(), card.numpy()) <= F32_LOGITS


@pytest.mark.parametrize("arch", LM_RECURRENT + ["deepseek-v3-671b"])
def test_lm_family_server_cli_on_the_card(arch, capsys):
    _need_card()
    from repro_torch.launch import serve

    finished = serve.main(["--arch", arch, "--requests", "5", "--slots", "2", "--max-new", "6"])
    assert len(finished) == 5 and all(len(r.out) == 6 for r in finished)
    assert "served 5 requests, 30 tokens" in capsys.readouterr().out


# -- LM training (chip_smoke.py phase 11's twins, at the smoke sizes) ---------------

LM_ARCHS = LM_DENSE + LM_RECURRENT + ["deepseek-v3-671b", "llama4-scout-17b-a16e",
                                      "whisper-tiny"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_float32_train_step_on_the_card_equals_the_cpu(arch):
    """One float32 train step (TF32 off) on the card and on the CPU from
    the same weights: loss, gradient norm and Adam's m within
    `F32_GRAD_DEEP` (ROADMAP §3aa)."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder, encdec
    from repro_torch.train import step as tstep
    from test_torch_lm_trap import F32_GRAD_DEEP, scaled_error

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rng = np.random.default_rng(0)
    text = 32 - cfg.vlm_patches
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, text)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, text)).astype(np.int32)}
    if cfg.vlm_patches:
        batch["visual_embeds"] = rng.standard_normal((2, cfg.vlm_patches, cfg.d_model), np.float32)
    if cfg.encdec:
        batch["frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), np.float32)
    init = (encdec if cfg.encdec else decoder).init_params
    tc = tstep.TrainConfig()
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = init(torch.Generator().manual_seed(0), cfg, device="cpu").to(dev)
            state, m = tstep.make_train_step(cfg, tc)(
                tstep.init_train_state(model, tc),
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            out.append((m, {n: t.cpu() for n, t in state.opt.m.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (mc, mcard), (mh, mcpu) = out
    for k in ("loss", "grad_norm"):
        assert scaled_error(float(mh[k]), float(mc[k])) <= F32_GRAD_DEEP, k
    for n, want in mcpu.items():
        assert scaled_error(want.numpy(), mcard[n].numpy()) <= F32_GRAD_DEEP, n


def test_lm_train_cli_on_the_card_resumes(tmp_path, capsys):
    """`launch.train` on the card at the smoke config: finite losses,
    periodic checkpoints, a restart resuming at the last step."""
    _need_card()
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import train

    losses = train.main(["--smoke", "--steps", "4", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert CheckpointManager(str(tmp_path)).valid_steps() == [2, 4]
    assert train.main(["--smoke", "--steps", "6", "--ckpt-dir", str(tmp_path)]) != []
    assert "resumed from checkpoint step 4" in capsys.readouterr().out


# -- the PT swap phase (csrc/pt_swap.cu) ------------------------------------------


def _pt_swap_block(R, B, n, L, V, seed, dev):
    """Random +-1 spins of a block of B slots, random betas, and R rows
    scattered over it (not in order, not contiguous), on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(B, generator=g)[:R].to(torch.int32)
    spins = torch.where(torch.rand(B, n * L // V, V, generator=g) < 0.5, -1.0, 1.0)
    betas = 0.1 + 2.9 * torch.rand(B, generator=g)
    return spins.to(dev), betas.to(dev), rows.to(dev)


def _pt_swap_chain(spins, betas, rows, tables, n, flavor, rounds=6, parity=0):
    """``rounds`` chained swap phases, kernel and plain version side by side
    on the card, a tenth of the spins flipped between rounds; asserts each
    round's energies, betas, generator and counters bit-equal.  Returns the
    accepted and proposed pairs."""
    dev = spins.device
    start = (mt.mt_init(1234, dev), torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    got = want = (betas, *start)
    before = ops.launches["pt_swap"]
    g = torch.Generator().manual_seed(99)
    for r in range(rounds):
        p = (parity + r) % 2
        flip = (torch.rand(spins.shape, generator=g) < 0.1).to(dev)
        spins = torch.where(flip, -spins, spins)
        e_got, *got = ops.pt_swap(spins, got[0], rows, *got[1:], *tables, n, p, flavor)
        e_want, *want = ref.pt_swap_ref(spins, want[0], rows, *want[1:], *tables, n, p, flavor)
        torch.cuda.synchronize()
        assert torch.equal(e_got.view(torch.int32), e_want.view(torch.int32)), r
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), r
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b), r
    assert ops.launches["pt_swap"] == before + rounds
    return int(got[2]), int(got[3])


@pytest.mark.parametrize("flavor", ["fast", "accurate", "exact"])
@pytest.mark.parametrize(
    "R,B,n,L,V,parity",
    [(115, 128, 96, 256, 128, 0), (115, 115, 96, 256, 128, 1), (7, 12, 8, 256, 128, 0),
     (7, 9, 8, 256, 128, 1), (2, 3, 6, 384, 128, 1), (5, 9, 8, 16, 4, 0),
     (5, 9, 8, 16, 2, 1), (1250, 1260, 4, 16, 4, 1)],
    ids=["paper", "paper-all-slots", "odd", "odd-parity1", "lpv3", "V4", "V2", "two-blocks"],
)
def test_pt_swap_kernel_bit_equals_plain(R, B, n, L, V, parity, flavor):
    """The kernel against `ref.pt_swap_ref` on the card over chained rounds:
    R = 115 at 96 x 256, odd R, both parities, 3 layer blocks, the plain
    backend's V = 4 and V = 2 (each term taken alone), 1,250 replicas of
    64 spins (two generator blocks a round, the task's tree cut short)."""
    _need_card()
    dev = torch.device("cuda")
    m = ising.random_layered_model(n=n, L=L, seed=n + R, beta=1.0)
    spins, betas, rows = _pt_swap_block(R, B, n, L, V, seed=R + B, dev=dev)
    tables = tempering.model_energy_tables(m, dev)
    accepted, proposed = _pt_swap_chain(spins, betas, rows, tables, n, flavor, parity=parity)
    if R > 3:
        assert 0 < accepted < proposed


def test_pt_swap_kernel_on_a_tenant_and_a_state_off_a_16_byte_boundary():
    """A job's own model (its own tables), and a block of spins that starts
    4 bytes into its storage: the same bits as the plain version."""
    _need_card()
    dev = torch.device("cuda")
    m = ising.reseed_couplings(ising.random_layered_model(n=96, L=256, seed=3, beta=1.0), seed=8)
    spins, betas, rows = _pt_swap_block(115, 120, 96, 256, 128, seed=5, dev=dev)
    flat = torch.empty(spins.numel() + 1, device=dev)
    shifted = flat[1:].view(spins.shape)
    shifted.copy_(spins)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    tables = tempering.model_energy_tables(m, dev)
    accepted, proposed = _pt_swap_chain(shifted, betas, rows, tables, 96, "fast")
    assert 0 < accepted < proposed


@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_pt_job_on_the_card_swaps_in_the_kernel(rung):
    """A served ladder: one swap kernel launch a round, counted as
    `pt_swap_fused`, and the standalone run's result."""
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=4, beta=1.0)
    betas = np.geomspace(0.1, 3.0, 9).astype(np.float32)
    state, _ = tempering.run_parallel_tempering(m, betas, 6, seed=3, sweeps_per_round=3,
                                                rung=rung, backend="cuda")
    server = SampleServer(m, slots=12, chunk_sweeps=2, rung=rung, backend="cuda")
    server.submit(AnnealJob.constant(seed=1, sweeps=7, beta=0.9))
    job = PTJob(seed=3, betas=betas, num_rounds=6, sweeps_per_round=3)
    server.submit(job)
    before = ops.launches["pt_swap"]
    r = {r.jid: r for r in server.drain()}[job.jid]
    assert server.stats()["placement"]["pt_swap_fused"] == 6
    assert ops.launches["pt_swap"] == before + 6
    np.testing.assert_array_equal(r.extras["betas"], state.betas.cpu().numpy())
    assert r.extras["swap_accept"] == int(state.swap_accept)
    assert r.extras["swap_propose"] == int(state.swap_propose)


def test_pt_swap_round_makes_no_host_round_trip():
    """A round's `on_segment` on the card, its rows made anew too, under
    ``torch.cuda.set_sync_debug_mode("error")``: no call waits for the card."""
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=5, beta=1.0)
    server = SampleServer(m, slots=8, chunk_sweeps=2, backend="cuda")
    job = PTJob(seed=2, betas=np.linspace(0.3, 1.5, 6).astype(np.float32), num_rounds=4,
                sweeps_per_round=2)
    server.submit(job)
    server.step()  # admission, the first round and its swap
    taken = server._active[job.jid][1]
    job._rows_key = None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            server.carry = job.on_segment(server, server.carry, taken)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert server.stats()["placement"]["pt_swap_fused"] == 3
