"""Public names of the ported annealing modules that the reference's
callers use (ROADMAP §3v): `mt19937.mt_next_block`, `mt_temper(y=)`,
`LayeredModel.max_degree` and `fastexp.fastexp_accurate(x, clamp=)`, each
against the reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import fastexp as jfx
from repro.core import ising as jising
from repro.core import mt19937 as jmt
from repro_torch.core import fastexp as tfx
from repro_torch.core import ising as tising
from repro_torch.core import mt19937 as tmt
from repro_torch.kernels import ref
from test_torch_fastexp import GRID, RANDOM, SPECIAL, _ulps
from test_torch_rsqrt import _f64_path, _rsqrt_f32


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("V", [1, 4, 128])
def test_mt_next_block_is_the_references(V):
    seeds = np.arange(1, V + 1, dtype=np.uint32) * 7919
    js, ts = jmt.mt_init(seeds), tmt.mt_init(seeds, device="cpu")
    for _ in range(3):  # chained blocks
        js, jout = jmt.mt_next_block(js)
        ts, tout = tmt.mt_next_block(ts)
        assert ts.shape == tout.shape == (624, V) and tout.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(js), _u32(ts))
        np.testing.assert_array_equal(np.asarray(jout), _u32(tout))
    new, words = ref.mt_next_block_ref(ts)
    assert torch.equal(new, tmt.mt_next_block(ts)[0]) and torch.equal(words,
                                                                     tmt.mt_next_block(ts)[1])


def test_mt_next_block_of_a_scalar_generator():
    js, jout = jmt.mt_next_block(jmt.mt_init(5489))
    ts, tout = tmt.mt_next_block(tmt.mt_init(5489, device="cpu"))
    np.testing.assert_array_equal(np.asarray(jout), _u32(tout))
    assert _u32(tout)[0] == 3499211612  # std::mt19937's first output


def test_mt_temper_takes_y():
    y = np.random.default_rng(0).integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jmt.mt_temper(y=jnp.asarray(y)))
    got = tmt.mt_temper(y=torch.from_numpy(y.view(np.int32)))
    np.testing.assert_array_equal(want, _u32(got))


@pytest.mark.parametrize("n,L,seed", [(8, 16, 0), (96, 256, 1), (30, 4, 7)])
def test_max_degree_is_the_references(n, L, seed):
    jm = jising.random_layered_model(n, L, seed=seed)
    tm = tising.random_layered_model(n, L, seed=seed)
    assert tm.max_degree == jm.max_degree == tm.space_degree + 2


@pytest.mark.parametrize("inputs", [GRID, RANDOM, SPECIAL], ids=["grid", "random", "special"])
def test_unclamped_accurate_within_2_ulp_of_the_reference(inputs):
    """``clamp=False`` skips both masks, as the reference does; within §3b's
    2 ulps of the reference, bit-equal to the masked path where no mask
    acts."""
    want = np.asarray(jfx.fastexp_accurate(jnp.asarray(inputs), clamp=False))
    got = tfx.fastexp_accurate(torch.from_numpy(inputs), clamp=False).numpy()
    assert _ulps(want, got).max() <= 2
    masked = tfx.fastexp_accurate(torch.from_numpy(inputs)).numpy()
    free = ~(inputs < tfx.ACCURATE_LO_F32) & ~(inputs > 0)
    np.testing.assert_array_equal(got[free].view(np.uint32), masked[free].view(np.uint32))


def test_unclamped_accurate_below_and_above_the_range():
    """Below -31.5 ln 2 the clipped interpolant is subnormal and flushed
    (§3f), so the root is 0 as the mask would make it; above 0 no floor of
    1 is applied: the root of the interpolant, which the reference gives too."""
    x = np.array([-1e10, -50.0, tfx.ACCURATE_LO - 1.0, 1e-3, 0.5, 10.0, 50.0, 1e10],
                 np.float32)
    want = np.asarray(jfx.fastexp_accurate(jnp.asarray(x), clamp=False))
    got = tfx.fastexp_accurate(torch.from_numpy(x), clamp=False).numpy()
    assert (got[:3] == 0.0).all() and (want[:3] == 0.0).all()
    assert _ulps(want, got).max() <= 2
    assert got[3] < 1.0 <= tfx.fastexp_accurate(torch.from_numpy(x[3:4])).item()


def test_unclamped_accurate_rsqrt_on_its_own_inputs():
    """§3m for the new caller: the values the unmasked path feeds its two
    reciprocal square roots (the interpolant of 4y over the clip range,
    reached from inputs past both ends too, and the first root) give the
    float64 path's bits in the card's float32 rsqrt (`csrc/fastexp.cuh:
    rsqrt_f32`, emulated) from every start within 2 ulps."""
    x = np.concatenate([np.linspace(-60.0, 40.0, 400_001, dtype=np.float32), SPECIAL])
    xc = torch.clamp(tfx.flush_subnormal(torch.from_numpy(x)), float(tfx.ACCURATE_LO_F32),
                     float(tfx.ACCURATE_CLIP_HI_F32))
    f = tfx._interpolant(xc * torch.tensor(tfx.SCALE4_F32)).numpy()
    v = f[np.isfinite(f) & (f >= np.finfo(np.float32).tiny)]
    v = np.unique(np.concatenate([v, _f64_path(v)]))
    want = _f64_path(v)
    for k in (-2, -1, 0, 1, 2):
        y = (want.view(np.uint32).astype(np.int64) + k).astype(np.uint32).view(np.float32)
        got, _ = _rsqrt_f32(v, y)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
