"""The port's MT19937 and fast exp against the JAX reference, bit for bit.

Inputs are numpy arrays made from seeds and handed to both packages; MT
state is compared as uint32 (the port stores it as int32 holding the
same bits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import fastexp as jfx
from repro.core import mt19937 as jmt
from repro_torch.core import fastexp as tfx
from repro_torch.core import mt19937 as tmt

SHAPES = [(), (4,), (256,)]  # lane shapes of the (624,) + shape state


def _seeds(shape, salt=0):
    rng = np.random.default_rng(1234 + salt)
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", SHAPES, ids=["624", "624x4", "624x256"])
def test_mt_init_twist_temper_match_jax(shape):
    seeds = _seeds(shape)
    js = jmt.mt_init(seeds)
    ts = tmt.mt_init(seeds, device="cpu")
    assert ts.dtype == torch.int32 and tuple(ts.shape) == (624,) + shape
    np.testing.assert_array_equal(np.asarray(js), _u32(ts))
    np.testing.assert_array_equal(np.asarray(jmt.mt_twist(js)), _u32(tmt.mt_twist(ts)))
    np.testing.assert_array_equal(np.asarray(jmt.mt_temper(js)), _u32(tmt.mt_temper(ts)))


@pytest.mark.parametrize("count", [192, 640, 1300])
@pytest.mark.parametrize("shape", SHAPES, ids=["624", "624x4", "624x256"])
def test_mt_uniforms_count_matches_jax(shape, count):
    seeds = _seeds(shape, salt=count)
    js, ju = jmt.mt_uniforms_count(jmt.mt_init(seeds), count)
    ts, tu = tmt.mt_uniforms_count(tmt.mt_init(seeds, device="cpu"), count)
    assert tu.dtype == torch.float32 and tuple(tu.shape) == (count,) + shape
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(js), _u32(ts))


def test_scalar_reference_known_answer():
    """C++ std::mt19937 (default seed 5489): the 10000th output."""
    ref = tmt.ScalarMT19937Ref()
    for _ in range(9999):
        ref.next_u32()
    assert ref.next_u32() == 4123659995


def test_interlaced_lanes_equal_scalar_generators():
    """Lane k of the interlaced generator is the scalar MT19937 seeded
    with seeds[k]: three blocks of tempered outputs, and the port's scalar
    reference equals the JAX package's."""
    seeds = np.array([5489, 1, 2**32 - 1, 12345], np.uint32)
    state = tmt.mt_init(seeds, device="cpu")
    words = []
    for _ in range(3):
        state = tmt.mt_twist(state)
        words.append(_u32(tmt.mt_temper(state)))
    words = np.concatenate(words)
    for k, s in enumerate(seeds):
        mine, theirs = tmt.ScalarMT19937Ref(int(s)), jmt.ScalarMT19937Ref(int(s))
        expect = [mine.next_u32() for _ in range(3 * 624)]
        assert expect == [theirs.next_u32() for _ in range(3 * 624)]
        np.testing.assert_array_equal(words[:, k], np.asarray(expect, np.uint32))


def test_fastexp_constants_round_like_jax():
    for mine, theirs in [
        (tfx.SCALE_F32, jnp.float32((1 << 23) * jfx.LOG2_E)),
        (tfx.CENTRE_F32, jnp.float32(jfx.TWO_LN2_SQ)),
    ]:
        assert tfx.f32_bits(mine) == int(np.asarray(theirs).view(np.uint32))


def test_fastexp_matches_jax_on_random_inputs():
    x = np.random.default_rng(7).uniform(-80.0, 80.0, 2**16).astype(np.float32)
    a = np.asarray(jfx.fastexp_fast(jnp.asarray(x)))
    b = tfx.fastexp_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize(
    "x", [-300.0, -178.0, 178.0, 300.0, 1e10, -1e10, np.inf, -np.inf, np.nan, 177.0, -177.0]
)
def test_fastexp_saturation_matches_jax(x):
    """Past |x| ~ 177.4 the float->int32 step saturates (NaN -> 0) and the
    bias add wraps; the port must reproduce those bits, not torch's own
    float->int32 conversion."""
    arr = np.full(4, x, np.float32)
    a = np.asarray(jfx.fastexp_fast(jnp.asarray(arr)))
    b = tfx.fastexp_fast(torch.from_numpy(arr)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_torch_int_conversion_differs_where_the_port_must_not():
    """Documents the trap: torch's CPU float->int32 conversion does not
    saturate, so a direct transcription would differ from the reference."""
    y = torch.tensor([1e10, np.nan], dtype=torch.float32) * float(tfx.SCALE_F32)
    direct = y.to(torch.int32).tolist()
    assert direct != [2**31 - 1, 0]
    port = tfx.fastexp_fast(torch.tensor([1e10, np.nan], dtype=torch.float32)).numpy()
    ref = np.asarray(jfx.fastexp_fast(jnp.asarray([1e10, np.nan], jnp.float32)))
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))


def test_unported_exp_flavour_raises():
    """Every flavour of the reference is ported; an unknown one raises,
    naming itself."""
    with pytest.raises(ValueError, match="zz"):
        tfx.exp_fn("zz")
    assert tfx.exp_fn("accurate") is tfx.fastexp_accurate
    assert tfx.exp_fn("exact") is tfx.exp_reference
    assert tfx.exp_fn("fast") is tfx.fastexp_fast
