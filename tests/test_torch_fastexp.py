"""The paper's exponential (§2.4), port vs JAX reference.

* the flush of subnormal results: the port's "fast" exp is bit-equal to
  the reference's on the grid [-180, -80], where the reference returns 0
  and an unflushed exp returns subnormals such as 3e-42 (x in about
  [-88.03, -87.31]), and on 2^20 random inputs in [-200, 200];
* the paper's error envelopes, ported from tests/test_fastexp.py;
* "accurate": its masking, the band just above ``ACCURATE_LO`` where the
  flushed interpolant makes the root 0, and agreement with the reference
  within 2 ulp; "exact" within 1 ulp;
* `ops.fastexp` (kernel #7's wrapper) == `ref.fastexp_ref` == the
  reference's `ops.fastexp` (its Pallas kernel in interpret mode), for the
  reference test's shapes and dtypes;
* the refusals: "exact" and unknown flavours in `ops.fastexp`, and every
  flavour but "fast" in the sweep kernels' wrappers off the CPU.

Tolerances.  "fast" is compared bit for bit.  The reference's ``rsqrt`` is
an approximation of its own (it differs from a correctly rounded rsqrt on
about 13% of inputs), while the port takes each reciprocal square root as
a float64 ``1 / sqrt`` rounded to float32, the same on the CPU and the
card; measured, the two "accurate" results differ by at most 2 ulp.  The
reference's ``exp`` differs from ``torch.exp`` by at most 1 ulp below
x = 88.5, and by up to 5 ulp in the last tenth before float32 overflows
(x in [88.6, 88.72]), where the port's is the closer one to the float64
exp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import fastexp as jfx
from repro.kernels import ops as jops
from repro_torch.core import fastexp as tfx
from repro_torch.core import ising, reorder
from repro_torch.kernels import ops, ref

GRID = np.linspace(-180.0, -80.0, 200_001).astype(np.float32)
RANDOM = np.random.default_rng(0).uniform(-200.0, 200.0, 2**20).astype(np.float32)
SPECIAL = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-45, -1e-45, 1.1e-38, 1e10, -1e10,
     88.7, 89.0, 89.5, 90.0, -87.5, -88.0, jfx.ACCURATE_LO, jfx.ACCURATE_HI],
    np.float32,
)


def _jax(flavor, x):
    return np.asarray(jfx.EXP_FNS[flavor](jnp.asarray(x)))


def _port(flavor, x):
    return tfx.EXP_FNS[flavor](torch.from_numpy(x)).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ulps(a, b):
    """|a - b| in float32 ulps (ordered integer distance); NaN == NaN."""

    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = np.abs(ordered(a) - ordered(b))
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


@pytest.mark.parametrize("inputs", [GRID, RANDOM, SPECIAL], ids=["grid", "random", "special"])
def test_fast_flushes_subnormals_like_jax(inputs):
    """Bit-equal to the reference, signed zeros, inf and NaN included.
    Before the flush the grid differed on 1,443 of 200,001 inputs."""
    np.testing.assert_array_equal(_bits(_jax("fast", inputs)), _bits(_port("fast", inputs)))


def test_fast_flush_is_a_select_not_a_global_mode():
    """The grid's flushed band comes out as zeros while the process keeps
    subnormal arithmetic: the flush is local to the exp."""
    band = GRID[(GRID > -88.03) & (GRID < -87.31)]
    out = _port("fast", band)
    assert band.size > 1000 and (out == 0.0).sum() > 1000
    tiny = torch.tensor([1e-38], dtype=torch.float32) / 1000.0
    assert 0.0 < float(tiny) < tfx.FLT_MIN  # subnormals still exist elsewhere
    r = torch.tensor([3e-42, -3e-42, 2e-38, float("nan")], dtype=torch.float32)
    got = tfx.flush_subnormal(r).numpy()
    np.testing.assert_array_equal(_bits(got[:3]), _bits(np.array([0.0, -0.0, 2e-38], np.float32)))
    assert np.isnan(got[3])


def test_fast_error_envelope():
    # Paper: linear interpolation scaled by 2 ln^2 2 -> err in (-3.92%, +2.0%).
    x = np.linspace(tfx.ACCURATE_LO, tfx.ACCURATE_HI - 0.01, 200_001).astype(np.float32)
    r = _port("fast", x).astype(np.float64) / np.exp(x.astype(np.float64)) - 1
    assert r.max() <= 0.0201, r.max()
    assert r.min() >= -0.0392, r.min()
    # Mean relative error centred near zero (the 2 ln^2 2 scaling's purpose).
    assert abs(r.mean()) < 2e-3


def test_accurate_error_envelope():
    # Paper: roughly (-0.01, +0.005).
    x = np.linspace(tfx.ACCURATE_LO + 0.01, tfx.ACCURATE_HI - 0.01, 200_001).astype(np.float32)
    r = _port("accurate", x).astype(np.float64) / np.exp(x.astype(np.float64)) - 1
    assert r.max() <= 0.0051, r.max()
    assert r.min() >= -0.0105, r.min()


@pytest.mark.parametrize("seed", range(4))
def test_fast_matches_interpolant(seed):
    """The reference's property test, on four seeds: within 4% of exp."""
    x = np.random.default_rng(seed).uniform(-20, 20, size=64).astype(np.float32)
    r = np.abs(_port("fast", x).astype(np.float64) / np.exp(x.astype(np.float64)) - 1)
    assert r.max() < 0.04


def test_accurate_masking():
    # 0.0 below -31.5 ln 2; >= 1.0 for x > 0 (Metropolis always-accept).
    x = np.asarray([tfx.ACCURATE_LO - 1.0, -50.0, 0.5, 1e-3, 10.0], np.float32)
    y = _port("accurate", x)
    assert y[0] == 0.0 and y[1] == 0.0
    assert (y[2:] >= 1.0 - 1e-7).all()


def test_accurate_root_of_a_flushed_interpolant_is_zero():
    """Just above ``ACCURATE_LO`` the interpolant of 2^(4y) is subnormal;
    the reference flushes it, and rsqrt(rsqrt(0)) = 0.  Without the flush
    the root would be about 3.3e-10.  The zeros coincide with the
    reference's exactly; the other roots are within the 2 ulp stated."""
    lo = np.float32(tfx.ACCURATE_LO)
    band = (lo + np.random.default_rng(3).uniform(0.0, 0.02, 2**16)).astype(np.float32)
    want, got = _jax("accurate", band), _port("accurate", band)
    np.testing.assert_array_equal(want == 0.0, got == 0.0)
    assert 0 < (got == 0.0).sum() < band.size  # the band holds both cases
    assert _ulps(want, got).max() <= 2


@pytest.mark.parametrize("inputs", [GRID, RANDOM, SPECIAL], ids=["grid", "random", "special"])
def test_accurate_within_2_ulp_of_jax(inputs):
    """The stated tolerance: 2 ulp (the reference's rsqrt is approximate).
    A positive subnormal input counts as zero, as in the reference (not
    "x > 0": the result stays 0.99, not 1.0)."""
    assert _ulps(_jax("accurate", inputs), _port("accurate", inputs)).max() <= 2


@pytest.mark.parametrize("inputs", [GRID, RANDOM, SPECIAL], ids=["grid", "random", "special"])
def test_exact_within_1_ulp_of_jax(inputs):
    """1 ulp below x = 88.5; in [88.5, 88.72] the reference's exp loses
    up to 5 ulp (stated above), and the port's is within 1 ulp of the
    float64 exp there."""
    want, got = _jax("exact", inputs), _port("exact", inputs)
    low = ~(inputs >= 88.5)
    assert _ulps(want[low], got[low]).max() <= 1
    top = inputs[~low & (inputs < tfx.FAST_HI)]
    if top.size:
        truth = np.exp(top.astype(np.float64)).astype(np.float32)
        assert _ulps(truth, _port("exact", top)).max() <= 1
        assert _ulps(want[~low & (inputs < tfx.FAST_HI)], got[~low & (inputs < tfx.FAST_HI)]).max() <= 5


def test_exact_flushes_subnormal_results():
    x = np.array([-88.0, -95.0, -103.0, -104.0], np.float32)  # e^x subnormal or 0 in float32
    np.testing.assert_array_equal(_bits(_port("exact", x)), np.zeros(4, np.uint32))
    np.testing.assert_array_equal(_bits(_jax("exact", x)), np.zeros(4, np.uint32))


@pytest.mark.parametrize("flavor", ["fast", "accurate"])
@pytest.mark.parametrize("shape", [(7,), (128,), (1000,), (3, 5, 11), (256, 128)])
def test_ops_fastexp_matches_ref_and_reference_kernel(flavor, shape):
    """The wrapper on CPU tensors is the plain version, counts no launch,
    and agrees with the reference's Pallas kernel (interpret mode): bit
    for bit under "fast", within 2 ulp under "accurate"."""
    x = np.random.default_rng(42).uniform(-20, 20, size=shape).astype(np.float32)
    ops.reset_launches()
    got = ops.fastexp(torch.from_numpy(x), flavor)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert sum(ops.launches.values()) == 0
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref.fastexp_ref(torch.from_numpy(x), flavor).numpy()))
    want = np.asarray(jops.fastexp(jnp.asarray(x), flavor, interpret=True))
    if flavor == "fast":
        np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    else:
        assert _ulps(want, got.numpy()).max() <= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_ops_fastexp_dtypes(dtype):
    """Half-precision input converts exactly to float32 first: bit-equal to
    the float32 path on the converted values and to the reference kernel."""
    xs = np.linspace(-5, 5, 384).astype(np.float32)
    jx = jnp.asarray(xs).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(xs).to(getattr(torch, dtype))
    got = ops.fastexp(tx, "fast")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref.fastexp_ref(tx.float()).numpy()))
    np.testing.assert_array_equal(
        _bits(np.asarray(jops.fastexp(jx, "fast", interpret=True))), _bits(got.numpy())
    )


def test_ops_fastexp_refusals():
    """"exact" (which the reference's kernel quietly computes as
    "accurate") and unknown flavours are refused; other dtypes too; a
    tensor on neither the CPU nor a CUDA device launches nothing."""
    x = torch.zeros(8)
    for flavor in ("exact", "zz"):
        with pytest.raises(ValueError, match=repr(flavor)):
            ops.fastexp(x, flavor)
        with pytest.raises(ValueError, match=repr(flavor)):
            ref.fastexp_ref(x, flavor)
    with pytest.raises(ValueError, match="float64"):
        ops.fastexp(x.double())
    ops.reset_launches()
    with pytest.raises(ValueError, match="cuda"):
        ops.fastexp(torch.empty(8, device="meta"))
    assert ops.launches["fastexp_2d"] == 0


def test_sweep_wrappers_refuse_other_flavours_off_the_cpu():
    """The sweep kernels take every flavour of `fastexp.EXP_FNS`: on a
    tensor of another device "accurate" and "exact" reach the device check
    as "fast" does, and only an unknown flavour is refused by name, before
    it (the colored entries refuse it when they are built)."""
    meta = torch.empty((1, 8, 128), device="meta")
    kw = dict(n=4, num_sweeps=1)
    for flavor in ("fast", "accurate", "exact"):
        for fn in (ops.metropolis_multisweep, ops.metropolis_multisweep_multi):
            with pytest.raises(ValueError, match="cuda"):
                fn(*[meta] * 8, **kw, exp_flavor=flavor)
        with pytest.raises(ValueError, match="cuda"):
            ops.metropolis_sweep(*[meta] * 8, n=4, exp_flavor=flavor)
    for fn in (ops.metropolis_multisweep, ops.metropolis_multisweep_multi):
        with pytest.raises(ValueError, match="'zz'"):
            fn(*[meta] * 8, **kw, exp_flavor="zz")
    with pytest.raises(ValueError, match="'zz'"):
        ops.metropolis_sweep(*[meta] * 8, n=4, exp_flavor="zz")
    m = ising.random_layered_model(n=4, L=256, seed=0)
    classes = reorder.colored_classes(m, 128)
    single = ops.make_colored_multisweep(classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=4,
                                         exp_flavor="accurate")
    multi = ops.make_colored_multisweep_multi(classes, m.space_nbr, n=4, exp_flavor="exact")
    with pytest.raises(ValueError, match="cuda"):
        single(meta, meta, meta, 1)
    with pytest.raises(ValueError, match="cuda"):
        multi(meta, meta, meta, meta, meta, meta, 1)
    with pytest.raises(ValueError, match="'zz'"):
        ops.make_colored_multisweep(classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=4,
                                    exp_flavor="zz")
    with pytest.raises(ValueError, match="'zz'"):
        ops.make_colored_multisweep_multi(classes, m.space_nbr, n=4, exp_flavor="zz")