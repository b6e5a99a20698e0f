"""The a4 rung and the MT19937 block, port vs JAX reference.

* the batched `sweep_lane` against the reference's per-replica
  `sweep_lane` (V=4 at two and three layer blocks, V=128);
* the plain `metropolis_multisweep_ref` / `metropolis_sweep_ref` and their
  kernel wrappers on CPU tensors against `repro.kernels.ref` (one and two
  generator blocks a sweep), the wrappers counting no launch;
* `mt_next_block` / `mt_uniforms` and the block loops against the
  reference's MT19937;
* the wrappers' refusals, and the build's hash over the shared headers.

The reference's a4 Pallas kernel does not run on the installed JAX, so
the port is held against the reference's jnp oracles, which the
reference's own tests hold equal to that kernel.  Every comparison is
bit-exact (`assert_array_equal`).  The engine's and the server's a4 runs
are cases of the rung-parametrized tests in test_torch_colored.py and
test_torch_serve.py.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import engine as jeng
from repro.core import ising as jis
from repro.core import metropolis as jmp
from repro.core import mt19937 as jmt
from repro.kernels import ref as jref
from repro_torch.core import convert, fastexp, metropolis
from repro_torch.core import mt19937 as tmt
from repro_torch.kernels import _build, ops, ref


def _pair(n, L, seed=1, beta=1.1):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=beta)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _np(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _tables(tm):
    """The port's a4 tables, as the engine makes them."""
    return dict(
        base_nbr=torch.from_numpy(tm.space_nbr.astype(np.int32)),
        base_J2=torch.from_numpy((2.0 * tm.space_J).astype(np.float32)),
        tau_J2=torch.from_numpy((2.0 * tm.tau_J).astype(np.float32)),
    )


def _jtables(jm):
    return (jnp.asarray(jm.space_nbr), jnp.asarray(2.0 * jm.space_J), jnp.asarray(2.0 * jm.tau_J))


def _random_state(B, rows, V, seed):
    """Spins of +-1 and fields that are arbitrary float32 (not the fields
    of the spins): the sweep's arithmetic must agree on any input."""
    rng = np.random.default_rng(seed)
    spins = np.where(rng.random((B, rows, V)) < 0.5, -1.0, 1.0).astype(np.float32)
    hs = rng.normal(0.0, 1.5, (B, rows, V)).astype(np.float32)
    ht = rng.normal(0.0, 0.5, (B, rows, V)).astype(np.float32)
    u = rng.random((B, rows, V), dtype=np.float32)
    return spins, hs, ht, u


# n, L, V: two layer blocks (every row wraps), three (middle rows), V=128.
SHAPES = [(5, 8, 4), (6, 12, 4), (4, 256, 128)]
SHAPE_IDS = ["V4-lpv2", "V4-lpv3", "V128-lpv2"]


@pytest.mark.parametrize("n,L,V", SHAPES, ids=SHAPE_IDS)
def test_sweep_lane_matches_reference(n, L, V):
    jm, tm = _pair(n, L, seed=n)
    B, rows = 3, n * L // V
    spins, hs, ht, u = _random_state(B, rows, V, seed=rows)
    betas = np.array([0.4, 1.1, 2.3], np.float32)
    t = _tables(tm)
    state = metropolis.LaneState(*(torch.from_numpy(x) for x in (spins, hs, ht)))
    got = metropolis.sweep_lane(
        state, t["base_nbr"], t["base_J2"], t["tau_J2"], torch.from_numpy(u),
        torch.from_numpy(betas), n, fastexp.fastexp_fast,
    )
    for x, orig in zip(state, (spins, hs, ht)):  # carries are values
        np.testing.assert_array_equal(x.numpy(), orig)
    nbr, j2, tau2 = _jtables(jm)
    flips = 0
    for b in range(B):
        want = jmp.sweep_lane(
            jmp.LaneState(jnp.asarray(spins[b]), jnp.asarray(hs[b]), jnp.asarray(ht[b])),
            nbr, j2, tau2, jnp.asarray(u[b]), jnp.float32(betas[b]), n, "fast",
        )
        for a, c in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), c[b].numpy())
        flips += int((np.asarray(want.spins) != spins[b]).sum())
    assert flips > 0  # the sweep did something


# n, L, V, B, S: one generator block a sweep at lpv 2 and 3, two blocks
# (n=160, L=16, V=4 -> 640 rows), and the card's lane width.
MULTI = [(5, 8, 4, 3, 3), (6, 12, 4, 2, 3), (160, 16, 4, 2, 2), (4, 256, 128, 2, 3)]
MULTI_IDS = ["V4-lpv2", "V4-lpv3", "V4-two-blocks", "V128"]


@pytest.mark.parametrize("n,L,V,B,S", MULTI, ids=MULTI_IDS)
def test_multisweep_plain_and_wrapper_match_reference(n, L, V, B, S):
    jm, tm = _pair(n, L, seed=n)
    je = jeng.SweepEngine.create(jm, rung="a4", backend="jnp", batch=B, V=V)
    jc = je.init_carry(seed=7, betas=np.linspace(0.4, 1.6, B, dtype=np.float32))
    tc = convert.carry_from_numpy({f: np.asarray(getattr(jc, f)) for f in jc._fields}, "cpu")
    want = jax.jit(
        lambda s, hs, ht, r, b: jref.metropolis_multisweep_ref(
            s, hs, ht, r, *_jtables(jm), b, n, S
        )
    )(jc.spins, jc.h_space, jc.h_tau, jc.rng, jc.betas)
    t = _tables(tm)
    args = (tc.spins, tc.h_space, tc.h_tau, tc.rng, t["base_nbr"], t["base_J2"], t["tau_J2"],
            tc.betas)
    got = ref.metropolis_multisweep_ref(*args, n=n, num_sweeps=S)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    # The kernel's wrapper takes the plain version on CPU tensors and
    # counts no launch doing so.
    ops.reset_launches()
    for a, b in zip(want, ops.metropolis_multisweep(*args, n=n, num_sweeps=S)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    assert sum(ops.launches.values()) == 0


@pytest.mark.parametrize("n,L,V", SHAPES[1:], ids=SHAPE_IDS[1:])
def test_sweep_plain_and_wrapper_match_reference(n, L, V):
    """One sweep on given uniforms, with the (n, 1) / (B, 1) table and
    beta shapes the reference's wrapper passes."""
    jm, tm = _pair(n, L, seed=3)
    B, rows = 2, n * L // V
    spins, hs, ht, u = _random_state(B, rows, V, seed=11)
    betas = np.array([[0.7], [1.9]], np.float32)
    nbr, j2, tau2 = _jtables(jm)
    want = jref.metropolis_sweep_ref(
        *(jnp.asarray(x) for x in (spins, hs, ht, u)), nbr, j2, tau2.reshape(-1, 1),
        jnp.asarray(betas), n,
    )
    t = _tables(tm)
    args = (*(torch.from_numpy(x) for x in (spins, hs, ht, u)), t["base_nbr"], t["base_J2"],
            t["tau_J2"].reshape(-1, 1), torch.from_numpy(betas))
    ops.reset_launches()
    for fn in (ref.metropolis_sweep_ref, ops.metropolis_sweep):
        got = fn(*args, n=n)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert sum(ops.launches.values()) == 0


@pytest.mark.parametrize("V", [4, 128, 256])
def test_mt_block_wrappers_match_reference(V):
    seeds = np.random.default_rng(V).integers(0, 2**32, V, dtype=np.uint64).astype(np.uint32)
    js, ts = jmt.mt_init(seeds), tmt.mt_init(seeds, device="cpu")
    ops.reset_launches()
    want = jref.mt_next_block_ref(js)
    for a, b in zip(want, ops.mt_next_block(ts)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    new = jmt.mt_twist(js)
    su, u = ops.mt_uniforms(ts)
    np.testing.assert_array_equal(np.asarray(new), _np(su))
    np.testing.assert_array_equal(np.asarray(jmt.uniforms_from_u32(jmt.mt_temper(new))), u.numpy())
    for count in (0, 192, 700):
        jsc, juc = jmt.mt_uniforms_count(js, count)
        tsc, tuc = ops.mt_uniforms_count(ts, count)
        assert tuple(tuc.shape) == (count, V)
        np.testing.assert_array_equal(np.asarray(jsc), _np(tsc))
        np.testing.assert_array_equal(np.asarray(juc), tuc.numpy())
    jsb, jub = jmt.mt_uniform_blocks(js, 2)
    tsb, tub = ops.mt_uniform_blocks(ts, 2)
    np.testing.assert_array_equal(np.asarray(jsb), _np(tsb))
    np.testing.assert_array_equal(np.asarray(jub), tub.numpy())
    assert sum(ops.launches.values()) == 0


def test_wrappers_refuse_other_devices_and_bad_inputs():
    """The wrappers take the plain version ONLY for CPU tensors; any
    other device launches the kernel (CUDA) or raises."""
    B, rows, n = 1, 8, 4
    meta = dict(device="meta")
    st = [torch.empty((B, rows, 128), **meta) for _ in range(3)]
    nbr = torch.empty((n, 2), dtype=torch.int32, **meta)
    j2, tau2 = torch.empty((n, 2), **meta), torch.empty((n,), **meta)
    beta = torch.empty((B,), **meta)
    rng = torch.empty((624, B * 128), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="cuda"):
        ops.metropolis_multisweep(*st, rng, nbr, j2, tau2, beta, n=n, num_sweeps=1)
    with pytest.raises(ValueError, match="num_sweeps"):
        ops.metropolis_multisweep(*st, rng, nbr, j2, tau2, beta, n=n, num_sweeps=-1)
    for flavor in ("accurate", "exact"):  # every flavour reaches the device check
        with pytest.raises(ValueError, match="cuda"):
            ops.metropolis_multisweep(*st, rng, nbr, j2, tau2, beta, n=n, num_sweeps=1,
                                      exp_flavor=flavor)
    with pytest.raises(ValueError, match="unknown exp flavour 'zz'"):
        ops.metropolis_multisweep(*st, rng, nbr, j2, tau2, beta, n=n, num_sweeps=1,
                                  exp_flavor="zz")
    with pytest.raises(ValueError, match="cuda"):
        ops.metropolis_sweep(*st, st[0], nbr, j2, tau2, beta, n=n)
    for fn in (ops.mt_next_block, ops.mt_uniforms):
        with pytest.raises(ValueError, match="cuda"):
            fn(rng)


def test_header_edit_changes_library_path(monkeypatch, tmp_path):
    """A library is named by a hash of its source, every shared header
    and the flags: editing a header must not load a stale library."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first  # deterministic
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._lib_path("k") not in (first, second)


def test_kernel_sources_and_headers_are_all_present():
    """Every source a wrapper builds is in csrc/, and every header a
    source includes exists there (the checkout alone must build)."""
    for name in ops.launches:
        assert (_build.CSRC / f"{name}.cu").exists(), name
    # The multi-tenant kernels and the headers they share with the
    # single-model ones.
    for name in ("colored_multisweep_multi", "metropolis_multisweep_multi"):
        assert name in ops.launches, name
    shared = {"colored_sweep.cuh": ("colored_multisweep", "colored_multisweep_multi"),
              "a4_sweep.cuh": ("metropolis_multisweep", "metropolis_multisweep_multi")}
    for header, users in shared.items():
        for name in users:
            assert f'#include "{header}"' in (_build.CSRC / f"{name}.cu").read_text(), name
    for src in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build.CSRC / inc).exists(), f"{src.name} includes missing {inc}"
