"""The colored ("cb") multisweep and the engine, port vs JAX reference.

* the port's plain `colored_multisweep_ref` against the reference's Pallas
  kernel in interpret mode and against the reference's jnp oracle;
* the port's kernel wrapper on CPU tensors (it takes the plain version);
* the port's engine (backend "torch", CPU) against the reference's engine
  (backend "jnp") at V=4 and V=128, including two generator blocks per
  sweep (n=160, L=16, V=4 -> 640 rows), on the rungs "cb" and "a4";
* slot splice/extract/park/resume round-trips, on both rungs;
* the ValueErrors of misuse (bad model lists, slot models on a
  single-model engine) and of everything not ported yet.

Every comparison is bit-exact (`assert_array_equal`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import engine as jeng
from repro.core import ising as jis
from repro.core import reorder as jro
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import convert, engine, fastexp, ising, metropolis, reorder
from repro_torch.kernels import _build, ops, ref
from repro_torch.serve_mc import SampleServer


def _pair(n, L, seed=1, beta=1.1):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=beta)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _np(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _carry_equal(jc, tc, msg=""):
    host = convert.carry_to_numpy(tc)
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), host[f], err_msg=f"{msg} {f}")


def _plain_tables(tm, V):
    classes = metropolis.classes_to(reorder.colored_classes(tm, V), "cpu")
    tabs = dict(
        h=torch.from_numpy(tm.h),
        base_nbr=torch.from_numpy(tm.space_nbr.astype(np.int64)),
        base_J=torch.from_numpy(tm.space_J),
        tau_J=torch.from_numpy(tm.tau_J),
    )
    return classes, tabs


def _inputs(jm, B, V, seed):
    """A reference carry with spread betas, and the same bytes for the port."""
    jeng_ = jeng.SweepEngine.create(jm, rung="cb", backend="jnp", batch=B, V=V)
    jc = jeng_.init_carry(seed=seed, betas=np.linspace(0.4, 1.6, B, dtype=np.float32))
    return jc, convert.carry_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in jc._fields}, device="cpu"
    )


@pytest.mark.parametrize("n,L,B,S", [(4, 256, 2, 2), (6, 384, 2, 1)], ids=["lpv2", "lpv3"])
def test_plain_matches_pallas_interpret(n, L, B, S):
    jm, tm = _pair(n, L)
    jc, tc = _inputs(jm, B, 128, seed=5)
    fn = jops.make_colored_multisweep(
        jro.colored_classes(jm, 128), jm.h, jm.space_nbr, jm.space_J, jm.tau_J, n=n,
        interpret=True,
    )
    want = fn(jc.spins, jc.rng, jc.betas, S)
    classes, tabs = _plain_tables(tm, 128)
    got = ref.colored_multisweep_ref(tc.spins, tc.rng, tc.betas, classes, **tabs, n=n, num_sweeps=S)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize(
    "n,L,V,B,S",
    [(5, 8, 4, 3, 3), (6, 12, 4, 2, 3), (160, 16, 4, 2, 2), (4, 256, 128, 2, 3)],
    ids=["V4-lpv2", "V4-lpv3", "V4-two-blocks", "V128"],
)
def test_plain_and_wrapper_match_jnp_oracle(n, L, V, B, S):
    jm, tm = _pair(n, L, seed=n)
    jc, tc = _inputs(jm, B, V, seed=7)
    classes_j = jro.colored_classes(jm, V)
    want = jax.jit(
        lambda s, r, b: jref.colored_multisweep_ref(
            s, r, b, classes_j, jm.h, jm.space_nbr, jm.space_J, jm.tau_J, n, S
        )
    )(jc.spins, jc.rng, jc.betas)
    classes, tabs = _plain_tables(tm, V)
    got = ref.colored_multisweep_ref(tc.spins, tc.rng, tc.betas, classes, **tabs, n=n, num_sweeps=S)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    if V == ops.LANES:
        # The kernel's wrapper takes the plain version on CPU tensors and
        # counts no launch doing so.
        ops.reset_launches()
        fn = ops.make_colored_multisweep(
            reorder.colored_classes(tm, V), tm.h, tm.space_nbr, tm.space_J, tm.tau_J, n=n
        )
        for a, b in zip(want, fn(tc.spins, tc.rng, tc.betas, S)):
            np.testing.assert_array_equal(np.asarray(a), _np(b))
        assert ops.launches["colored_multisweep"] == 0


@pytest.mark.parametrize("rung", ["cb", "a4"])
@pytest.mark.parametrize(
    "n,L,V,B", [(5, 16, 4, 3), (160, 16, 4, 2), (4, 256, 128, 2)],
    ids=["V4", "V4-two-blocks", "V128"],
)
def test_engine_matches_jax_engine(n, L, V, B, rung):
    jm, tm = _pair(n, L, seed=2)
    je = jeng.SweepEngine.create(jm, rung=rung, backend="jnp", batch=B, V=V)
    te = engine.SweepEngine.create(tm, rung=rung, backend="torch", batch=B, V=V, device="cpu")
    jc, tc = je.init_carry(seed=4), te.init_carry(seed=4)
    _carry_equal(jc, tc, "init")
    for k in (3, 1, 2):  # consecutive runs of different lengths
        jc, tc = je.run(jc, k), te.run(tc, k)
        _carry_equal(jc, tc, f"after run({k})")
    np.testing.assert_array_equal(je.spins_flat(jc), te.spins_flat(tc))
    for a, b in zip(je.state_of(jc, B - 1), te.state_of(tc, B - 1)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sweep_colored_matches_reference():
    """One sweep of the batched `sweep_colored` against the reference's
    per-replica function on the same spins and uniforms."""
    from repro.core import metropolis as jmp

    jm, tm = _pair(6, 12, seed=3)
    B, V, rows = 2, 4, 18
    rng = np.random.default_rng(0)
    lanes = np.where(rng.random((B, rows, V)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((B, rows, V), dtype=np.float32)
    betas = np.array([0.6, 1.8], np.float32)
    classes, tabs = _plain_tables(tm, V)
    st = torch.from_numpy(lanes)
    got = metropolis.sweep_colored(
        metropolis.LaneState(st, st, st), classes, tabs["h"], tabs["base_nbr"],
        tabs["base_J"], tabs["tau_J"], torch.from_numpy(u), torch.from_numpy(betas), 6,
        exp_fn=fastexp.fastexp_fast,
    )
    for b in range(B):
        s = jnp.asarray(lanes[b])
        want = jmp.sweep_colored(
            jmp.LaneState(s, s, s), jro.colored_classes(jm, V), jnp.asarray(jm.h),
            jnp.asarray(jm.space_nbr), jnp.asarray(jm.space_J), jnp.asarray(jm.tau_J),
            jnp.asarray(u[b]), jnp.float32(betas[b]), 6, "fast",
        )
        for a, c in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), c[b].numpy())


def test_engine_inputs_spins_and_betas_match():
    jm, tm = _pair(5, 16, seed=8)
    spins = np.where(np.random.default_rng(2).random((2, 80)) < 0.5, -1.0, 1.0).astype(np.float32)
    betas = np.array([0.7, 1.9], np.float32)
    je = jeng.SweepEngine.create(jm, rung="cb", backend="jnp", batch=2, V=4)
    te = engine.SweepEngine.create(tm, rung="cb", backend="torch", batch=2, V=4, device="cpu")
    jc = je.run(je.init_carry(seed=1, spins=spins, betas=betas), 5)
    tc = te.run_fn(5)(te.init_carry(seed=1, spins=spins, betas=betas))
    _carry_equal(jc, tc)


@pytest.mark.parametrize("rung", ["cb", "a4"])
@pytest.mark.parametrize("V,n,L", [(4, 5, 16), (128, 4, 256)], ids=["V4", "V128"])
def test_slot_round_trips_match_jax(V, n, L, rung):
    jm, tm = _pair(n, L, seed=6)
    je = jeng.SweepEngine.create(jm, rung=rung, backend="jnp", batch=3, V=V)
    te = engine.SweepEngine.create(tm, rung=rung, backend="torch", batch=3, V=V, device="cpu")
    jc, tc = je.run(je.init_carry(seed=2), 2), te.run(te.init_carry(seed=2), 2)
    # Fresh slot carries agree, splice into slot 1, set slot 2's beta.
    js, ts = je.init_slot_carry(seed=9, beta=0.8), te.init_slot_carry(seed=9, beta=0.8)
    _carry_equal(js, ts, "slot carry")
    # Seeded beside other slots in one pass, the slot's generators are the same.
    rngs = te.seed_slot_rngs([engine.lane_seeds(1, V, s) for s in (3, 9, 4)])
    _carry_equal(js, te.init_slot_carry(seed=9, beta=0.8, rng_state=rngs[1]), "batch-seeded")
    jc, tc = je.splice_slot(jc, 1, js), te.slot(1).splice(tc, ts)
    jc, tc = je.set_slot_betas(jc, [2], [1.7]), te.set_slot_betas(tc, [2], [1.7])
    _carry_equal(jc, tc, "spliced")
    # Park slot 0, run, resume it into slot 2: a trajectory is slot-independent.
    jp, tp = je.slot(0).park(jc), te.slot(0).park(tc)
    _carry_equal(jp.carry, tp.carry, "parked")
    assert tp.tables is None
    jc, tc = je.run(jc, 3), te.run(tc, 3)
    jc, tc = je.slot(2).resume(jc, jp), te.slot(2).resume(tc, tp)
    jc, tc = je.run(jc, 2), te.run(tc, 2)
    _carry_equal(jc, tc, "resumed")
    # extract is the exact inverse of splice, and never aliases the carry.
    before = convert.carry_to_numpy(tc)
    ex = te.extract_slot(tc, 1)
    back = te.splice_slot(tc, 1, ex)
    for f, v in convert.carry_to_numpy(back).items():
        np.testing.assert_array_equal(v, before[f])
    ex.spins.fill_(0.0)
    np.testing.assert_array_equal(convert.carry_to_numpy(tc)["spins"], before["spins"])
    assert te.slot(1).device == 0 and te.model_of(1) is tm


def test_carry_conversion_round_trips():
    jm, tm = _pair(5, 16)
    je = jeng.SweepEngine.create(jm, rung="cb", backend="jnp", batch=2, V=4)
    jc = je.run(je.init_carry(seed=3), 2)
    host = {f: np.asarray(getattr(jc, f)) for f in jc._fields}
    tc = convert.carry_from_numpy(host, device="cpu")
    assert tc.rng.dtype == torch.int32
    for f, v in convert.carry_to_numpy(tc).items():
        assert v.dtype == host[f].dtype, f
        np.testing.assert_array_equal(v, host[f])


_M = None


def _model():
    global _M
    if _M is None:
        _M = _pair(4, 16)[1]
    return _M


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(rung="a2", backend="cuda", V=128, device="cuda"), "\\('a4', 'cb'\\)"),
        (dict(rung="a1", backend="torch", exp_flavor="zz"), "unknown exp flavour 'zz'"),
        (dict(rung="zz", backend="torch"), "unknown rung"),
        (dict(backend="jnp"), "unknown backend"),
        (dict(backend="cuda", exp_flavor="zz", V=128, device="cuda"), "unknown exp flavour 'zz'"),
        (dict(backend="torch", replica_tile=1), "replica_tile"),
        (dict(backend="torch", mesh=object()), 'engine meshes need a "data" axis'),
        (dict(backend="torch", capacities=[1]), "capacities need a mesh-sharded engine"),
        (dict(backend="torch", batch=0), "batch"),
        (dict(backend="cuda", V=128), "CUDA device"),
        (dict(backend="cuda", V=4, device="cuda"), "V=128"),
    ],
    ids=["a3", "a1", "unknown-rung", "unknown-backend", "exp", "replica_tile",
         "mesh", "capacities", "batch0", "cuda-on-cpu", "cuda-V4"],
)
def test_engine_rejects_unported_modes(kwargs, match):
    """Modes the port does not run raise ValueError naming themselves: the
    "cuda" backend refuses the rungs its kernels do not compute (id "a3");
    an unknown exp flavour is refused on any rung and backend (ids "a1",
    "exp": the kernels take every known flavour).  A mesh that is not one
    and capacities without a mesh raise the reference's messages (ids
    "mesh", "capacities": the mesh itself is ported, tests/test_torch_mesh.py)."""
    kw = dict(V=4, device="cpu")
    kw.update(kwargs)
    with pytest.raises(ValueError, match=match):
        engine.SweepEngine.create(_model(), **kw)


def test_engine_rejects_model_lists_slots_and_slot_models():
    m = _model()
    kw = dict(backend="torch", V=4, device="cpu")
    with pytest.raises(ValueError, match="len\\(models\\)"):
        engine.SweepEngine.create([m, m], batch=3, **kw)
    with pytest.raises(ValueError, match="space_nbr"):
        engine.SweepEngine.create([m, ising.random_layered_model(n=4, L=16, seed=99)], **kw)
    with pytest.raises(ValueError, match="multi-tenant engines implement rungs"):
        engine.SweepEngine.create([m, m], rung="a3", **kw)
    eng = engine.SweepEngine.create(m, backend="torch", batch=2, V=4, device="cpu")
    carry = eng.init_carry()
    for bad in (-1, 2):
        with pytest.raises(ValueError, match="out of range"):
            eng.slot(bad)
        with pytest.raises(ValueError, match="out of range"):
            eng.extract_slot(carry, bad)
    with pytest.raises(ValueError, match="multi-tenant"):
        eng.init_slot_carry(seed=1, model=m)
    with pytest.raises(ValueError, match="rng_seeds"):
        eng.init_slot_carry(seed=1, rng_seeds=np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="rng_state"):
        eng.init_slot_carry(seed=1, rng_state=torch.zeros((624, 3), dtype=torch.int32))
    other = _pair(5, 16)[1]
    with pytest.raises(ValueError, match="lane shape"):
        eng.check_model(other)


def test_unported_serving_features_raise(tmp_path):
    """Misused serving knobs raise: a ``mesh`` that is not one and
    ``capacities`` without a mesh raise the reference's messages, on the
    server and on a restore (the mesh itself is served,
    tests/test_torch_mesh_serve.py); ``replica_tile`` is refused on the
    plain backend, a snapshot without a manager and an empty profiler
    window are refused."""
    m = _model()
    for field, value, match in [
        ("mesh", object(), 'engine meshes need a "data" axis'),
        ("capacities", (4,), r"capacities need a mesh-sharded engine \(mesh=\.\.\.\)"),
        ("replica_tile", 1, "replica_tile"),
    ]:
        with pytest.raises(ValueError, match=match):
            SampleServer(m, slots=2, backend="torch", V=4, device="cpu", **{field: value})
    server = SampleServer(m, slots=2, backend="torch", V=4, device="cpu")
    with pytest.raises(ValueError, match="num_chunks"):
        server.arm_profiler(str(tmp_path), num_chunks=0)
    with pytest.raises(ValueError, match="no snapshot manager"):
        server.snapshot()
    server.snapshot(str(tmp_path))
    for field, match in (("mesh", 'engine meshes need a "data" axis'),
                         ("capacities", "capacities need a mesh-sharded engine")):
        with pytest.raises(ValueError, match=match):
            SampleServer.restore(str(tmp_path), device="cpu", **{field: (1,)})
    with pytest.raises(ValueError, match="cuda"):
        SampleServer(m, slots=2, V=128, device="cpu")  # default backend is the kernel


def test_kernel_wrapper_refuses_other_devices():
    """The wrapper takes the plain version ONLY for CPU tensors; anything
    else either launches the kernel (CUDA) or raises."""
    m = _pair(4, 256)[1]
    fn = ops.make_colored_multisweep(
        reorder.colored_classes(m, 128), m.h, m.space_nbr, m.space_J, m.tau_J, n=4
    )
    spins = torch.empty((1, 8, 128), device="meta")
    rng = torch.empty((624, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        fn(spins, rng, torch.empty((1,), device="meta"), 1)
    with pytest.raises(ValueError, match="num_sweeps"):
        fn(spins, rng, torch.empty((1,), device="meta"), -1)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """A build that cannot run raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if _build._lib_path("colored_multisweep").exists():  # pragma: no cover
        pytest.fail("fresh build dir already holds the library")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build(["colored_multisweep"])
    assert _build.ptxas_report("colored_multisweep") == ""
