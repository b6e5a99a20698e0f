"""The exp flavours of the sweep kernels (#1-#5): plain versions vs JAX,
and the C entries' signatures.

Every Pallas sweep kernel of the reference takes ``exp_flavor``; the
port's kernels take it as a template parameter and are held bit for bit
to their plain versions on the card (chip_smoke.py, tests/
test_torch_cuda.py).  Here, on the CPU, the plain versions of #1-#5 with
"accurate" and "exact" are held to the reference's jnp engine.  Those
exps are not the reference's bit for bit ("accurate" within 2 ulp,
"exact" within 1 ulp, ROADMAP §3b), so the test compares accept
DECISIONS: every accept test of the port's run is recorded with its
``x``, uniform ``u`` and ``p``; where the reference's exp of the same
``x`` decides otherwise, ``u`` must lie within that ulp bound of ``p``.
Where no decision differs, the whole trajectory equals the reference's
bit for bit.

The arity test reads the C prototypes of csrc/*.cu against
`ops.ENTRY_ARGS`, the ctypes signatures: a wrong signature would pass a
cut value silently.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import ising as jis
from repro.core import metropolis as jmp
from repro.core.fastexp import EXP_FNS as JEXP
from repro_torch.core import convert, engine, fastexp, ising, metropolis
from repro_torch.kernels import _build, ops, ref

#: The ulps within which each exp agrees with the reference's (§3b).
ULPS = {"accurate": 2, "exact": 1}
N, L, V, B, SWEEPS = 16, 32, 4, 4, 3


def _pair(n, L, seed=1, beta=1.1):
    jm = jis.random_layered_model(n=n, L=L, seed=seed, beta=beta)
    return jm, convert.model_from_arrays(dataclasses.asdict(jm))


def _record(monkeypatch):
    """Record (x, u, p) of every accept test of the port's plain sweeps."""
    seen = []
    flip = metropolis._flip

    def recording(s, h_sum, u, beta, exp_fn):
        x = ((-2.0 * beta) * s) * h_sum
        seen.append((x.reshape(-1), u.reshape(-1), exp_fn(x).reshape(-1)))
        return flip(s, h_sum, u, beta, exp_fn)

    monkeypatch.setattr(metropolis, "_flip", recording)
    return seen


def _differing_decisions(seen, flavor) -> int:
    """Check every recorded accept test against the reference's exp of the
    same x; returns how many decide otherwise (each within the bound)."""
    x, u, p = (torch.cat(t).numpy() for t in zip(*seen))
    p_ref = np.asarray(JEXP[flavor](jnp.asarray(x)))
    differ = (u < p) != (u < p_ref)
    bound = ULPS[flavor] * np.spacing(np.abs(p[differ]).astype(np.float32))
    assert np.all(np.abs(u[differ] - p[differ]) <= bound), (
        f"{flavor}: a decision differs with u {u[differ]} beyond {ULPS[flavor]} ulp of p "
        f"{p[differ]} (reference {p_ref[differ]})")
    assert x.size > 1000
    return int(differ.sum())


def _engines(rung, multi, flavor):
    jm, tm = _pair(N, L, seed=3)
    betas = np.linspace(0.3, 2.0, B, dtype=np.float32)
    if multi:
        seeds = [100 + k for k in range(B)]
        jmodels = [jis.reseed_couplings(jm, seed=s) for s in seeds]
        tmodels = [ising.reseed_couplings(tm, seed=s) for s in seeds]
        je = jeng.SweepEngine.create(jmodels, rung=rung, backend="jnp", V=V, exp_flavor=flavor)
        te = engine.SweepEngine.create(tmodels, rung=rung, backend="torch", V=V,
                                       exp_flavor=flavor, device="cpu")
    else:
        je = jeng.SweepEngine.create(jm, rung=rung, backend="jnp", batch=B, V=V,
                                     exp_flavor=flavor)
        te = engine.SweepEngine.create(tm, rung=rung, backend="torch", batch=B, V=V,
                                       exp_flavor=flavor, device="cpu")
    return je, je.init_carry(seed=5, betas=betas), te, te.init_carry(seed=5, betas=betas)


@pytest.mark.parametrize("flavor", ["accurate", "exact"])
@pytest.mark.parametrize("rung,multi", [("cb", False), ("cb", True), ("a4", False),
                                        ("a4", True)], ids=["1-cb", "2-cb-multi", "3-a4",
                                                            "4-a4-multi"])
def test_multisweep_decisions_match_jax(monkeypatch, rung, multi, flavor):
    """#1-#4's plain versions (the engine's "torch" backend) against the
    reference's jnp engine on the same seeds, decision by decision."""
    je, jc, te, tc = _engines(rung, multi, flavor)
    seen = _record(monkeypatch)
    got = te.run(tc, SWEEPS)
    want = je.run(jc, SWEEPS)
    if _differing_decisions(seen, flavor) == 0:
        host = convert.carry_to_numpy(got)
        for f in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(want, f)), host[f], err_msg=f)


@pytest.mark.parametrize("flavor", ["accurate", "exact"])
def test_one_sweep_decisions_match_jax(monkeypatch, flavor):
    """#5's plain version on given uniforms and arbitrary fields (so the
    exp sees inputs over a wide range) against the reference's
    `sweep_lane`, decision by decision."""
    jm, tm = _pair(N, L, seed=4)
    rows = N * L // V
    rng = np.random.default_rng(7)
    spins = np.where(rng.random((B, rows, V)) < 0.5, -1.0, 1.0).astype(np.float32)
    hs = rng.normal(0.0, 3.0, (B, rows, V)).astype(np.float32)
    ht = rng.normal(0.0, 1.0, (B, rows, V)).astype(np.float32)
    u = rng.random((B, rows, V), dtype=np.float32)
    betas = np.linspace(0.3, 2.0, B, dtype=np.float32)
    t = dict(base_nbr=torch.from_numpy(tm.space_nbr.astype(np.int32)),
             base_J2=torch.from_numpy((2.0 * tm.space_J).astype(np.float32)),
             tau_J2=torch.from_numpy((2.0 * tm.tau_J).astype(np.float32)))
    seen = _record(monkeypatch)
    got = ref.metropolis_sweep_ref(*(torch.from_numpy(a) for a in (spins, hs, ht, u)), **t,
                                   beta=torch.from_numpy(betas), n=N, exp_flavor=flavor)
    if _differing_decisions(seen, flavor):
        return
    for b in range(B):
        want = jmp.sweep_lane(
            jmp.LaneState(jnp.asarray(spins[b]), jnp.asarray(hs[b]), jnp.asarray(ht[b])),
            jnp.asarray(jm.space_nbr), jnp.asarray(2.0 * jm.space_J), jnp.asarray(2.0 * jm.tau_J),
            jnp.asarray(u[b]), jnp.float32(betas[b]), N, flavor,
        )
        for a, c in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), c[b].numpy())


@pytest.mark.parametrize("flavor", ["fast", "accurate", "exact"])
@pytest.mark.parametrize("rung", ["cb", "a4"])
def test_cuda_backend_takes_every_flavour(rung, flavor):
    """`SweepEngine.create(..., backend="cuda")` accepts every flavour on both
    rungs (single-model and multi-tenant); without a card, the check is
    made at construction, before any table moves to the device."""
    _, tm = _pair(4, 256, seed=2)
    if torch.cuda.is_available():
        for models in (tm, [tm, ising.reseed_couplings(tm, seed=1)]):
            eng = engine.SweepEngine.create(models, rung=rung, exp_flavor=flavor)
            assert eng.exp_flavor == flavor and eng.backend == "cuda"
        return
    if rung == "cb":  # builds no device tensor at construction
        eng = engine.SweepEngine.create(tm, rung=rung, exp_flavor=flavor)
        assert eng.exp_flavor == flavor and eng.backend == "cuda"
    with pytest.raises(ValueError, match="unknown exp flavour 'zz'"):
        engine.SweepEngine.create(tm, rung=rung, exp_flavor="zz")


# -----------------------------------------------------------------------------
# The C entries' signatures.
# -----------------------------------------------------------------------------

_CTYPES = {"ptr": ops._VP, "int": ops._INT, "uint32_t": ops._U32,
           "long long": ops.ctypes.c_longlong}


def _prototype(name):
    """The ctypes types of the parameters of ``extern "C" int name(...)``
    in csrc/<name>.cu: a pointer (a ``*``), int, uint32_t or long long."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert [f[0] for f in found] == [name], found
    types = []
    for param in found[0][1].split(","):
        param = " ".join(param.split())
        kind = "ptr" if "*" in param else param.rsplit(" ", 1)[0].replace("const ", "")
        types.append(_CTYPES[kind])
    return types


@pytest.mark.parametrize("name", sorted(ops.ENTRY_ARGS))
def test_entry_signatures_match_the_c_prototypes(name):
    assert _prototype(name) == ops.ENTRY_ARGS[name]


def test_flavour_codes_and_constants_match_the_header():
    """`ops.SWEEP_FLAVOURS` are fastexp.cuh's codes for every flavour of
    `fastexp.EXP_FNS`, and `ops._EXP_CONSTS` come in `ExpConsts`' order."""
    src = (_build.CSRC / "fastexp.cuh").read_text()
    codes = dict(re.findall(r"EXP_(FAST|ACCURATE|EXACT) = (\d)", src))
    assert {k.lower(): int(v) for k, v in codes.items()} == ops.SWEEP_FLAVOURS
    assert set(ops.SWEEP_FLAVOURS) == set(fastexp.EXP_FNS)
    fields = re.search(r"struct ExpConsts \{\s*float ([^;]*);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == ["scale", "centre", "scale4", "lo",
                                                      "clip_hi"]
    want = [fastexp.SCALE_F32, fastexp.CENTRE_F32, fastexp.SCALE4_F32, fastexp.ACCURATE_LO_F32,
            fastexp.ACCURATE_CLIP_HI_F32]
    assert list(ops._EXP_CONSTS) == [fastexp.f32_bits(c) for c in want]
    for name, args in ops.ENTRY_ARGS.items():
        if name not in ("mt_next_block", "fastexp_2d"):  # the sweeps and the check
            assert args[-7:-1] == ops._EXP_ARGS, name

