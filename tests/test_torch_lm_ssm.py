"""The port's Mamba2 and RWKV6 mixers (`repro_torch.nn.mamba2`,
`repro_torch.nn.rwkv6`) against the reference's, on the reference's
initial parameters and the same numpy inputs.  The chunked scans
(`_ssd_chunked`, `_wkv_chunked`) at ``s = chunk``, ``s = 2 chunk`` and
``s < chunk``, against the reference's and against a step-by-step
recurrence; the mixers' full-sequence and decode paths, float32 and
bfloat16; decode against the full sequence.  Bounds on the scaled error
(`test_torch_lm_trap.py`): ``F32_SCAN_EXP`` for a float32 scan (the
exps of cumsum differences, ROADMAP §3y), ``F32_LAYER`` / ``BF16_LAYER``
for a layer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.nn import mamba2 as jmb
from repro.nn import rwkv6 as jrk
from repro.nn.param import split_tree as jsplit
from repro_torch.nn import mamba2 as mb
from repro_torch.nn import rwkv6 as rk
from test_torch_lm_trap import BF16_LAYER, F32_LAYER, F32_SCAN_EXP, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DT = {"float32": (jnp.float32, torch.float32, F32_LAYER),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_LAYER)}
MCFG = mb.Mamba2Config(d_model=64, d_state=16, head_dim=16, chunk=8)
RCFG = rk.RWKV6Config(d_model=64, d_ff=128, head_dim=16, lora_mix=8, lora_decay=16, chunk=8)
LENGTHS = pytest.mark.parametrize("s", [8, 16, 5], ids=["s=chunk", "s=2chunk", "s<chunk"])


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tree(values):
    values = jax.tree_util.tree_map(np.asarray, values)
    return (jax.tree_util.tree_map(jnp.asarray, values),
            jax.tree_util.tree_map(torch.from_numpy, values))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _close(want, got, bound, what=""):
    assert _np(want).shape == _np(got).shape, what
    err = scaled_error(_np(want), _np(got))
    assert err <= bound, (what, err)


# --- the chunked scans --------------------------------------------------------------------


def _ssd_inputs(s, seed=0):
    b, h, p, n = 2, 3, 4, 5
    xdt = _rand(seed, b, s, h, p)
    dA = -np.abs(_rand(seed + 1, b, s, h)) * 1.5
    return xdt, dA.astype(np.float32), _rand(seed + 2, b, s, h, n), _rand(seed + 3, b, s, h, n)


def _ssd_recurrence(xdt, dA, B, C):
    b, s, h, p = xdt.shape
    S = np.zeros((b, h, B.shape[-1], p))
    ys = []
    for t in range(s):
        S = S * np.exp(dA[:, t])[..., None, None] + B[:, t, :, :, None] * xdt[:, t, :, None, :]
        ys.append(np.einsum("bhn,bhnp->bhp", C[:, t], S))
    return np.stack(ys, 1)


@LENGTHS
def test_ssd_chunked_matches_the_reference_and_the_recurrence(s):
    args = _ssd_inputs(s)
    want = jmb._ssd_chunked(*map(jnp.asarray, args), chunk=8)
    got = mb._ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    _close(want, got, F32_SCAN_EXP, "vs reference")
    _close(_ssd_recurrence(*[a.astype(np.float64) for a in args]), got, F32_SCAN_EXP,
           "vs recurrence")


def _wkv_inputs(s, seed=0):
    b, h, n = 2, 3, 4
    r, k, v = (_rand(seed + i, b, s, h, n) for i in range(3))
    logw = -np.clip(np.exp(_rand(seed + 3, b, s, h, n)), 1e-6, rk.LOGW_CLAMP)
    return r, k, v, logw.astype(np.float32), _rand(seed + 4, h, n)


def _wkv_recurrence(r, k, v, logw, u):
    b, s, h, n = k.shape
    S = np.zeros((b, h, n, v.shape[-1]))
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhn,bhnp->bhp", r[:, t], S + u[None, :, :, None] * kv))
        S = np.exp(logw[:, t])[..., None] * S + kv
    return np.stack(ys, 1)


@LENGTHS
def test_wkv_chunked_matches_the_reference_and_the_recurrence(s):
    args = _wkv_inputs(s)
    want = jrk._wkv_chunked(*map(jnp.asarray, args), chunk=8)
    got = rk._wkv_chunked(*map(torch.from_numpy, args), chunk=8)
    _close(want, got, F32_SCAN_EXP, "vs reference")
    _close(_wkv_recurrence(*[a.astype(np.float64) for a in args]), got, F32_SCAN_EXP,
           "vs recurrence")


def test_scans_refuse_a_length_off_the_chunk():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mb._ssd_chunked(*map(torch.from_numpy, _ssd_inputs(12)), chunk=8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rk._wkv_chunked(*map(torch.from_numpy, _wkv_inputs(12)), chunk=8)


# --- Mamba2 -------------------------------------------------------------------------------


def _mamba_params(seed=0):
    return _tree(jsplit(jmb.mamba2_init(jax.random.PRNGKey(seed), MCFG))[0])


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("s", [16, 4])
def test_mamba2_apply_and_decode_match_the_reference(dtype, s):
    jdt, tdt, bound = DT[dtype]
    jp, tp = _mamba_params()
    x = _rand(1, 2, s, MCFG.d_model)
    _close(jmb.mamba2_apply(jp, jnp.asarray(x).astype(jdt), MCFG, jdt),
           mb.mamba2_apply(tp, torch.from_numpy(x).to(tdt), MCFG, tdt), bound, "apply")
    jc = jmb.mamba2_init_cache(2, MCFG, jdt)
    tc = mb.mamba2_init_cache(2, MCFG, tdt, device="cpu")
    for t in range(s):
        xt = x[:, t:t + 1]
        jy, jc = jmb.mamba2_decode_apply(jp, jnp.asarray(xt).astype(jdt), jc, MCFG, jdt)
        y, tc = mb.mamba2_decode_apply(tp, torch.from_numpy(xt).to(tdt), tc, MCFG, tdt)
        _close(jy, y, bound, f"decode {t}")
    assert tc.conv.dtype == tdt and tc.ssm.dtype == torch.float32
    _close(jc.conv, tc.conv, bound, "conv window")
    _close(jc.ssm, tc.ssm, bound, "ssm state")


def test_mamba2_decode_matches_its_full_sequence():
    """16 recurrent steps equal the chunked forward (two chunks), float32."""
    _, tp = _mamba_params(2)
    x = torch.from_numpy(_rand(3, 2, 16, MCFG.d_model))
    full = mb.mamba2_apply(tp, x, MCFG, torch.float32)
    cache = mb.mamba2_init_cache(2, MCFG, torch.float32, device="cpu")
    for t in range(16):
        y, cache = mb.mamba2_decode_apply(tp, x[:, t:t + 1], cache, MCFG, torch.float32)
        _close(full[:, t], y[:, 0], F32_SCAN_EXP, f"step {t}")


# --- RWKV6 --------------------------------------------------------------------------------


def _rwkv_params(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tm = jsplit(jrk.rwkv6_time_mix_init(k1, RCFG))[0]
    # The zero-initialised mixing and bonus make the LoRAs and the bonus
    # path vanish; give them values, as training would.
    tm = dict(tm, maa_x=_rand(7, RCFG.d_model, scale=0.3),
              maa_base=_rand(8, 5, RCFG.d_model, scale=0.3),
              bonus_u=_rand(9, RCFG.num_heads, RCFG.head_dim, scale=0.5))
    return _tree(tm), _tree(jsplit(jrk.rwkv6_channel_mix_init(k2, RCFG))[0])


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("s", [16, 4])
def test_rwkv6_mixes_match_the_reference(dtype, s):
    jdt, tdt, bound = DT[dtype]
    (jtm, ttm), (jcm, tcm) = _rwkv_params()
    x = _rand(1, 2, s, RCFG.d_model)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    _close(jrk.rwkv6_time_mix_apply(jtm, jx, RCFG, jdt), rk.rwkv6_time_mix_apply(ttm, tx, RCFG, tdt),
           bound, "time mix")
    _close(jrk.rwkv6_channel_mix_apply(jcm, jx, jdt), rk.rwkv6_channel_mix_apply(tcm, tx, tdt),
           bound, "channel mix")
    jc = jrk.rwkv6_init_cache(2, RCFG, jdt)
    tc = rk.rwkv6_init_cache(2, RCFG, tdt, device="cpu")
    jtm_s, jcm_s, jw = jc
    ttm_s, tcm_s, tw = tc
    for t in range(s):
        jy, jtm_s, jw = jrk.rwkv6_time_mix_decode(jtm, jx[:, t:t + 1], jtm_s, jw, RCFG, jdt)
        y, ttm_s, tw = rk.rwkv6_time_mix_decode(ttm, tx[:, t:t + 1], ttm_s, tw, RCFG, tdt)
        _close(jy, y, bound, f"time mix decode {t}")
        jy, jcm_s = jrk.rwkv6_channel_mix_decode(jcm, jx[:, t:t + 1], jcm_s, jdt)
        y, tcm_s = rk.rwkv6_channel_mix_decode(tcm, tx[:, t:t + 1], tcm_s, tdt)
        _close(jy, y, bound, f"channel mix decode {t}")
    assert tw.dtype == torch.float32 and ttm_s.dtype == tdt
    _close(jw, tw, bound, "wkv state")


def test_rwkv6_decode_matches_its_full_sequence():
    (_, ttm), (_, tcm) = _rwkv_params(2)
    x = torch.from_numpy(_rand(3, 2, 16, RCFG.d_model))
    full = rk.rwkv6_time_mix_apply(ttm, x, RCFG, torch.float32)
    cm_full = rk.rwkv6_channel_mix_apply(tcm, x, torch.float32)
    shift, wkv = torch.zeros(2, RCFG.d_model), torch.zeros(2, RCFG.num_heads, 16, 16)
    cm_shift = torch.zeros(2, RCFG.d_model)
    for t in range(16):
        y, shift, wkv = rk.rwkv6_time_mix_decode(ttm, x[:, t:t + 1], shift, wkv, RCFG,
                                                 torch.float32)
        _close(full[:, t], y[:, 0], F32_SCAN_EXP, f"time mix {t}")
        y, cm_shift = rk.rwkv6_channel_mix_decode(tcm, x[:, t:t + 1], cm_shift, torch.float32)
        _close(cm_full[:, t], y[:, 0], F32_LAYER, f"channel mix {t}")


def test_the_decay_is_clamped():
    """``_decay_log`` lies in [-LOGW_CLAMP, -1e-6] however large the
    LoRA's output (the chunked scan's ``exp(-cs)`` stays below e^64)."""
    (_, ttm), _ = _rwkv_params()
    p = dict(ttm, decay_base=torch.full((RCFG.d_model,), 50.0))
    logw = rk._decay_log(p, torch.from_numpy(_rand(4, 2, 8, RCFG.d_model)))
    assert float(logw.min()) == -rk.LOGW_CLAMP and float(logw.max()) <= -1e-6
    p = dict(ttm, decay_base=torch.full((RCFG.d_model,), -50.0))
    assert float(rk._decay_log(p, torch.zeros(1, 1, RCFG.d_model)).max()) == np.float32(-1e-6)


def test_float32_parameters_stay_float32_when_held():
    from repro_torch.nn.basic import hold_in

    g = torch.Generator().manual_seed(0)
    m = hold_in(mb.Mamba2(g, MCFG, device="cpu"), torch.bfloat16)
    assert {n for n, p in m.named_parameters() if p.dtype == torch.float32} == {
        "A_log", "D", "dt_bias", "norm.scale"}
    tm = hold_in(rk.TimeMix(g, RCFG, device="cpu"), torch.bfloat16)
    assert {n for n, p in tm.named_parameters() if p.dtype == torch.float32} == {
        "decay_base", "decay_w1", "decay_w2", "bonus_u", "ln_x.scale", "ln_x.bias"}
