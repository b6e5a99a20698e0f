"""RWKV-6 "Finch" block, arXiv:2404.05892 (data-dependent decay linear
attention), in the reference's chunked form.

Time mixing uses data-dependent token-shift (DDLerp LoRA) and a
data-dependent per-channel decay ``w_t = exp(-exp(...))``; the WKV state is
a per-head (N x P) matrix updated multiplicatively: attention-free, O(1)
state a token.

The full sequence runs the chunked WKV: within a chunk all decay products
are taken relative to the chunk's start, with non-positive exponents
wherever the tensors are large, and the per-step log-decay is clamped to
[-LOGW_CLAMP, -1e-6], so the one positive-exponent factor (``k *
exp(-cs_j)``, at most e^{LOGW_CLAMP * chunk}) stays inside float32's
range.  That factor amplifies any rounding of the products that follow:
float32 products must not run in a reduced precision (TF32 off, ROADMAP
§3y).

Channel mixing is the squared-ReLU receptance-gated FFN of the paper.
Decode carries an `RWKVCache`: the last input of each mix (compute
dtype) and the WKV state (float32).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import LayerNorm, layernorm_apply
from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32
LOGW_CLAMP = 4.0  # |log decay| per step; exp(4*16) ~ 6e27 << f32 max


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_mix: int = 32
    lora_decay: int = 64
    chunk: int = 16

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


MIX_NAMES = ("w", "k", "v", "r", "g")


def rwkv6_time_mix_init(generator, cfg: RWKV6Config, device=None):
    """The reference's tree less ``ln_x`` (`TimeMix` holds it as a `LayerNorm`)."""
    d, H, N = cfg.d_model, cfg.num_heads, cfg.head_dim
    dev = device or generator.device
    nm = len(MIX_NAMES)

    def draw(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, device=device)

    return {
        "maa_x": Param(torch.zeros((d,), dtype=f32, device=dev), (None,)),
        "maa_base": Param(torch.zeros((nm, d), dtype=f32, device=dev), (None, None)),
        "maa_w1": Param(draw((d, nm * cfg.lora_mix), d), (None, None)),
        "maa_w2": Param(draw((nm, cfg.lora_mix, d), cfg.lora_mix), (None, None, None)),
        "decay_base": Param(torch.full((d,), -2.0, dtype=f32, device=dev), (None,)),
        "decay_w1": Param(draw((d, cfg.lora_decay), d), (None, None)),
        "decay_w2": Param(draw((cfg.lora_decay, d), cfg.lora_decay), (None, None)),
        "bonus_u": Param(torch.zeros((H, N), dtype=f32, device=dev), ("heads", None)),
        "wr": Param(draw((d, d), d), ("embed", "qkv")),
        "wk": Param(draw((d, d), d), ("embed", "qkv")),
        "wv": Param(draw((d, d), d), ("embed", "qkv")),
        "wg": Param(draw((d, d), d), ("embed", "qkv")),
        "wo": Param(draw((d, d), d), ("qkv", "embed")),
    }


def _ddlerp(p, x, x_shift):
    """Data-dependent token-shift mixing (Finch's DDLerp): [xw, xk, xv, xr, xg]."""
    xx = x_shift - x
    xxx = x + xx * p["maa_x"].to(x.dtype)
    lora = torch.tanh(torch.matmul(xxx, p["maa_w1"].to(x.dtype)))
    lora = lora.reshape(*lora.shape[:2], len(MIX_NAMES), -1)
    deltas = torch.einsum("bscm,cmd->bscd", lora, p["maa_w2"].to(x.dtype))
    base = p["maa_base"].to(x.dtype)
    return [x + xx * (base[c] + deltas[:, :, c]) for c in range(len(MIX_NAMES))]


def _decay_log(p, xw):
    """Per-channel log decay in [-LOGW_CLAMP, -1e-6]."""
    dd = torch.tanh(torch.matmul(xw.to(f32), p["decay_w1"].to(f32)))
    raw = p["decay_base"].to(f32) + torch.matmul(dd, p["decay_w2"].to(f32))
    return -torch.clamp(torch.exp(raw), 1e-6, LOGW_CLAMP)


def _wkv_chunked(r, k, v, logw, u, chunk: int):
    """Chunked WKV: r,k,v (b,s,h,n|p), logw (b,s,h,n), u (h,n)."""
    b, s, h, n = k.shape
    pdim = v.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    nc = s // q

    def rs(t):
        return t.reshape((b, nc, q) + tuple(t.shape[2:]))

    r, k, v, logw = rs(r), rs(k), rs(v), rs(logw)
    cs = torch.cumsum(logw, dim=2)  # (b,nc,q,h,n), decreasing
    total = cs[:, :, -1]  # (b,nc,h,n)

    # Intra-chunk, strict lower triangle: factor exp(cs_{i-1} - cs_j), j < i.
    r_dec = r * torch.exp(cs - logw)  # r_i * exp(cs_{i-1}) relative to chunk start
    k_grow = k * torch.exp(-cs)  # k_j * exp(-cs_j); bounded by clamp
    scores = torch.einsum("bcihn,bcjhn->bcijh", r_dec, k_grow)
    idx = torch.arange(q, device=r.device)
    mask = (idx[:, None] > idx[None, :])[None, None, :, :, None]
    scores = torch.where(mask, scores, torch.zeros((), dtype=scores.dtype, device=r.device))
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, v)
    # Diagonal bonus term: r_i . (u * k_i) v_i.
    diag = torch.einsum("bcqhn,bcqhn->bcqh", r * u[None, None, None, :, :], k)
    y = y + diag[..., None] * v

    # Chunk-final states: S_c = sum_j exp(total - cs_j) k_j (x) v_j (exponent <= 0).
    S_c = torch.einsum("bcqhn,bcqhp->bchnp", k * torch.exp(total[:, :, None] - cs), v)

    S_prev = torch.zeros((b, h, n, pdim), dtype=f32, device=r.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S_prev)
        S_prev = S_prev * torch.exp(total[:, c])[..., None] + S_c[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # (b,nc,h,n,p)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", r_dec, S_prevs)
    return (y + y_inter).reshape(b, s, h, pdim)


def _project(p, xs, dtype, shape):
    xw, xk, xv, xr, xg = xs
    logw = _decay_log(p, xw).reshape(shape)
    r = torch.matmul(xr, p["wr"].to(dtype)).reshape(shape).to(f32)
    k = torch.matmul(xk, p["wk"].to(dtype)).reshape(shape).to(f32)
    v = torch.matmul(xv, p["wv"].to(dtype)).reshape(shape).to(f32)
    g = F.silu(torch.matmul(xg, p["wg"].to(dtype)))
    return logw, r, k, v, g


def rwkv6_time_mix_apply(p, x, cfg: RWKV6Config, dtype=torch.bfloat16, shift_state=None):
    """Full-sequence time mixing. x: (B,S,d)."""
    B, S, d = x.shape
    H, N = cfg.num_heads, cfg.head_dim
    prev = torch.zeros_like(x[:, :1]) if shift_state is None else shift_state[:, None, :]
    x_shift = torch.cat([prev, x[:, :-1]], dim=1)
    xs = _ddlerp(p, x.to(dtype), x_shift.to(dtype))
    logw, r, k, v, g = _project(p, xs, dtype, (B, S, H, N))
    y = _wkv_chunked(r, k, v, logw, p["bonus_u"].to(f32), cfg.chunk)
    y = layernorm_apply(p["ln_x"], y.reshape(B, S, d).to(dtype))
    return torch.matmul(y * g, p["wo"].to(dtype))


class RWKVCache(NamedTuple):
    tm_shift: torch.Tensor  # (B, d) last input of time mix
    cm_shift: torch.Tensor  # (B, d) last input of channel mix
    wkv: torch.Tensor  # (B, H, N, P) f32


def rwkv6_init_cache(batch: int, cfg: RWKV6Config, dtype=torch.bfloat16,
                     device="cuda") -> RWKVCache:
    H, N = cfg.num_heads, cfg.head_dim
    return RWKVCache(
        tm_shift=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        cm_shift=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, H, N, N), dtype=f32, device=device),
    )


def rwkv6_time_mix_decode(p, x, cache_tm, wkv, cfg: RWKV6Config, dtype=torch.bfloat16):
    """One recurrent step. x: (B,1,d); returns (y, new_tm_shift, new_wkv)."""
    B, _, d = x.shape
    H, N = cfg.num_heads, cfg.head_dim
    x_shift = cache_tm[:, None, :].to(dtype)
    xs = _ddlerp(p, x.to(dtype), x_shift)
    logw, r, k, v, g = _project(p, xs, dtype, (B, H, N))
    g = g[:, 0]
    u = p["bonus_u"].to(f32)
    # y = r . (S + u*k (x) v);  S' = diag(exp(logw)) S + k (x) v.
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", r, wkv + u[None, :, :, None] * kv)
    new_wkv = torch.exp(logw)[..., None] * wkv + kv
    y = layernorm_apply(p["ln_x"], y.reshape(B, d).to(dtype))
    out = torch.matmul(y * g, p["wo"].to(dtype))
    return out[:, None, :], x[:, 0], new_wkv


def rwkv6_channel_mix_init(generator, cfg: RWKV6Config, device=None):
    d, f = cfg.d_model, cfg.d_ff
    dev = device or generator.device

    def draw(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, device=device)

    return {
        "maa_k": Param(torch.full((d,), 0.5, dtype=f32, device=dev), (None,)),
        "maa_r": Param(torch.full((d,), 0.5, dtype=f32, device=dev), (None,)),
        "wk": Param(draw((d, f), d), ("embed", "mlp")),
        "wv": Param(draw((f, d), f), ("mlp", "embed")),
        "wr": Param(draw((d, d), d), ("embed", None)),
    }


def rwkv6_channel_mix_apply(p, x, dtype=torch.bfloat16, shift_state=None):
    prev = torch.zeros_like(x[:, :1]) if shift_state is None else shift_state[:, None, :]
    x_shift = torch.cat([prev, x[:, :-1]], dim=1).to(dtype)
    xd = x.to(dtype)
    xx = x_shift - xd
    xk = xd + xx * p["maa_k"].to(dtype)
    xr = xd + xx * p["maa_r"].to(dtype)
    rgate = torch.sigmoid(torch.matmul(xr, p["wr"].to(dtype)))
    h = torch.square(F.relu(torch.matmul(xk, p["wk"].to(dtype))))
    return rgate * torch.matmul(h, p["wv"].to(dtype))


def rwkv6_channel_mix_decode(p, x, cache_cm, dtype=torch.bfloat16):
    y = rwkv6_channel_mix_apply(p, x, dtype, shift_state=cache_cm.to(x.dtype))
    return y, x[:, 0]


class TimeMix(ParamModule):
    """Time mixing: ``forward`` is `rwkv6_time_mix_apply`, ``decode``
    `rwkv6_time_mix_decode`.  The decay LoRA and the bonus are used in
    float32 whatever the compute dtype (`basic.hold_in` leaves them so)."""

    FLOAT32_PARAMS = ("decay_base", "decay_w1", "decay_w2", "bonus_u")

    def __init__(self, generator, cfg: RWKV6Config, *, dtype=torch.bfloat16, device=None):
        super().__init__(rwkv6_time_mix_init(generator, cfg, device=device))
        self.ln_x = LayerNorm(cfg.d_model, logical=(None,), device=device)
        self.cfg, self.dtype = cfg, dtype

    def tree(self) -> dict:
        return dict(self.params(), ln_x=self.ln_x.params())

    def forward(self, x):
        return rwkv6_time_mix_apply(self.tree(), x, self.cfg, self.dtype)

    def decode(self, x, cache_tm, wkv):
        return rwkv6_time_mix_decode(self.tree(), x, cache_tm, wkv, self.cfg, self.dtype)


class ChannelMix(ParamModule):
    """Channel mixing: ``forward`` is `rwkv6_channel_mix_apply`, ``decode``
    `rwkv6_channel_mix_decode`."""

    def __init__(self, generator, cfg: RWKV6Config, *, dtype=torch.bfloat16, device=None):
        super().__init__(rwkv6_channel_mix_init(generator, cfg, device=device))
        self.dtype = dtype

    def forward(self, x):
        return rwkv6_channel_mix_apply(self.params(), x, self.dtype)

    def decode(self, x, cache_cm):
        return rwkv6_channel_mix_decode(self.params(), x, cache_cm, self.dtype)
