"""Mamba-2 (SSD) block, arXiv:2405.21060, in the reference's chunked form.

The selective-state-space recurrence is evaluated with the chunked SSD
algorithm: intra-chunk terms are masked matmuls over ``exp`` of cumulative
log-decay differences (bounded by 1), chunk-final states are summed with
their decay to the chunk's end, and a short scan over the chunks carries
the state between them.

Full sequence: `mamba2_apply`.  Decode: `mamba2_decode_apply` carries a
`MambaCache`, the last ``conv_width - 1`` conv inputs in the compute
dtype and the SSM state in float32: O(1) a token.

``softplus`` is the reference's (``jax.nn.softplus`` is
``logaddexp(x, 0)``), not ``torch.nn.functional.softplus``, which returns
``x`` itself above its threshold of 20 (ROADMAP §3y).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import RMSNorm, rmsnorm_apply
from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba2_init(generator, cfg: Mamba2Config, device=None):
    """The reference's tree less ``norm`` (`Mamba2` holds it as an `RMSNorm`)."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
    dev = device or generator.device
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + H
    return {
        "in_proj": Param(fan_in_init(generator, (d, proj_out), d, device=device),
                         ("embed", "ssm_heads")),
        "conv_w": Param(fan_in_init(generator, (cfg.conv_width, cfg.conv_dim), cfg.conv_width,
                                    device=device), (None, "ssm_heads")),
        "conv_b": Param(torch.zeros((cfg.conv_dim,), dtype=f32, device=dev), ("ssm_heads",)),
        "A_log": Param(torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=dev)),
                       ("ssm_heads",)),
        "D": Param(torch.ones((H,), dtype=f32, device=dev), ("ssm_heads",)),
        "dt_bias": Param(torch.zeros((H,), dtype=f32, device=dev), ("ssm_heads",)),
        "out_proj": Param(fan_in_init(generator, (di, d), di, device=device),
                          ("ssm_heads", "embed")),
    }


def _causal_conv(x, w, b, width: int):
    """Depthwise causal conv over seq: x (B,S,C), w (width,C)."""
    pads = F.pad(x, (0, 0, width - 1, 0))
    S = x.shape[1]
    y = pads[:, 0:S, :] * w[0]
    for i in range(1, width):
        y = y + pads[:, i:i + S, :] * w[i]
    return y + b


def _ssd_chunked(xdt, dA, B, C, chunk: int):
    """Chunked SSD scan.

    xdt: (b,s,h,p) inputs pre-multiplied by dt;  dA: (b,s,h) = dt*A (<=0);
    B, C: (b,s,h,n) (groups already broadcast to heads).
    Returns y: (b,s,h,p).
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    nc = s // q

    def r(t):
        return t.reshape((b, nc, q) + tuple(t.shape[2:]))

    xdt, dA, B, C = r(xdt), r(dA), r(B), r(C)
    cs = torch.cumsum(dA, dim=2)  # (b,nc,q,h)
    total = cs[:, :, -1]  # (b,nc,h)

    # Intra-chunk: L_ij = exp(cs_i - cs_j) for i >= j (bounded <= 1).
    Lexp = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (b,nc,i,j,h)
    idx = torch.arange(q, device=xdt.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    # exp of the masked upper triangle (cs_i - cs_j > 0) can overflow; its
    # gradient is then 0 * inf = NaN, so the exp sees 0 there (the forward
    # is unchanged: those entries are masked to 0).
    zero = torch.zeros((), dtype=Lexp.dtype, device=xdt.device)
    L = torch.where(mask, torch.exp(torch.where(mask, Lexp, zero)), zero)
    scores = torch.einsum("bcihn,bcjhn->bcijh", C, B) * L
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)

    # Chunk-final states: S_c = sum_j exp(total - cs_j) B_j (x) xdt_j.
    decay_to_end = torch.exp(total[:, :, None] - cs)  # (b,nc,q,h)
    S_c = torch.einsum("bcqhn,bcqhp->bchnp", decay_to_end[..., None] * B, xdt)

    # Inter-chunk scan over nc chunks: the state entering each chunk.
    S_prev = torch.zeros((b, h, n, p), dtype=xdt.dtype, device=xdt.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S_prev)
        S_prev = S_prev * torch.exp(total[:, c])[..., None, None] + S_c[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # (b,nc,h,n,p)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", torch.exp(cs)[..., None] * C, S_prevs)
    return (y + y_inter).reshape(b, s, h, p)


def _project(p, x, cfg: Mamba2Config, dtype):
    di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    zxbcdt = torch.matmul(x.to(dtype), p["in_proj"].to(dtype))
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xBC, dt_raw


def _split_xbc(xBC, cfg: Mamba2Config):
    di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    return xBC[..., :di], xBC[..., di:di + G * N], xBC[..., di + G * N:]


def mamba2_apply(p, x, cfg: Mamba2Config, dtype=torch.bfloat16):
    """Full-sequence forward: x (B,S,d) -> (B,S,d)."""
    Bsz, S, _ = x.shape
    di, H, G, N, P_ = cfg.d_inner, cfg.num_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xBC, dt_raw = _project(p, x, cfg, dtype)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"].to(dtype), p["conv_b"].to(dtype), cfg.conv_width))
    xs, Bm, Cm = _split_xbc(xBC, cfg)
    xs = xs.reshape(Bsz, S, H, P_)
    rep = H // G
    Bm = torch.repeat_interleave(Bm.reshape(Bsz, S, G, N), rep, dim=2)
    Cm = torch.repeat_interleave(Cm.reshape(Bsz, S, G, N), rep, dim=2)
    dt = softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))  # (B,S,H)
    A = -torch.exp(p["A_log"].to(f32))  # (H,)
    dA = dt * A
    xdt = xs.to(f32) * dt[..., None]
    y = _ssd_chunked(xdt, dA, Bm.to(f32), Cm.to(f32), cfg.chunk)
    y = y + p["D"].to(f32)[None, None, :, None] * xs.to(f32)
    y = y.reshape(Bsz, S, di).to(dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    return torch.matmul(y.to(dtype), p["out_proj"].to(dtype))


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, width-1, conv_dim), compute dtype
    ssm: torch.Tensor  # (B, H, N, P) float32


def mamba2_init_cache(batch: int, cfg: Mamba2Config, dtype=torch.bfloat16,
                      device="cuda") -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.num_heads, cfg.d_state, cfg.head_dim), dtype=f32,
                        device=device),
    )


def mamba2_decode_apply(p, x, cache: MambaCache, cfg: Mamba2Config, dtype=torch.bfloat16):
    """Single-token recurrent step: x (B,1,d) -> (y (B,1,d), new cache)."""
    Bsz = x.shape[0]
    di, H, G, N, P_ = cfg.d_inner, cfg.num_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xBC, dt_raw = _project(p, x, cfg, dtype)
    window = torch.cat([cache.conv, xBC], dim=1)  # (B, width, conv_dim)
    conv_out = (torch.einsum("bwc,wc->bc", window.to(dtype), p["conv_w"].to(dtype))
                + p["conv_b"].to(dtype))[:, None, :]
    xBC = F.silu(conv_out)
    xs, Bm, Cm = _split_xbc(xBC, cfg)
    xs = xs.reshape(Bsz, H, P_)
    rep = H // G
    Bm = torch.repeat_interleave(Bm.reshape(Bsz, G, N), rep, dim=1).to(f32)
    Cm = torch.repeat_interleave(Cm.reshape(Bsz, G, N), rep, dim=1).to(f32)
    dt = softplus(dt_raw[:, 0].to(f32) + p["dt_bias"].to(f32))  # (B,H)
    A = -torch.exp(p["A_log"].to(f32))
    decay = torch.exp(dt * A)  # (B,H)
    xdt = xs.to(f32) * dt[..., None]  # (B,H,P)
    ssm = cache.ssm * decay[..., None, None] + Bm[..., :, None] * xdt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Cm, ssm) + p["D"].to(f32)[None, :, None] * xs.to(f32)
    y = y.reshape(Bsz, 1, di).to(dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = torch.matmul(y.to(dtype), p["out_proj"].to(dtype))
    return out, MambaCache(conv=window[:, 1:], ssm=ssm)


class Mamba2(ParamModule):
    """``forward`` is `mamba2_apply`, ``decode`` is `mamba2_decode_apply`.
    ``A_log``, ``D`` and ``dt_bias`` are used in float32 whatever the
    compute dtype (`basic.hold_in` leaves them so)."""

    FLOAT32_PARAMS = ("A_log", "D", "dt_bias")

    def __init__(self, generator, cfg: Mamba2Config, *, dtype=torch.bfloat16, device=None):
        super().__init__(mamba2_init(generator, cfg, device=device))
        self.norm = RMSNorm(cfg.d_inner, logical=("ssm_heads",), device=device)
        self.cfg, self.dtype = cfg, dtype

    def tree(self) -> dict:
        return dict(self.params(), norm=self.norm.params())

    def forward(self, x):
        return mamba2_apply(self.tree(), x, self.cfg, self.dtype)

    def decode(self, x, cache: MambaCache):
        return mamba2_decode_apply(self.tree(), x, cache, self.cfg, self.dtype)
