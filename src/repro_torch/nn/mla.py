"""Multi-head Latent Attention (DeepSeek-V2/V3), arXiv:2412.19437 §2.1.

Queries and KV are factored through low-rank latents.  Training/prefill
up-projects per-head K/V and runs the shared chunked attention (``v``
padded to the q/k head dim, then sliced).  Decode uses the *absorbed*
formulation: only the compressed latent ``c_kv`` plus the shared rope key
are cached (576 floats a token at deepseek-v3's width, whatever the 128
heads), and the K/V up-projections are folded into the query and output
sides.  The new token's latents are written into the cache in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.nn.attention import NEG_INF, chunked_attention
from repro_torch.nn.basic import RMSNorm, apply_rope, rmsnorm_apply
from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32


def mla_init(generator, d_model: int, num_heads: int, *, q_lora_rank: int = 1536,
             kv_lora_rank: int = 512, qk_nope_head_dim: int = 128, qk_rope_head_dim: int = 64,
             v_head_dim: int = 128, device=None):
    """The reference's tree less the two norms (`MLA` holds them as
    `RMSNorm` modules ``q_norm`` and ``kv_norm``)."""
    dn, dr, dv = qk_nope_head_dim, qk_rope_head_dim, v_head_dim

    def draw(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, device=device)

    return {
        "wq_a": Param(draw((d_model, q_lora_rank), d_model), ("embed", None)),
        "wq_b": Param(draw((q_lora_rank, num_heads, dn + dr), q_lora_rank),
                      ("lora", "heads", None)),
        "wkv_a": Param(draw((d_model, kv_lora_rank + dr), d_model), ("embed", None)),
        "wk_b": Param(draw((kv_lora_rank, num_heads, dn), kv_lora_rank), ("lora", "heads", None)),
        "wv_b": Param(draw((kv_lora_rank, num_heads, dv), kv_lora_rank), ("lora", "heads", None)),
        "wo": Param(draw((num_heads, dv, d_model), num_heads * dv),
                    ("heads", "head_dim", "embed")),
    }


def _up(x, w):
    """einsum("bsr,rhk->bshk") as one matmul."""
    r, h, k = w.shape
    return torch.matmul(x, w.reshape(r, h * k)).reshape(*x.shape[:-1], h, k)


def _latents(p, x, positions, rope_theta, dtype, kv_lora_rank, dr):
    """Shared q/kv latent computation. Returns (q_nope, q_rope, c_kv, k_rope)."""
    cq = torch.matmul(x.to(dtype), p["wq_a"].to(dtype))
    cq = rmsnorm_apply(p["q_norm"], cq)
    q = _up(cq.to(dtype), p["wq_b"].to(dtype))
    q_nope, q_rope = q[..., :-dr], q[..., -dr:]
    q_rope = apply_rope(q_rope, positions, rope_theta)

    ckv_full = torch.matmul(x.to(dtype), p["wkv_a"].to(dtype))
    c_kv = rmsnorm_apply(p["kv_norm"], ckv_full[..., :kv_lora_rank])
    k_rope = ckv_full[..., kv_lora_rank:][:, :, None, :]  # (B,S,1,dr) shared head
    k_rope = apply_rope(k_rope, positions, rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p, x, positions, *, num_heads: int, kv_lora_rank: int = 512,
              qk_rope_head_dim: int = 64, rope_theta: float = 1e4, dtype=torch.bfloat16,
              q_chunk: int = 512, kv_chunk: int = 1024, skip_masked_chunks: bool = False):
    """Full-sequence MLA (training / prefill): up-project K/V per head.
    Returns (y, (c_kv (B,S,rank), k_rope (B,S,1,dr)))."""
    dr = qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, positions, rope_theta, dtype, kv_lora_rank, dr)
    k_nope = _up(c_kv.to(dtype), p["wk_b"].to(dtype))
    v = _up(c_kv.to(dtype), p["wv_b"].to(dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], dr)], dim=-1)
    # v head dim may differ from qk head dim; pad for the shared kernel then slice.
    dv, dq = v.shape[-1], q.shape[-1]
    v_p = F.pad(v, (0, dq - dv)) if dv < dq else v
    out = chunked_attention(q, k, v_p, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            skip_masked_chunks=skip_masked_chunks)[..., :dv]
    wo = p["wo"].to(dtype)
    h, k_, d = wo.shape
    y = torch.matmul(out.reshape(*out.shape[:2], h * k_), wo.reshape(h * k_, d))
    return y, (c_kv, k_rope)


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S_max, kv_lora_rank)
    k_rope: torch.Tensor  # (B, S_max, dr)


def mla_decode_apply(p, x, cache: MLACache, cur_len: int, *, num_heads: int,
                     kv_lora_rank: int = 512, qk_rope_head_dim: int = 64,
                     rope_theta: float = 1e4, dtype=torch.bfloat16):
    """Absorbed-matmul decode: attention runs in the latent space.  x
    (B, 1, d); the new latents are written into ``cache`` in place at
    ``cur_len`` (clamped to the last position, as the reference's dynamic
    update clamps).  Returns (y, cache)."""
    cur_len = int(cur_len)
    B = x.shape[0]
    dr = qk_rope_head_dim
    positions = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _latents(p, x, positions, rope_theta, dtype, kv_lora_rank, dr)
    S_max = cache.c_kv.shape[1]
    at = min(max(cur_len, 0), S_max - 1)
    cache.c_kv[:, at:at + 1] = c_new.to(cache.c_kv.dtype)
    cache.k_rope[:, at:at + 1] = kr_new[:, :, 0, :].to(cache.k_rope.dtype)
    c_kv, k_rope = cache.c_kv.to(dtype), cache.k_rope.to(dtype)
    wk_b = p["wk_b"].to(dtype)
    # Absorb wk_b into the query: q_eff (B,1,H,rank).
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
    s = torch.einsum("bshr,btr->bhst", q_eff, c_kv).to(f32)
    s = s + torch.einsum("bshk,btk->bhst", q_rope, k_rope).to(f32)
    s = s / math.sqrt(wk_b.shape[2] + dr)
    valid = torch.arange(S_max, device=x.device)[None, None, None, :] <= cur_len
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    # Attention output in latent space, then absorb wv_b.
    o_lat = torch.einsum("bhst,btr->bshr", w.to(dtype), c_kv)
    out = torch.einsum("bshr,rhk->bshk", o_lat, p["wv_b"].to(dtype))
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return y, cache


class MLA(ParamModule):
    """``forward`` is `mla_apply`, ``decode`` is `mla_decode_apply`."""

    def __init__(self, generator, d_model: int, num_heads: int, spec, *, rope_theta: float = 1e4,
                 dtype=torch.bfloat16, q_chunk: int = 512, kv_chunk: int = 1024,
                 skip_masked_chunks: bool = False, device=None):
        super().__init__(mla_init(
            generator, d_model, num_heads, q_lora_rank=spec.q_lora_rank,
            kv_lora_rank=spec.kv_lora_rank, qk_nope_head_dim=spec.qk_nope_head_dim,
            qk_rope_head_dim=spec.qk_rope_head_dim, v_head_dim=spec.v_head_dim, device=device))
        self.q_norm = RMSNorm(spec.q_lora_rank, logical=("lora",), device=device)
        self.kv_norm = RMSNorm(spec.kv_lora_rank, logical=("lora",), device=device)
        self.kw = dict(num_heads=num_heads, kv_lora_rank=spec.kv_lora_rank,
                       qk_rope_head_dim=spec.qk_rope_head_dim, rope_theta=rope_theta,
                       dtype=dtype)
        self.chunks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk,
                           skip_masked_chunks=skip_masked_chunks)

    def tree(self) -> dict:
        return dict(self.params(), q_norm=self.q_norm.params(), kv_norm=self.kv_norm.params())

    def forward(self, x, positions):
        return mla_apply(self.tree(), x, positions, **self.kw, **self.chunks)

    def decode(self, x, cache: MLACache, cur_len: int):
        return mla_decode_apply(self.tree(), x, cache, cur_len, **self.kw)
