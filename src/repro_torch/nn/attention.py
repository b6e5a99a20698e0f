"""GQA/MQA attention with chunked (flash-style) softmax and KV-cache decode.

Training/prefill never materializes the (S, S) score matrix: queries and
keys are processed in chunks with the online-softmax recurrence, chunk for
chunk as the reference computes it (the same chunk sizes, the same order
of the running max, sum and accumulator updates), so the reductions add
in the same order.  ``skip_masked_chunks=True`` prunes fully-masked KV
chunks for causal attention (upper triangle).  ``softmax_exp="fast"`` puts
the paper's bit-trick exp inside the softmax (`core.fastexp.fastexp_fast`,
the plain PyTorch function, as the reference calls its jnp one).

Decode attends a single query over the cache; GQA repeats KV heads
virtually via reshape (no materialized repeat).  The new token's K/V is
written into the cache in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.fastexp import FAST_LO, fastexp_fast
from repro_torch.nn.basic import apply_rope
from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32
NEG_INF = -1e30


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (sequence chunking helper)."""
    if n <= target:
        return n
    if n % target == 0:
        return target
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return n


def attention_init(
    generator,
    d_model: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    qkv_bias: bool = False,
    device=None,
):
    def draw(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, device=device)

    p = {
        "wq": Param(draw((d_model, num_heads, head_dim), d_model), ("embed", "heads", "head_dim")),
        "wk": Param(draw((d_model, num_kv_heads, head_dim), d_model),
                    ("embed", "kv_heads", "head_dim")),
        "wv": Param(draw((d_model, num_kv_heads, head_dim), d_model),
                    ("embed", "kv_heads", "head_dim")),
        "wo": Param(draw((num_heads, head_dim, d_model), num_heads * head_dim),
                    ("heads", "head_dim", "embed")),
    }
    if qkv_bias:  # qwen2-style
        dev = device or generator.device
        p["bq"] = Param(torch.zeros((num_heads, head_dim), dtype=f32, device=dev),
                        ("heads", "head_dim"))
        p["bk"] = Param(torch.zeros((num_kv_heads, head_dim), dtype=f32, device=dev),
                        ("kv_heads", "head_dim"))
        p["bv"] = Param(torch.zeros((num_kv_heads, head_dim), dtype=f32, device=dev),
                        ("kv_heads", "head_dim"))
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def _project_qkv(p, x, positions, rope_theta, dtype):
    xd = x.to(dtype)
    q = _proj(xd, p["wq"].to(dtype))
    k = _proj(xd, p["wk"].to(dtype))
    v = _proj(xd, p["wv"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _fast_softmax_exp(x):
    """The reference's ``softmax_exp="fast"`` (attention.py:118-123): the
    fast exp of ``max(x, FAST_LO + 1)``, zero where ``x`` is masked."""
    return fastexp_fast(torch.clamp(x, min=FAST_LO + 1.0)) * (x > NEG_INF / 2).to(f32)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, K, D)
    v: torch.Tensor,  # (B, Skv, K, D)
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    skip_masked_chunks: bool = False,
    softmax_exp: str = "exact",
) -> torch.Tensor:
    """Flash-style attention; O(Sq*D + chunk^2) memory per head.

    ``softmax_exp="fast"`` swaps the online-softmax exponential for the
    paper's bit-trick approximation (§2.4); the running max keeps
    arguments in (-inf, 0] where its relative error (<4%, mean ~0)
    perturbs attention weights mildly and identically in numerator and
    denominator.
    """
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K  # query groups per KV head
    scale = 1.0 / math.sqrt(D)
    exp_fn = _fast_softmax_exp if softmax_exp == "fast" else torch.exp
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Skv, kv_chunk)
    nq, nk = Sq // qc, Skv // kc

    qr = q.reshape(B, nq, qc, K, G, D)
    kr = k.reshape(B, nk, kc, K, D)
    vr = v.reshape(B, nk, kc, K, D)
    dev = q.device

    def attend_q_block(qi: int, qb, nk_used: int):
        """Online softmax over ``nk_used`` KV chunks for one query chunk.
        qb: (B, qc, K, G, D) -> (B, qc, H, D)."""
        m = torch.full((B, K, G, qc), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, K, G, qc), dtype=f32, device=dev)
        acc = torch.zeros((B, K, G, qc, D), dtype=f32, device=dev)
        for kj in range(nk_used):
            kb, vb = kr[:, kj], vr[:, kj]
            s = torch.einsum("bqkgd,bckd->bkgqc", qb, kb).to(f32) * scale
            if causal:
                qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
                kpos = kj * kc + torch.arange(kc, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = s.masked_fill(~mask[None, None, None], NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = exp_fn(s - m_new[..., None])
            corr = exp_fn(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(qb.dtype), vb).to(f32)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(B, qc, K * G, D)

    if nq == 1:
        out = attend_q_block(0, qr[:, 0], nk)
    elif causal and skip_masked_chunks:
        # Query chunk qi only attends to the first
        # ceil(((qi+1)*qc + q_offset)/kc) KV chunks — prunes ~half the FLOPs
        # of causal attention.
        blocks = [
            attend_q_block(qi, qr[:, qi], min(nk, -(-((qi + 1) * qc + q_offset) // kc)))
            for qi in range(nq)
        ]
        out = torch.cat(blocks, dim=1)
    else:
        # Every query chunk over every KV chunk (the reference's scan).
        out = torch.cat([attend_q_block(qi, qr[:, qi], nk) for qi in range(nq)], dim=1)
    return out.to(q.dtype)


def attention_apply(
    p,
    x,
    positions,
    *,
    rope_theta: float = 1e4,
    causal: bool = True,
    dtype=torch.bfloat16,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    skip_masked_chunks: bool = False,
    softmax_exp: str = "exact",
):
    """Full-sequence (training / prefill) attention; returns (y, (k, v))."""
    q, k, v = _project_qkv(p, x, positions, rope_theta, dtype)
    out = chunked_attention(
        q,
        k,
        v,
        causal=causal,
        q_chunk=q_chunk,
        kv_chunk=kv_chunk,
        skip_masked_chunks=skip_masked_chunks,
        softmax_exp=softmax_exp,
    )
    return _out_proj(out, p["wo"].to(dtype)), (k, v)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, K, D)
    v: torch.Tensor  # (B, S_max, K, D)


def decode_attention_apply(
    p,
    x,  # (B, 1, d)
    cache: KVCache,
    cur_len: int,  # number of valid cache positions
    *,
    rope_theta: float = 1e4,
    dtype=torch.bfloat16,
):
    """Single-token decode over a filled KV cache; returns (y, cache).

    The new K/V is written into ``cache`` in place at ``cur_len`` (clamped
    to the last position, as the reference's dynamic update clamps)."""
    cur_len = int(cur_len)
    B = x.shape[0]
    positions = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, rope_theta, dtype)
    S_max, K, D = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    at = min(max(cur_len, 0), S_max - 1)
    cache.k[:, at:at + 1] = k_new.to(cache.k.dtype)
    cache.v[:, at:at + 1] = v_new.to(cache.v.dtype)
    H = q.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qr, cache.k.to(dtype)).to(f32)
    s = s / math.sqrt(D)
    valid = torch.arange(S_max, device=x.device)[None, None, None, :] <= cur_len
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(dtype), cache.v.to(dtype))
    out = out.reshape(B, 1, H, D)
    return _out_proj(out, p["wo"].to(dtype)), cache


class Attention(ParamModule):
    """GQA attention: ``forward`` is `attention_apply`, ``decode`` is
    `decode_attention_apply`."""

    def __init__(self, generator, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, qkv_bias: bool = False, rope_theta: float = 1e4,
                 dtype=torch.bfloat16, q_chunk: int = 512, kv_chunk: int = 1024,
                 skip_masked_chunks: bool = False, softmax_exp: str = "exact", device=None):
        super().__init__(attention_init(generator, d_model, num_heads, num_kv_heads, head_dim,
                                        qkv_bias=qkv_bias, device=device))
        self.rope_theta, self.dtype = rope_theta, dtype
        self.q_chunk, self.kv_chunk = q_chunk, kv_chunk
        self.skip_masked_chunks, self.softmax_exp = skip_masked_chunks, softmax_exp

    def forward(self, x, positions):
        return attention_apply(
            self.params(), x, positions, rope_theta=self.rope_theta, dtype=self.dtype,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
            skip_masked_chunks=self.skip_masked_chunks, softmax_exp=self.softmax_exp)

    def decode(self, x, cache: KVCache, cur_len: int):
        return decode_attention_apply(self.params(), x, cache, cur_len,
                                      rope_theta=self.rope_theta, dtype=self.dtype)
