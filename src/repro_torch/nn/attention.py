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

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.fastexp import FAST_LO, fastexp_fast
from repro_torch.nn.basic import apply_rope
from repro_torch.nn.param import Param, ParamModule, fan_in_init
from repro_torch.sharding import (P, axis_index, current_ctx, pmax, psum, shard_constraint,
                                  shard_map)
from repro_torch.sharding.ctx import axis_size, is_dtensor, reshape

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
    return reshape(torch.matmul(x, reshape(w, (d, h * k))), (*x.shape[:-1], h, k))


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(reshape(out, (*out.shape[:-2], h * k)), reshape(wo, (h * k, d)))


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
    q = shard_constraint(q, ("batch", "seq", "heads", None))
    k = shard_constraint(k, ("batch", "seq", "kv_heads", None))
    v = shard_constraint(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def _fast_softmax_exp(x):
    """The reference's ``softmax_exp="fast"`` (attention.py:118-123): the
    fast exp of ``max(x, FAST_LO + 1)``, zero where ``x`` is masked."""
    return fastexp_fast(torch.clamp(x, min=FAST_LO + 1.0)) * (x > NEG_INF / 2).to(f32)


def chunked_attention(q, k, v, **kw) -> torch.Tensor:
    """`_chunked_attention`; over a mesh (the active ctx has a
    ``DeviceMesh`` and ``q`` is a DTensor) it runs through ``shard_map``:
    each device attends its own (batch, head) block, which needs no other
    device's data, as one op (`_attention_op`).  Where the query heads
    shard and the KV heads do not (they do not divide the axis), each
    device takes the KV heads its query heads read."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not is_dtensor(q):
        return _chunked_attention(q, k, v, **kw)
    H, K = q.shape[2], k.shape[2]
    G = H // K
    qs = ctx.spec(("batch", None, "heads", None), tuple(q.shape))
    ks = ctx.spec(("batch", None, "kv_heads", None), tuple(k.shape))
    ks = (qs[0], None, ks[2], None)
    axis = qs[2]
    args = tuple({**_ATTN_DEFAULTS, **kw}[n] for n in _ATTN_DEFAULTS)
    op = _attention_op()
    if axis is not None and ks[2] is None:
        Hl = H // ctx.axis_size((axis,) if isinstance(axis, str) else axis)

        def local(ql, kl, vl):
            idx = (axis_index(ctx.mesh, axis) * Hl + torch.arange(Hl, device=ql.device)) // G
            return op(ql, kl[:, :, idx], vl[:, :, idx], *args)
    else:
        def local(ql, kl, vl):
            return op(ql, kl, vl, *args)
    return shard_map(local, ctx.mesh, in_specs=(P(*qs), P(*ks), P(*ks)), out_specs=P(*qs))(q, k, v)


_ATTN_DEFAULTS = dict(causal=True, q_chunk=512, kv_chunk=1024, q_offset=0,
                      skip_masked_chunks=False, softmax_exp="exact")


def _attention_pairs(q_shape, k_shape, causal, q_chunk, kv_chunk, q_offset, skip):
    """(query chunk, key chunk) pairs `_chunked_attention` computes, and the chunks."""
    Sq, Skv = q_shape[1], k_shape[1]
    qc, kc = _pick_chunk(Sq, q_chunk), _pick_chunk(Skv, kv_chunk)
    nq, nk = Sq // qc, Skv // kc
    if nq > 1 and causal and skip:
        return sum(min(nk, -(-((qi + 1) * qc + q_offset) // kc)) for qi in range(nq)), qc, kc
    return nq * nk, qc, kc


def _attention_grads(g, q, k, v, *args):
    """The gradients of `_chunked_attention` at (q, k, v), recomputed under autograd."""
    kw = dict(zip(_ATTN_DEFAULTS, args))
    with torch.enable_grad():
        qkv = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
        return torch.autograd.grad(_chunked_attention(*qkv, **kw), qkv, g)


@functools.lru_cache(maxsize=None)
def _attention_op():
    """`_chunked_attention` as one op, ``repro_torch::chunked_attention``:
    the same arithmetic, one op a call, so that a fake-tensor trace of a
    mesh step (`launch.dryrun`) does not run the chunk loop op by op (on
    the CPU, gemma-2b prefill_32k's step traces in seconds with the op,
    in 657.6 s without).  A fake shape and a flop formula stand for the
    forward.  The backward is the chunk loop's own, recomputed under
    autograd (`_attention_grads`) on real and fake tensors alike, so a
    trace holds the recompute's temporaries and counts its products."""
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::chunked_attention", mutates_args=())
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_chunk: int,
            kv_chunk: int, q_offset: int, skip_masked_chunks: bool,
            softmax_exp: str) -> torch.Tensor:
        return _chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                  q_offset=q_offset, skip_masked_chunks=skip_masked_chunks,
                                  softmax_exp=softmax_exp).clone()

    @fwd.register_fake
    def _(q, k, v, *args):
        return q.new_empty(q.shape)

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])
        ctx.args = inputs[3:]

    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return tuple(_attention_grads(g, q, k, v, *ctx.args)) + (None,) * len(ctx.args)

    fwd.register_autograd(backward, setup_context=setup_context)

    @register_flop_formula(torch.ops.repro_torch.chunked_attention)
    def _(q, k, v, causal, q_chunk, kv_chunk, q_offset, skip, exp, out_shape=None, **kw):
        pairs, qc, kc = _attention_pairs(q, k, causal, q_chunk, kv_chunk, q_offset, skip)
        B, _, H, D = q
        return 4 * B * H * qc * kc * D * pairs  # scores and the weighted values

    return fwd


def _chunked_attention(
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
    return shard_constraint(_out_proj(out, p["wo"].to(dtype)), ("batch", "seq", None)), (k, v)


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
    write_position(cache.k, k_new, at, _KV_CACHE)
    write_position(cache.v, v_new, at, _KV_CACHE)
    H = q.shape[2]
    G = H // K
    qr = reshape(q, (B, K, G, D))
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not is_dtensor(cache.k):
        out = _decode_attend(qr, cache.k.to(dtype), cache.v.to(dtype), cur_len, dtype)
    else:
        out = _decode_attend_blocks(qr, cache.k.to(dtype), cache.v.to(dtype), cur_len, dtype, ctx)
    out = reshape(out, (B, 1, H, D))
    return shard_constraint(_out_proj(out, p["wo"].to(dtype)), ("batch", None, None)), cache


_KV_CACHE = ("batch", "cache_seq", "kv_heads", "cache_head_dim")


def _seq_block(mesh, axes) -> int:
    """This device's block of a dim sharded over ``axes`` (major to minor)."""
    block = 0
    for a in axes:
        block = block * axis_size(mesh, a) + axis_index(mesh, a)
    return block


def _axis_names(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def write_position(cache_t, new, at: int, logical):
    """``cache_t[:, at] = new[:, 0]`` in place (a cache of ``logical`` axes,
    batch then sequence first; ``new`` one position long).  Over a mesh
    whose rules shard the sequence, the device whose block holds ``at``
    writes into its block, through ``shard_map``: a DTensor's slice of a
    sharded dim is a gathered copy, which the write would miss."""
    ctx = current_ctx()
    on_mesh = ctx is not None and ctx.mesh is not None and is_dtensor(cache_t)
    spec = ctx.spec(logical, tuple(cache_t.shape)) if on_mesh else (None, None)
    seq_axes = _axis_names(spec[1])
    if not seq_axes:
        cache_t[:, at:at + 1] = new.to(cache_t.dtype)
        return
    if tuple(cache_t.placements) != ctx.placements(spec):
        raise ValueError(f"the cache's placements {tuple(cache_t.placements)} are not its "
                         f"sharding {ctx.placements(spec)}: a write would land in a copy")
    mesh = ctx.mesh

    def local(cl, nl):
        lo = _seq_block(mesh, seq_axes) * cl.shape[1]
        if lo <= at < lo + cl.shape[1]:
            cl[:, at - lo:at - lo + 1] = nl.to(cl.dtype)
        return cl

    shard_map(local, mesh, in_specs=(P(*spec), P(spec[0], None, *spec[2:])),
              out_specs=P(*spec))(cache_t, new)


def _decode_attend(qr, k, v, cur_len: int, dtype):
    """One query token over the cache: qr (B,K,G,D), k and v (B,S,K,D)."""
    s = torch.einsum("bkgd,bskd->bkgs", qr, k).to(f32)
    s = s / math.sqrt(qr.shape[-1])
    valid = torch.arange(k.shape[1], device=qr.device)[None, None, None, :] <= cur_len
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w.to(dtype), v)


def _decode_attend_blocks(qr, k, v, cur_len: int, dtype, ctx):
    """`_decode_attend` over a mesh, through ``shard_map`` on each device's
    block of the cache (its rules: batch, KV heads, and the decode
    overrides' sequence or head dim).  A sharded head dim sums the scores
    over its axes; a sharded sequence takes a softmax whose max and sum,
    and then the output, are reduced over its axes.  DTensor's own rules
    would merge the sharded batch and head dims into strided shards its
    products refuse."""
    mesh = ctx.mesh
    kspec = ctx.spec(_KV_CACHE, tuple(k.shape))
    b_ax, s_ax, k_ax, d_ax = kspec
    seq_axes, dim_axes = _axis_names(s_ax), _axis_names(d_ax)

    def local(ql, kl, vl):
        s = psum(torch.einsum("bkgd,bskd->bkgs", ql, kl).to(f32), mesh, dim_axes)
        s = s / math.sqrt(qr.shape[-1])
        pos = _seq_block(mesh, seq_axes) * kl.shape[1] + torch.arange(kl.shape[1],
                                                                      device=ql.device)
        s = s.masked_fill(~(pos <= cur_len)[None, None, None, :], NEG_INF)
        if not seq_axes:
            w = torch.softmax(s, dim=-1)
            return torch.einsum("bkgs,bskd->bkgd", w.to(dtype), vl)
        m = pmax(torch.amax(s, dim=-1, keepdim=True), mesh, seq_axes)
        e = torch.exp(s - m)
        w = e / psum(torch.sum(e, dim=-1, keepdim=True), mesh, seq_axes)
        return psum(torch.einsum("bkgs,bskd->bkgd", w.to(dtype), vl), mesh, seq_axes)

    qspec = P(b_ax, k_ax, None, d_ax)
    return shard_map(local, mesh, in_specs=(qspec, P(*kspec), P(*kspec)), out_specs=qspec)(
        qr, k, v)


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
