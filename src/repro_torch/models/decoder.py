"""Decoder-only model covering every decoder family of the registry.

One config-driven assembly handles: dense GQA transformers (qwen2.5
(QKV bias), deepseek-coder, gemma (zero-centred RMSNorm, tied and scaled
embeddings, MQA), command-r (LayerNorm, parallel attention + MLP block,
tied embeddings), the internvl backbone (patch embeddings prepended to the
text)), MLA + MoE (deepseek-v3: dense head layers, then MoE layers), GQA +
MoE (llama4-scout), the Mamba2 hybrid with a shared attention block
(zamba2) and RWKV6 (attention-free).  An encoder-decoder config (whisper)
is built as a dense decoder, as the reference's decoder builds it
(`models.encdec` is its encoder-decoder).  The blocks are
``nn.ModuleList``s; the decode caches keep the reference's stacked
``(L, B, ...)`` layouts and are written in place.

  apply(params, tokens, cfg)                       -> logits, aux   [train]
  prefill(params, tokens, cfg, max_len)            -> logits, caches, len
  decode_step(params, token, caches, cur_len, cfg) -> logits, caches

``params`` is a `Decoder` (`init_params`).  ``prefill`` serves the
attention families (GQA and MLA); Mamba2, RWKV6 and encoder-decoder
configs raise NotImplementedError there, as in the reference (their
prompts are consumed by decode steps).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import mamba2 as mb
from repro_torch.nn import rwkv6 as rk
from repro_torch.nn.basic import MLP, Embedding, LayerNorm, RMSNorm, hold_in
from repro_torch.nn.mla import MLA, MLACache
from repro_torch.nn.moe import MoE
from repro_torch.nn.param import Param, ParamModule, fan_in_init
from repro_torch.sharding import current_ctx, shard_constraint, use_ctx
from repro_torch.sharding.ctx import gather_on_use

f32 = torch.float32


def _save_dots_policy(ctx, op, *args, **kwargs):
    """Save the products with no batch dimension (JAX's
    ``dots_with_no_batch_dims_saveable``: ``mm``, ``addmm``, and the
    ``bmm`` of one batch that an einsum without batch dims becomes);
    recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_save_dots_policy)


def remat_call(enabled: bool, policy: str, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    ``enabled`` (the reference's ``jax.checkpoint`` of a block): ``"full"``
    saves only the block's inputs, ``"dots"`` also the products (a
    selective checkpoint).  Memory changes, never the numbers.  Without
    autograd recording (serving) the call is plain.  The recompute runs
    under the forward's sharding context: on the card the backward runs
    on autograd's device thread, which does not see the caller's."""
    if not enabled or not torch.is_grad_enabled():
        return fn(*args)
    ctx = current_ctx()

    def block(*a):
        with use_ctx(ctx):
            return fn(*a)

    if policy == "dots":
        return checkpoint(block, *args, use_reentrant=False, context_fn=_save_dots)
    return checkpoint(block, *args, use_reentrant=False)


def _norm(cfg: ModelConfig, device):
    if cfg.norm_kind == "layernorm":
        return LayerNorm(cfg.d_model, device=device)
    return RMSNorm(cfg.d_model, zero_centered=cfg.zero_centered_norm, device=device)


def _embed_scale(cfg: ModelConfig) -> float:
    """The reference's ``dtype(embed_multiplier)`` (through float32, then
    the compute dtype) as a Python float: a bf16 tensor times it rounds
    once, as a product of two bf16 values does."""
    m = torch.tensor(float(np.float32(cfg.embed_multiplier)), dtype=cfg.compute_dtype)
    return float(m)


class Block(nn.Module):
    """One transformer block: pre-norm attention (GQA or MLA) and an MLP
    or MoE, or command-r's parallel form (one norm, one residual)."""

    def __init__(self, cfg: ModelConfig, generator, device=None, *, use_moe: bool = False):
        super().__init__()
        self.parallel = cfg.parallel_block
        self.norm1, self.norm2 = _norm(cfg, device), _norm(cfg, device)
        dtype = cfg.compute_dtype
        chunks = dict(q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                      skip_masked_chunks=cfg.skip_masked_chunks)
        if cfg.attn_kind == "mla":
            self.attn = MLA(generator, cfg.d_model, cfg.num_heads, cfg.mla,
                            rope_theta=cfg.rope_theta, dtype=dtype, device=device, **chunks)
        else:
            self.attn = attn.Attention(
                generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, dtype=dtype,
                softmax_exp=cfg.attn_exp, device=device, **chunks)
        if use_moe:
            self.moe = MoE(generator, cfg.d_model, cfg.moe, cfg.mlp_kind, dtype=dtype,
                           device=device)
        else:
            self.mlp = MLP(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype=dtype,
                           device=device)

    def _mix(self, x, h, attn_out):
        """The residual stream after attention: (x, aux loss)."""
        zero = torch.zeros((), dtype=f32, device=x.device)
        if self.parallel:  # command-r: one residual, parallel attn+ffn
            return x + attn_out + self.mlp(h), zero
        x = x + attn_out
        h = self.norm2(x)
        if hasattr(self, "moe"):
            mo, aux = self.moe(h)
            return x + mo, aux
        return x + self.mlp(h), zero

    def forward(self, x, positions):
        """Returns (x, kv, aux): the block's output, its keys and values
        (MLA: its latents) and its aux loss."""
        h = self.norm1(x)
        attn_out, kv = self.attn(h, positions)
        x, aux = self._mix(x, h, attn_out)
        return x, kv, aux

    def decode(self, x, cache, cur_len: int):
        h = self.norm1(x)
        attn_out, cache = self.attn.decode(h, cache, cur_len)
        return self._mix(x, h, attn_out)[0], cache


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 with a residual."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        self.norm = _norm(cfg, device)
        self.mamba = mb.Mamba2(generator, cfg.mamba, dtype=cfg.compute_dtype, device=device)

    def forward(self, x):
        return x + self.mamba(self.norm(x))

    def decode(self, x, cache: mb.MambaCache):
        y, cache = self.mamba.decode(self.norm(x), cache)
        return x + y, cache


class RWKVBlock(nn.Module):
    """Pre-LayerNorm time mixing, then channel mixing, each with a residual."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        dtype = cfg.compute_dtype
        self.tm = rk.TimeMix(generator, cfg.rwkv, dtype=dtype, device=device)
        self.cm = rk.ChannelMix(generator, cfg.rwkv, dtype=dtype, device=device)

    def forward(self, x):
        # The residual stream held batch-sharded at each mixer's input (not
        # in the reference): a constraint's cotangent takes its placements,
        # so a partial-sum gradient from one mixer is summed before the
        # other's gates, whose backward DTensor would scatter it over the
        # sequence.  No-ops without a mesh.
        x = shard_constraint(x, ("batch", "seq", None))
        x = shard_constraint(x + self.tm(self.ln1(x)), ("batch", "seq", None))
        return x + self.cm(self.ln2(x))

    def decode(self, x, cache: rk.RWKVCache):
        y, tm_shift, wkv = self.tm.decode(self.ln1(x), cache.tm_shift, cache.wkv)
        x = x + y
        y2, cm_shift = self.cm.decode(self.ln2(x), cache.cm_shift)
        return x + y2, rk.RWKVCache(tm_shift, cm_shift, wkv)


class DecodeCaches(NamedTuple):
    """Stacked per-layer caches: ``kv`` is an `attn.KVCache` of
    ``(L, B, S_max, K, D)`` tensors, an `MLACache`, a `mamba2.MambaCache`
    or an `rwkv6.RWKVCache` (each field with a leading layer axis);
    ``shared_kv`` is zamba2's shared block's `attn.KVCache`, one entry an
    invocation, or None."""

    kv: Any
    shared_kv: Any


def _layer(cache, layer: int):
    """The layer's views of a stacked cache (a NamedTuple of tensors)."""
    return type(cache)(*(t[layer] for t in cache))


def _write(cache, layer: int, new) -> None:
    """Write a layer's new recurrent state into the stacked cache."""
    for stacked, t in zip(cache, new):
        stacked[layer].copy_(t)


class Decoder(ParamModule):
    """The decoder: embedding, blocks, final norm, head (tied to the
    embedding or ``lm_head`` of shape (d_model, padded vocab)).  MoE
    configs have ``dense_blocks`` (the first ``moe_layer_start`` layers)
    and ``blocks``; a hybrid Mamba2 config has ``shared_attn``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__({})
        self.cfg = cfg
        self.embed_scale = _embed_scale(cfg)
        dtype = cfg.compute_dtype
        self.embed = Embedding(generator, cfg.padded_vocab, cfg.d_model, dtype=dtype,
                               device=device)
        if not cfg.tie_embeddings:
            self.add_param("lm_head", Param(
                fan_in_init(generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model,
                            device=device),
                ("embed", "vocab")))
        L = cfg.num_layers
        if cfg.rwkv is not None:
            self.blocks = nn.ModuleList(RWKVBlock(cfg, generator, device) for _ in range(L))
        elif cfg.mamba is not None:
            self.blocks = nn.ModuleList(MambaBlock(cfg, generator, device) for _ in range(L))
            if cfg.hybrid_attn_every:
                self.shared_attn = Block(cfg, generator, device)
        elif cfg.moe is not None:
            n_dense = cfg.moe_layer_start
            if n_dense:
                self.dense_blocks = nn.ModuleList(Block(cfg, generator, device)
                                                  for _ in range(n_dense))
            self.blocks = nn.ModuleList(Block(cfg, generator, device, use_moe=True)
                                        for _ in range(L - n_dense))
        else:
            self.blocks = nn.ModuleList(Block(cfg, generator, device) for _ in range(L))
        self.final_norm = _norm(cfg, device)

    def hold_compute_dtype(self) -> "Decoder":
        """Hold the weights used in ``cfg.compute_dtype`` in it (`hold_in`)."""
        return hold_in(self, self.cfg.compute_dtype)

    def _attn_blocks(self) -> list:
        """The attention families' blocks in layer order."""
        return list(getattr(self, "dense_blocks", ())) + list(self.blocks)

    def _shared_here(self, layer: int) -> bool:
        every = self.cfg.hybrid_attn_every
        return bool(every) and layer % every == 0

    def _embed(self, tokens):
        return self.embed(tokens) * self.embed_scale

    def _head(self, x):
        # Not in the reference: the head's input is held replicated over
        # "model", so its cotangent (a partial sum over the vocab shards) is
        # summed here before it runs back through the blocks, where DTensor
        # would scatter it over the sequence.
        x = shard_constraint(self.final_norm(x), ("batch", "seq", None))
        if self.cfg.tie_embeddings:
            return self.embed.logits(x)
        dtype = self.cfg.compute_dtype
        logits = torch.matmul(x.to(dtype), gather_on_use(self.lm_head).to(dtype))
        return shard_constraint(logits, ("batch", "seq", "vocab"))

    def forward(self, tokens, visual_embeds: Optional[torch.Tensor] = None):
        """Full forward; returns (logits (B, S, vocab), aux_loss)."""
        cfg = self.cfg
        x = self._embed(tokens)
        if visual_embeds is not None:
            x = torch.cat([visual_embeds.to(x.dtype), x], dim=1)
        positions = _positions(x.shape[0], x.shape[1], x.device)
        x = shard_constraint(x, ("batch", "seq", None))
        aux = torch.zeros((), dtype=f32, device=x.device)
        remat = functools.partial(remat_call, cfg.remat, cfg.remat_policy)
        if cfg.mamba is not None and cfg.hybrid_attn_every:
            # The shared attention block runs before every hybrid_attn_every-th
            # mamba layer, the first included (a plain loop: the reference
            # scans, and remats, the other families' blocks only).
            for l, blk in enumerate(self.blocks):
                if self._shared_here(l):
                    x = self.shared_attn(x, positions)[0]
                x = blk(x)
        elif cfg.rwkv is not None or cfg.mamba is not None:
            for blk in self.blocks:
                x = remat(blk, x)
        else:
            for blk in self._attn_blocks():
                x, _, aux_l = remat(blk, x, positions)
                aux = aux + aux_l
        return self._head(x), aux

    def prefill(self, tokens, max_len: int):
        cfg = self.cfg
        if cfg.mamba is not None or cfg.rwkv is not None or cfg.encdec:
            raise NotImplementedError("prefill(): attention-family archs only")
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens does not fit max_len={max_len}")
        caches = init_decode_caches(cfg, B, max_len, device=tokens.device)
        x = self._embed(tokens)
        positions = _positions(B, S, x.device)
        x = shard_constraint(x, ("batch", "seq", None))
        for l, blk in enumerate(self._attn_blocks()):
            x, kv, _ = blk(x, positions)
            if cfg.attn_kind == "mla":
                c_kv, k_rope = kv  # (B,S,rank), (B,S,1,dr)
                caches.kv.c_kv[l, :, :S] = c_kv
                caches.kv.k_rope[l, :, :S] = k_rope[:, :, 0, :]
            else:
                caches.kv.k[l, :, :S] = kv[0]
                caches.kv.v[l, :, :S] = kv[1]
        return self._head(x), caches, S

    def decode(self, token, caches: DecodeCaches, cur_len: int):
        cfg = self.cfg
        x = shard_constraint(self._embed(token), ("batch", None, None))
        if cfg.rwkv is not None or cfg.mamba is not None:
            for l, blk in enumerate(self.blocks):
                if self._shared_here(l):
                    sc = _layer(caches.shared_kv, l // cfg.hybrid_attn_every)
                    x, _ = self.shared_attn.decode(x, sc, cur_len)
                x, new = blk.decode(x, _layer(caches.kv, l))
                _write(caches.kv, l, new)
        else:
            for l, blk in enumerate(self._attn_blocks()):
                x, _ = blk.decode(x, _layer(caches.kv, l), cur_len)
        return self._head(x), caches


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _model(params: Decoder, cfg: ModelConfig) -> Decoder:
    """``params``, after checking it was built for ``cfg`` (the serving
    length ``max_target_length`` aside)."""
    if dataclasses.replace(cfg, max_target_length=params.cfg.max_target_length) != params.cfg:
        raise ValueError(f"the Decoder was built for {params.cfg.name} with other settings "
                         f"than the config given")
    return params


# --- the reference's functions ---------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> Decoder:
    """A `Decoder` for ``cfg``: weights drawn from ``generator`` (on its
    device, in the reference's fan-in scales), placed on ``device``."""
    return Decoder(cfg, generator, device=torch.device(device))


def apply(params: Decoder, tokens: torch.Tensor, cfg: ModelConfig, *,
          visual_embeds: Optional[torch.Tensor] = None):
    """Full forward; returns (logits (B, S, vocab), aux_loss)."""
    return _model(params, cfg)(tokens, visual_embeds)


def _stack(n: int, cache):
    """``n`` zeroed copies of ``cache``'s fields on a leading axis."""
    return type(cache)(*(torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                         for t in cache))


def _kv_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> attn.KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return attn.KVCache(k=torch.empty(shape, dtype=cfg.compute_dtype, device=device),
                        v=torch.empty(shape, dtype=cfg.compute_dtype, device=device))


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> DecodeCaches:
    """Zeroed caches of ``batch`` slots of ``max_len`` positions."""
    device, dtype, L = torch.device(device), cfg.compute_dtype, cfg.num_layers
    if cfg.rwkv is not None:
        return DecodeCaches(_stack(L, rk.rwkv6_init_cache(batch, cfg.rwkv, dtype, device)), None)
    if cfg.mamba is not None:
        kv = _stack(L, mb.mamba2_init_cache(batch, cfg.mamba, dtype, device))
        shared = None
        if cfg.hybrid_attn_every:
            shared = _stack(-(-L // cfg.hybrid_attn_every),
                            _kv_cache(cfg, batch, max_len, device))
        return DecodeCaches(kv, shared)
    if cfg.mla is not None:
        s = cfg.mla
        one = MLACache(c_kv=torch.empty((batch, max_len, s.kv_lora_rank), dtype=dtype,
                                        device=device),
                       k_rope=torch.empty((batch, max_len, s.qk_rope_head_dim), dtype=dtype,
                                          device=device))
        return DecodeCaches(_stack(L, one), None)
    return DecodeCaches(_stack(L, _kv_cache(cfg, batch, max_len, device)), None)


def decode_step(params: Decoder, token: torch.Tensor, caches: DecodeCaches, cur_len: int,
                cfg: ModelConfig):
    """One-token serve step; returns (logits (B, 1, vocab), caches), the
    caches written in place."""
    return _model(params, cfg).decode(token, caches, cur_len)


def prefill(params: Decoder, tokens: torch.Tensor, cfg: ModelConfig, max_len: int):
    """Full-prompt forward that fills the decode caches, padded to
    ``max_len`` (attention families: GQA and MLA).  Returns (logits
    (B, S_prompt, vocab), DecodeCaches, next_len)."""
    return _model(params, cfg).prefill(tokens, max_len)
