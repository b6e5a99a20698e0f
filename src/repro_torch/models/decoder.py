"""Decoder-only model: the dense GQA family.

One config-driven assembly covers the dense transformers of the registry:
qwen2.5 (QKV bias), deepseek-coder, gemma (zero-centred RMSNorm, tied and
scaled embeddings, MQA), command-r (LayerNorm, parallel attention + MLP
block, tied embeddings) and the internvl backbone (patch embeddings
prepended to the text).  The blocks are an ``nn.ModuleList``; the decode
caches keep the reference's stacked ``(L, B, S_max, K, D)`` layout.

  apply(params, tokens, cfg)                       -> logits, aux   [train]
  prefill(params, tokens, cfg, max_len)            -> logits, caches, len
  decode_step(params, token, caches, cur_len, cfg) -> logits, caches

``params`` is a `Decoder` (`init_params`).  The other families (MoE, MLA,
Mamba2, RWKV6, encoder-decoder) are not ported yet: a config that needs
one is refused with a ValueError naming the module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import attention as attn
from repro_torch.nn.basic import MLP, Embedding, LayerNorm, RMSNorm, hold_in
from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32

#: Config fields whose families are not ported yet -> the module they need.
UNPORTED = (
    ("moe", "nn/moe.py (mixture of experts)"),
    ("mla", "nn/mla.py (multi-head latent attention)"),
    ("mamba", "nn/mamba2.py (Mamba2)"),
    ("rwkv", "nn/rwkv6.py (RWKV6)"),
    ("encdec", "models/encdec.py (encoder-decoder)"),
)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ValueError if ``cfg`` needs a module the port does not have."""
    for field, module in UNPORTED:
        if getattr(cfg, field):
            raise ValueError(f"{cfg.name}: {field} needs {module}, which is not ported yet; "
                             f"the decoder runs the dense family only")


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
    """One transformer block: pre-norm attention and MLP, or command-r's
    parallel form (one norm, one residual)."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        self.parallel = cfg.parallel_block
        self.norm1, self.norm2 = _norm(cfg, device), _norm(cfg, device)
        dtype = cfg.compute_dtype
        self.attn = attn.Attention(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, dtype=dtype,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            skip_masked_chunks=cfg.skip_masked_chunks, softmax_exp=cfg.attn_exp, device=device)
        self.mlp = MLP(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype=dtype, device=device)

    def _mix(self, x, h, attn_out):
        if self.parallel:  # command-r: one residual, parallel attn+ffn
            return x + attn_out + self.mlp(h)
        x = x + attn_out
        return x + self.mlp(self.norm2(x))

    def forward(self, x, positions):
        """Returns (x, (k, v)): the block's output and its keys and values."""
        h = self.norm1(x)
        attn_out, kv = self.attn(h, positions)
        return self._mix(x, h, attn_out), kv

    def decode(self, x, cache: attn.KVCache, cur_len: int):
        h = self.norm1(x)
        attn_out, cache = self.attn.decode(h, cache, cur_len)
        return self._mix(x, h, attn_out), cache


class DecodeCaches(NamedTuple):
    """Stacked per-layer caches: ``kv`` is an `attn.KVCache` of
    ``(L, B, S_max, K, D)`` tensors; ``shared_kv`` (zamba2's shared block)
    is None for the dense family."""

    kv: Any
    shared_kv: Any


class Decoder(ParamModule):
    """The dense decoder: embedding, blocks, final norm, head (tied to the
    embedding or ``lm_head`` of shape (d_model, padded vocab))."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        check_ported(cfg)
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
        self.blocks = nn.ModuleList(Block(cfg, generator, device) for _ in range(cfg.num_layers))
        self.final_norm = _norm(cfg, device)

    def hold_compute_dtype(self) -> "Decoder":
        """Hold the weights used in ``cfg.compute_dtype`` in it (`hold_in`)."""
        return hold_in(self, self.cfg.compute_dtype)

    def _embed(self, tokens):
        return self.embed(tokens) * self.embed_scale

    def _head(self, x):
        x = self.final_norm(x)
        if self.cfg.tie_embeddings:
            return self.embed.logits(x)
        dtype = self.cfg.compute_dtype
        return torch.matmul(x.to(dtype), self.lm_head.to(dtype))

    def forward(self, tokens, visual_embeds: Optional[torch.Tensor] = None):
        """Full forward; returns (logits (B, S, vocab), aux_loss)."""
        x = self._embed(tokens)
        if visual_embeds is not None:
            x = torch.cat([visual_embeds.to(x.dtype), x], dim=1)
        positions = _positions(x.shape[0], x.shape[1], x.device)
        for blk in self.blocks:
            x, _ = blk(x, positions)
        return self._head(x), torch.zeros((), dtype=f32, device=x.device)

    def prefill(self, tokens, max_len: int):
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens does not fit max_len={max_len}")
        caches = init_decode_caches(self.cfg, B, max_len, device=tokens.device)
        x = self._embed(tokens)
        positions = _positions(B, S, x.device)
        for l, blk in enumerate(self.blocks):
            x, (k, v) = blk(x, positions)
            caches.kv.k[l, :, :S] = k
            caches.kv.v[l, :, :S] = v
        return self._head(x), caches, S

    def decode(self, token, caches: DecodeCaches, cur_len: int):
        x = self._embed(token)
        for l, blk in enumerate(self.blocks):
            x, _ = blk.decode(x, attn.KVCache(caches.kv.k[l], caches.kv.v[l]), cur_len)
        return self._head(x), caches


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _model(params: Decoder, cfg: ModelConfig) -> Decoder:
    """``params``, after checking it was built for ``cfg`` (the serving
    length ``max_target_length`` aside)."""
    check_ported(cfg)
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


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> DecodeCaches:
    check_ported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    kw = dict(dtype=cfg.compute_dtype, device=torch.device(device))
    return DecodeCaches(attn.KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw)),
                        None)


def decode_step(params: Decoder, token: torch.Tensor, caches: DecodeCaches, cur_len: int,
                cfg: ModelConfig):
    """One-token serve step; returns (logits (B, 1, vocab), caches), the
    caches written in place."""
    return _model(params, cfg).decode(token, caches, cur_len)


def prefill(params: Decoder, tokens: torch.Tensor, cfg: ModelConfig, max_len: int):
    """Full-prompt forward that fills the decode caches, padded to
    ``max_len``.  Returns (logits (B, S_prompt, vocab), DecodeCaches,
    next_len)."""
    return _model(params, cfg).prefill(tokens, max_len)
