"""Encoder-decoder (Whisper-family) backbone, arXiv:2212.04356.

The conv frontend is a stub, as in the reference: the caller provides
precomputed frame embeddings (B, enc_seq, d_model), the output of
Whisper's two conv1d layers.  Positions are sinusoidal on both sides (the
decoder's learned positions are replaced by sinusoids, as the reference
does).

Encoder blocks: non-causal self-attention + GELU MLP, pre-LayerNorm.
Decoder blocks: causal self-attention (KV cache) + cross-attention over
the encoded frames (its K/V computed once, when the caches are made) +
GELU MLP, pre-LayerNorm.

  apply(params, tokens, frames, cfg)                -> logits, aux=0
  init_decode_caches(params, frames, cfg, max_len)  -> EncDecCaches
  decode_step(params, token, caches, cur_len, cfg)  -> logits, caches

``params`` is an `EncDec` (`init_params`); the caches' self-attention K/V
are written in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import remat_call
from repro_torch.nn import attention as attn
from repro_torch.nn.basic import MLP, Embedding, LayerNorm, hold_in
from repro_torch.nn.param import ParamModule
from repro_torch.sharding import shard_constraint

f32 = torch.float32


def sinusoid_positions(length: int, dim: int) -> np.ndarray:
    """(length, dim) float32: sines then cosines, computed in float64."""
    inv = 1.0 / (10000 ** (np.arange(0, dim, 2) / dim))
    pos = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _positions_on(length: int, dim: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    # Made once a device and dtype (read-only): no host copy a call.
    return torch.from_numpy(sinusoid_positions(length, dim)).to(device=device, dtype=dtype)


def _attention(cfg: ModelConfig, generator, device) -> attn.Attention:
    return attn.Attention(generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, rope_theta=0.0, dtype=cfg.compute_dtype,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, device=device)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.d_model, device=device)
        self.norm2 = LayerNorm(cfg.d_model, device=device)
        self.attn = _attention(cfg, generator, device)
        self.mlp = MLP(generator, cfg.d_model, cfg.d_ff, "gelu", dtype=cfg.compute_dtype,
                       device=device)

    def forward(self, h, positions):
        a, _ = attn.attention_apply(
            self.attn.params(), self.norm1(h), positions, rope_theta=0.0, causal=False,
            dtype=self.attn.dtype, q_chunk=self.attn.q_chunk, kv_chunk=self.attn.kv_chunk)
        h = h + a
        return h + self.mlp(self.norm2(h))


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.d_model, device=device)
        self.norm_x = LayerNorm(cfg.d_model, device=device)
        self.norm2 = LayerNorm(cfg.d_model, device=device)
        self.self_attn = _attention(cfg, generator, device)
        self.cross_attn = _attention(cfg, generator, device)
        self.mlp = MLP(generator, cfg.d_model, cfg.d_ff, "gelu", dtype=cfg.compute_dtype,
                       device=device)
        self.skip_masked_chunks = cfg.skip_masked_chunks

    def cross_kv(self, enc_out):
        p, dtype = self.cross_attn.params(), self.cross_attn.dtype
        e = enc_out.to(dtype)
        return attn._proj(e, p["wk"].to(dtype)), attn._proj(e, p["wv"].to(dtype))

    def _cross(self, h, k, v, **chunks):
        p, dtype = self.cross_attn.params(), self.cross_attn.dtype
        q = attn._proj(self.norm_x(h).to(dtype), p["wq"].to(dtype))
        o = attn.chunked_attention(q, k, v, causal=False, **chunks)
        h = h + attn._out_proj(o, p["wo"].to(dtype))
        return h + self.mlp(self.norm2(h))

    def forward(self, h, positions, enc_out):
        sa = self.self_attn
        a, _ = attn.attention_apply(
            sa.params(), self.norm1(h), positions, rope_theta=0.0, causal=True, dtype=sa.dtype,
            q_chunk=sa.q_chunk, kv_chunk=sa.kv_chunk, skip_masked_chunks=self.skip_masked_chunks)
        k, v = self.cross_kv(enc_out)
        return self._cross(h + a, k, v, q_chunk=sa.q_chunk, kv_chunk=sa.kv_chunk)

    def decode(self, h, kv: attn.KVCache, cross_k, cross_v, cur_len: int):
        a, _ = self.self_attn.decode(self.norm1(h), kv, cur_len)
        # The reference's decode attends the frames with the default chunks.
        return self._cross(h + a, cross_k, cross_v)


class EncDec(ParamModule):
    """Tied embedding, ``enc_blocks``, ``dec_blocks``, ``enc_norm``,
    ``final_norm``: the reference's tree, one module a stacked layer."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__({})
        self.cfg = cfg
        self.embed = Embedding(generator, cfg.padded_vocab, cfg.d_model,
                               dtype=cfg.compute_dtype, device=device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, generator, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, generator, device)
                                        for _ in range(cfg.num_layers))
        self.enc_norm = LayerNorm(cfg.d_model, device=device)
        self.final_norm = LayerNorm(cfg.d_model, device=device)

    def hold_compute_dtype(self) -> "EncDec":
        """Hold the weights used in ``cfg.compute_dtype`` in it (`hold_in`)."""
        return hold_in(self, self.cfg.compute_dtype)

    def _positions(self, length: int, device) -> torch.Tensor:
        return _positions_on(length, self.cfg.d_model, self.cfg.compute_dtype, str(device))

    def encode(self, frames):
        """frames: (B, enc_seq, d) stub conv output -> encoded (B, enc_seq, d)."""
        B, S, _ = frames.shape
        x = frames.to(self.cfg.compute_dtype) + self._positions(S, frames.device)
        x = shard_constraint(x, ("batch", "seq", None))
        positions = torch.arange(S, dtype=torch.int32, device=frames.device).expand(B, S)
        for blk in self.enc_blocks:
            # The reference checkpoints its encoder and decoder blocks whole
            # whatever remat_policy says.
            x = remat_call(self.cfg.remat, "full", blk, x, positions)
        return self.enc_norm(x)

    def forward(self, tokens, frames):
        """Teacher-forced forward: returns (logits, aux=0)."""
        enc_out = self.encode(frames)
        B, S = tokens.shape
        x = self.embed(tokens) + self._positions(S, tokens.device)
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        for blk in self.dec_blocks:
            x = remat_call(self.cfg.remat, "full", blk, x, positions, enc_out)
        return self.embed.logits(self.final_norm(x)), torch.zeros((), dtype=f32, device=x.device)

    def init_decode_caches(self, frames, max_len: int) -> "EncDecCaches":
        enc_out = self.encode(frames)
        cross = [blk.cross_kv(enc_out) for blk in self.dec_blocks]
        cfg = self.cfg
        shape = (cfg.num_layers, frames.shape[0], max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        kw = dict(dtype=cfg.compute_dtype, device=frames.device)
        return EncDecCaches(attn.KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw)),
                            torch.stack([k for k, _ in cross]),
                            torch.stack([v for _, v in cross]))

    def decode(self, token, caches: "EncDecCaches", cur_len: int):
        table = self._positions(self.cfg.max_target_length, token.device)
        at = min(max(int(cur_len), 0), table.shape[0] - 1)  # the reference's dynamic slice clamps
        x = self.embed(token) + table[at:at + 1]
        for l, blk in enumerate(self.dec_blocks):
            kv = attn.KVCache(caches.self_kv.k[l], caches.self_kv.v[l])
            x = blk.decode(x, kv, caches.cross_k[l], caches.cross_v[l], cur_len)
        return self.embed.logits(self.final_norm(x)), caches


class EncDecCaches(NamedTuple):
    self_kv: attn.KVCache  # stacked (L, B, max_len, K, D)
    cross_k: torch.Tensor  # (L, B, enc_seq, H, hd)
    cross_v: torch.Tensor


def _model(params: EncDec, cfg: ModelConfig) -> EncDec:
    """``params``, after checking it was built for ``cfg`` (the serving
    length ``max_target_length`` aside)."""
    if dataclasses.replace(cfg, max_target_length=params.cfg.max_target_length) != params.cfg:
        raise ValueError(f"the EncDec was built for {params.cfg.name} with other settings "
                         f"than the config given")
    return params


# --- the reference's functions ---------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> EncDec:
    """An `EncDec` for ``cfg``: weights drawn from ``generator``, placed on ``device``."""
    return EncDec(cfg, generator, device=torch.device(device))


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _model(params, cfg).encode(frames)


def apply(params: EncDec, tokens: torch.Tensor, frames: torch.Tensor, cfg: ModelConfig):
    """Teacher-forced training forward: returns (logits, aux=0)."""
    return _model(params, cfg)(tokens, frames)


def init_decode_caches(params: EncDec, frames: torch.Tensor, cfg: ModelConfig,
                       max_len: int) -> EncDecCaches:
    """Runs the encoder once and precomputes every layer's cross-attention K/V."""
    return _model(params, cfg).init_decode_caches(frames, max_len)


def decode_step(params: EncDec, token: torch.Tensor, caches: EncDecCaches, cur_len: int,
                cfg: ModelConfig):
    """One-token step; positions from a ``cfg.max_target_length`` table.
    Returns (logits (B, 1, vocab), caches)."""
    return _model(params, cfg).decode(token, caches, cur_len)
