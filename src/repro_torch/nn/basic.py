"""Basic layers: linear, norms, embeddings, rotary position embedding, MLP.

Each layer is an ``(init, apply)`` pair over a dict of Params, as in the
reference, and an ``nn.Module`` (`ParamModule`) that holds the parameters
and calls the apply function.  Compute dtype is the caller's (bf16 in the
production configs); parameters are float32 and norms compute in float32.
A parameter used in the compute dtype may be held in it (`hold_in`): one
cast is the same as a cast at every use.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32


def _zeros(shape, device):
    return torch.zeros(shape, dtype=f32, device=device)


def _ones(shape, device):
    return torch.ones(shape, dtype=f32, device=device)


# --- linear -------------------------------------------------------------------


def linear_init(
    generator,
    in_dim: int,
    out_dim: int,
    *,
    logical: Tuple[Optional[str], Optional[str]],
    bias: bool = False,
    bias_logical: Tuple[Optional[str], ...] | None = None,
    device=None,
):
    p = {"kernel": Param(fan_in_init(generator, (in_dim, out_dim), in_dim, device=device), logical)}
    if bias:
        p["bias"] = Param(_zeros((out_dim,), device or generator.device),
                          bias_logical or (logical[1],))
    return p


def linear_apply(p, x, dtype=torch.bfloat16):
    y = torch.matmul(x.to(dtype), p["kernel"].to(dtype))
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


# --- norms ---------------------------------------------------------------------


def rmsnorm_init(dim: int, logical=("embed",), device=None):
    return {"scale": Param(_ones((dim,), device), logical)}


def rmsnorm_apply(p, x, eps: float = 1e-6, zero_centered: bool = False):
    xf = x.to(f32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p["scale"].to(f32)
    if zero_centered:  # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


def layernorm_init(dim: int, logical=("embed",), device=None):
    return {"scale": Param(_ones((dim,), device), logical),
            "bias": Param(_zeros((dim,), device), logical)}


def layernorm_apply(p, x, eps: float = 1e-5):
    xf = x.to(f32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(f32) + p["bias"].to(f32)).to(x.dtype)


# --- embedding ------------------------------------------------------------------


def embedding_init(generator, vocab: int, dim: int, scale_by_dim: bool = False, device=None):
    std = 1.0 if scale_by_dim else 0.02
    return {"table": Param(fan_in_init(generator, (vocab, dim), int(1 / (std**2)), device=device),
                           ("vocab", "embed"))}


def embedding_lookup(p, tokens, dtype=torch.bfloat16):
    # Rows first, then the cast: the same values as casting the whole table.
    return p["table"][tokens.long()].to(dtype)


def embedding_logits(p, x, dtype=torch.bfloat16):
    """Tied decode head: (..., embed) @ (embed, vocab)."""
    return torch.matmul(x.to(dtype), p["table"].to(dtype).t())


# --- rotary ----------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 1e4) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_frequencies_on(head_dim: int, theta: float, device: str) -> torch.Tensor:
    return torch.tensor(rope_frequencies(head_dim, theta), dtype=f32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    # Made once a device (read-only): on the card, no copy and no host sync a call.
    freqs = _rope_frequencies_on(hd, float(theta), str(x.device))
    angles = positions[..., :, None].to(f32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- gated MLP --------------------------------------------------------------------

MLP_KINDS = ("swiglu", "geglu", "gelu", "relu_sq")


def mlp_init(generator, d_model: int, d_ff: int, kind: str = "swiglu", device=None):
    p = {"wi": Param(fan_in_init(generator, (d_model, d_ff), d_model, device=device),
                     ("embed", "mlp"))}
    if kind in ("swiglu", "geglu"):
        p["wg"] = Param(fan_in_init(generator, (d_model, d_ff), d_model, device=device),
                        ("embed", "mlp"))
    p["wo"] = Param(fan_in_init(generator, (d_ff, d_model), d_ff, device=device), ("mlp", "embed"))
    return p


def mlp_apply(p, x, kind: str = "swiglu", dtype=torch.bfloat16):
    xd = x.to(dtype)
    h = torch.matmul(xd, p["wi"].to(dtype))
    if kind == "swiglu":
        g = torch.matmul(xd, p["wg"].to(dtype))
        h = F.silu(g) * h
    elif kind == "geglu":
        g = torch.matmul(xd, p["wg"].to(dtype))
        h = F.gelu(g, approximate="tanh") * h
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "relu_sq":  # rwkv channel-mix style
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return torch.matmul(h, p["wo"].to(dtype))


# --- modules ------------------------------------------------------------------------


class RMSNorm(ParamModule):
    """Float32 scale, float32 compute (never held in the compute dtype)."""

    def __init__(self, dim: int, *, eps: float = 1e-6, zero_centered: bool = False,
                 logical=("embed",), device=None):
        super().__init__(rmsnorm_init(dim, logical, device=device))
        self.eps, self.zero_centered = eps, zero_centered

    def forward(self, x):
        return rmsnorm_apply(self.params(), x, self.eps, self.zero_centered)


class LayerNorm(ParamModule):
    """Float32 scale and bias, float32 compute (never held in the compute dtype)."""

    def __init__(self, dim: int, *, eps: float = 1e-5, logical=("embed",), device=None):
        super().__init__(layernorm_init(dim, logical, device=device))
        self.eps = eps

    def forward(self, x):
        return layernorm_apply(self.params(), x, self.eps)


class Embedding(ParamModule):
    """Token lookup; ``logits`` is the tied head."""

    def __init__(self, generator, vocab: int, dim: int, *, dtype=torch.bfloat16, device=None):
        super().__init__(embedding_init(generator, vocab, dim, device=device))
        self.dtype = dtype

    def forward(self, tokens):
        return embedding_lookup(self.params(), tokens, self.dtype)

    def logits(self, x):
        return embedding_logits(self.params(), x, self.dtype)


class MLP(ParamModule):
    def __init__(self, generator, d_model: int, d_ff: int, kind: str = "swiglu", *,
                 dtype=torch.bfloat16, device=None):
        if kind not in MLP_KINDS:
            raise ValueError(f"unknown mlp kind {kind!r}; available: {MLP_KINDS}")
        super().__init__(mlp_init(generator, d_model, d_ff, kind, device=device))
        self.kind, self.dtype = kind, dtype

    def forward(self, x):
        return mlp_apply(self.params(), x, self.kind, self.dtype)


#: Modules whose parameters are used in float32 whatever the compute dtype.
FLOAT32_MODULES = (RMSNorm, LayerNorm)


def hold_in(module: torch.nn.Module, dtype) -> torch.nn.Module:
    """Hold every parameter that is used in the compute dtype in ``dtype``,
    one at a time; returns ``module``.  Norm parameters stay float32, and
    so do those a module names in ``FLOAT32_PARAMS`` (used in float32
    whatever the compute dtype: a router, an SSM's decay)."""
    for mod in module.modules():
        if isinstance(mod, FLOAT32_MODULES):
            continue
        keep = getattr(mod, "FLOAT32_PARAMS", ())
        for name, p in mod.named_parameters(recurse=False):
            if name not in keep:
                p.data = p.data.to(dtype)
    return module
