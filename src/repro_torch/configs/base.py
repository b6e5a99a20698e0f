"""Model / run configuration dataclasses shared by all architectures.

Every architecture in ``repro_torch.configs.<id>`` exports:
  CONFIG  — the exact published configuration (full scale),
  smoke_config() — a reduced same-family config for CPU tests.

Input shapes: train_4k, prefill_32k, decode_32k, long_500k.
``decode_*``/``long_*`` run ``serve_step`` (one token + KV/state cache);
inapplicable combinations raise SkipCell with a reason.  The dry run's
abstract inputs per shape (the reference's ``input_specs``) come with the
dry run (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn.mamba2 import Mamba2Config
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.rwkv6 import RWKV6Config


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # Block structure.
    attn_kind: str = "gqa"  # gqa | mla | none
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    zero_centered_norm: bool = False  # gemma (1 + scale)
    parallel_block: bool = False  # command-r: attn and mlp in parallel
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    embed_multiplier: float = 1.0  # gemma: sqrt(d_model)

    # MoE.
    moe: Optional[MoEConfig] = None
    moe_layer_start: int = 0  # deepseek-v3: first 3 layers dense

    # MLA.
    mla: Optional[MLASpec] = None

    # SSM / RWKV / hybrid.
    mamba: Optional[Mamba2Config] = None
    rwkv: Optional[RWKV6Config] = None
    hybrid_attn_every: int = 0  # zamba2: shared attn block every k mamba layers

    # Encoder-decoder (whisper).
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500  # conv-frontend output frames (stub provides these)

    # VLM (internvl): stub provides pre-projected patch embeddings.
    vlm_patches: int = 0

    # Execution knobs.
    vocab_pad_multiple: int = 128  # pad vocab so the "vocab" axis shards evenly
    dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    skip_masked_chunks: bool = False
    attn_exp: str = "exact"  # "fast" = paper's bit-trick exp inside softmax
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"  # full=save nothing | dots=save matmul outputs
    max_target_length: int = 4096

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a shardable multiple (standard production trick;
        extra classes participate in softmax but are never labelled)."""
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, L = self.d_model, self.num_layers
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.rwkv is not None:
            per = 5 * d * d + 2 * d * self.d_ff + d * d
            return total + L * per
        if self.mamba is not None:
            m = self.mamba
            per_m = d * (2 * m.d_inner + 2 * m.n_groups * m.d_state + m.num_heads) + m.d_inner * d
            n_attn = L // self.hybrid_attn_every if self.hybrid_attn_every else 0
            hd = self.resolved_head_dim
            per_a = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d + 3 * d * self.d_ff
            return total + L * per_m + (per_a if n_attn else 0)
        hd = self.resolved_head_dim
        per_attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.mla is not None:
            s = self.mla
            per_attn = (
                d * s.q_lora_rank
                + s.q_lora_rank * self.num_heads * (s.qk_nope_head_dim + s.qk_rope_head_dim)
                + d * (s.kv_lora_rank + s.qk_rope_head_dim)
                + s.kv_lora_rank * self.num_heads * (s.qk_nope_head_dim + s.v_head_dim)
                + self.num_heads * s.v_head_dim * d
            )
        dense_mlp = 3 * d * self.d_ff if self.mlp_kind in ("swiglu", "geglu") else 2 * d * self.d_ff
        if self.moe is not None:
            n_moe = L - self.moe_layer_start
            per_moe = d * self.moe.num_experts + 3 * self.moe.num_experts * d * self.moe.d_ff_expert
            if self.moe.num_shared_experts:
                per_moe += 3 * d * self.moe.d_ff_expert * self.moe.num_shared_experts
            return total + L * per_attn + self.moe_layer_start * dense_mlp + n_moe * per_moe
        return total + L * (per_attn + dense_mlp)

    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        full = self.num_params()
        n_moe = L - self.moe_layer_start
        all_experts = 3 * self.moe.num_experts * d * self.moe.d_ff_expert
        active = 3 * self.moe.top_k * d * self.moe.d_ff_expert
        return full - n_moe * (all_experts - active)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


class SkipCell(Exception):
    """Raised when an (arch x shape) cell is inapplicable; the dry run
    records the reason instead of compiling."""
