"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf].

18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=256000, zero-centered
RMSNorm (1+scale), embeddings tied and scaled by sqrt(d_model).
The single KV head replicates across the model axis (kv=1 < 16 shards) —
exercised deliberately by the sharding divisibility fallback.
"""

import dataclasses
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_kind="geglu",
    zero_centered_norm=True,
    tie_embeddings=True,
    embed_multiplier=math.sqrt(2048.0),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        embed_multiplier=8.0,
        q_chunk=16,
        kv_chunk=16,
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape)
