"""qwen2.5-14b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-14B; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, head_dim=128,
rope_theta=1e6, untied embeddings, RMSNorm + SwiGLU.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        q_chunk=16,
        kv_chunk=16,
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape)
