"""rwkv6-1.6b [ssm] — Finch, data-dependent decay [arXiv:2404.05892;
unverified].

24L d_model=2048 (attention-free; 32 heads x 64) d_ff=7168 vocab=65536,
LayerNorm.  Runs long_500k: the WKV state is a fixed (H, 64, 64) matrix per
layer, so decode cost is independent of the 524288-token context.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.rwkv6 import RWKV6Config

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attn_kind="none",
    norm_kind="layernorm",
    rwkv=RWKV6Config(d_model=2048, d_ff=7168, head_dim=64, chunk=16),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        rwkv=RWKV6Config(d_model=64, d_ff=128, head_dim=16, lora_mix=8, lora_decay=16, chunk=8),
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape, allow_long=True)
