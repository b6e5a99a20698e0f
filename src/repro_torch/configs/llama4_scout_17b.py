"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) vocab=202048; every layer MoE with 16
routed experts (d_ff_expert=8192) top-1 plus one always-on shared expert
(8192).  Text backbone only (early-fusion multimodality enters as tokens).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.moe import MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        routing="softmax",
        capacity_factor=1.5,
    ),
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
        moe=dataclasses.replace(CONFIG.moe, num_experts=4, d_ff_expert=96, capacity_factor=2.0),
        q_chunk=16,
        kv_chunk=16,
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape)
