"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, head_dim=128,
parallel attention+FFN block (single residual), LayerNorm, tied
embeddings, rope_theta=8e6.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    norm_kind="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8e6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        q_chunk=16,
        kv_chunk=16,
    )

