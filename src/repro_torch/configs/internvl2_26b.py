"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

Backbone (InternLM2-20b): 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553, rope_theta=1e6.  The InternViT-6B frontend is a STUB: the
caller provides 256 pre-projected patch embeddings (B, 256, d_model),
which the decoder prepends to the text sequence (the pixel-shuffle + MLP
projector output in the real pipeline).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1e6,
    vlm_patches=256,
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
        vlm_patches=8,
        q_chunk=16,
        kv_chunk=16,
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape)
