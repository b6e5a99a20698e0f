"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified].

4 encoder + 4 decoder layers, d_model=384, 6H (kv=6), d_ff=1536,
vocab=51865, LayerNorm + GELU, tied decoder embeddings.  The conv1d
frontend is a STUB: the dry run's inputs provide the 1500 post-conv frame
embeddings.  Positions are sinusoidal on both sides (the learned decoder
positions are replaced so the 32k decode cell is well-defined; Whisper's
design length is 448 — noted in DESIGN.md).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm_kind="layernorm",
    mlp_kind="gelu",
    tie_embeddings=True,
    encdec=True,
    enc_layers=4,
    enc_seq=1500,
    rope_theta=0.0,  # sinusoidal absolute positions instead
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        enc_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        enc_seq=16,
        q_chunk=16,
        kv_chunk=16,
        max_target_length=64,
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape)
