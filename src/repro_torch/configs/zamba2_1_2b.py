"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

38L d_model=2048, Mamba2 (d_inner=4096, headdim=64, ssm_state=64) with one
SHARED full-attention block (32H, kv=32, MHA) invoked every 6 mamba layers;
d_ff=8192 for the shared block's MLP; vocab=32000.

Deviation noted in DESIGN.md: Zamba2's shared block consumes
concat(hidden, original embedding) with per-invocation LoRA deltas; here
the shared block takes the hidden state directly (identical parameter
sharing pattern and comms, simpler data flow).

Runs long_500k: decode state is O(1) in context for the mamba backbone;
the shared blocks keep a standard KV cache (sharded over data on the
sequence axis for the batch=1 cell).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.mamba2 import Mamba2Config

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mamba=Mamba2Config(d_model=2048, d_state=64, head_dim=64, expand=2, chunk=64),
    hybrid_attn_every=6,
    scan_layers=False,  # heterogeneous pattern (shared block interleave)
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        mamba=Mamba2Config(d_model=64, d_state=16, head_dim=16, chunk=8),
        hybrid_attn_every=2,
        q_chunk=16,
        kv_chunk=16,
    )


def input_specs(shape, cfg=None):
    from repro_torch.configs import common

    return common.input_specs(cfg or CONFIG, shape, allow_long=True)
