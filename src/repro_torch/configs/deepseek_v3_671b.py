"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437; hf].

61L d_model=7168, MLA (q_lora 1536, kv_lora 512, nope 128 + rope 64, v 128,
128 heads), first 3 layers dense (d_ff 18432), remaining 58 MoE: 256 routed
experts (d_ff_expert=2048) top-8 with sigmoid scoring + normalized top-k +
routed scaling 2.5, plus 1 shared expert; vocab=129280.

Deviations noted in DESIGN.md: the MTP (multi-token-prediction) auxiliary
head is not implemented; the aux-free bias-update balancing is represented
by the selection-bias term (static during a step, updated by the trainer
between steps in a full deployment).
"""

import dataclasses

from repro_torch.configs.base import MLASpec, ModelConfig
from repro_torch.nn.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # dense head layers; experts use d_ff_expert below
    vocab_size=129280,
    attn_kind="mla",
    mla=MLASpec(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        routing="sigmoid",
        norm_topk=True,
        routed_scaling=2.5,
        capacity_factor=1.25,
    ),
    moe_layer_start=3,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        mla=MLASpec(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        ),
        moe=dataclasses.replace(
            CONFIG.moe, num_experts=8, top_k=2, d_ff_expert=64, capacity_factor=2.0
        ),
        moe_layer_start=1,
        q_chunk=16,
        kv_chunk=16,
    )

