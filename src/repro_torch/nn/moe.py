"""Mixture-of-Experts FFN (DeepSeek-V3 / Llama-4 style): its configuration.

The layer itself (routing, capacity dispatch, shared experts, the
load-balance loss) is the next LM slice of the port (ROADMAP); a decoder
config with ``moe`` is refused by `models.decoder` until then.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    routing: str = "softmax"  # "softmax" | "sigmoid" (deepseek-v3)
    routed_scaling: float = 1.0
    norm_topk: bool = False
    aux_loss_weight: float = 0.001
    z_loss_weight: float = 1e-4
    # Expert-parallel combine: "psum" all-reduces the full (T, d) partial
    # output (2x T*d ring bytes); "gather" all-gathers only the compact
    # per-expert outputs (k*cf*T*d bytes) and combines locally — cheaper
    # whenever top_k * capacity_factor < 2 (e.g. llama4's top-1).
    combine: str = "psum"
