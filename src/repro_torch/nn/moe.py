"""Mixture-of-Experts FFN with sort-based capacity dispatch (DeepSeek-V3 /
Llama-4 style).

Routing supports softmax-top-k (Switch/Mixtral style) and DeepSeek-V3's
sigmoid scoring with a selection-only bias, normalized top-k and routed
scaling.  Dispatch is the reference's sort-based fixed capacity: each
expert takes at most ``C = max(8, int(T*k*cf) // E)`` of the ``T*k``
(token, expert) assignments, in the order of a stable sort by expert;
the rest go to a spare row and are dropped.  A grouped gated GEMM runs the
experts and the weighted outputs are combined per token.  Shared experts
(an always-on dense branch) are applied outside the dispatch.  Aux
outputs: load-balance loss and router z-loss.

Order and determinism, where the reference's semantics fix them:

* top-k breaks ties toward the lower expert index (``jax.lax.top_k``):
  a stable descending sort, not ``torch.topk``, which promises no order;
* the assignments are sorted by expert with a stable sort
  (``jnp.argsort`` is stable), so the same pairs pass capacity;
* a token's k weighted outputs are added in the order the reference's
  scatter-add adds them (ascending expert), one add at a time in the
  compute dtype, never with atomics: served tokens do not vary from run
  to run on the card.

The reference's expert-parallel paths (``shard_map`` over a "model" mesh
axis, ``combine="psum"|"gather"``) compute the same function as the local
path and reduce to it on one device; the port runs the local path (its
``shard_map`` belongs with the dry run's meshes, ROADMAP item 5).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import MLP, mlp_apply
from repro_torch.nn.param import Param, ParamModule, fan_in_init

f32 = torch.float32


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


def moe_init(generator, d_model: int, cfg: MoEConfig, mlp_kind: str = "swiglu", device=None):
    """The reference's parameter tree less the shared expert, which `MoE`
    holds as an `MLP` module (the reference's ``"shared"`` subtree)."""
    E, F_ = cfg.num_experts, cfg.d_ff_expert

    def draw(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, device=device)

    p = {
        "router": Param(draw((d_model, E), d_model), ("embed", None)),
        "wi": Param(draw((E, d_model, F_), d_model), ("experts", "embed", "expert_mlp")),
        "wg": Param(draw((E, d_model, F_), d_model), ("experts", "embed", "expert_mlp")),
        "wo": Param(draw((E, F_, d_model), F_), ("experts", "expert_mlp", "embed")),
    }
    if cfg.routing == "sigmoid":
        p["router_bias"] = Param(torch.zeros((E,), dtype=f32, device=device or generator.device),
                                 (None,))
    return p


def topk_lower_index_first(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    toward the lower index (a stable descending sort)."""
    values, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _route(p, x2d, cfg: MoEConfig):
    """Router scores -> (weights (T,k), ids (T,k), aux_losses)."""
    logits = torch.matmul(x2d.to(f32), p["router"].to(f32))
    if cfg.routing == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"].to(f32)  # bias affects selection only
        _, ids = topk_lower_index_first(sel, cfg.top_k)
        w = torch.gather(scores, -1, ids)
        if cfg.norm_topk:
            w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
        w = w * cfg.routed_scaling
        probs = scores / torch.clamp(torch.sum(scores, -1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = topk_lower_index_first(probs, cfg.top_k)
        if cfg.norm_topk:
            w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    # Load-balance loss (Switch-style): E * sum_e f_e * P_e.
    T, E = x2d.shape[0], cfg.num_experts
    assign = torch.zeros((T, E), dtype=f32, device=x2d.device).scatter_(1, ids, 1.0)
    f_e = torch.mean(assign, dim=0)
    p_e = torch.mean(probs, dim=0)
    lb_loss = E * torch.sum(f_e * p_e) * cfg.aux_loss_weight
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.z_loss_weight
    return w, ids, lb_loss + z_loss


def capacity(T: int, cfg: MoEConfig) -> int:
    """Slots an expert takes for ``T`` tokens: ``max(8, int(T*k*cf) // E)``."""
    return max(8, int(T * cfg.top_k * cfg.capacity_factor) // cfg.num_experts)


def _assign(ids, T: int, cfg: MoEConfig):
    """Sort-based fixed-capacity bookkeeping for ids (T, k).  Returns
    ``(order, dest_sorted, dest, C)``: the stable sort of the flattened
    assignments by expert, each sorted assignment's row of the expert
    buffer, the same rows in the order of the flattened ``ids``, and the
    capacity.  A row is ``E*C`` (the spare row) where the expert was full."""
    k, E = cfg.top_k, cfg.num_experts
    C = capacity(T, cfg)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=ids.device) - start[se]
    dest_sorted = torch.where(pos < C, se * C + pos, torch.full_like(se, E * C))
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    return order, dest_sorted, dest, C


def _dispatch(x2d, ids, cfg: MoEConfig, dtype):
    """The experts' input buffer: ``(buf (E*C, d), dest (T*k,), C)``."""
    T, d = x2d.shape
    order, dest_sorted, dest, C = _assign(ids, T, cfg)
    buf = torch.zeros((cfg.num_experts * C + 1, d), dtype=dtype, device=x2d.device)
    buf[dest_sorted] = x2d.to(dtype)[order // cfg.top_k]  # sorted assignment -> its token
    return buf[:-1], dest, C


def dropped_pairs(p, x2d, cfg: MoEConfig) -> torch.Tensor:
    """The (token, expert) assignments that capacity drops for tokens
    ``x2d`` (T, d): an (n, 2) int64 tensor in (token, expert) order."""
    _, ids, _ = _route(p, x2d, cfg)
    T = x2d.shape[0]
    _, _, dest, C = _assign(ids, T, cfg)
    t, j = torch.nonzero((dest == cfg.num_experts * C).reshape(T, cfg.top_k), as_tuple=True)
    pairs = torch.stack([t, ids[t, j]], 1)
    return pairs[torch.argsort(pairs[:, 0] * cfg.num_experts + pairs[:, 1])]


def _expert_ffn(h, wi, wg, wo, E: int, C: int, dtype):
    """Grouped gated GEMM over the experts: h (E*C, d) -> (E*C, d)."""
    d = h.shape[-1]
    h = h.reshape(E, C, d)
    g = torch.bmm(h, wg.to(dtype))
    up = torch.bmm(h, wi.to(dtype))
    act = F.silu(g) * up
    return torch.bmm(act, wo.to(dtype)).reshape(E * C, d)


def _dispatch_compute_combine(x2d, w, ids, wi, wg, wo, cfg: MoEConfig, dtype):
    """Fixed-capacity gather -> grouped GEMM -> weighted combine.

    The reference scatter-adds each sorted assignment's weighted output
    into its token's row of zeros; a token's k outputs are therefore added
    in ascending expert order.  Here they are gathered to (T, k, d) in
    that order and added one at a time: the same sums, no atomics."""
    T, d = x2d.shape
    buf, dest, C = _dispatch(x2d, ids, cfg, dtype)
    out = _expert_ffn(buf, wi, wg, wo, cfg.num_experts, C, dtype)
    out_flat = torch.cat([out, torch.zeros((1, d), dtype=dtype, device=out.device)])
    contrib = (out_flat[dest] * w.reshape(-1, 1).to(dtype)).reshape(T, cfg.top_k, d)
    by_expert = torch.argsort(ids, dim=1, stable=True)
    contrib = torch.gather(contrib, 1, by_expert[:, :, None].expand(T, cfg.top_k, d))
    y = torch.zeros((T, d), dtype=dtype, device=out.device)
    for j in range(cfg.top_k):
        y = y + contrib[:, j]
    return y


def moe_apply(p, x, cfg: MoEConfig, *, mlp_kind: str = "swiglu", dtype=torch.bfloat16):
    """x (B, S, d) -> (y, aux_loss).  ``p`` is the reference's tree, the
    shared expert under ``"shared"`` where the config has one."""
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    w, ids, aux = _route(p, x2d, cfg)
    y = _dispatch_compute_combine(x2d, w, ids, p["wi"], p["wg"], p["wo"], cfg, dtype)
    y = y.reshape(x.shape)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, mlp_kind, dtype)
    return y, aux


class MoE(ParamModule):
    """``forward`` is `moe_apply`; the shared expert is the `MLP` module
    ``shared``.  The router's weights are used in float32 whatever the
    compute dtype (`basic.hold_in` leaves them so)."""

    FLOAT32_PARAMS = ("router", "router_bias")

    def __init__(self, generator, d_model: int, cfg: MoEConfig, mlp_kind: str = "swiglu", *,
                 dtype=torch.bfloat16, device=None):
        super().__init__(moe_init(generator, d_model, cfg, mlp_kind, device=device))
        self.cfg, self.mlp_kind, self.dtype = cfg, mlp_kind, dtype
        if cfg.num_shared_experts:
            self.shared = MLP(generator, d_model, cfg.d_ff_expert * cfg.num_shared_experts,
                              mlp_kind, dtype=dtype, device=device)

    def tree(self) -> dict:
        p = self.params()
        if self.cfg.num_shared_experts:
            p["shared"] = self.shared.params()
        return p

    def forward(self, x):
        return moe_apply(self.tree(), x, self.cfg, mlp_kind=self.mlp_kind, dtype=self.dtype)
