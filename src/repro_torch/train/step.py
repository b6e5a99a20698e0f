"""The train step: loss, microbatch gradient accumulation, AdamW,
and the int8 error-feedback gradient compression.

The model's parameters stay float32 (each op casts them to the compute
dtype, as the reference's layers do); gradients come from
``torch.autograd.grad`` over them, and the step updates the parameters
and the optimizer state in place (the reference donates the state).

* Microbatching: ``grad_accum > 1`` takes contiguous microbatch slices of
  the batch, accumulates float32 gradients in microbatch order, then
  divides by the count (the reference's ``lax.scan``).  As in the
  reference, the metrics then carry no ``ce_loss`` / ``aux_loss``.
* Cross-pod gradient compression (``grad_compression="int8_ef"``): int8
  quantization with error-feedback residuals (carried in the
  `TrainState`), reduced over the mesh's ``"pod"`` axis.  A mesh with no
  ``"pod"`` axis is refused (ValueError); on one device the pod axis has
  size 1 and the reduction is the identity.  The cross-pod sync over
  several devices is not ported yet (NotImplementedError).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder, encdec
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update, init_opt_state
from repro_torch.sharding import current_ctx

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1
    z_loss_weight: float = 1e-4
    grad_compression: str = "none"  # none | int8_ef


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    params: Any  # the model (`models.decoder.Decoder` or `models.encdec.EncDec`)
    opt: OptState  # m, v: {parameter name: tensor}
    ef_residual: Any  # {parameter name: float32 error-feedback buffer}, or None


def named_params(state_or_model) -> dict:
    """``{name: parameter}`` of a `TrainState`'s model, or of a model."""
    model = state_or_model.params if isinstance(state_or_model, TrainState) else state_or_model
    return dict(model.named_parameters())


def init_train_state(params, tc: TrainConfig) -> TrainState:
    """Step 0 for the model ``params``, whose parameters are asked for
    gradients here (they are made without)."""
    params.requires_grad_(True)
    named = named_params(params)
    dev = next(iter(named.values())).device
    ef = None
    if tc.grad_compression == "int8_ef":
        ef = {n: torch.zeros(p.shape, dtype=f32, device=dev) for n, p in named.items()}
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      init_opt_state(named, tc.optimizer.state_torch_dtype), ef)


def cross_entropy_loss(logits, labels, z_loss_weight: float = 1e-4):
    """Token-mean CE with z-loss; logits f32-upcast. labels -100 = ignore."""
    logits = logits.to(f32)
    mask = (labels >= 0).to(f32)
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll) / denom
    zl = torch.sum(torch.square(logz) * mask) / denom * z_loss_weight
    return loss + zl, loss


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    def loss_fn(params, batch):
        if cfg.encdec:
            logits, aux = encdec.apply(params, batch["tokens"], batch["frames"], cfg)
        else:
            logits, aux = decoder.apply(params, batch["tokens"], cfg,
                                        visual_embeds=batch.get("visual_embeds"))
            if cfg.vlm_patches:
                logits = logits[:, cfg.vlm_patches:]
        total, ce = cross_entropy_loss(logits, batch["labels"], tc.z_loss_weight)
        return total + aux, {"ce_loss": ce.detach(), "aux_loss": aux.detach()}

    return loss_fn


def _quantize_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _pod_compressed_allreduce(grads: dict, residual: dict):
    """int8 + error-feedback all-reduce over the ``"pod"`` axis, one leaf
    at a time: ``g + r`` quantized to int8 at ``max|g + r| / 127``, the
    dequantized value reduced, the rounding error carried to the next step.
    Returns ``(synced, new_residual)``.  On one device the pod axis has
    size 1: the mean over it is the dequantized value itself."""
    synced, new_res = {}, {}
    for name, g in grads.items():
        g = g.to(f32) + residual[name]
        scale = torch.maximum(torch.max(torch.abs(g)), torch.tensor(1e-8, dtype=f32,
                                                                   device=g.device)) / 127.0
        deq = _quantize_int8(g, scale).to(f32) * scale
        new_res[name] = g - deq
        synced[name] = deq
    return synced, new_res


def _check_int8_ef():
    ctx = current_ctx()
    pods = None if ctx is None else ctx.mesh_shape.get("pod")
    if pods is None:
        raise ValueError("grad_compression='int8_ef' requires a multi-pod mesh: the sharding "
                         "context has no 'pod' axis")
    if pods != 1:
        raise NotImplementedError(f"grad_compression='int8_ef' over {pods} pods: the cross-pod "
                                  f"sync needs several devices, which the port does not drive yet")


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    parameters and the optimizer state are updated in place; the returned
    state carries the next step.  ``batch`` is a dict of tensors on the
    parameters' device; the metrics are float32 scalars there."""
    loss_fn = make_loss_fn(cfg, tc)

    def grad_fn(model, named, batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), grads)}
        return loss.detach(), metrics, grads

    def compute_grads(model, named, batch):
        if tc.grad_accum <= 1:
            return grad_fn(model, named, batch)
        n = tc.grad_accum
        acc = {name: torch.zeros(p.shape, dtype=f32, device=p.device) for name, p in named.items()}
        loss_sum = torch.zeros((), dtype=f32, device=next(iter(named.values())).device)
        for i in range(n):
            mb = {k: x.reshape((n, -1) + tuple(x.shape[1:]))[i] for k, x in batch.items()}
            loss, _, grads = grad_fn(model, named, mb)
            for name in list(grads):
                acc[name].add_(grads.pop(name).to(f32))
            loss_sum = loss_sum + loss
        for g in acc.values():
            g.div_(n)
        return loss_sum / n, {}, acc

    def train_step(state: TrainState, batch):
        if tc.grad_compression == "int8_ef":
            _check_int8_ef()
        named = named_params(state)
        loss, metrics, grads = compute_grads(state.params, named, batch)
        ef = state.ef_residual
        if tc.grad_compression == "int8_ef":
            grads, ef = _pod_compressed_allreduce(grads, ef)
        _, opt, opt_metrics = adamw_update(tc.optimizer, named, grads, state.opt, state.step)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(state.step + 1, state.params, opt, ef), metrics

    return train_step
