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
  `TrainState`), reduced over the mesh's ``"pod"`` axis.  A context with
  no ``"pod"`` axis is refused (ValueError).  Over a ``DeviceMesh`` the
  sync runs through ``shard_map`` with the parameters' specs: each device
  quantizes its own gradient shard at ``max(|g + r|, 1e-8) / 127``, keeps
  ``g + r - deq`` as its residual, and the dequantized values are summed
  over ``"pod"`` and divided by the pod count.  A mesh shape alone with one
  pod runs the quantizer and the identity sync; with several pods it has
  no devices to sum over and is refused (ValueError).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder, encdec
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update, init_opt_state
from repro_torch.sharding import (P, axis_index, current_ctx, pmax, psum, shard_constraint,
                                  shard_map)
from repro_torch.sharding.ctx import axis_size, is_dtensor, replicate_dims

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
        ef = {n: torch.zeros_like(p, dtype=f32) for n, p in named.items()}
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      init_opt_state(named, tc.optimizer.state_torch_dtype), ef)


def _logz_and_label_logit(logits, labels):
    """Over a mesh: ``(logsumexp(logits), logits[label])`` per token through
    ``shard_map``, the vocab dim left sharded: each device reduces its
    vocab block (max, sum of exps, the label's logit where it holds it)
    and the blocks are combined over the vocab's mesh axis.  A gather or
    a logsumexp over a sharded dim would gather the whole vocab first."""
    ctx = current_ctx()
    mesh = ctx.mesh
    spec = ctx.spec(("batch", "seq", "vocab"), tuple(logits.shape))
    axis = spec[2]

    def local(lg, lb):
        if axis is None:
            return torch.logsumexp(lg, dim=-1), torch.gather(lg, -1, lb[..., None])[..., 0]
        m = pmax(torch.amax(lg, dim=-1).detach(), mesh, axis)
        logz = m + torch.log(psum(torch.sum(torch.exp(lg - m[..., None]), dim=-1), mesh, axis))
        vl = lg.shape[-1]
        idx = lb - axis_index(mesh, axis) * vl
        here = (idx >= 0) & (idx < vl)
        got = torch.gather(lg, -1, torch.where(here, idx, 0)[..., None])[..., 0]
        return logz, psum(torch.where(here, got, 0.0), mesh, axis)

    tok = P(spec[0], spec[1])
    return shard_map(local, mesh, in_specs=(P(*spec), tok), out_specs=(tok, tok))(logits, labels)


def cross_entropy_loss(logits, labels, z_loss_weight: float = 1e-4):
    """Token-mean CE with z-loss; logits f32-upcast. labels -100 = ignore."""
    logits = logits.to(f32)
    mask = (labels >= 0).to(f32)
    labels_safe = torch.clamp(labels, min=0).long()
    if is_dtensor(logits):
        logz, ll = _logz_and_label_logit(logits, labels_safe)
    else:
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


def _quantized(g, r):
    """This device's (dequantized int8 value, new residual) of ``g + r``."""
    g = g.to(f32) + r
    scale = torch.maximum(torch.max(torch.abs(g)), torch.tensor(1e-8, dtype=f32,
                                                               device=g.device)) / 127.0
    deq = _quantize_int8(g, scale).to(f32) * scale
    return deq, g - deq


def pod_sync_local(g, r, mesh=None):
    """One device's int8 + error-feedback sync of its gradient block ``g``
    with residual ``r``: ``(psum(deq, "pod") / P, g + r - deq)``.  Without a
    mesh the pod axis has size 1 and the mean is ``deq`` itself."""
    deq, new_r = _quantized(g, r)
    if mesh is None:
        return deq, new_r
    return psum(deq, mesh, "pod") / float(axis_size(mesh, "pod")), new_r


def _pod_compressed_allreduce(grads: dict, residual: dict, mesh=None, specs=None):
    """int8 + error-feedback all-reduce over the ``"pod"`` axis, one leaf
    at a time: ``g + r`` quantized to int8 at ``max|g + r| / 127``, the
    dequantized value averaged over the pods, the rounding error carried to
    the next step.  Over a mesh each leaf runs through ``shard_map`` with
    its spec (``specs[name]``; replicated where None), so each device
    quantizes its own shard.  Returns ``(synced, new_residual)``."""
    synced, new_res = {}, {}
    for name, g in grads.items():
        if mesh is None:
            synced[name], new_res[name] = pod_sync_local(g, residual[name])
            continue
        spec = P(*specs[name]) if specs is not None and specs.get(name) is not None \
            else P(*([None] * g.dim()))
        synced[name], new_res[name] = shard_map(
            lambda gl, rl: pod_sync_local(gl, rl, mesh), mesh,
            in_specs=(spec, spec), out_specs=(spec, spec))(g, residual[name])
    return synced, new_res


def _check_int8_ef():
    """The active ctx, after checking it can run the int8 sync."""
    ctx = current_ctx()
    pods = None if ctx is None else ctx.mesh_shape.get("pod")
    if pods is None:
        raise ValueError("grad_compression='int8_ef' requires a multi-pod mesh: the sharding "
                         "context has no 'pod' axis")
    if pods != 1 and ctx.mesh is None:
        raise ValueError(f"grad_compression='int8_ef' over {pods} pods needs the context's "
                         f"device mesh (ShardingCtx.over(mesh)) to sum over: it has a mesh "
                         f"shape only")
    return ctx


def make_train_step(cfg: ModelConfig, tc: TrainConfig, param_specs=None, *,
                    microbatches: int | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    parameters and the optimizer state are updated in place; the returned
    state carries the next step.  ``batch`` is a dict of tensors on the
    parameters' device; the metrics are float32 scalars there.

    ``param_specs`` (``{parameter name: partition spec}``) gives the int8
    sync each parameter's sharding over a device mesh (the reference's
    ``param_specs``); None syncs every leaf replicated.

    ``microbatches`` runs only the first that many of the ``grad_accum``
    slices (the sum still divided by ``grad_accum``): the dry run runs the
    accumulation loop's body once, as the reference's compiled analysis
    counts a scan body once.  A training run leaves it None."""
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
        # Over a mesh the batch dim is gathered first: a microbatch is a
        # contiguous slice of it, which a sharded dim cannot be split into.
        batch = {k: replicate_dims(x, (0,)) for k, x in batch.items()}
        acc = {name: torch.zeros_like(p, dtype=f32) for name, p in named.items()}
        loss_sum = torch.zeros((), dtype=f32, device=next(iter(named.values())).device)
        for i in range(n if microbatches is None else min(n, microbatches)):
            mb = {k: x.reshape((n, -1) + tuple(x.shape[1:]))[i] for k, x in batch.items()}
            # ... and each microbatch sharded over the batch axes again.
            mb = {k: shard_constraint(x, ("batch",) + (None,) * (x.dim() - 1))
                  for k, x in mb.items()}
            loss, _, grads = grad_fn(model, named, mb)
            for name in list(grads):
                acc[name].add_(grads.pop(name).to(f32))
            loss_sum = loss_sum + loss
        for g in acc.values():
            g.div_(n)
        return loss_sum / n, {}, acc

    def train_step(state: TrainState, batch):
        ctx = _check_int8_ef() if tc.grad_compression == "int8_ef" else None
        named = named_params(state)
        loss, metrics, grads = compute_grads(state.params, named, batch)
        ef = state.ef_residual
        if tc.grad_compression == "int8_ef":
            grads, ef = _pod_compressed_allreduce(grads, ef, ctx.mesh, param_specs)
        _, opt, opt_metrics = adamw_update(tc.optimizer, named, grads, state.opt, state.step)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(state.step + 1, state.params, opt, ef), metrics

    return train_step
