"""AdamW with decoupled weight decay, global-norm clipping and schedules.

Hand-rolled, as in the reference: the state is a mirror of the
parameters (m, v), ``{parameter name: tensor}`` dicts beside the model's
``named_parameters()``.  The update is the reference's arithmetic in its
order (the clip scale, the schedule's learning rate, the bias
corrections, then per parameter ``g*scale``, m, v, ``mh/(sqrt(vh)+eps) +
wd*p`` and ``p - lr*delta``), written in place on the same storage (the
reference donates the state) one parameter at a time, each gradient
dropped as soon as it is used: at gemma-2b's width the update then needs
the parameters, m, v and the gradients, plus a few temporaries of the
largest parameter.

Scalars are float32 tensors on the parameters' device, as JAX's weak
types make them.  ``c / tensor`` is written ``torch.div``: PyTorch's
``__rtruediv__`` multiplies by the reciprocal, which rounds otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.nn.param import leaf_groups

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"  # "bfloat16" halves optimizer memory (m, v)

    @property
    def state_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.state_dtype == "bfloat16" else f32


class OptState(NamedTuple):
    m: dict  # {parameter name: tensor}
    v: dict


def init_opt_state(params: dict, state_dtype=f32) -> OptState:
    """Zeroed m and v of ``state_dtype`` for ``{name: parameter}``."""
    def z(p):
        return torch.zeros_like(p, dtype=state_dtype)

    return OptState({n: z(p) for n, p in params.items()}, {n: z(p) for n, p in params.items()})


def _c(value, device) -> torch.Tensor:
    """A Python number as a float32 scalar on ``device`` (JAX's weak type)."""
    return torch.tensor(value, dtype=f32, device=device)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then a cosine decay to ``min_lr_ratio``; float32."""
    step = torch.as_tensor(step).to(f32)
    dev = step.device
    if cfg.warmup_steps > 0:
        warm = torch.minimum(step / cfg.warmup_steps, _c(1.0, dev))
    else:
        warm = _c(1.0, dev)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over ``{name: tensor}``, summed in the
    reference's leaf order (`nn.param.leaf_groups`): a stacked leaf's
    layers are reduced as one leaf, then the leaves added one by one."""
    total = None
    for _, names in leaf_groups(tree):
        sums = [torch.sum(torch.square(tree[n].to(f32))) for n in names]
        s = sums[0] if len(sums) == 1 else torch.sum(torch.stack(sums))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, opt: OptState, step):
    """Updates ``params`` (``{name: tensor}``), ``opt.m`` and ``opt.v`` in
    place and returns ``(params, opt, {"grad_norm", "lr"})``.  Consumes
    ``grads``: each gradient is removed from the dict once it is used."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(_c(1.0, dev), torch.div(_c(cfg.clip_norm, dev),
                                                  torch.maximum(gnorm, _c(1e-9, dev))))
    lr = lr_schedule(cfg, torch.as_tensor(step).to(dev))
    b1, b2 = _c(cfg.b1, dev), _c(cfg.b2, dev)
    step1 = (torch.as_tensor(step).to(dev) + 1).to(f32)
    bc1 = 1 - torch.pow(b1, step1)
    bc2 = 1 - torch.pow(b2, step1)
    omb1, omb2 = 1 - b1, 1 - b2

    for name in list(grads):
        p, m, v = params[name], opt.m[name], opt.v[name]
        g = grads.pop(name).to(f32).mul_(scale)
        m32 = m.to(f32).mul_(b1).add_(g * omb1)
        v32 = v.to(f32).mul_(b2).add_(g.square_().mul_(omb2))
        del g
        p32 = p.to(f32)
        delta = torch.div(m32, bc1).div_(torch.div(v32, bc2).sqrt_().add_(cfg.eps))
        delta.add_(p32 * cfg.weight_decay)
        p32.sub_(delta.mul_(lr))
        del delta
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:  # another dtype: write the float32 result back, rounded
                dst.copy_(src)
    return params, opt, {"grad_norm": gnorm, "lr": lr}
