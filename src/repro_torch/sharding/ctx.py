"""Logical-axis sharding rules (MaxText-style, hand-rolled).

Model code names the logical axes of its tensors ("batch", "embed",
"heads", "mlp", "experts", ...).  A ``ShardingCtx`` binds a mesh shape
(``{mesh axis: size}``) and a logical -> physical mapping, and ``spec``
resolves a tuple of logical names to a partition spec: a tuple with one
entry a dimension, ``None`` (replicated), a mesh axis name, or a tuple of
mesh axis names.

Divisibility guard: a logical axis only maps to a physical mesh axis when
the dimension size divides evenly; otherwise it falls back to replication
(gemma's single KV head on a 16-wide model axis).  A mesh axis already
claimed by an earlier dimension is dropped: earlier dims win.

One card runs every tensor whole, so ``shard_constraint`` is a no-op;
the rules are kept for the sharded layouts to come (ROADMAP).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Optional, Sequence, Tuple

import torch

# Default logical -> physical mapping.  "pod" multiplies the batch axes when
# present (multi-pod meshes); tensor-parallel axes all map to "model".
DEFAULT_RULES: Mapping[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),  # replicated by default; long-context configs override
    "seq_shard": ("data",),  # explicit sequence parallelism
    # Params' embed dim shards over the data axis: FSDP/ZeRO-style — weights
    # and optimizer state distribute over BOTH mesh axes, gathered on use.
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "lora": ("data",),  # MLA low-rank dims: FSDP-shard like embed
    "cache_seq": (),
    "cache_head_dim": (),  # decode fallback when kv_heads don't divide
    "qkv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "layers": (),
    "conv": (),
    "ssm_heads": ("model",),
    "state": (),
}


@dataclasses.dataclass
class ShardingCtx:
    mesh_shape: Mapping[str, int]  # mesh axis -> size, in mesh order
    rules: Mapping[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )

    def axis_size(self, names: Sequence[str]) -> int:
        size = 1
        for nm in names:
            if nm in self.mesh_shape:
                size *= self.mesh_shape[nm]
        return size

    def spec(self, logical: Sequence[Optional[str]], dims: Sequence[int] | None = None) -> tuple:
        """Partition spec for a tuple of logical names (None = replicated).

        When ``dims`` is given, any logical axis whose physical shard count
        does not divide the dim size falls back to replication.  A mesh axis
        already claimed by an earlier dim is dropped (a spec may not repeat
        axes) — earlier dims win.
        """
        parts = []
        used: set = set()
        for k, name in enumerate(logical):
            if name is None:
                parts.append(None)
                continue
            phys = tuple(
                a
                for a in self.rules.get(name, ())
                if a in self.mesh_shape and a not in used
            )
            if not phys:
                parts.append(None)
                continue
            if dims is not None:
                n = self.axis_size(phys)
                if n <= 1 or dims[k] % n != 0:
                    parts.append(None)
                    continue
            used.update(phys)
            parts.append(phys if len(phys) > 1 else phys[0])
        return tuple(parts)


_local = threading.local()


def set_ctx(ctx: Optional[ShardingCtx]) -> None:
    _local.ctx = ctx


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardingCtx]):
    prev = current_ctx()
    set_ctx(ctx)
    try:
        yield ctx
    finally:
        set_ctx(prev)


def shard_constraint(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate activation sharding: on one device, ``x`` unchanged."""
    return x
