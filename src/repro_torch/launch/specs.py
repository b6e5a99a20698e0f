"""Sharding-spec resolution for every step-function argument.

Parameters carry logical axes (`nn.param`, ``ParamModule.logical_axes``);
batches and decode caches get logical axes assigned here by structural
rules, then the active ``ShardingCtx`` maps logical -> physical with the
divisibility fallback.  The port has no ``NamedSharding``: each function
returns partition specs (`ShardingCtx.spec`: one entry a dimension, None
for replicated), which on one device are all replicated.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sharding import ShardingCtx


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same keys)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def param_shardings(ctx: ShardingCtx, values_tree, logical_tree):
    """The spec of each parameter: ``values_tree`` and ``logical_tree`` are
    nested dicts of the same keys (or flat ``{name: tensor}`` and
    ``ParamModule.logical_axes()``)."""
    return _map(lambda v, lg: ctx.spec(lg, tuple(v.shape)), values_tree, logical_tree)


def batch_shardings(ctx: ShardingCtx, batch_tree):
    def one(x):
        if x.ndim == 0:
            return ()
        logical = ("batch",) + (None,) * (x.ndim - 1)
        return ctx.spec(logical, tuple(x.shape))

    return _map(one, batch_tree)


_CACHE_RULES = {
    # leaf name -> logical axes by ndim (leading "layers" axis always first)
    "k": {5: ("layers", "batch", "cache_seq", "kv_heads", "cache_head_dim")},
    "v": {5: ("layers", "batch", "cache_seq", "kv_heads", "cache_head_dim")},
    "c_kv": {4: ("layers", "batch", "cache_seq", "cache_head_dim")},
    "k_rope": {4: ("layers", "batch", "cache_seq", "cache_head_dim")},
    "conv": {4: ("layers", "batch", None, "ssm_heads")},
    "ssm": {5: ("layers", "batch", "ssm_heads", None, None)},
    "tm_shift": {3: ("layers", "batch", None)},
    "cm_shift": {3: ("layers", "batch", None)},
    "wkv": {5: ("layers", "batch", "heads", None, None)},
    "cross_k": {5: ("layers", "batch", None, "heads", None)},
    "cross_v": {5: ("layers", "batch", None, "heads", None)},
}


def cache_shardings(ctx: ShardingCtx, caches_tree):
    """Structural logical-axis assignment for decode cache trees
    (NamedTuples of stacked tensors, None for no cache): a leaf's rule is
    that of the innermost NamedTuple field on its path."""

    def one(name, x):
        logical = _CACHE_RULES.get(name, {}).get(x.ndim)
        if logical is None:
            logical = ("layers", "batch") + (None,) * (x.ndim - 2)
        return ctx.spec(logical, tuple(x.shape))

    def walk(tree, name):
        if tree is None:
            return None
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v, f) for f, v in zip(tree._fields, tree)))
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, name) for v in tree)
        if isinstance(tree, dict):
            return {k: walk(v, name) for k, v in tree.items()}
        return one(name, tree)

    return walk(caches_tree, None)


def scalar_sharding(ctx: ShardingCtx):
    return ()


def tree_size_bytes(tree) -> int:
    """Bytes of every leaf of nested dicts, tuples and lists of tensors or arrays."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_size_bytes(v) for v in tree)
    itemsize = getattr(tree, "itemsize", None) or tree.element_size()
    return int(np.prod(tuple(tree.shape))) * int(itemsize)
