"""Parameters carrying logical sharding axes.

``Param`` pairs a tensor with the tuple of logical axis names of its
dimensions ("embed", "heads", "vocab", ...).  Init functions build trees
(nested dicts) of Params; ``split_tree`` separates the value tree from the
logical-axes tree, as the sharding rules need.  A `ParamModule` is an
``nn.Module`` whose parameters come from such a tree: each leaf becomes an
``nn.Parameter`` and its axes stay readable through ``logical_axes()``.

Random draws take an explicit ``torch.Generator``; values are float32.

`leaf_groups` names the reference's leaves: its layer stacks (`STACKS`)
hold one leaf per parameter name with a leading layer axis, where the
port has one module a layer, and its leaves come in JAX's flatten order
(the keys sorted level by level).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.sharding.ctx import gather_on_use


class Param:
    """A model parameter annotated with logical axis names."""

    def __init__(self, value: Any, logical: Tuple[str, ...]):
        self.value = value
        self.logical = tuple(logical)

    def __repr__(self):
        shape = tuple(getattr(self.value, "shape", ()))
        return f"Param(shape={shape}, logical={self.logical})"


def is_param(x) -> bool:
    return isinstance(x, Param)


def _map(fn, tree):
    if is_param(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a Param tree node: {type(tree).__name__}")


def split_tree(tree):
    """(params_with_Param_leaves) -> (values_tree, logical_axes_tree)."""
    return _map(lambda p: p.value, tree), _map(lambda p: p.logical, tree)


def normal_init(generator: torch.Generator, shape, std, dtype=torch.float32, device=None):
    """``normal(shape) * std`` in float32, drawn from ``generator`` (on its
    device), then cast to ``dtype`` and moved to ``device``."""
    x = torch.randn(tuple(shape), generator=generator, device=generator.device,
                    dtype=torch.float32).mul_(std)  # in place: no second tensor of the size
    return x.to(dtype=dtype, device=device or generator.device)


def fan_in_init(generator: torch.Generator, shape, fan_in, dtype=torch.float32, device=None):
    return normal_init(generator, shape, 1.0 / np.sqrt(max(fan_in, 1)), dtype, device)


class ParamModule(nn.Module):
    """An ``nn.Module`` over a flat ``{name: Param}`` tree.

    Each Param becomes a parameter of the module and its logical axes are
    kept.  Parameters are made without gradients, so serving builds no
    autograd graph; training asks for them (`train.step.init_train_state`
    calls ``requires_grad_()``).  ``params()`` gives the ``{name: tensor}``
    dict the functional ``*_apply`` layers take (a DTensor parameter
    gathered over the batch axes, `sharding.ctx.gather_on_use`).
    """

    def __init__(self, tree: dict):
        super().__init__()
        self._logical = {}
        for name, leaf in tree.items():
            self.add_param(name, leaf)

    def add_param(self, name: str, leaf: Param) -> None:
        if not is_param(leaf):
            raise TypeError(f"{name}: a ParamModule takes Params, got {type(leaf).__name__}")
        self.register_parameter(name, nn.Parameter(leaf.value, requires_grad=False))
        self._logical[name] = leaf.logical

    def params(self) -> dict:
        return {name: gather_on_use(p) for name, p in self.named_parameters(recurse=False)}

    def logical_axes(self) -> dict:
        """``{parameter name: logical axes}`` of this module and every
        module below it (dotted names, as ``named_parameters``)."""
        out = {}
        for prefix, mod in self.named_modules():
            for name, axes in getattr(mod, "_logical", {}).items():
                out[f"{prefix}.{name}" if prefix else name] = axes
        return out


#: The reference's layer stacks: a leading layer axis, one module a layer in the port.
STACKS = ("blocks", "dense_blocks", "enc_blocks", "dec_blocks")


def leaf_groups(names) -> list:
    """The reference's leaves for the port's parameter ``names`` (dotted,
    as ``named_parameters`` gives them), in JAX's ``tree_flatten`` order:
    ``[(reference name, [port names])]``.  A name under one of `STACKS`
    (``blocks.3.attn.wq``) belongs to the stacked leaf ``blocks.attn.wq``,
    its port names in layer order; any other name is a leaf of its own."""
    groups: dict = {}
    for name in names:
        head, _, tail = name.partition(".")
        if head in STACKS:
            layer, rest = tail.split(".", 1)
            groups.setdefault(f"{head}.{rest}", {})[int(layer)] = name
        else:
            groups[name] = {0: name}
    order = sorted(groups, key=lambda ref: tuple(ref.split(".")))
    return [(ref, [groups[ref][i] for i in sorted(groups[ref])]) for ref in order]
