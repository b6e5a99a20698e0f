"""Carry models and sweep state across as plain numpy arrays.

A model, a carry or a multi-tenant engine's slot tables written by
another program (or by the JAX reference package this port mirrors)
crosses into the port as a dict of numpy arrays: that keeps the port free of any other framework, and the bytes
are exactly the same on both sides.  MT19937 state travels as uint32.
A language model's weights travel as the reference's value tree, and a
whole train state as its leaves in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ising
from repro_torch.core.engine import SweepCarry
from repro_torch.nn.param import STACKS, leaf_groups

MODEL_KEYS = ("n", "L", "h", "space_nbr", "space_J", "tau_J", "beta")


def model_to_arrays(m: ising.LayeredModel) -> dict:
    """``{n, L, h, space_nbr, space_J, tau_J, beta}`` as numpy values."""
    return {
        "n": np.int64(m.n),
        "L": np.int64(m.L),
        "h": np.asarray(m.h, np.float32),
        "space_nbr": np.asarray(m.space_nbr, np.int32),
        "space_J": np.asarray(m.space_J, np.float32),
        "tau_J": np.asarray(m.tau_J, np.float32),
        "beta": np.float64(m.beta),
    }


def model_from_arrays(d: dict) -> ising.LayeredModel:
    """The inverse of `model_to_arrays`."""
    missing = [k for k in MODEL_KEYS if k not in d]
    if missing:
        raise ValueError(f"model arrays miss {missing}")
    return ising.LayeredModel(
        n=int(d["n"]),
        L=int(d["L"]),
        h=np.asarray(d["h"], np.float32),
        space_nbr=np.asarray(d["space_nbr"], np.int32),
        space_J=np.asarray(d["space_J"], np.float32),
        tau_J=np.asarray(d["tau_J"], np.float32),
        beta=float(d["beta"]),
    )


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (never a view of a CPU tensor's storage)."""
    return t.detach().to("cpu", copy=True).numpy()


def carry_to_numpy(carry: SweepCarry) -> dict:
    """The five `SweepCarry` leaves as host numpy copies; rng as uint32."""
    out = {f: host_copy(getattr(carry, f)) for f in SweepCarry._fields}
    out["rng"] = out["rng"].view(np.uint32)
    return out


def carry_from_numpy(d: dict, device="cuda") -> SweepCarry:
    """A `SweepCarry` on ``device`` from five numpy leaves (rng uint32)."""

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)  # a writable copy

    rng = np.ascontiguousarray(np.asarray(d["rng"], np.uint32)).view(np.int32)
    return SweepCarry(
        f32(d["spins"]), f32(d["h_space"]), f32(d["h_tau"]), f32(d["betas"]),
        torch.from_numpy(rng.copy()).to(device),
    )


SLOT_TABLE_KEYS = ("h", "base_J", "tau_J", "base_J2", "tau_J2")


def slot_tables_to_numpy(engine) -> dict:
    """A multi-tenant engine's `slot_tables` (``[B, ...]`` float32 per key
    of `SLOT_TABLE_KEYS`) as host numpy copies."""
    if not engine.multi:
        raise ValueError("slot tables belong to multi-tenant engines")
    return {k: host_copy(engine.slot_tables[k]) for k in SLOT_TABLE_KEYS}


def slot_tables_from_numpy(d: dict, device="cuda") -> dict:
    """Slot tables on ``device`` from numpy arrays (float32 copies), e.g.
    those of another program's multi-tenant engine."""
    missing = [k for k in SLOT_TABLE_KEYS if k not in d]
    if missing:
        raise ValueError(f"slot tables miss {missing}")
    return {k: torch.from_numpy(np.array(d[k], np.float32)).to(device) for k in SLOT_TABLE_KEYS}


# -- language-model weights ----------------------------------------------------------


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def lm_params_from_arrays(values: dict, cfg, device="cuda"):
    """The port's model for ``cfg`` holding ``values``: the reference's
    value tree (``split_tree(init_params(key, cfg))[0]``, of
    `models.decoder` or, with ``enc_blocks``, of `models.encdec`) as numpy
    arrays, its layer stacks (`STACKS`) sliced into the port's
    ``ModuleList``s.  A `models.decoder.Decoder`, or a
    `models.encdec.EncDec`.  Every name must match, shape for shape."""
    from repro_torch.models import decoder, encdec

    cls = encdec.EncDec if "enc_blocks" in values else decoder.Decoder
    model = cls(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = dict(model.named_parameters())
    flat = {}
    for name, arr in _flatten(values).items():
        arr = np.asarray(arr, np.float32)
        stack, _, rest = name.partition(".")
        if stack in STACKS:
            for layer in range(arr.shape[0]):
                flat[f"{stack}.{layer}.{rest}"] = arr[layer]
        else:
            flat[name] = arr
    if set(flat) != set(want):
        raise ValueError(f"parameter names differ: missing {sorted(set(want) - set(flat))}, "
                         f"unknown {sorted(set(flat) - set(want))}")
    with torch.no_grad():
        for name, p in want.items():
            if tuple(flat[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {flat[name].shape}, want {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(flat[name])))
    return model.to(device)


def lm_params_to_arrays(model) -> dict:
    """The inverse of `lm_params_from_arrays`: the reference's value tree
    (nested dicts of float32 numpy arrays, each of `STACKS` stacked on a
    leading layer axis)."""
    named = dict(model.named_parameters())
    tree: dict = {}
    for ref, names in leaf_groups(named):
        arrays = [host_copy(named[n].float()) for n in names]
        node = tree
        *path, leaf = ref.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.stack(arrays) if _stacked(ref) else arrays[0]
    return tree


def _stacked(ref: str) -> bool:
    return ref.split(".", 1)[0] in STACKS


# -- a whole train state ----------------------------------------------------------------


def train_state_names(state) -> list:
    """The reference's leaf names of ``state`` (a `train.step.TrainState`)
    in JAX's ``tree_flatten`` order on the reference's TrainState:
    ``step``; then ``params.<leaf>``, ``opt.m.<leaf>`` and ``opt.v.<leaf>``,
    each over the reference's value tree in sorted-key order with the
    layers stacked (`nn.param.leaf_groups`); then ``ef_residual.<leaf>``
    where the state has error-feedback buffers (None has no leaves)."""
    refs = [ref for ref, _ in leaf_groups(n for n, _ in state.params.named_parameters())]
    trees = ["params", "opt.m", "opt.v"] + (["ef_residual"] if state.ef_residual is not None
                                            else [])
    return ["step"] + [f"{tree}.{ref}" for tree in trees for ref in refs]


def _train_state_tensors(state) -> dict:
    """``{tree: {port parameter name: tensor}}`` for the trees of `train_state_names`."""
    out = {"params": dict(state.params.named_parameters()), "opt.m": state.opt.m,
           "opt.v": state.opt.v}
    if state.ef_residual is not None:
        out["ef_residual"] = state.ef_residual
    return out


def train_state_to_arrays(state) -> dict:
    """``{name: host tensor}`` in the order of `train_state_names`: host
    copies, each leaf in its own dtype (bfloat16 m and v included, which
    numpy cannot hold without ``ml_dtypes``), each layer stack stacked on a
    leading axis; ``step`` an int32 scalar.  What the reference's
    ``tree_flatten`` of its TrainState gives, leaf for leaf."""
    tensors = _train_state_tensors(state)
    groups = leaf_groups(tensors["params"])
    out = {"step": state.step.detach().to("cpu", torch.int32, copy=True)}
    for tree, named in tensors.items():
        for ref, names in groups:
            if _stacked(ref):
                out[f"{tree}.{ref}"] = torch.stack([named[n].detach().cpu() for n in names])
            else:
                out[f"{tree}.{ref}"] = named[names[0]].detach().to("cpu", copy=True)
    return out


def to_tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (a tensor, or a numpy array: a bfloat16 one,
    ``ml_dtypes``', through its 16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def train_state_from_arrays(arrays: dict, state):
    """Write ``arrays`` (``{name: array}`` as `train_state_to_arrays`
    gives, numpy or tensors, e.g. a reference TrainState's leaves) into
    ``state`` in place: the model's parameters, m, v, the error-feedback
    buffers and the step, each cast to the dtype it holds.  Every name and
    shape is checked before anything is written.  Returns ``state``."""
    want = train_state_names(state)
    if set(arrays) != set(want):
        raise ValueError(f"train state names differ: missing {sorted(set(want) - set(arrays))}, "
                         f"unknown {sorted(set(arrays) - set(want))}")
    tensors = _train_state_tensors(state)
    writes = [(state.step, to_tensor(arrays["step"]))]
    for tree, named in tensors.items():
        for ref, names in leaf_groups(tensors["params"]):
            src = to_tensor(arrays[f"{tree}.{ref}"])
            parts = list(src) if _stacked(ref) else [src]
            if len(parts) != len(names):
                raise ValueError(f"{tree}.{ref}: {len(parts)} layers, want {len(names)}")
            for n, part in zip(names, parts):
                if tuple(part.shape) != tuple(named[n].shape):
                    raise ValueError(f"{tree}.{ref}: shape {tuple(part.shape)}, "
                                     f"want {tuple(named[n].shape)}")
                writes.append((named[n], part))
    if tuple(writes[0][1].shape) != ():
        raise ValueError(f"step: shape {tuple(writes[0][1].shape)}, want ()")
    for dst, src in writes:
        dst.copy_(src)
    return state
