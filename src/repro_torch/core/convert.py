"""Carry models and sweep state across as plain numpy arrays.

A model, a carry or a multi-tenant engine's slot tables written by
another program (or by the JAX reference package this port mirrors)
crosses into the port as a dict of numpy arrays: that keeps the port free of any other framework, and the bytes
are exactly the same on both sides.  MT19937 state travels as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ising
from repro_torch.core.engine import SweepCarry

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


#: The reference's layer stacks: a leading layer axis, one module a layer in the port.
STACKS = ("blocks", "dense_blocks", "enc_blocks", "dec_blocks")


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
    tree: dict = {}
    stacks: dict = {}
    for name, p in model.named_parameters():
        arr = host_copy(p.float())
        head, _, tail = name.partition(".")
        if head in STACKS:
            layer, rest = tail.split(".", 1)
            stacks.setdefault((head, rest), {})[int(layer)] = arr
            continue
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    for (stack, rest), layers in stacks.items():
        node = tree.setdefault(stack, {})
        *path, leaf = rest.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.stack([layers[i] for i in range(len(layers))])
    return tree
