"""Public entry points for the port's CUDA kernels.

Each wrapper checks its inputs, allocates outputs and scratch with
`torch.empty`, and launches its kernel on PyTorch's current stream; it
takes its plain PyTorch version (kernels/ref.py) only when the tensors
it is given lie on the CPU.  A CUDA tensor either launches the kernel or
raises: a failed build or a refused launch is an error, never a silent
fallback.  ``launches[name]`` counts the kernel's launches (and nothing
else), so a run can show that its main path really went through the
kernel.

Every wrapper derives the batch extent from its input shapes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import fastexp as fx
from repro_torch.core import metropolis
from repro_torch.core import mt19937 as mt
from repro_torch.kernels import _build, ref

LANES = 128

#: Largest dynamic shared memory one CTA may use on Hopper (bytes).
MAX_SMEM = 232_448

#: Kernel name -> launches since the last `reset_launches`.
launches = {"colored_multisweep": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _colored_lib():
    lib = _build.load("colored_multisweep")
    fn = lib.colored_multisweep
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ]
    return fn


def _check(t: torch.Tensor, what: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{what}: want contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def make_colored_multisweep(
    classes,  # tuple of reorder.ColorClass (host numpy)
    h,  # (n,) f32
    base_nbr,  # (n, SD) int32
    base_J,  # (n, SD) f32, NOT doubled
    tau_J,  # (n,) f32, NOT doubled
    n: int,
    exp_flavor: str = "fast",
):
    """Build the fused colored-sweep entry (the "cb" rung) for one model:
    ``fn(spins, rng, beta, num_sweeps) -> (spins, h_space, h_tau, rng)``.

    ``spins`` is (B, rows, 128) float32 of +-1, ``rng`` the (624, B*128)
    interlaced MT19937 state (int32 holding uint32 bits; replica b owns
    columns b*128..(b+1)*128), ``beta`` (B,) float32.  The inputs are not
    modified.  On CUDA tensors this launches the kernel of
    csrc/colored_multisweep.cu (one CTA per replica); on CPU tensors it
    runs `ref.colored_multisweep_ref`.
    """
    fx.exp_fn(exp_flavor)  # raises for unported flavours
    classes = tuple(classes)
    host = {
        "h": np.asarray(h, np.float32),
        "base_nbr": np.asarray(base_nbr, np.int32),
        "base_J": np.asarray(base_J, np.float32),
        "tau_J": np.asarray(tau_J, np.float32),
    }
    sd = host["base_nbr"].shape[1]
    # Kernel tables: every class's rows concatenated in visit order, with
    # offsets; the roll masks packed as bit 0 (down) | bit 1 (up).
    packed = {
        "off": np.concatenate([[0], np.cumsum([len(c.rows) for c in classes])]),
        "row": np.concatenate([c.rows for c in classes]),
        "h": np.concatenate([c.h for c in classes]),
        "J": np.concatenate([c.space_J for c in classes]).reshape(-1),
        "tgt": np.concatenate([c.space_tgt for c in classes]).reshape(-1),
        "tau": np.concatenate([c.tau_J for c in classes]),
        "down": np.concatenate([c.down_src for c in classes]),
        "up": np.concatenate([c.up_src for c in classes]),
        "roll": np.concatenate(
            [c.down_roll.astype(np.int32) | (c.up_roll.astype(np.int32) << 1) for c in classes]
        ),
        "nbr": host["base_nbr"].reshape(-1),
    }
    per_device: dict = {}

    def tables(device: torch.device) -> dict:
        key = str(device)
        if key not in per_device:
            def dev(x):
                x = np.ascontiguousarray(x)
                if x.dtype.kind in "iu":
                    x = x.astype(np.int32)
                return torch.from_numpy(x).to(device)

            per_device[key] = {
                "classes": metropolis.classes_to(classes, device),
                "plain": {
                    "h": dev(host["h"]),
                    "base_nbr": dev(host["base_nbr"]).long(),
                    "base_J": dev(host["base_J"]),
                    "tau_J": dev(host["tau_J"]),
                },
                "kernel": {k: dev(v) for k, v in packed.items()},
            }
        return per_device[key]

    def fn(spins, rng, beta, num_sweeps: int):
        num_sweeps = int(num_sweeps)
        if num_sweeps < 0:
            raise ValueError(f"num_sweeps must be >= 0, got {num_sweeps}")
        dev = spins.device
        if dev.type == "cpu":
            t = tables(dev)
            return ref.colored_multisweep_ref(
                spins, rng, beta, t["classes"], **t["plain"], n=n,
                num_sweeps=num_sweeps, exp_flavor=exp_flavor,
            )
        if dev.type != "cuda":
            raise ValueError(f"colored_multisweep runs on cuda (or cpu) tensors, got {dev}")
        B, rows, lanes = spins.shape
        _check(spins, "spins", torch.float32, (B, rows, LANES))
        _check(rng, "rng", torch.int32, (mt.N, B * LANES))
        _check(beta, "beta", torch.float32, (B,))
        if rng.device != dev or beta.device != dev:
            raise ValueError("spins, rng and beta must be on one device")
        if rows % n or rows // n < 2:
            raise ValueError(f"rows={rows} is not a lane layout of n={n}")
        if rows * LANES > MAX_SMEM:
            raise ValueError(
                f"rows={rows} needs {rows * LANES} B of shared memory; "
                f"the kernel holds at most {MAX_SMEM // LANES} rows"
            )
        t = tables(dev)
        k, p = t["kernel"], t["plain"]
        blocks = -(-rows // mt.N)
        out_spins = torch.empty_like(spins)
        out_hs = torch.empty_like(spins)
        out_ht = torch.empty_like(spins)
        out_rng = torch.empty_like(rng)
        scratch = (
            torch.empty(((blocks - 1) * mt.N, B * LANES), dtype=torch.float32, device=dev)
            if blocks > 1 and num_sweeps > 0
            else None
        )
        with torch.cuda.device(dev):
            err = _colored_lib()(
                _ptr(spins), _ptr(rng), _ptr(beta), _ptr(out_spins), _ptr(out_hs),
                _ptr(out_ht), _ptr(out_rng), _ptr(scratch), _ptr(k["off"]),
                _ptr(k["row"]), _ptr(k["h"]), _ptr(k["J"]), _ptr(k["tgt"]),
                _ptr(k["tau"]), _ptr(k["down"]), _ptr(k["up"]), _ptr(k["roll"]),
                _ptr(p["h"]), _ptr(k["nbr"]), _ptr(p["base_J"]), _ptr(p["tau_J"]),
                B, rows, n, sd, len(classes), num_sweeps,
                fx.f32_bits(fx.SCALE_F32), fx.f32_bits(fx.CENTRE_F32),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
            )
        if err != 0:
            raise RuntimeError(f"colored_multisweep launch failed: CUDA error {err}")
        launches["colored_multisweep"] += 1
        return out_spins, out_hs, out_ht, out_rng

    return fn
