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

#: Kernel name -> launches since the last `reset_launches`.  A
#: `mt_uniforms` launch counts under "mt_next_block": it is that kernel.
launches = {
    "colored_multisweep": 0,
    "metropolis_multisweep": 0,
    "metropolis_sweep": 0,
    "mt_next_block": 0,
}

#: Shared-memory bytes of the a4 kernels' lane-roll exchange buffers
#: (csrc/a4_sweep.cuh: XBUF_BYTES).
_A4_XBUF = 2 * LANES * 4


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _kernel(name: str, argtypes: list):
    """The C entry ``name`` of library ``name`` (built on first use)."""
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_if_failed(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _sweeps(num_sweeps) -> int:
    num_sweeps = int(num_sweeps)
    if num_sweeps < 0:
        raise ValueError(f"num_sweeps must be >= 0, got {num_sweeps}")
    return num_sweeps


def _need_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda (or cpu) tensors, got {dev}")


_VP, _INT, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
#: ctypes signatures of the C entries (pointers, ints, float bit patterns,
#: stream), in the order of their definitions in csrc/.
_COLORED_ARGS = [_VP] * 21 + [_INT] * 6 + [_U32, _U32, _VP]
_MULTISWEEP_ARGS = [_VP] * 13 + [_INT] * 6 + [_U32, _U32, _VP]
_SWEEP_ARGS = [_VP] * 11 + [_INT] * 5 + [_U32, _U32, _VP]
_MT_ARGS = [_VP] * 3 + [_INT] * 2 + [_VP]


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
        num_sweeps = _sweeps(num_sweeps)
        dev = spins.device
        if dev.type == "cpu":
            t = tables(dev)
            return ref.colored_multisweep_ref(
                spins, rng, beta, t["classes"], **t["plain"], n=n,
                num_sweeps=num_sweeps, exp_flavor=exp_flavor,
            )
        _need_cuda("colored_multisweep", dev)
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
            err = _kernel("colored_multisweep", _COLORED_ARGS)(
                _ptr(spins), _ptr(rng), _ptr(beta), _ptr(out_spins), _ptr(out_hs),
                _ptr(out_ht), _ptr(out_rng), _ptr(scratch), _ptr(k["off"]),
                _ptr(k["row"]), _ptr(k["h"]), _ptr(k["J"]), _ptr(k["tgt"]),
                _ptr(k["tau"]), _ptr(k["down"]), _ptr(k["up"]), _ptr(k["roll"]),
                _ptr(p["h"]), _ptr(k["nbr"]), _ptr(p["base_J"]), _ptr(p["tau_J"]),
                B, rows, n, sd, len(classes), num_sweeps,
                fx.f32_bits(fx.SCALE_F32), fx.f32_bits(fx.CENTRE_F32),
                _stream(dev),
            )
        _raise_if_failed("colored_multisweep", err)
        launches["colored_multisweep"] += 1
        return out_spins, out_hs, out_ht, out_rng

    return fn


# -----------------------------------------------------------------------------
# The a4 rung: fused multisweep (in-kernel MT19937) and one sweep per launch.
# -----------------------------------------------------------------------------


def _same_device(dev: torch.device, **tensors) -> None:
    for what, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, spins on {dev}: one device, please")


def _a4_inputs(name, spins, h_space, h_tau, base_nbr, base_J2, tau_J2, beta, n: int):
    """Check the a4 kernels' common inputs (CUDA tensors); returns
    ``(B, rows, sd, nbr, j2, tau2, beta)`` with the last four flat views."""
    dev = spins.device
    _need_cuda(name, dev)
    if spins.dim() != 3:
        raise ValueError(f"spins: want (B, rows, {LANES}), got {tuple(spins.shape)}")
    B, rows, _ = spins.shape
    for what, t in (("spins", spins), ("h_space", h_space), ("h_tau", h_tau)):
        _check(t, what, torch.float32, (B, rows, LANES))
    if rows % n or rows // n < 2:
        raise ValueError(f"rows={rows} is not a lane layout of n={n}")
    if _A4_XBUF + rows * LANES > MAX_SMEM:
        raise ValueError(
            f"rows={rows} needs {_A4_XBUF + rows * LANES} B of shared memory; "
            f"the a4 kernels hold at most {(MAX_SMEM - _A4_XBUF) // LANES} rows"
        )
    sd = base_nbr.shape[-1] if base_nbr.dim() == 2 else -1
    _check(base_nbr, "base_nbr", torch.int32, (n, sd))
    _check(base_J2, "base_J2", torch.float32, (n, sd))
    for what, t, count in (("tau_J2", tau_J2, n), ("beta", beta, B)):
        _check(t, what, torch.float32, (count,) if t.dim() == 1 else (count, 1))
    _same_device(dev, h_space=h_space, h_tau=h_tau, base_nbr=base_nbr, base_J2=base_J2,
                 tau_J2=tau_J2, beta=beta)
    return B, rows, sd


def metropolis_multisweep(
    spins,  # (B, rows, 128) f32 of +-1
    h_space,  # (B, rows, 128) f32
    h_tau,  # (B, rows, 128) f32
    rng,  # (624, B*128) int32: the interlaced MT19937 state, uint32 bits
    base_nbr,  # (n, SD) int32 in-layer neighbour site ids
    base_J2,  # (n, SD) f32, pre-doubled
    tau_J2,  # (n,) or (n, 1) f32, pre-doubled
    beta,  # (B,) or (B, 1) f32
    n: int,
    num_sweeps: int,
    exp_flavor: str = "fast",
):
    """``num_sweeps`` fused a4 sweeps of every replica, MT19937 in the
    kernel (csrc/metropolis_multisweep.cu, one CTA per replica); the
    fields are carried and updated incrementally.  Returns ``(spins,
    h_space, h_tau, rng)``; the inputs are not modified.  On CPU tensors
    this runs `ref.metropolis_multisweep_ref`."""
    fx.exp_fn(exp_flavor)  # raises for unported flavours
    num_sweeps = _sweeps(num_sweeps)
    dev = spins.device
    if dev.type == "cpu":
        return ref.metropolis_multisweep_ref(
            spins, h_space, h_tau, rng, base_nbr, base_J2, tau_J2, beta, n, num_sweeps,
            exp_flavor,
        )
    B, rows, sd = _a4_inputs(
        "metropolis_multisweep", spins, h_space, h_tau, base_nbr, base_J2, tau_J2, beta, n
    )
    _check(rng, "rng", torch.int32, (mt.N, B * LANES))
    _same_device(dev, rng=rng)
    blocks = -(-rows // mt.N)
    out = [torch.empty_like(spins), torch.empty_like(h_space), torch.empty_like(h_tau),
           torch.empty_like(rng)]
    scratch = (
        torch.empty(((blocks - 1) * mt.N, B * LANES), dtype=torch.float32, device=dev)
        if blocks > 1 and num_sweeps > 0
        else None
    )
    with torch.cuda.device(dev):
        err = _kernel("metropolis_multisweep", _MULTISWEEP_ARGS)(
            _ptr(spins), _ptr(h_space), _ptr(h_tau), _ptr(rng), _ptr(base_nbr),
            _ptr(base_J2), _ptr(tau_J2), _ptr(beta), *(_ptr(t) for t in out), _ptr(scratch),
            B, rows, n, sd, num_sweeps, MAX_SMEM,
            fx.f32_bits(fx.SCALE_F32), fx.f32_bits(fx.CENTRE_F32), _stream(dev),
        )
    _raise_if_failed("metropolis_multisweep", err)
    launches["metropolis_multisweep"] += 1
    return tuple(out)


def metropolis_sweep(
    spins,  # (B, rows, 128) f32 of +-1
    h_space,  # (B, rows, 128) f32
    h_tau,  # (B, rows, 128) f32
    u,  # (B, rows, 128) f32 uniforms
    base_nbr,  # (n, SD) int32
    base_J2,  # (n, SD) f32, pre-doubled
    tau_J2,  # (n,) or (n, 1) f32, pre-doubled
    beta,  # (B,) or (B, 1) f32
    n: int,
    exp_flavor: str = "fast",
):
    """One a4 sweep of every replica on the caller's uniforms
    (csrc/metropolis_sweep.cu, one launch per sweep).  Returns ``(spins,
    h_space, h_tau)``; the inputs are not modified.  On CPU tensors this
    runs `ref.metropolis_sweep_ref`."""
    fx.exp_fn(exp_flavor)
    dev = spins.device
    if dev.type == "cpu":
        return ref.metropolis_sweep_ref(
            spins, h_space, h_tau, u, base_nbr, base_J2, tau_J2, beta, n, exp_flavor
        )
    B, rows, sd = _a4_inputs(
        "metropolis_sweep", spins, h_space, h_tau, base_nbr, base_J2, tau_J2, beta, n
    )
    _check(u, "u", torch.float32, (B, rows, LANES))
    _same_device(dev, u=u)
    out = [torch.empty_like(spins), torch.empty_like(h_space), torch.empty_like(h_tau)]
    with torch.cuda.device(dev):
        err = _kernel("metropolis_sweep", _SWEEP_ARGS)(
            _ptr(spins), _ptr(h_space), _ptr(h_tau), _ptr(u), _ptr(base_nbr), _ptr(base_J2),
            _ptr(tau_J2), _ptr(beta), *(_ptr(t) for t in out), B, rows, n, sd, MAX_SMEM,
            fx.f32_bits(fx.SCALE_F32), fx.f32_bits(fx.CENTRE_F32), _stream(dev),
        )
    _raise_if_failed("metropolis_sweep", err)
    launches["metropolis_sweep"] += 1
    return tuple(out)


# -----------------------------------------------------------------------------
# MT19937 block advance (csrc/mt_next_block.cu).
# -----------------------------------------------------------------------------


def _mt_block(state: torch.Tensor, uniforms: bool):
    name = "mt_uniforms" if uniforms else "mt_next_block"
    dev = state.device
    if dev.type == "cpu":
        return (ref.mt_uniforms_ref if uniforms else ref.mt_next_block_ref)(state)
    _need_cuda(name, dev)
    if state.dim() != 2 or state.shape[1] < 1:
        raise ValueError(f"state: want ({mt.N}, V) with V >= 1, got {tuple(state.shape)}")
    V = state.shape[1]
    _check(state, "state", torch.int32, (mt.N, V))
    pad = (-V) % LANES
    if pad:  # dummy generators on the padding columns; their output is dropped
        state = torch.cat([state, state.new_zeros((mt.N, pad))], dim=1)
    new = torch.empty_like(state)
    out = torch.empty(state.shape, dtype=torch.float32 if uniforms else torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel("mt_next_block", _MT_ARGS)(
            _ptr(state), _ptr(new), _ptr(out), V + pad, int(uniforms), _stream(dev)
        )
    _raise_if_failed(name, err)
    launches["mt_next_block"] += 1
    if pad:
        return new[:, :V].contiguous(), out[:, :V].contiguous()
    return new, out


def mt_next_block(state: torch.Tensor):
    """Advance the (624, V) interlaced state by one block: ``(new_state,
    tempered words)``, int32 storage of uint32 bits.  One launch of
    csrc/mt_next_block.cu (V padded to a multiple of 128); on CPU tensors
    `ref.mt_next_block_ref`."""
    return _mt_block(state, uniforms=False)


def mt_uniforms(state: torch.Tensor):
    """`mt_next_block` with the 24-bit float conversion in the kernel:
    ``(new_state, uniforms)``, uniforms (624, V) float32 in [0, 1)."""
    return _mt_block(state, uniforms=True)


def mt_uniform_blocks(state: torch.Tensor, num_blocks: int):
    """``num_blocks`` blocks of 624 uniforms per lane, one `mt_uniforms`
    launch each: ``(new_state, uniforms)``, uniforms
    ``(num_blocks * 624, V)``."""
    outs = []
    for _ in range(int(num_blocks)):
        state, u = mt_uniforms(state)
        outs.append(u)
    if not outs:
        return state, torch.empty((0, state.shape[1]), dtype=torch.float32, device=state.device)
    return state, outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def mt_uniforms_count(state: torch.Tensor, count: int):
    """Exactly ``count`` uniforms per lane: ceil(count/624) blocks, tail
    discarded (the per-sweep draw of `core.mt19937.mt_uniforms_count`)."""
    state, u = mt_uniform_blocks(state, -(-int(count) // mt.N))
    return state, u[:count]
