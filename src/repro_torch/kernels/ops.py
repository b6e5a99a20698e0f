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
from repro_torch.core import ising, metropolis, reorder
from repro_torch.core import mt19937 as mt
from repro_torch.kernels import _build, ref

LANES = 128

#: Largest dynamic shared memory one CTA may use on Hopper (bytes).
MAX_SMEM = 232_448

#: Kernel name -> launches since the last `reset_launches`.  A
#: `mt_uniforms` launch counts under "mt_next_block": it is that kernel.
launches = {
    "colored_multisweep": 0,
    "fastexp_2d": 0,
    "colored_multisweep_multi": 0,
    "metropolis_multisweep": 0,
    "metropolis_multisweep_multi": 0,
    "metropolis_sweep": 0,
    "mt_next_block": 0,
    "pt_swap": 0,
}

def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _kernel(name: str):
    """The C entry ``name`` of library ``name`` (built on first use), with
    its `ENTRY_ARGS` signature."""
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ENTRY_ARGS[name]
    return fn


#: The timing events of the engine launch in progress, ``[start, end,
#: recorded]``, or None: set by `SweepEngine.run` around each device
#: block's launch on the card.  Each kernel entry records ``start`` right
#: before the first C call under it and ``end`` right after each, on the
#: launching stream, so the pair spans the kernels and not the Python
#: before them.
launch_timing: list | None = None


def _launch(entry: str, dev: torch.device, *args, what: str | None = None) -> None:
    """Call C entry ``entry`` with ``args`` and ``dev``'s current stream
    (its last argument), recording an armed `launch_timing` pair right
    around the call; raise, naming ``what`` (default ``entry``), if the
    launch failed."""
    fn, stream = _kernel(entry), torch.cuda.current_stream(dev)
    handle = ctypes.c_void_p(stream.cuda_stream)
    timing = launch_timing
    if timing is not None and not timing[2]:
        timing[0].record(stream)
        timing[2] = True
    err = fn(*args, handle)
    if timing is not None:
        timing[1].record(stream)
    if err != 0:
        raise RuntimeError(f"{what or entry} launch failed: CUDA error {err}")


def _sweeps(num_sweeps) -> int:
    num_sweeps = int(num_sweeps)
    if num_sweeps < 0:
        raise ValueError(f"num_sweeps must be >= 0, got {num_sweeps}")
    return num_sweeps


def _need_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda (or cpu) tensors, got {dev}")


#: The exp flavours the sweep kernels (#1-#5) take, with their codes in
#: csrc/fastexp.cuh (EXP_FAST, EXP_ACCURATE, EXP_EXACT): every flavour of
#: `core.fastexp.EXP_FNS`, each a template instantiation of the kernels.
SWEEP_FLAVOURS = {"fast": 0, "accurate": 1, "exact": 2}


def _flavour_code(exp_flavor: str) -> int:
    """The kernels' code of ``exp_flavor``; ValueError for unknown ones."""
    fx.exp_fn(exp_flavor)
    return SWEEP_FLAVOURS[exp_flavor]


#: The exps' float constants as bit patterns, in the order every C entry
#: takes them (csrc/fastexp.cuh: ExpConsts).
_EXP_CONSTS = tuple(fx.f32_bits(c) for c in (
    fx.SCALE_F32, fx.CENTRE_F32, fx.SCALE4_F32, fx.ACCURATE_LO_F32, fx.ACCURATE_CLIP_HI_F32))

_VP, _INT, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
#: The exp arguments of a sweep entry: its flavour code and the constants.
_EXP_ARGS = [_INT] + [_U32] * len(_EXP_CONSTS)
#: ctypes signatures of the C entries (pointers, ints, the exp's flavour
#: and constants, stream), as csrc/<name>.cu defines them; each entry lives
#: in the library of its name.
ENTRY_ARGS = {
    "colored_multisweep": [_VP] * 17 + [_INT] * 6 + _EXP_ARGS + [_VP],
    "colored_multisweep_multi": [_VP] * 18 + [_INT] * 7 + _EXP_ARGS + [_VP],
    "metropolis_multisweep": [_VP] * 13 + [_INT] * 7 + _EXP_ARGS + [_VP],
    "metropolis_multisweep_multi": [_VP] * 13 + [_INT] * 7 + _EXP_ARGS + [_VP],
    "metropolis_sweep": [_VP] * 11 + [_INT] * 5 + _EXP_ARGS + [_VP],
    "mt_next_block": [_VP] * 3 + [_INT] * 2 + [_VP],
    "fastexp_2d": [_VP, _VP, ctypes.c_longlong, _INT, _INT] + [_U32] * 5 + [_VP],
    "sweep_exp_check": [_VP, _VP, ctypes.c_longlong] + _EXP_ARGS + [_VP],
    "pt_swap": [_VP] * 15 + [_INT] * 7 + _EXP_ARGS + [_VP],
}


def _same_device(dev: torch.device, **tensors) -> None:
    for what, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, spins on {dev}: one device, please")


def _check(t: torch.Tensor, what: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{what}: want contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _class_tables(classes, n: int) -> dict:
    """The structural class tables both colored kernels read: every class's
    entries concatenated in visit order, with offsets; each entry's site
    (row % n) and absolute neighbour rows; the tau source rows; the roll
    masks packed as bit 0 (down) | bit 1 (up).  An entry's tables are also
    those of its row's dense field refresh (`metropolis.lane_h_eff`)."""
    rows = np.concatenate([c.rows for c in classes])
    return {
        "off": np.concatenate([[0], np.cumsum([len(c.rows) for c in classes])]),
        "row": rows,
        "site": rows % n,
        "tgt": np.concatenate([c.space_tgt for c in classes]).reshape(-1),
        "down": np.concatenate([c.down_src for c in classes]),
        "up": np.concatenate([c.up_src for c in classes]),
        "roll": np.concatenate(
            [c.down_roll.astype(np.int32) | (c.up_roll.astype(np.int32) << 1) for c in classes]
        ),
    }


def _per_device(build):
    """``tables(device)``: ``build(device)`` run once per device, cached."""
    cache: dict = {}

    def tables(device: torch.device):
        key = str(device)
        if key not in cache:
            cache[key] = build(device)
        return cache[key]

    return tables


def _to_device(x, device) -> torch.Tensor:
    """A host table as a contiguous tensor on ``device`` (ints as int32)."""
    x = np.ascontiguousarray(x)
    if x.dtype.kind in "iu":
        x = x.astype(np.int32)
    return torch.from_numpy(x).to(device)


#: Warp groups of 128 threads in a colored kernel's CTA (1-8): the class
#: walk, the generator twist and the fixed cost are spread over all of them
#: (csrc/colored_sweep.cuh).  chip_smoke.py times other values.
COLORED_WARP_GROUPS = 8


def colored_smem_bytes(rows: int, sd: int, C: int, uniforms: bool) -> int:
    """Shared memory of one colored CTA, as csrc/colored_sweep.cuh's
    ``cb_smem_bytes`` lays it out (each part rounded up to 16 bytes): the
    (rows, 128) int8 spin tile; the staged class tables (C+1 offsets; per
    entry row, down, up, roll and ``sd`` targets as int32, h, tau and ``sd``
    couplings as float32); with ``uniforms``, a sweep's (rows, 128) float32
    uniforms."""
    def align16(x):
        return -(-x // 16) * 16

    tables = align16(4 * ((C + 1) + rows * (4 + sd) + rows * (2 + sd)))
    return align16(rows * LANES) + tables + (rows * LANES * 4 if uniforms else 0)


def _colored_max_rows(sd: int, C: int) -> int:
    """The largest rows whose spin tile and class tables fit `MAX_SMEM`."""
    most = MAX_SMEM // LANES
    while colored_smem_bytes(most, sd, C, uniforms=False) > MAX_SMEM:
        most -= 1
    return most


def colored_smem_plan(rows: int, sd: int, C: int, num_sweeps: int = 1) -> tuple[int, bool]:
    """``(shared-memory bytes, uniforms in shared memory)`` of a colored
    launch.  The spin tile and the class tables must fit in `MAX_SMEM`; a
    sweep's uniforms join them when they fit too, else they go to a
    device-memory scratch buffer (and a launch of 0 sweeps has none).
    Raises ValueError naming the largest ``rows`` the kernels take when the
    tile and tables do not fit."""
    base = colored_smem_bytes(rows, sd, C, uniforms=False)
    if base > MAX_SMEM:
        raise ValueError(
            f"rows={rows} needs {base} B of shared memory for the spin tile and class "
            f"tables (sd={sd}, C={C}); the colored kernels hold at most "
            f"{_colored_max_rows(sd, C)} rows ({MAX_SMEM} B)"
        )
    with_u = colored_smem_bytes(rows, sd, C, uniforms=True)
    if num_sweeps > 0 and with_u <= MAX_SMEM:
        return with_u, True
    return base, False


def _colored_io(name, spins, rng, beta, n: int, sd: int, C: int, entries: int, num_sweeps: int):
    """Check the colored kernels' replica inputs (CUDA tensors) against a
    lattice of ``entries`` class entries (one per row) and allocate their
    outputs: ``(spins, rng, B, rows, out_spins, out_hs, out_ht, out_rng,
    scratch)``.  ``spins`` and ``rng`` are the inputs, copied when they do
    not start on a 16-byte boundary; scratch holds a sweep's (rows, B*128)
    uniforms when they do not fit in shared memory (`colored_smem_plan`),
    else it is None."""
    dev = spins.device
    _need_cuda(name, dev)
    if spins.dim() != 3:
        raise ValueError(f"spins: want (B, rows, {LANES}), got {tuple(spins.shape)}")
    B, rows, _ = spins.shape
    _check(spins, "spins", torch.float32, (B, rows, LANES))
    _check(rng, "rng", torch.int32, (mt.N, B * LANES))
    _check(beta, "beta", torch.float32, (B,))
    _same_device(dev, rng=rng, beta=beta)
    if rows % n or rows // n < 2 or rows != entries:
        raise ValueError(f"rows={rows} is not the lane layout of the classes (n={n}, "
                         f"{entries} rows)")
    _, u_in_smem = colored_smem_plan(rows, sd, C, num_sweeps)
    # The kernels read spins and generator state in 16-byte words.
    spins, rng = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (spins, rng))
    scratch = (
        torch.empty((rows, B * LANES), dtype=torch.float32, device=dev)
        if num_sweeps > 0 and not u_in_smem
        else None
    )
    return (spins, rng, B, rows, torch.empty_like(spins), torch.empty_like(spins),
            torch.empty_like(spins), torch.empty_like(rng), scratch)


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
    csrc/colored_multisweep.cu (one CTA of 128 * `COLORED_WARP_GROUPS`
    threads per replica); on CPU tensors it runs
    `ref.colored_multisweep_ref`.
    """
    flavour = _flavour_code(exp_flavor)  # raises for unknown flavours
    classes = tuple(classes)
    host = {
        "h": np.asarray(h, np.float32),
        "base_nbr": np.asarray(base_nbr, np.int32),
        "base_J": np.asarray(base_J, np.float32),
        "tau_J": np.asarray(tau_J, np.float32),
    }
    sd = host["base_nbr"].shape[1]
    # The class coefficients gathered per class entry, beside the
    # structural tables.
    packed = _class_tables(classes, n)
    packed.update(
        h=np.concatenate([c.h for c in classes]),
        J=np.concatenate([c.space_J for c in classes]).reshape(-1),
        tau=np.concatenate([c.tau_J for c in classes]),
    )
    tables = _per_device(lambda device: {
        "classes": metropolis.classes_to(classes, device),
        "plain": {
            "h": _to_device(host["h"], device),
            "base_nbr": _to_device(host["base_nbr"], device).long(),
            "base_J": _to_device(host["base_J"], device),
            "tau_J": _to_device(host["tau_J"], device),
        },
        "kernel": {k: _to_device(v, device) for k, v in packed.items()},
    })

    def fn(spins, rng, beta, num_sweeps: int):
        num_sweeps = _sweeps(num_sweeps)
        dev = spins.device
        if dev.type == "cpu":
            t = tables(dev)
            return ref.colored_multisweep_ref(
                spins, rng, beta, t["classes"], **t["plain"], n=n,
                num_sweeps=num_sweeps, exp_flavor=exp_flavor,
            )
        spins, rng, B, rows, *out, scratch = _colored_io(
            "colored_multisweep", spins, rng, beta, n, sd, len(classes), len(packed["row"]),
            num_sweeps,
        )
        t = tables(dev)
        k = t["kernel"]
        with torch.cuda.device(dev):
            _launch(
                "colored_multisweep", dev,
                _ptr(spins), _ptr(rng), _ptr(beta), *(_ptr(o) for o in out), _ptr(scratch),
                _ptr(k["off"]), _ptr(k["row"]), _ptr(k["h"]), _ptr(k["J"]), _ptr(k["tgt"]),
                _ptr(k["tau"]), _ptr(k["down"]), _ptr(k["up"]), _ptr(k["roll"]),
                B, rows, sd, len(classes), num_sweeps, COLORED_WARP_GROUPS, flavour,
                *_EXP_CONSTS,
            )
        launches["colored_multisweep"] += 1
        return tuple(out)

    return fn


def make_colored_multisweep_multi(
    classes,  # tuple of reorder.ColorClass (host numpy) of any tenant
    base_nbr,  # (n, SD) int32, the shared topology
    n: int,
    exp_flavor: str = "fast",
):
    """Build the multi-tenant fused colored-sweep entry for one lattice:
    ``fn(spins, rng, beta, h_b, base_J_b, tau_J_b, num_sweeps) -> (spins,
    h_space, h_tau, rng)``.  Slot b sweeps with its own (UNDOUBLED) tables
    ``h_b[b]`` (n,), ``base_J_b[b]`` (n, SD), ``tau_J_b[b]`` (n,), float32
    and contiguous, bound onto the structural classes shared by every
    tenant; only the classes' structure is read, never their coefficients.
    The other arguments are as in `make_colored_multisweep`.  On CUDA
    tensors this launches the kernel of csrc/colored_multisweep_multi.cu
    (one CTA of 128 * `COLORED_WARP_GROUPS` threads per slot); on CPU
    tensors it runs `ref.colored_multisweep_multi_ref`.
    """
    flavour = _flavour_code(exp_flavor)  # raises for unknown flavours
    classes = tuple(classes)
    base_nbr = np.asarray(base_nbr, np.int32)
    sd = base_nbr.shape[1]
    packed = _class_tables(classes, n)
    tables = _per_device(lambda device: {
        "classes": metropolis.classes_to(classes, device),
        "base_nbr": _to_device(base_nbr, device).long(),
        "kernel": {k: _to_device(v, device) for k, v in packed.items()},
    })

    def fn(spins, rng, beta, h_b, base_J_b, tau_J_b, num_sweeps: int):
        num_sweeps = _sweeps(num_sweeps)
        dev = spins.device
        if dev.type == "cpu":
            t = tables(dev)
            return ref.colored_multisweep_multi_ref(
                spins, rng, beta, t["classes"], h_b, t["base_nbr"], base_J_b, tau_J_b, n=n,
                num_sweeps=num_sweeps, exp_flavor=exp_flavor,
            )
        spins, rng, B, rows, *out, scratch = _colored_io(
            "colored_multisweep_multi", spins, rng, beta, n, sd, len(classes),
            len(packed["row"]), num_sweeps,
        )
        _check(h_b, "h_b", torch.float32, (B, n))
        _check(base_J_b, "base_J_b", torch.float32, (B, n, sd))
        _check(tau_J_b, "tau_J_b", torch.float32, (B, n))
        _same_device(dev, h_b=h_b, base_J_b=base_J_b, tau_J_b=tau_J_b)
        k = tables(dev)["kernel"]
        with torch.cuda.device(dev):
            _launch(
                "colored_multisweep_multi", dev,
                _ptr(spins), _ptr(rng), _ptr(beta), *(_ptr(o) for o in out), _ptr(scratch),
                _ptr(k["off"]), _ptr(k["row"]), _ptr(k["site"]), _ptr(k["tgt"]),
                _ptr(k["down"]), _ptr(k["up"]), _ptr(k["roll"]), _ptr(h_b), _ptr(base_J_b),
                _ptr(tau_J_b),
                B, rows, n, sd, len(classes), num_sweeps, COLORED_WARP_GROUPS, flavour,
                *_EXP_CONSTS,
            )
        launches["colored_multisweep_multi"] += 1
        return tuple(out)

    return fn


# -----------------------------------------------------------------------------
# The a4 rung: fused multisweep (in-kernel MT19937) and one sweep per launch.
# -----------------------------------------------------------------------------

#: Most space neighbours a site may have on the a4 kernels
#: (csrc/a4_sweep.cuh: A4_MAX_SD).
A4_MAX_SD = 8
#: Rows of a walker's uniform ring in shared memory (csrc/a4_sweep.cuh).
A4_URING = 8
#: Most threads of an a4 CTA (csrc/a4_sweep.cuh: A4_MAX_THREADS): 4 walker
#: warps a replica, a lane a thread, and at least one generator warp.
A4_MAX_THREADS = 384


def a4_table_bytes(n: int, sd: int) -> int:
    """Bytes of one model's staged a4 tables: per site ``sd`` (target
    offset, J2) int32 pairs and one (tau2, same-cell mask) pair, rounded up
    to 16 (csrc/a4_sweep.cuh: a4_table_bytes)."""
    return -(-n * (sd + 1) * 8 // 16) * 16


def a4_smem_bytes(rows: int, n: int, sd: int, tile: int = 1, tables: int = 1,
                  fields: bool = True) -> int:
    """Shared memory of one a4 CTA of ``tile`` replicas, as
    csrc/a4_sweep.cuh's ``a4_smem_bytes`` lays it out: with ``fields``
    their (rows, 128) float32 h_space and h_tau, their int8 spins,
    ``tables`` staged tables, their (`A4_URING`, 128) float32 uniform
    rings and their (2, 128) float32 tau exchange buffers."""
    cells = tile * rows * LANES
    return ((8 * cells if fields else 0) + cells + tables * a4_table_bytes(n, sd)
            + tile * (A4_URING + 2) * LANES * 4)


def a4_smem_plan(rows: int, n: int, sd: int, tile: int = 1,
                 multi: bool = False) -> tuple[int, bool]:
    """``(shared-memory bytes, fields in shared memory)`` of an a4 launch
    of ``tile`` replicas a CTA.  The fields join the spins and tables in
    shared memory when they fit; a single replica keeps them in device
    memory otherwise, a tile of several must fit them.  Raises ValueError
    naming the limit when the launch does not fit."""
    if sd > A4_MAX_SD:
        raise ValueError(f"sd={sd}: the a4 kernels take at most {A4_MAX_SD} space neighbours")
    if 4 * tile + 1 > A4_MAX_THREADS // 32:
        raise ValueError(f"replica_tile {tile} leaves no generator warp in a CTA of "
                         f"{A4_MAX_THREADS} threads")
    tables = tile if multi else 1
    with_fields = a4_smem_bytes(rows, n, sd, tile, tables, fields=True)
    if with_fields <= MAX_SMEM:
        return with_fields, True
    if tile > 1:
        raise ValueError(
            f"replica_tile {tile} at rows={rows} needs {with_fields} B of shared memory for "
            f"its replicas' fields, spins and tables; the a4 kernels hold at most "
            f"{_a4_max_rows(n, sd, tile, multi)} rows a replica at that tile "
            f"({MAX_SMEM} B)"
        )
    base = a4_smem_bytes(rows, n, sd, 1, 1, fields=False)
    if base > MAX_SMEM:
        raise ValueError(
            f"rows={rows} needs {base} B of shared memory for the spin tile and tables "
            f"(n={n}, sd={sd}); the a4 kernels hold at most "
            f"{_a4_max_rows(n, sd, 1, multi)} rows ({MAX_SMEM} B)"
        )
    return base, False


def _a4_max_rows(n: int, sd: int, tile: int, multi: bool) -> int:
    """The largest rows an a4 CTA of ``tile`` replicas takes on a lattice
    of ``n`` sites (a single replica with its fields in device memory)."""
    tables = tile if multi else 1
    fixed = a4_smem_bytes(0, n, sd, tile, tables, fields=tile > 1)
    per_row = a4_smem_bytes(1, n, sd, tile, tables, fields=tile > 1) - fixed
    return max(0, (MAX_SMEM - fixed) // per_row)


def check_kernel_rows(rung: str, rows: int, n: int, sd: int, C: int = 0,
                      replica_tile: int = 1, multi: bool = False) -> int:
    """The largest lane rows ``rung``'s kernels take on a lattice of ``n``
    sites with ``sd`` space neighbours and ``C`` color classes, or a
    ValueError naming it when ``rows`` is past it (or the replica tile
    does not fit); the check `SweepEngine.create` makes for
    ``backend="cuda"``, before any launch.  cb holds its spin tile and
    class tables in shared memory (`colored_smem_plan`); a4 its spins and
    tables, and the fields of a tile of several replicas
    (`a4_smem_plan`)."""
    if rung == "cb":
        colored_smem_plan(rows, sd, C)
        return _colored_max_rows(sd, C)
    a4_smem_plan(rows, n, sd, replica_tile, multi)
    return _a4_max_rows(n, sd, replica_tile, multi)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it does not start on a 16-byte boundary
    (the a4 kernels read spins, fields and generator state in 16-byte words)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _a4_inputs(name, spins, h_space, h_tau, base_nbr, base_J2, tau_J2, beta, n: int,
               per_slot: bool = False, tile: int = 1):
    """Check the a4 kernels' common inputs (CUDA tensors) and plan their
    CTA (`a4_smem_plan`); returns ``(B, rows, sd)``.  ``per_slot``: the
    coupling tables carry a leading batch dimension (the multi-tenant
    kernel)."""
    dev = spins.device
    _need_cuda(name, dev)
    if spins.dim() != 3:
        raise ValueError(f"spins: want (B, rows, {LANES}), got {tuple(spins.shape)}")
    B, rows, _ = spins.shape
    for what, t in (("spins", spins), ("h_space", h_space), ("h_tau", h_tau)):
        _check(t, what, torch.float32, (B, rows, LANES))
    if rows % n or rows // n < 2:
        raise ValueError(f"rows={rows} is not a lane layout of n={n}")
    if tile < 1 or B % tile:
        raise ValueError(f"replica_tile {tile} must divide batch {B}")
    sd = base_nbr.shape[-1] if base_nbr.dim() == 2 else -1
    _check(base_nbr, "base_nbr", torch.int32, (n, sd))
    a4_smem_plan(rows, n, sd, tile, per_slot)  # raises naming the limit
    lead = (B,) if per_slot else ()
    _check(base_J2, "base_J2", torch.float32, (*lead, n, sd))
    for what, t, shape in (("tau_J2", tau_J2, (*lead, n)), ("beta", beta, (B,))):
        _check(t, what, torch.float32, shape if t.dim() == len(shape) else (*shape, 1))
    _same_device(dev, h_space=h_space, h_tau=h_tau, base_nbr=base_nbr, base_J2=base_J2,
                 tau_J2=tau_J2, beta=beta)
    return B, rows, sd


def _a4_fused(name, per_slot, spins, h_space, h_tau, rng, base_nbr, base_J2, tau_J2, beta,
              n: int, num_sweeps: int, flavour: int, replica_tile):
    """Launch a fused a4 kernel (#3, or #4 with ``per_slot`` tables) with,
    when there are sweeps to run, a scratch of each replica's uniforms of
    two sweeps, (B, 2, rows, 128); returns ``(spins, h_space, h_tau,
    rng)``."""
    tile = 1 if replica_tile is None else int(replica_tile)
    B, rows, sd = _a4_inputs(name, spins, h_space, h_tau, base_nbr, base_J2, tau_J2, beta, n,
                             per_slot=per_slot, tile=tile)
    _check(rng, "rng", torch.int32, (mt.N, B * LANES))
    _same_device(spins.device, rng=rng)
    spins, h_space, h_tau, rng = (_aligned(t) for t in (spins, h_space, h_tau, rng))
    out = (torch.empty_like(spins), torch.empty_like(h_space), torch.empty_like(h_tau),
           torch.empty_like(rng))
    scratch = (torch.empty((B, 2, rows, LANES), dtype=torch.float32, device=spins.device)
               if num_sweeps > 0 else None)
    with torch.cuda.device(spins.device):
        _launch(
            name, spins.device,
            _ptr(spins), _ptr(h_space), _ptr(h_tau), _ptr(rng), _ptr(base_nbr),
            _ptr(base_J2), _ptr(tau_J2), _ptr(beta), *(_ptr(t) for t in out), _ptr(scratch),
            B, rows, n, sd, num_sweeps, MAX_SMEM, tile, flavour, *_EXP_CONSTS,
        )
    launches[name] += 1
    return out


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
    replica_tile: int | None = None,
):
    """``num_sweeps`` fused a4 sweeps of every replica, MT19937 in the
    kernel (csrc/metropolis_multisweep.cu: ``replica_tile`` replicas a CTA,
    default 1, each walked by its own 4 warps beside the CTA's generator
    warps); the fields are carried and updated incrementally.  Returns
    ``(spins, h_space, h_tau, rng)``; the inputs are not modified.  On CPU
    tensors this runs `ref.metropolis_multisweep_ref` (any tile: the
    results do not depend on it)."""
    num_sweeps = _sweeps(num_sweeps)
    flavour = _flavour_code(exp_flavor)
    dev = spins.device
    if dev.type == "cpu":
        return ref.metropolis_multisweep_ref(
            spins, h_space, h_tau, rng, base_nbr, base_J2, tau_J2, beta, n, num_sweeps,
            exp_flavor,
        )
    return _a4_fused("metropolis_multisweep", False, spins, h_space, h_tau, rng, base_nbr,
                     base_J2, tau_J2, beta, n, num_sweeps, flavour, replica_tile)


def metropolis_multisweep_multi(
    spins,  # (B, rows, 128) f32 of +-1
    h_space,  # (B, rows, 128) f32
    h_tau,  # (B, rows, 128) f32
    rng,  # (624, B*128) int32: the interlaced MT19937 state, uint32 bits
    base_nbr,  # (n, SD) int32 in-layer neighbour site ids, the shared topology
    base_J2_b,  # (B, n, SD) f32, each slot's own couplings, pre-doubled
    tau_J2_b,  # (B, n) or (B, n, 1) f32, each slot's own tau couplings, pre-doubled
    beta,  # (B,) or (B, 1) f32
    n: int,
    num_sweeps: int,
    exp_flavor: str = "fast",
    replica_tile: int | None = None,
):
    """`metropolis_multisweep` where slot b sweeps its own model's tables
    ``base_J2_b[b]``, ``tau_J2_b[b]`` (csrc/metropolis_multisweep_multi.cu).
    Returns ``(spins, h_space, h_tau, rng)``; the inputs are not modified.
    On CPU tensors this runs `ref.metropolis_multisweep_multi_ref`."""
    num_sweeps = _sweeps(num_sweeps)
    flavour = _flavour_code(exp_flavor)
    dev = spins.device
    if dev.type == "cpu":
        return ref.metropolis_multisweep_multi_ref(
            spins, h_space, h_tau, rng, base_nbr, base_J2_b, tau_J2_b, beta, n, num_sweeps,
            exp_flavor,
        )
    return _a4_fused("metropolis_multisweep_multi", True, spins, h_space, h_tau, rng, base_nbr,
                     base_J2_b, tau_J2_b, beta, n, num_sweeps, flavour, replica_tile)


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
    flavour = _flavour_code(exp_flavor)
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
    spins, h_space, h_tau, u = (_aligned(t) for t in (spins, h_space, h_tau, u))
    out = [torch.empty_like(spins), torch.empty_like(h_space), torch.empty_like(h_tau)]
    with torch.cuda.device(dev):
        _launch(
            "metropolis_sweep", dev,
            _ptr(spins), _ptr(h_space), _ptr(h_tau), _ptr(u), _ptr(base_nbr), _ptr(base_J2),
            _ptr(tau_J2), _ptr(beta), *(_ptr(t) for t in out), B, rows, n, sd, MAX_SMEM,
            flavour, *_EXP_CONSTS,
        )
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
    if state.dim() != 2 or state.shape[1] < 1 or mt.N * state.shape[1] >= 2**31:
        raise ValueError(f"state: want ({mt.N}, V) with 1 <= V < 2^31 / {mt.N}, "
                         f"got {tuple(state.shape)}")
    V = state.shape[1]
    _check(state, "state", torch.int32, (mt.N, V))
    new = torch.empty_like(state)
    out = torch.empty(state.shape, dtype=torch.float32 if uniforms else torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("mt_next_block", dev, _ptr(state), _ptr(new), _ptr(out), V, int(uniforms),
                what=name)
    launches["mt_next_block"] += 1
    return new, out


def mt_next_block(state: torch.Tensor):
    """Advance the (624, V) interlaced state by one block: ``(new_state,
    tempered words)``, int32 storage of uint32 bits.  One launch of
    csrc/mt_next_block.cu (any V >= 1); on CPU tensors
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


# -----------------------------------------------------------------------------
# The parallel-tempering swap phase (csrc/pt_swap.cu).
# -----------------------------------------------------------------------------

#: Terms a warp of the swap phase's energy kernel sums at once (csrc/pt_swap.cu: TASK).
PT_SWAP_TASK = 128


def pt_swap_smem_bytes(rows: int, V: int) -> int:
    """Shared memory of one energy CTA of `pt_swap` (csrc/pt_swap.cu:
    energy_smem_bytes): a float64 sum per task of `PT_SWAP_TASK` terms,
    zero-padded to a power of two."""
    tasks = -(-rows * V // PT_SWAP_TASK)
    return 8 * (1 << max(tasks - 1, 0).bit_length())


def pt_swap(
    spins,  # (B, rows, V) f32: a block of replica slots
    betas,  # (B,) f32
    rows,  # (R,) int32: the ladder's rows of the block, in replica order
    swap_rng,  # (624,) int32: the ladder's scalar MT19937, uint32 bits
    swap_accept,  # () int32
    swap_propose,  # () int32
    base_nbr,  # (n, SD) int64
    base_J,  # (n, SD) f32, NOT doubled
    tau_J,  # (n,) f32, NOT doubled
    h,  # (n,) f32
    n: int,
    swap_parity: int,
    exp_flavor: str = "fast",
):
    """One even/odd round of adjacent-temperature swap proposals of the
    ladder whose replica r lies at row ``rows[r]`` of the block, read in
    place (`tempering.swap_phase` on those rows).  Returns ``(energies (R,),
    betas (B,), swap_rng, swap_accept, swap_propose)``: new tensors, the
    block's betas with the accepted pairs swapped; the inputs are not
    modified.  On CUDA tensors this is one host call of
    csrc/pt_swap.cu (an energy kernel of one CTA a replica, then a decision
    kernel of one CTA), with no host round trip; on CPU tensors it runs
    `ref.pt_swap_ref`."""
    flavour = _flavour_code(exp_flavor)
    parity = int(swap_parity)
    if parity not in (0, 1):
        raise ValueError(f"swap_parity must be 0 or 1, got {swap_parity}")
    dev = spins.device
    if dev.type == "cpu":
        return ref.pt_swap_ref(spins, betas, rows, swap_rng, swap_accept, swap_propose, base_nbr,
                               base_J, tau_J, h, n, parity, exp_flavor)
    _need_cuda("pt_swap", dev)
    if spins.dim() != 3 or rows.dim() != 1 or base_nbr.dim() != 2:
        raise ValueError(f"want spins (B, rows, V), rows (R,), base_nbr (n, SD); got "
                         f"{tuple(spins.shape)}, {tuple(rows.shape)}, {tuple(base_nbr.shape)}")
    B, lane_rows, V = spins.shape
    R, sd = rows.shape[0], base_nbr.shape[1]
    _check(spins, "spins", torch.float32, (B, lane_rows, V))
    _check(betas, "betas", torch.float32, (B,))
    _check(rows, "rows", torch.int32, (R,))
    _check(swap_rng, "swap_rng", torch.int32, (mt.N,))
    _check(swap_accept, "swap_accept", torch.int32, ())
    _check(swap_propose, "swap_propose", torch.int32, ())
    _check(base_nbr, "base_nbr", torch.int64, (n, sd))
    _check(base_J, "base_J", torch.float32, (n, sd))
    _check(tau_J, "tau_J", torch.float32, (n,))
    _check(h, "h", torch.float32, (n,))
    _same_device(dev, betas=betas, rows=rows, swap_rng=swap_rng, swap_accept=swap_accept,
                 swap_propose=swap_propose, base_nbr=base_nbr, base_J=base_J, tau_J=tau_J, h=h)
    if not 1 <= R <= B or lane_rows % n or lane_rows < n:
        raise ValueError(f"a ladder of {R} replicas on {B} slots of {lane_rows} rows, n={n}: "
                         "want 1 <= R <= B and rows a multiple of n")
    if pt_swap_smem_bytes(lane_rows, V) > MAX_SMEM:
        most = (1 << ((MAX_SMEM // 8).bit_length() - 1)) * PT_SWAP_TASK
        raise ValueError(f"pt_swap sums at most {most} terms a replica; got rows * V = "
                         f"{lane_rows * V}")
    out = (torch.empty(R, dtype=torch.float32, device=dev), torch.empty_like(betas),
           torch.empty_like(swap_rng), torch.empty_like(swap_accept),
           torch.empty_like(swap_propose))
    with torch.cuda.device(dev):
        _launch(
            "pt_swap", dev,
            _ptr(spins), _ptr(betas), _ptr(rows), _ptr(swap_rng), _ptr(swap_accept),
            _ptr(swap_propose), _ptr(h), _ptr(base_nbr), _ptr(base_J), _ptr(tau_J),
            *(_ptr(o) for o in out), B, R, lane_rows, V, n, sd, parity, flavour, *_EXP_CONSTS,
        )
    launches["pt_swap"] += 1
    return out


# -----------------------------------------------------------------------------
# The paper's bit-trick exp (csrc/fastexp_2d.cu).
# -----------------------------------------------------------------------------

#: Input dtypes of `fastexp` and their codes in csrc/fastexp_2d.cu.
_FASTEXP_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def fastexp(x: torch.Tensor, flavor: str = "fast") -> torch.Tensor:
    """The bit-trick exp of every element of ``x`` (any shape; float32,
    float16 or bfloat16), as float32 of the same shape.  ``flavor`` is
    "fast" or "accurate".  On a CUDA tensor this is one launch of
    csrc/fastexp_2d.cu; on a CPU tensor it runs `ref.fastexp_ref`.

    Any other flavour raises ValueError.  The reference's kernel runs its
    "accurate" body for every flavour but "fast", "exact" included; the
    exact exp has no bit trick to run, so here it is refused.
    """
    ref.check_fastexp_flavor(flavor)
    if x.dtype not in _FASTEXP_DTYPES:
        raise ValueError(f"fastexp takes {tuple(_FASTEXP_DTYPES)} input, got {x.dtype}")
    dev = x.device
    if dev.type == "cpu":
        return ref.fastexp_ref(x, flavor)
    _need_cuda("fastexp_2d", dev)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _launch(
            "fastexp_2d", dev,
            _ptr(x), _ptr(out), x.numel(), _FASTEXP_DTYPES[x.dtype], int(flavor == "accurate"),
            *_EXP_CONSTS,
        )
    launches["fastexp_2d"] += 1
    return out


def _sweep_exp_check(x: torch.Tensor, exp_flavor: str) -> torch.Tensor:
    """The sweep kernels' exp ``sweep_exp<exp_flavor>`` of every element of
    the contiguous float32 CUDA tensor ``x`` (csrc/sweep_exp_check.cu): a
    check of the exp that #1-#5 decide with, run on the card over all
    float32 inputs.  Not a kernel of any path, and not counted."""
    flavour = _flavour_code(exp_flavor)
    _need_cuda("sweep_exp_check", x.device)
    _check(x, "x", torch.float32, x.shape)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("sweep_exp_check", x.device, _ptr(x), _ptr(out), x.numel(), flavour,
                *_EXP_CONSTS)
    return out


def make_kernel_inputs(m: ising.LayeredModel, batch: int, *, seed: int = 0, device="cuda"):
    """``(spins, h_space, h_tau, u, base_nbr, base_J2, tau_J2, beta)`` for
    `metropolis_sweep` on ``batch`` replicas of ``m`` in the 128-lane
    layout, on ``device``: the JAX reference's inputs from the same numpy
    seeds (replica b from ``init_spins(m, seed * 131 + b)``, the uniforms
    from ``default_rng(seed)``), the tables as the kernels take them."""
    reorder.check_lane_shape(m.n, m.L, LANES)
    states = [metropolis.make_lane_state(m, ising.init_spins(m, seed=seed * 131 + b), LANES, device)
              for b in range(batch)]
    spins, hs, ht = (torch.stack([s[i] for s in states]) for i in range(3))
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random(tuple(spins.shape), dtype=np.float32)).to(device)
    return (
        spins,
        hs,
        ht,
        u,
        _to_device(m.space_nbr, device),
        _to_device(np.asarray(2.0 * m.space_J, np.float32), device),
        _to_device(np.asarray(2.0 * m.tau_J, np.float32), device),
        torch.full((batch,), m.beta, dtype=torch.float32, device=device),
    )
