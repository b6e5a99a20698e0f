"""Meshes: the LM's production and host meshes, and the slot mesh.

The LM's meshes are ``torch.distributed`` ``DeviceMesh``es over the world
the caller initialised (``init_process_group``): a fake world for the dry
run, a gloo world for the CPU tests, one NCCL rank on the card.  They are
functions, never module-level values, and none initialises a world.
Production target (the reference's): 16x16 = 256 chips a pod,
``("data", "model")``; the multi-pod mesh adds a leading ``"pod"`` axis
(2 pods = 512 chips).  Batch shards over ``("pod", "data")``;
tensor/expert parallelism over ``"model"``; ``"pod"`` also carries the
compressed gradient sync (`train.step`).

The slot mesh is the devices a `SweepEngine`'s slot pool is laid out over.

A `SlotMesh` is a frozen tuple of `torch.device` with one axis, "data"
(``mesh.shape == {"data": D}``, the reference's slot-mesh shape): replica
slots are split into contiguous per-device blocks (``capacities=[...]``
on the engine or server says how many each device owns; the default is
the equal ``batch / D`` split) and every launch runs the unmodified
single-device sweep body once per device, on that device's own stream.

An entry may repeat: ``SlotMesh(("cuda:0",) * 4)`` is four LOGICAL
devices on one card (four blocks, four streams), ``SlotMesh(("cpu",) *
4)`` four on the host.  They take the part of the reference's forced host
devices (``--xla_force_host_platform_device_count``): the whole mesh path
runs, and D devices give the results of one, bit for bit.  A mesh is
always built by the caller; nothing falls back to one.

  mesh = make_slot_mesh(4, device="cpu")          # four logical host devices
  mesh = make_slot_mesh(torch.cuda.device_count())  # every visible card
"""

from __future__ import annotations

import torch


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first ranks of
    the initialised world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs an initialised process group "
                         f"(torch.distributed.init_process_group) of at least {shape} ranks")
    n = 1
    for k in shape:
        n *= k
    if dist.get_world_size() < n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has {dist.get_world_size()}")
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device="cpu"):
    """A small ``("data", "model")`` mesh over the first ``data * model`` ranks."""
    return make_mesh((data, model), ("data", "model"), device)


def mesh_devices_required(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


class SlotMesh(tuple):
    """A frozen tuple of devices with the one axis ``"data"``."""

    def __new__(cls, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a slot mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a slot mesh's devices share one type; got {[str(d) for d in devs]}")
        return super().__new__(cls, devs)

    @property
    def shape(self) -> dict:
        return {"data": len(self)}

    @property
    def devices(self) -> tuple:
        return tuple(self)

    def __repr__(self) -> str:
        return f"SlotMesh({[str(d) for d in self]})"


def make_slot_mesh(data: int | None = None, device="cuda") -> SlotMesh:
    """A `SlotMesh` over the first ``data`` visible devices of ``device``'s
    type (``data=None``: all of them).  On the card these are ``cuda:0``,
    ``cuda:1``, ...; raises the reference's ``"{data} devices requested,
    {n} visible"`` when fewer are visible.  On the host (``device="cpu"``)
    it is ``data`` logical entries of ``cpu`` (one for ``None``), the
    counterpart of the reference's forced host devices."""
    kind = torch.device(device).type
    if kind != "cuda":  # the host has no device count: as many as asked for
        return SlotMesh((kind,) * (1 if data is None else int(data)))
    n = torch.cuda.device_count()
    if data is None:
        data = n
    if data > n:
        raise ValueError(f"make_slot_mesh: {data} devices requested, {n} visible")
    return SlotMesh(f"{kind}:{i}" for i in range(int(data)))
