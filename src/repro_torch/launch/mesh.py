"""The slot mesh: the devices a `SweepEngine`'s slot pool is laid out over.

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
