"""The system under test: `repro_torch.serve_mc.SampleServer`, built from a
configuration file, and its jobs, built from traffic specs.

This is the only module of the harness that imports the program.
"""

from __future__ import annotations

import numpy as np


def build_server(cfg: dict, model_arrays, **overrides):
    """A `SampleServer` over the model ``model_arrays`` (the reference's
    `Model`), with the configuration's ``server`` settings (`ServeConfig`
    fields) and ``overrides`` (the CPU rehearsal's backend, device, V).
    The configuration's optional ``devices`` lays the slots out over a
    slot mesh (`slot_mesh`); ``server.capacities`` splits them over the
    mesh's devices, as any other `ServeConfig` field."""
    from repro_torch.core import ising
    from repro_torch.serve_mc import SampleServer

    m = model_arrays
    model = ising.LayeredModel(n=m.n, L=m.L, h=m.h, space_nbr=m.space_nbr,
                               space_J=m.space_J, tau_J=m.tau_J)
    kwargs = dict(cfg["server"])
    kwargs.setdefault("V", cfg["lanes"])
    kwargs.setdefault("exp_flavor", cfg["exp_flavor"])
    kwargs.update(overrides)
    if "devices" in cfg:
        kwargs["mesh"] = slot_mesh(cfg["devices"], kwargs.get("device", "cuda"))
    return SampleServer(model, **kwargs)


def slot_mesh(devices, device: str):
    """The slot mesh a configuration's ``devices`` names on ``device``'s
    type: an int D is the first D visible devices (`make_slot_mesh`, as
    ``anneal_serve --devices D``), a list names each device, so that
    ``["cuda:0"] * 4`` is four logical devices on one card.  Off the card
    (the CPU rehearsal) either gives as many logical host devices."""
    import torch
    from repro_torch.launch.mesh import SlotMesh, make_slot_mesh

    kind = torch.device(device).type
    if isinstance(devices, int):
        return make_slot_mesh(devices, device=kind)
    return SlotMesh(devices if kind == "cuda" else [kind] * len(devices))


def cuda_cards(devices) -> int:
    """How many distinct cards a configuration's ``devices`` names (1 when
    it names none: the server's one device)."""
    if devices is None:
        return 1
    if isinstance(devices, int):
        return devices
    import torch

    return len({torch.device(d).index or 0 for d in devices if torch.device(d).type == "cuda"})


def devices(server) -> list:
    """The distinct devices the server's engine spans, in mesh order, a
    card with its index (``cuda`` is the current card)."""
    import torch

    out = []
    for d in server.engine.mesh or [server.engine.device]:
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in out:
            out.append(d)
    return out


def make_job(spec: dict):
    """The service's job for a traffic spec."""
    from repro_torch.serve_mc import AnnealJob, PTJob

    if spec["kind"] == "anneal":
        return AnnealJob(spec["seed"], [(int(k), float(b)) for k, b in spec["schedule"]],
                         priority=spec["priority"], user=spec["user"])
    if spec["kind"] == "pt":
        return PTJob(spec["seed"], np.asarray(spec["betas"], np.float32), spec["rounds"],
                     spec["sweeps_per_round"], priority=spec["priority"], user=spec["user"])
    raise ValueError(f"unknown job kind {spec['kind']!r}")


def warmup_specs(traffic) -> list[dict]:
    """Small jobs of the kinds the traffic sends: an anneal job of two short
    segments (a beta rewrite between launches), or a ladder of the traffic's
    width for two rounds (the swap phase)."""
    first = traffic.jobs[0] if traffic.loop == "open" else traffic.spec(0)
    base = {"user": "warmup", "priority": 0}
    if first["kind"] == "pt":
        return [dict(base, kind="pt", seed=2**30 + 1, betas=first["betas"], rounds=2,
                     sweeps_per_round=first["sweeps_per_round"])]
    return [dict(base, kind="anneal", seed=2**30 + k, schedule=[[2, 0.5], [3, 1.0]])
            for k in range(2)]


def counters(server) -> dict:
    """Every counter series of the server's telemetry, read without
    waiting for the card: a scalar counter under its name, a labelled one
    under ``name{label=value,...}`` (`repro_torch.obs.metrics.snapshot`'s
    keys), and the launches by chunk as ``launches_by_chunk``."""
    from repro_torch.obs import metrics

    tel = server.telemetry
    out = dict(metrics.snapshot(tel)["counters"])
    out["launches_by_chunk"] = {int(lab["chunk"]): int(v)
                                for lab, v in tel.series("serve.launches_by_chunk")}
    return out


def shapes(server) -> dict:
    eng = server.engine
    return {"rung": eng.rung, "slots": server.slots, "rows": eng.rows,
            "sd": int(eng.model.space_degree), "lanes": eng.V}
