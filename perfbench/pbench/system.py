"""The system under test: `repro_torch.serve_mc.SampleServer`, built from a
configuration file, and its jobs, built from traffic specs.

This is the only module of the harness that imports the program.
"""

from __future__ import annotations

import numpy as np


def build_server(cfg: dict, model_arrays, **overrides):
    """A `SampleServer` over the model ``model_arrays`` (the reference's
    `Model`), with the configuration's ``server`` settings (`ServeConfig`
    fields) and ``overrides`` (the CPU rehearsal's backend, device, V)."""
    from repro_torch.core import ising
    from repro_torch.serve_mc import SampleServer

    m = model_arrays
    model = ising.LayeredModel(n=m.n, L=m.L, h=m.h, space_nbr=m.space_nbr,
                               space_J=m.space_J, tau_J=m.tau_J)
    kwargs = dict(cfg["server"])
    kwargs.setdefault("V", cfg["lanes"])
    kwargs.setdefault("exp_flavor", cfg["exp_flavor"])
    kwargs.update(overrides)
    return SampleServer(model, **kwargs)


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
    """The server's counters that the metrics read, and its launches by chunk."""
    tel = server.telemetry
    out = {name: tel.value(name) for name in (
        "serve.launches", "serve.sweeps_elapsed", "serve.busy_slot_sweeps",
        "serve.jobs_completed")}
    out["launches_by_chunk"] = {int(lab["chunk"]): int(v)
                                for lab, v in tel.series("serve.launches_by_chunk")}
    return out


def shapes(server) -> dict:
    eng = server.engine
    return {"rung": eng.rung, "slots": server.slots, "rows": eng.rows,
            "sd": int(eng.model.space_degree), "lanes": eng.V}
