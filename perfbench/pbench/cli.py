"""One run of one cell: set up, warm up, measure, check, print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (and ``breakdown``).  The run needs as many CUDA devices as
the cell asks for; without them it prints no result and exits 2.  It exits
3, with no result, if the process has loaded JAX or the JAX package.
``--control`` (not a driver's run) puts the reference computed one
precision below the configuration's (bfloat16 for float32) in the
program's place: its ``correct`` has to come out false.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time

from pbench import check, readers, spec as specmod, system, window
from pbench.traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Trace events the traced run keeps (the scheduler's spans over the window).
TRACE_EVENTS = 2_000_000
PROFILE_S = 4.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _spans(tel) -> dict:
    """Every sync span of the telemetry ring, by name, in host seconds."""
    base = time.perf_counter() - tel.now_us() * 1e-6
    out: dict = {}
    open_: dict = {}
    for ev in tel.events():
        key = (ev["tid"], ev["name"])
        if ev["ph"] == "B":
            open_.setdefault(key, []).append(ev["ts"])
        elif ev["ph"] == "E" and open_.get(key):
            a = open_[key].pop()
            out.setdefault(ev["name"], []).append((base + a * 1e-6, base + ev["ts"] * 1e-6))
    return out


def _device(devs: list) -> dict:
    """The result's ``device``: the cards the engine spans, their count and
    the peak device memory of the fullest (the host: count 1, no memory)."""
    import torch

    if devs[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]), "count": len(devs),
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(d)) for d in devs)}


def _synchronize(devs: list) -> None:
    import torch

    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _breakdown(record: dict) -> dict | None:
    from pbench.trace import clip, intersection, union

    dev = record.get("device")
    if not dev:
        return None
    t0, t1 = dev["t0"], dev["t1"]
    ops = sorted(dev["kernels_by_name"].items(), key=lambda kv: -kv[1])[:10]
    ops = [(k if len(k) <= 120 else k[:117] + "...", v) for k, v in ops]
    gaps, prev = [], t0
    for a, b in dev["busy"]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    spans = record.get("spans", {})
    seg = union(clip(record.get("segments", []), t0, t1))
    admit = union(clip(spans.get("sched.admit", []), t0, t1))
    steps = union(clip(spans.get("sched.step", []), t0, t1))
    total = sum(b - a for a, b in gaps)
    in_seg, in_admit, in_step = (intersection(gaps, u) for u in (seg, admit, steps))
    idle = {"pt.on_segment": in_seg, "sched.admit": in_admit,
            "sched.step other": in_step - in_seg - in_admit,
            "outside sched.step": total - in_step}
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items() if v > 0), key=lambda kv: -kv[1])}


def run_cell(spec: specmod.Spec, workload: str, seed: int, seconds: float, trace: bool, *,
             cpu: bool = False, control: bool = False, fault=None, step_hook=None,
             t_start: float | None = None, grace_s: float = 60.0, out_dir=None,
             mix_over: dict | None = None, log=sys.stderr) -> dict:
    """Run one cell once and return its result object.  ``cpu`` is the
    rehearsal on the host: the configuration's and the mix's
    ``cpu_rehearsal`` sizes, the program's plain backend.  ``fault(server)``
    breaks the program underneath and ``mix_over`` changes the mix (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if cpu:
        cfg = specmod.merged(cfg, cfg.get("cpu_rehearsal", {}))
        mix = specmod.merged(mix, mix.get("cpu_rehearsal", {}))
    mix = specmod.merged(mix, mix_over or {})
    ref = spec.reference(cfg)
    model = ref.make_model(cfg, seed)
    over = {"backend": "torch", "device": "cpu"} if cpu else {}
    if trace:
        from repro_torch.obs import Telemetry

        over["telemetry"] = Telemetry(enabled=True, max_events=TRACE_EVENTS)
    server = system.build_server(cfg, model, **over)
    shapes = system.shapes(server)
    devs = system.devices(server)
    cuda = devs[0].type == "cuda"
    traffic = Traffic(mix, seed, seconds, cfg)
    out_dir = spec.dir / "out" if out_dir is None else out_dir
    tracer = None
    if trace:
        from pbench.trace import Window

        tracer = window.Tracer(min(PROFILE_S, seconds / 2),
                               lambda: Window(out_dir / f"{workload}.trace.json", devs))
        tracer.instrument(server)
    for s in system.warmup_specs(traffic):
        server.submit(system.make_job(s))
    server.drain()
    if tracer is not None:  # the profiler's own first start, outside the window
        w = tracer.factory()
        w.start()
        server.step()
        w.stop()
    if fault is not None:
        fault(server)
    _synchronize(devs)
    # The set-up's objects (the traffic's schedule among them) stay out of
    # the collector's scans inside the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s; {workload}: {shapes}", file=log)
    rec = window.run(server, traffic, seconds, grace_s=grace_s, tracer=tracer, step_hook=step_hook)
    gc.unfreeze()
    rec.update(setup_s=setup_s, wall_s=rec["t1"] - rec["t0"], shapes=shapes,
               cards=[d.index if d.type == "cuda" else d.type for d in devs])
    print(f"window {rec['wall_s']:.3f} s; the generator ran at most "
          f"{rec['generator_late_s']:.6f} s late", file=log)
    if tracer is not None:
        rec.update(spans=_spans(server.telemetry), segments=tracer.segments,
                   device=tracer.device, launches=tracer.launches,
                   events_dropped=server.telemetry.dropped_events)
    device = _device(devs)
    if tracer is not None and rec.get("device"):
        dev = rec["device"]
        print(f"trace: {dev['engine_ranges']} engine launches, their kernels "
              f"{dev['engine_kernel_s']:.6f} s, {len(dev['kernels_by_name'])} kernel names, "
              f"events dropped {rec['events_dropped']}", file=log)
        device["busy_s"] = statistics.fmean(readers.busy_by_card(rec))
        device["window_s"] = dev["t1"] - dev["t0"]
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    jids = check.sample(rec, mix, cfg, seed)
    results = rec["results"]
    answers = [check.served_answer(results[j]) if j in results else None for j in jids]
    specs = [rec["jobs"][j]["spec"] for j in jids]
    jobs_done = sum(1 for r in rec["jobs"].values() if r["done"] is not None and r["done"] <= rec["t1"])
    if rec["loop"] == "open":
        attempted = sum(1 for r in rec["jobs"].values() if r["due"] is not None)
        failed = sum(1 for r in rec["jobs"].values() if r["due"] is not None and r["done"] is None)
    else:
        attempted, failed = jobs_done, 0
    del server, results, rec["results"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_dev = "cuda" if cuda else "cpu"
    t_ref = time.perf_counter()
    expected = check.replay(ref, model, shapes, specs, ref_dev)
    if control:
        served = check.replay(ref, model, shapes, specs, ref_dev,
                              dtype=check.CONTROL[cfg["precision"]])
        answers = [a if a is None else s for a, s in zip(answers, served)]
    print(f"reference: {len(specs)} jobs in {time.perf_counter() - t_ref:.3f} s", file=log)
    nums = check.compare(answers, expected)
    # A job due in the window that never came back is missing, sampled or not.
    nums["missing"] = max(nums["missing"], failed)
    correct, table = check.verdict(nums, cfg["limits"], len(specs))
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device}
    if trace:
        bd = _breakdown(rec)
        if bd is not None:
            result["breakdown"] = bd
    result["checked_jobs"] = len(specs)
    result["checks"] = table
    return result


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None, t_start: float | None = None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the reference in bfloat16 in the program's place (must fail)")
    args = p.parse_args(argv)
    spec = specmod.Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = _finite(run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              control=args.control, t_start=t_start))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    check.report(result["checks"], result["checked_jobs"])
    print(json.dumps(result), flush=True)
    return 0
