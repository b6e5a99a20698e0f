"""Find an open-loop cell's knee: the highest arrival rate it sustains
without a growing queue.  One server, the rates in the order given, each
for ``--seconds``; one JSON line a rate on stdout.

    python3 perfbench/knee.py --workload cb-anneal-short --seed 1 --seconds 8 --rates 100,200,300

A rate is sustained when the window retires at least 97% of what it
offered and leaves no more than half a second of arrivals in the server.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

import numpy as np  # noqa: E402

from pbench import spec as specmod, system, window  # noqa: E402
from pbench.traffic import Traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True, help="comma-separated jobs/s")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("knee.py measures on a CUDA device", file=sys.stderr)
        return 2
    spec = specmod.Spec()
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    ref = spec.reference(cfg)
    server = system.build_server(cfg, ref.make_model(cfg, args.seed))
    for s in system.warmup_specs(Traffic(mix, args.seed, args.seconds, cfg)):
        server.submit(system.make_job(s))
    server.drain()
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        traffic = Traffic(dict(mix, rate_per_s=rate), args.seed + i, args.seconds, cfg)
        rec = window.run(server, traffic, args.seconds, grace_s=0.0)
        jobs = [r for r in rec["jobs"].values()]
        done = [r for r in jobs if r["done"] is not None and r["done"] <= rec["t1"]]
        lat = np.asarray([r["done"] - r["due"] for r in done])
        backlog = len(jobs) - len(done)
        print(json.dumps({
            "rate_per_s": rate, "offered": len(jobs), "retired": len(done), "backlog_at_close": backlog,
            "p50_s": float(np.percentile(lat, 50)) if len(lat) else None,
            "p95_s": float(np.percentile(lat, 95)) if len(lat) else None,
            "sustained": len(done) >= 0.97 * len(jobs) and backlog <= 0.5 * rate,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        server.drain()  # what the window left behind, before the next rate
    return 0


if __name__ == "__main__":
    sys.exit(main())
