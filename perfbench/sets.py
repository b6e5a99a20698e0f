"""Measure a cell's spread: runs of ``run.py`` one after another, each a
process of its own, then each metric's median and quartile spread.

    python3 perfbench/sets.py --workload cb-pt115 --seeds 11,12,13,14,15,16 --sets 2 \
        --seconds 20 --out perfbench/out/cb-pt115.jsonl

Every set runs the same seeds in order.  A spread is (q3 - q1) / median
with the quartiles of ``statistics.quantiles(values, n=4)``; the bound a
metric can hold is about five times its widest spread over the sets.
``--summary FILE`` only summarizes lines written before.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q3 - q1) / abs(med) if med else float("inf")


def summarize(lines) -> dict:
    by: dict = {}
    for ln in lines:
        res = ln.get("result")
        if not res:
            continue
        for name, m in res["metrics"].items():
            by.setdefault((ln["workload"], name, ln["set"]), []).append(m["value"])
    out = {}
    for (w, name, s), vals in sorted(by.items()):
        if len(vals) >= 2:
            med, sp = spread(vals)
            out[f"{w} {name} set{s}"] = {"n": len(vals), "median": med, "spread": sp,
                                         "min": min(vals), "max": max(vals)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", default="")
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", type=Path)
    p.add_argument("--summary", type=Path)
    args = p.parse_args(argv)
    if args.summary:
        lines = [json.loads(x) for x in args.summary.read_text().splitlines() if x.strip()]
        print(json.dumps(summarize(lines), indent=1))
        return 0
    lines = []
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for s in range(args.sets):
        for seed in (int(x) for x in args.seeds.split(",")):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(HERE / "run.py"), "--workload", args.workload, "--seed",
                 str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True, cwd=HERE.parent)
            out = proc.stdout.strip().splitlines()
            try:
                res = json.loads(out[-1]) if out else None
            except json.JSONDecodeError:
                res = None
            ln = {"workload": args.workload, "set": s, "seed": seed, "trace": args.trace,
                  "rc": proc.returncode, "wall_s": time.perf_counter() - t, "result": res,
                  "stderr_tail": proc.stderr[-1500:] if proc.returncode or not res else
                  proc.stderr[-400:]}
            lines.append(ln)
            with args.out.open("a") as f:
                f.write(json.dumps(ln) + "\n")
            short = {k: round(v["value"], 6) for k, v in (res or {}).get("metrics", {}).items()}
            print(json.dumps({"set": s, "seed": seed, "rc": proc.returncode,
                              "wall_s": round(ln["wall_s"], 1),
                              "correct": (res or {}).get("correct"), "metrics": short}), flush=True)
    print(json.dumps(summarize(lines), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
