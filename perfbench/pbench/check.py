"""Deciding ``correct``: the served results against the plain reference.

After the window, a sample drawn from the seed (``check_jobs`` of the
traffic mix, at most ``check_jobs_max`` of the configuration) of the
jobs due in the window (open loop) or retired in it (closed loop) is
replayed by the configuration's reference from what each user
submitted, and every served answer is compared with the replay.  In an
open loop every job due in the window that never retired is missing,
whether sampled or not.  The numbers compared, each against
its limit in the configuration's ``limits``:

``spin_mismatches``  spins that differ, over every checked job;
``energy_gap``       the largest |served energy - reference energy|;
``beta_mismatches``  final betas that differ (an anneal's last beta, a
                     ladder's betas after its last swap);
``swap_count_gap``   |accepted - reference| + |proposed - reference|
                     swaps over the checked ladders;
``missing``          jobs due in the window that never came back.

The control (``control=True``) puts the reference computed one precision
below the configuration's (`CONTROL`) in the program's place; it has to
fail.
"""

from __future__ import annotations

import sys

import numpy as np

NUMBERS = ("spin_mismatches", "energy_gap", "beta_mismatches", "swap_count_gap", "missing")
#: Jobs replayed together by the reference.
BATCH = 512
#: The precision a configuration states -> its control's.
CONTROL = {"float32": "bfloat16"}


def sample(record: dict, mix: dict, cfg: dict, seed: int) -> list[int]:
    """The jids to check, a sample drawn from the seed: in an open loop of
    the jobs due in the window, in a closed loop of those it retired."""
    jobs = record["jobs"]
    if record["loop"] == "open":
        pool = sorted((j for j, r in jobs.items() if r["due"] is not None),
                      key=lambda j: jobs[j]["index"])
    else:
        pool = sorted((j for j, r in jobs.items() if r["done"] is not None and r["done"] <= record["t1"]),
                      key=lambda j: jobs[j]["index"])
    want = mix.get("check_jobs", "all")
    cap = cfg.get("check_jobs_max")
    count = len(pool) if want == "all" else min(int(want), len(pool))
    if cap is not None:
        count = min(count, int(cap))
    if count >= len(pool):
        return pool
    pick = np.random.default_rng([int(seed), 4]).choice(len(pool), size=count, replace=False)
    return [pool[i] for i in sorted(pick)]


def replay(ref, model, shapes: dict, specs: list[dict], device, dtype="float32") -> list[dict]:
    """The reference's answers to ``specs``, in order."""
    out: list = [None] * len(specs)
    V, rung = shapes["lanes"], shapes["rung"]
    kinds: dict = {}
    for i, s in enumerate(specs):
        key = ("pt", len(s["betas"]), s["rounds"], s["sweeps_per_round"]) if s["kind"] == "pt" \
            else ("anneal",)
        kinds.setdefault(key, []).append(i)
    for key, idx in kinds.items():
        for lo in range(0, len(idx), BATCH):
            part = idx[lo:lo + BATCH]
            if key[0] == "pt":
                got = ref.ladders(model, V, rung, [specs[i] for i in part], device=device, dtype=dtype)
            else:
                got = ref.anneal(model, V, rung, [specs[i] for i in part], device=device, dtype=dtype)
            for i, g in zip(part, got):
                out[i] = g
    return out


def served_answer(result) -> dict:
    """A `JobResult` in the reference's terms."""
    ex = result.extras
    if "betas" in ex:
        return {"spins": np.asarray(result.spins), "energy": np.asarray(result.energy),
                "betas": np.asarray(ex["betas"], np.float32), "accept": ex["swap_accept"],
                "propose": ex["swap_propose"]}
    return {"spins": np.asarray(result.spins), "energy": np.asarray(result.energy),
            "final_beta": ex["final_beta"]}


def compare(answers: list, expected: list[dict]) -> dict:
    """The compared numbers over checked jobs; ``answers[i]`` None for a
    job that never came back."""
    nums = {k: 0 for k in NUMBERS}
    nums["energy_gap"] = 0.0
    for got, want in zip(answers, expected):
        if got is None:
            nums["missing"] += 1
            continue
        nums["spin_mismatches"] += int(np.count_nonzero(got["spins"] != want["spins"]))
        gap = float(np.max(np.abs(np.asarray(got["energy"], np.float64) - want["energy"])))
        nums["energy_gap"] = max(nums["energy_gap"], gap if gap == gap else float("inf"))
        if "betas" in want:
            nums["beta_mismatches"] += int(np.count_nonzero(got["betas"] != want["betas"]))
            nums["swap_count_gap"] += abs(got["accept"] - want["accept"]) + abs(
                got["propose"] - want["propose"])
        else:
            nums["beta_mismatches"] += int(np.float32(got["final_beta"]) != np.float32(want["final_beta"]))
    return nums


def verdict(nums: dict, limits: dict, checked: int) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number within its
    limit, and at least one job checked."""
    table = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS}
    ok = checked > 0 and all(v["value"] <= v["limit"] for v in table.values())
    return ok, table


def report(table: dict, checked: int, stream=sys.stderr) -> None:
    print(f"check: {checked} jobs compared with the reference", file=stream)
    for k, v in table.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=stream)
