"""The one generator of traffic: a mix file of parameters plus a seed.

Every seed of a mix gets the same work: the job shapes (budgets,
schedules, users, priorities) and, in an open loop, the arrival times
are drawn once from the mix's ``population_seed``.  The run's seed only
orders the shapes (which job arrives at which time) and gives every job
its own sampling seed; the arrivals stay where they are, so no seed
brings bursts of its own.

A job spec is a dict: ``{"kind": "anneal", "seed", "schedule": [[sweeps,
beta], ...], "user", "priority"}`` or ``{"kind": "pt", "seed", "betas",
"rounds", "sweeps_per_round", "user", "priority"}``.

Mix keys: ``loop`` ("open": ``rate_per_s`` Poisson arrivals; "closed":
``outstanding`` jobs in flight, a new one on each retirement); ``job``
(the job template, below); ``users`` ({name: share}); ``priority1_share``;
``population`` (closed loops: shapes drawn before the order repeats).
Anneal template: ``budget`` ({"uniform_int": [lo, hi]} or {"choice":
[...]}), times ``budget_unit`` sweeps (default 1), ``constant_beta``
[lo, hi], ``ramp_share``, ``ramp`` ({"beta": [start, end], "segments":
[lo, hi]}).  PT template: ``sweeps_per_round``, and ``replicas``,
``beta`` [lo, hi] (linear ladder) and ``rounds``, which default to the
configuration's ``num_models``, ``[beta_min, beta_max]`` and
``num_sweeps // sweeps_per_round``.
"""

from __future__ import annotations

import numpy as np

#: Job seeds stay below 2^31: the service seeds 32-bit generators with them.
SEED_SPAN = 2**31 - 1024


def _pt_template(job: dict, cfg: dict | None) -> dict:
    """The PT template with what it leaves out taken from the configuration."""
    cfg = cfg or {}
    out = dict(job)
    out.setdefault("replicas", cfg.get("num_models"))
    if "beta" not in out and "beta_min" in cfg:
        out["beta"] = [cfg["beta_min"], cfg["beta_max"]]
    if "rounds" not in out and "num_sweeps" in cfg:
        out["rounds"] = int(cfg["num_sweeps"]) // int(out["sweeps_per_round"])
    missing = [k for k in ("replicas", "beta", "rounds") if out.get(k) is None]
    if missing:
        raise ValueError(f"the PT template lacks {missing} and the configuration gives none")
    return out


def _shapes(mix: dict, count: int, rng: np.random.Generator, cfg: dict | None = None) -> list[dict]:
    job = mix["job"]
    users = list(mix["users"])
    shares = np.asarray([mix["users"][u] for u in users], np.float64)
    who = rng.choice(len(users), size=count, p=shares / shares.sum())
    prio = rng.random(count) < mix.get("priority1_share", 0.0)
    out = []
    if job["kind"] == "pt":
        job = _pt_template(job, cfg)
        lo, hi = job["beta"]
        betas = [float(b) for b in np.linspace(lo, hi, job["replicas"]).astype(np.float32)]
        for k in range(count):
            out.append({"kind": "pt", "betas": betas, "rounds": int(job["rounds"]),
                        "sweeps_per_round": int(job["sweeps_per_round"]),
                        "user": users[who[k]], "priority": int(prio[k])})
        return out
    if job["kind"] != "anneal":
        raise ValueError(f"unknown job kind {job['kind']!r}")
    b = job["budget"]
    if "uniform_int" in b:
        lo, hi = b["uniform_int"]
        budgets = rng.integers(lo, hi + 1, size=count)
    else:
        budgets = rng.choice(np.asarray(b["choice"]), size=count)
    budgets = budgets * int(job.get("budget_unit", 1))
    ramp = rng.random(count) < job.get("ramp_share", 0.0)
    blo, bhi = job["constant_beta"]
    beta = rng.uniform(blo, bhi, size=count)
    slo, shi = job["ramp"]["segments"] if "ramp" in job else (1, 1)
    segs = rng.integers(slo, shi + 1, size=count)
    for k in range(count):
        total = int(budgets[k])
        if ramp[k]:
            s = int(min(segs[k], total))
            parts = [total // s + (1 if i < total % s else 0) for i in range(s)]
            b0, b1 = job["ramp"]["beta"]
            sched = [[p, float(x)] for p, x in zip(parts, np.linspace(b0, b1, s))]
        else:
            sched = [[total, float(beta[k])]]
        out.append({"kind": "anneal", "schedule": sched, "user": users[who[k]],
                    "priority": int(prio[k])})
    return out


class Traffic:
    """One run's traffic: ``open`` (a list of specs with ``due`` seconds
    from the window's start) or ``closed`` (`spec(k)`, ``outstanding``)."""

    def __init__(self, mix: dict, seed: int, seconds: float, config: dict | None = None):
        self.mix, self.seed, self.loop = mix, int(seed), mix["loop"]
        pop = np.random.default_rng([int(mix.get("population_seed", 0)), 0])
        self._seeds = np.random.default_rng([self.seed, 1])
        if self.loop == "open":
            rate = float(mix["rate_per_s"])
            count = max(1, int(round(rate * seconds)))
            shapes = _shapes(mix, count, pop, config)
            gaps = pop.exponential(1.0, size=count)
            gaps *= seconds / gaps.sum()
            due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            order = np.random.default_rng([self.seed, 2])
            shapes = [shapes[i] for i in order.permutation(count)]
            job_seeds = self._seeds.integers(0, SEED_SPAN, size=count)
            self.jobs = [dict(s, seed=int(js), due=float(d))
                         for s, js, d in zip(shapes, job_seeds, due)]
        elif self.loop == "closed":
            self.outstanding = int(mix["outstanding"])
            self._pop = _shapes(mix, int(mix.get("population", 1024)), pop, config)
            self._order: list[int] = []
            self._cycle = 0
            self._made: list[dict] = []
        else:
            raise ValueError(f"unknown loop {self.loop!r}")

    def spec(self, k: int) -> dict:
        """The closed loop's ``k``-th job (0, 1, 2, ... in submission order)."""
        while len(self._made) <= k:
            if not self._order:
                perm = np.random.default_rng([self.seed, 3, self._cycle]).permutation(len(self._pop))
                self._order, self._cycle = list(perm), self._cycle + 1
            shape = self._pop[self._order.pop(0)]
            self._made.append(dict(shape, seed=int(self._seeds.integers(0, SEED_SPAN))))
        return self._made[k]
