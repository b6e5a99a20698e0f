"""Placement over a slot mesh: the port's `SlotPool`, `PlacementPlanner`
and placement-aware policies decide exactly as the reference's.

Placement never changes a job's results (slots are independent), so a
wrong best-fit or tie-break would show only in WHICH slots a job gets.
The reference's pool and policies are host-only, so both packages run
side by side here on any device count:

* seeded random sequences of `alloc` (with and without ``avoid``),
  `release`, `take` and `restore_free` on equal, ragged and zero
  capacities, affine and flat, agree call for call (slots returned, free
  lists, errors);
* the reference's own pool cases (test_placement.py, test_hetero.py) give
  the same answers on both;
* `PriorityBackfillPolicy.plan` with a placement planner (the reservation
  that pins a device for a blocked ladder) and with a bare count (a custom
  policy's contract) admits, places and preempts alike on seeded queues;
* `PlacementPlanner` is int-compatible.
"""

import numpy as np
import pytest

from repro.serve_mc import scheduler as jsched
from repro_torch.serve_mc import scheduler as sched

CONFIGS = {
    "d1": (8, 1, None),
    "d4": (8, 4, None),
    "ragged": (8, 4, (4, 2, 1, 1)),
    "zero": (8, 4, (3, 3, 2, 0)),
    "d2-odd": (10, 2, (7, 3)),
}


def _call(pool, name, *args, **kw):
    try:
        out = getattr(pool, name)(*args, **kw)
    except (ValueError, RuntimeError) as e:
        return ("raise", type(e).__name__, str(e))
    return ("ok", out)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["affine", "flat"])
@pytest.mark.parametrize("cfg", list(CONFIGS), ids=list(CONFIGS))
def test_slot_pool_agrees_with_the_reference_call_for_call(cfg, mode, seed):
    slots, devices, caps = CONFIGS[cfg]
    port = sched.SlotPool(slots, devices=devices, mode=mode, capacities=caps)
    ref = jsched.SlotPool(slots, devices=devices, mode=mode, capacities=caps)
    rng = np.random.default_rng(seed)
    for step in range(120):
        op = rng.choice(["alloc", "alloc_avoid", "release", "take", "restore"],
                        p=[0.35, 0.15, 0.3, 0.1, 0.1])
        if op == "alloc":
            args, kw, name = (int(rng.integers(0, 5)),), {}, "alloc"
        elif op == "alloc_avoid":
            args, kw, name = (int(rng.integers(1, 4)),), {"avoid": int(rng.integers(0, devices))}, \
                "alloc"
        elif op == "release":
            args, kw, name = (int(rng.integers(-1, slots + 1)),), {}, "release"
        elif op == "take":
            args, kw, name = (tuple(int(b) for b in rng.integers(0, slots, 2)),), {}, "take"
        else:
            free = sorted(set(int(b) for b in rng.integers(0, slots, rng.integers(0, slots))))
            args, kw, name = (free,), {}, "restore_free"
        got, want = _call(port, name, *args, **kw), _call(ref, name, *args, **kw)
        assert got == want, f"step {step}: {name}{args}{kw}"
        assert port.flat_free() == ref.flat_free()
        assert port.free_by_device() == ref.free_by_device()
        assert port.total_free == ref.total_free
        assert [port.device_of(b) for b in range(slots)] == [ref.device_of(b) for b in range(slots)]
    clone = port.clone()
    assert clone.flat_free() == port.flat_free() and clone.capacities == port.capacities


def _pool_cases(SlotPool):
    """The reference tests' pool cases, as a log of answers."""
    log = []
    for kw in (dict(slots=6, devices=4), dict(slots=8, devices=4, mode="weird"),
               dict(slots=8, devices=0), dict(slots=8, devices=4, capacities=(4, 2, 2))):
        try:
            SlotPool(**kw)
        except ValueError as e:
            log.append(str(e))
    pool = SlotPool(8, devices=4, mode="flat")
    log += [pool.alloc(3), pool.release(1), pool.alloc(2)]
    pool = SlotPool(8, devices=4)
    log += [pool.alloc(2), pool.alloc(1), pool.alloc(2), pool.alloc(1), pool.free_by_device()]
    pool = SlotPool(8, devices=4)
    for _ in range(8):
        pool.alloc(1)
    pool.release(2)
    pool.release(6)
    log.append(pool.alloc(2))
    pool = SlotPool(8, devices=4, capacities=[4, 2, 1, 1])
    pool.take([0, 1, 2])
    log += [pool.alloc(5), pool.free_by_device()]
    pool = SlotPool(6, devices=2, capacities=[4, 2])
    pool.take([0, 1])
    log.append(pool.alloc(2))
    pool = SlotPool(4, devices=4, capacities=[2, 0, 2, 0])
    log += [[pool.device_of(b) for b in range(4)], pool.alloc(4)]
    p4 = SlotPool(8, devices=4)
    p4.take((0, 1, 4, 5))
    for d in (1, 2):
        p = SlotPool(8, devices=d)
        p.take(range(8))
        p.restore_free(p4.flat_free())
        log += [p.flat_free(), p.free_by_device()]
    return log


def test_the_references_pool_cases_answer_alike():
    assert _pool_cases(sched.SlotPool) == _pool_cases(jsched.SlotPool)


class _Job:
    """The attributes a policy reads, for either package's policy."""

    def __init__(self, jid, num_slots, remaining, priority=0, user="u"):
        self.jid, self.num_slots, self._remaining = jid, num_slots, remaining
        self.priority, self.user = priority, user
        self.parked, self._seq, self._submit_sweep = None, None, 0

    def total_remaining(self):
        return self._remaining


def _plan_log(pkg, seed, caps, policy, bare):
    rng = np.random.default_rng(seed)
    pool = pkg.SlotPool(8, devices=4, capacities=caps)
    pol = pkg.make_policy(policy)
    active, log, jid = {}, [], 0
    for _ in range(10):
        for _ in range(int(rng.integers(0, 3))):
            pol.enqueue(_Job(jid, int(rng.integers(1, 5)), int(rng.integers(1, 12)),
                             priority=int(rng.integers(0, 3)), user=f"u{jid % 3}"))
            jid += 1
        if bare:
            pre, adm = pol.plan(pool.total_free, [j for j, _ in active.values()])
        else:
            planner = pkg.PlacementPlanner(pool, {id(j): s for j, s in active.values()})
            pre, adm = pol.plan(planner, [j for j, _ in active.values()])
        for j in pre:
            pool.release_all(active.pop(j.jid)[1])
        for e in adm:
            j, slots = e if isinstance(e, tuple) else (e, pool.alloc(e.num_slots))
            if isinstance(e, tuple):
                pool.take(slots)
            active[j.jid] = (j, tuple(slots))
        log.append(([j.jid for j in pre], sorted((j, s) for j, (_, s) in active.items()),
                    pool.free_by_device()))
        for j, _ in list(active.values()):  # every active job advances 3 sweeps
            j._remaining -= 3
            if j._remaining <= 0:
                pool.release_all(active.pop(j.jid)[1])
    return log


@pytest.mark.parametrize("bare", [False, True], ids=["planner", "bare-count"])
@pytest.mark.parametrize("policy", ["fifo", "backfill", "fair"])
@pytest.mark.parametrize("caps", [None, (4, 2, 1, 1)], ids=["d4", "ragged"])
def test_policies_plan_and_place_like_the_reference(caps, policy, bare):
    for seed in range(3):
        assert _plan_log(sched, seed, caps, policy, bare) == \
            _plan_log(jsched, seed, caps, policy, bare), f"seed {seed}"


def test_planner_is_int_compatible():
    """Custom policies that treat ``free`` as a count keep working; the
    planner simulates on a clone, so the pool is untouched."""
    pool = sched.SlotPool(8, devices=4)
    pool.take((0, 1, 2))
    planner = sched.PlacementPlanner(pool)
    assert isinstance(planner, int)
    assert int(planner) == 5 and planner - 2 == 3 and planner >= 5
    assert planner.devices == 4 and planner.mode == "affine" and planner.cap == 2
    job = _Job(0, 2, 4)
    slots = planner.alloc(job)
    assert planner.slots_of(job) == slots and pool.total_free == 5
    planner.putback(job)
    assert planner.total_free == 5 and planner.slots_of(job) == ()
    a, b = _Job(1, 2, 3), _Job(2, 1, 5)
    port = sched.PlacementPlanner.from_counts(3, [a, b])
    ref = jsched.PlacementPlanner.from_counts(3, [a, b])
    assert int(port) == int(ref) == 3
    assert port.slots_of(a) == ref.slots_of(a) and port.slots_of(b) == ref.slots_of(b)
    assert port.free_by_device() == ref.free_by_device()
