"""The traffic generator: the same seed gives the same traffic, and every
seed of a mix gets the same work in another order."""

from collections import Counter
from pathlib import Path

import pytest

from pbench import spec as specmod
from pbench.traffic import SEED_SPAN, Traffic

SPEC = specmod.Spec(Path(__file__).resolve().parent.parent)
MIXES = ("anneal-short", "pt115")
CFG = SPEC.config("ising-qmc-cb")


def _shape(s):
    return (s["kind"], str(s.get("schedule")), str(s.get("betas")), s.get("rounds"), s["user"],
            s["priority"])


def _jobs(mix, seed, count=300):
    t = Traffic(mix, seed, 20.0, CFG)
    if t.loop == "open":
        return t.jobs
    return [t.spec(k) for k in range(count)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = SPEC.traffic(name)
    assert _jobs(mix, 2**31 + 5) == _jobs(mix, 2**31 + 5)
    assert _jobs(mix, 1) != _jobs(mix, 2) or name == "pt115" and \
        [j["seed"] for j in _jobs(mix, 1)] != [j["seed"] for j in _jobs(mix, 2)]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_work(name):
    mix = SPEC.traffic(name)
    a, b = _jobs(mix, 3), _jobs(mix, 2**33 + 1)
    if Traffic(mix, 3, 20.0, CFG).loop == "open":
        assert Counter(map(_shape, a)) == Counter(map(_shape, b))
        assert len(a) == len(b)
        assert max(j["due"] for j in a) < 20.0
        # the same arrival times: a seed orders the jobs, it brings no bursts
        assert [j["due"] for j in a] == [j["due"] for j in b]
        assert [_shape(j) for j in a] != [_shape(j) for j in b]
    else:  # one whole population, in another order
        n = int(mix.get("population", 1024))
        assert Counter(map(_shape, _jobs(mix, 3, n))) == Counter(map(_shape, _jobs(mix, 9, n)))
    assert all(0 <= j["seed"] < SEED_SPAN for j in a + b)


def test_mixes_keep_the_issue_shapes():
    """anneal-short is serve_bench's job mix (4-16 chunks of 8 sweeps,
    constant beta in 0.5-1.5); pt115 takes its ladder from the
    configuration: 115 replicas over beta 0.1-3.0, 4096 sweeps in rounds of 8."""
    short = _jobs(SPEC.traffic("anneal-short"), 5)
    budgets = {sum(k for k, _ in j["schedule"]) for j in short}
    assert budgets == set(range(32, 129, 8))
    assert all(len(j["schedule"]) == 1 and 0.5 <= j["schedule"][0][1] <= 1.5 for j in short)
    (pt,) = _jobs(SPEC.traffic("pt115"), 5, 1)
    assert len(pt["betas"]) == 115 and pt["rounds"] == 512 and pt["sweeps_per_round"] == 8
    assert pt["betas"][0] == pytest.approx(0.1) and pt["betas"][-1] == pytest.approx(3.0)


def test_a_pt_mix_needs_its_ladder_from_somewhere():
    with pytest.raises(ValueError, match="PT template"):
        Traffic(SPEC.traffic("pt115"), 1, 20.0).spec(0)
