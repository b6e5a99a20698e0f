"""The four-card cell ``cb-mesh4-long``: its mix of long ramped anneals,
its configuration's slot mesh, the reference against ramped anneals
served over four logical host devices bit for bit, and ``card_skew``
read from synthetic records."""

from pathlib import Path

import numpy as np
import pytest

from pbench import check, spec as specmod, system
from pbench.traffic import Traffic

HERE = Path(__file__).resolve().parent
SPEC = specmod.Spec(HERE.parent)
CELL = "cb-mesh4-long"
SEED = 2**31 + 3030


def _rehearsal():
    cfg = SPEC.config("ising-qmc-cb-mesh4")
    return specmod.merged(cfg, cfg["cpu_rehearsal"])


def test_the_cell_spans_four_cards_of_460_slots():
    cell = SPEC.cell(CELL)
    cfg = SPEC.config(cell["config"])
    assert cell["chips"] == system.cuda_cards(cfg["devices"]) == 4
    assert cfg["server"]["slots"] == 4 * cfg["num_models"] == 460
    chips = [w["chips"] for w in SPEC.data["workloads"]]
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_the_mix_ramps_every_job_in_whole_chunks():
    """Budgets of 1,024-4,096 sweeps, each a 16-step staircase from beta 0.1
    to 3.0 whose steps are multiples of the 64-sweep chunk."""
    mix = SPEC.traffic("anneal-long")
    t = Traffic(mix, SEED, 51.0, SPEC.config("ising-qmc-cb-mesh4"))
    jobs = [t.spec(k) for k in range(int(mix["population"]))]
    assert {sum(k for k, _ in j["schedule"]) for j in jobs} == {1024, 2048, 3072, 4096}
    betas = [float(b) for b in np.linspace(0.1, 3.0, 16)]
    for j in jobs:
        assert [b for _, b in j["schedule"]] == betas
        assert all(k % 64 == 0 and 64 <= k <= 256 for k, _ in j["schedule"])
    assert t.outstanding == 512 > SPEC.config("ising-qmc-cb-mesh4")["server"]["slots"]


def test_ramped_anneals_on_four_host_devices_equal_the_reference():
    """16-segment ramps served on the rehearsal's mesh (2 slots on each of
    4 logical host devices, 4-sweep chunks cut at every step) equal the
    plain reference's `anneal` bit for bit."""
    cfg = _rehearsal()
    ref = SPEC.reference(cfg)
    model = ref.make_model(cfg, SEED)
    server = system.build_server(cfg, model, backend="torch", device="cpu")
    assert len(server.engine.mesh) == 4 and server.engine.capacities == (2, 2, 2, 2)
    mix = specmod.merged(SPEC.traffic("anneal-long"),
                         {"job": {"budget_unit": 16, "ramp": {"segments": [16, 16]}}})
    t = Traffic(mix, SEED, 3.0, cfg)
    specs = [t.spec(k) for k in range(12)]
    assert all(len(s["schedule"]) == 16 for s in specs)
    jids = [server.submit(system.make_job(s)) for s in specs]
    served = {r.jid: r for r in server.drain()}
    answers = [check.served_answer(served[j]) for j in jids]
    expected = check.replay(ref, model, system.shapes(server), specs, "cpu")
    nums = check.compare(answers, expected)
    assert all(v == 0 for v in nums.values()), nums
    assert server.telemetry.value("serve.launches_timed", device=3) == server.launches


def _record(cards, grown: dict):
    """A record whose labelled ``serve.launch_device_s`` series grew by
    ``grown`` ({device: seconds}) over the window."""
    c0 = {"serve.launch_device_s": 5.0}
    c1 = {"serve.launch_device_s": 5.0 + max(grown.values(), default=0.0)}
    for d, g in grown.items():
        c0[f"serve.launch_device_s{{device={d}}}"] = 1.0
        c1[f"serve.launch_device_s{{device={d}}}"] = 1.0 + g
    return {"cards": cards, "counters": (c0, c1)}


@pytest.mark.parametrize("cards,grown,want", [
    ([0, 1, 2, 3], {0: 1.0, 1: 1.0, 2: 1.0, 3: 2.0}, 60.0),
    ([0, 1, 2, 3], {0: 2.0, 1: 2.0, 2: 2.0, 3: 2.0}, 0.0),
    ([0], {0: 2.0}, None),
    ([0, 1, 2, 3], {}, None),
], ids=["skewed", "even", "one-card", "no-series"])
def test_card_skew_reads_the_slowest_card_above_the_mean(cards, grown, want):
    got = SPEC.reader("card_skew").read(_record(cards, grown))
    assert got == (None if want is None else pytest.approx(want))
