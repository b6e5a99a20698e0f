"""The port's LM server (`repro_torch.launch.serve`) against the
reference's, with the reference's initial weights carried across, at
``dtype="float32"``: every emitted token is equal, step for step.  A step
may pick another token only where the reference's own top-two logit gap,
scaled by its largest logit, is under ROADMAP §3w's ``F32_TOP2_GAP``
(`test_torch_lm_trap.py`); the test checks that condition where it
happens and continues both engines from the reference's token.  Also the
CLI on the CPU, its two kept quirks (ROADMAP §3x) and the example."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jget
from repro.launch import serve as jserve
from repro.models import decoder as jdec
from repro.nn.param import split_tree as jsplit
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.launch import serve
from test_torch_lm_trap import F32_LOGITS, F32_TOP2_GAP, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _capture(engine, store, to_numpy):
    inner = engine._decode

    def decode(*args):
        logits, caches = inner(*args)
        store.append(to_numpy(logits))
        return logits, caches

    engine._decode = decode


def _engines(arch, slots, max_len, dtype="float32"):
    jcfg = dataclasses.replace(jget(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    values, _ = jsplit(jdec.init_params(jax.random.PRNGKey(0), jcfg))
    values = jax.tree_util.tree_map(np.asarray, values)
    params = convert.lm_params_from_arrays(values, cfg, "cpu")
    ref = jserve.ServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, values), slots, max_len)
    port = serve.ServeEngine(cfg, params, slots, max_len, device="cpu")
    return ref, port


def _requests(cls, prompts, max_new):
    return [cls(rid=i, prompt=p.copy(), max_new=m) for i, (p, m) in enumerate(zip(prompts, max_new))]


def _lockstep(ref, port, prompts, max_new):
    """Serve the same requests on both engines a step at a time; returns
    (requests of each, steps, steps where the tokens differed)."""
    jl, tl = [], []
    _capture(ref, jl, lambda x: np.asarray(jnp.asarray(x)[:, 0].astype(jnp.float32)))
    _capture(port, tl, lambda x: x[:, 0].float().numpy())
    jreqs = _requests(jserve.Request, prompts, max_new)
    treqs = _requests(serve.Request, prompts, max_new)
    jpend, tpend = list(jreqs), list(treqs)
    steps, differed = 0, 0
    vocab = port.cfg.vocab_size
    while jpend or any(s is not None for s in ref.slots):
        while jpend and ref.add_request(jpend[0]):
            jpend.pop(0)
        while tpend and port.add_request(tpend[0]):
            tpend.pop(0)
        assert [s is None for s in ref.slots] == [s is None for s in port.slots]
        active = {i: (s, port.slots[i]) for i, s in enumerate(ref.slots) if s is not None}
        ref.step()
        port.step()
        steps += 1
        assert scaled_error(jl[-1], tl[-1]) <= F32_LOGITS, steps
        for i, (jreq, treq) in active.items():
            if ref.cur_token[i, 0] == port.cur_token[i, 0]:
                continue
            # Only a generated token can differ (prompt tokens are copied).
            top2 = np.sort(jl[-1][i, :vocab])[-2:]
            gap = (top2[1] - top2[0]) / np.abs(jl[-1][i]).max()
            assert gap < F32_TOP2_GAP, (steps, i, gap)
            differed += 1
            treq.out[-1] = jreq.out[-1]
            port.cur_token[i, 0] = ref.cur_token[i, 0]
        np.testing.assert_array_equal(ref.pos, port.pos)
        assert steps < 500
    return jreqs, treqs, steps, differed


def test_serve_engine_matches_the_reference():
    """``tests/test_serving.py``'s setup: gemma-2b smoke, 2 slots,
    max_len 64, 4 requests of 6-token prompts and 5 new tokens."""
    ref, port = _engines("gemma-2b", 2, 64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 6).astype(np.int32) for _ in range(4)]
    jreqs, treqs, steps, differed = _lockstep(ref, port, prompts, [5] * 4)
    assert all(len(r.out) == 5 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert differed == 0


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2.5-14b", "command-r-35b"])
def test_ragged_requests_decode_at_the_first_active_slots_length(arch):
    """Prompts and budgets of different lengths put the slots at different
    lengths; both engines decode every slot at the first active slot's
    length (the reference's `step`, kept: ROADMAP §3x), and retire at
    max_len - 1."""
    ref, port = _engines(arch, 3, 24)
    rng = np.random.default_rng(5)
    lens, budgets = [6, 2, 9, 4, 3], [5, 9, 3, 30, 7]
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    jreqs, treqs, _, _ = _lockstep(ref, port, prompts, budgets)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert len(treqs[3].out) < 30  # retired at max_len - 1


def test_serve_engine_end_to_end():
    """The reference's own engine test, on the port."""
    cfg = get_config("gemma-2b", smoke=True)
    from repro_torch.models import decoder

    params = decoder.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    engine = serve.ServeEngine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                          max_new=5) for i in range(4)]
    finished, steps = serve.drain(engine, reqs)
    assert steps < 500
    assert finished == reqs and all(len(r.out) == 5 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)


def test_cli_on_the_cpu(capsys):
    finished = serve.main(["--device", "cpu", "--requests", "5", "--slots", "2",
                           "--prompt-len", "4", "--max-new", "6", "--seed", "3"])
    assert [r.rid for r in finished] == list(range(5))
    assert all(len(r.out) == 6 for r in finished)
    out = capsys.readouterr().out
    assert "served 5 requests, 30 tokens" in out


def test_cli_always_serves_the_smoke_config(monkeypatch):
    """``--smoke`` is a store_true flag whose default is True (the
    reference's ``launch/serve.py:108``, kept: ROADMAP §3x)."""
    seen = []

    def fake_get_config(arch, smoke=False):
        seen.append((arch, smoke))
        return get_config(arch, smoke=smoke)

    monkeypatch.setattr(serve, "get_config", fake_get_config)
    serve.main(["--device", "cpu", "--requests", "1", "--max-new", "2", "--arch", "qwen2.5-14b"])
    assert seen == [("qwen2.5-14b", True)]


def test_cli_prompts_are_the_references():
    cfg = get_config("gemma-2b", smoke=True)
    rng = np.random.default_rng(7)
    want = [rng.integers(0, cfg.vocab_size, size=4).astype(np.int32) for _ in range(3)]
    got = serve.make_requests(cfg, 3, 4, 2, seed=7)
    for w, r in zip(want, got):
        np.testing.assert_array_equal(w, r.prompt)


def test_cli_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "1"])


def test_example_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm

    serve_lm.main(["--device", "cpu"])
    assert "OK: all 12 requests served to completion" in capsys.readouterr().out
