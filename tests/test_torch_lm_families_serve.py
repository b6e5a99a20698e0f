"""The port's LM server (`repro_torch.launch.serve`) on the families
beyond the dense one, against the reference's engine, with the
reference's initial weights carried across, at ``dtype="float32"``: every
emitted token is equal, step for step (a step may pick another token only
where the reference's top-two logit gap is under ROADMAP §3w's
``F32_TOP2_GAP``, `test_torch_lm_serve._lockstep`).  Also the CLI on the
CPU for each of these archs, and the reference's serving quirk that this
slice makes visible (ROADMAP §3x): a request admitted into a freed slot
inherits the previous request's recurrent state."""

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve
from test_torch_lm_serve import _engines, _lockstep
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ["deepseek-v3-671b", "llama4-scout-17b-a16e", "zamba2-1.2b", "rwkv6-1.6b",
            "whisper-tiny"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_engine_matches_the_reference(arch):
    """2 slots, max_len 32, 4 requests of prompts of 3-6 tokens and 4-6
    new tokens: the port serves the reference's tokens."""
    ref, port = _engines(arch, 2, 32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 3, 5, 4)]
    jreqs, treqs, steps, differed = _lockstep(ref, port, prompts, [5, 6, 4, 5])
    assert [len(r.out) for r in treqs] == [5, 6, 4, 5]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert differed == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_on_the_cpu(arch, capsys):
    finished = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots", "2",
                           "--prompt-len", "4", "--max-new", "3", "--seed", "1"])
    assert [r.rid for r in finished] == [0, 1, 2] and all(len(r.out) == 3 for r in finished)
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def _second_request_alone_and_after(arch, engines):
    """Request B served on a fresh one-slot engine, and after request A
    in the same slot: B's tokens each way, for each engine of ``engines``
    (a function returning a fresh (reference, port) pair)."""
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 512, 5).astype(np.int32) for _ in range(2))
    out = {}
    for order in ("alone", "after"):
        ref, port = engines()
        prompts = [b] if order == "alone" else [a, b]
        jreqs, treqs, _, differed = _lockstep(ref, port, prompts, [6] * len(prompts))
        assert differed == 0 and [r.out for r in treqs] == [r.out for r in jreqs]
        out[order] = treqs[-1].out
    return out


@pytest.mark.parametrize("arch,inherits", [("rwkv6-1.6b", True), ("zamba2-1.2b", True),
                                           ("llama4-scout-17b-a16e", False)])
def test_a_freed_slot_passes_its_recurrent_state_on(arch, inherits):
    """The reference's ``ServeEngine.add_request`` resets the slot's
    length, not its caches.  Attention caches are masked by length, so an
    attention model serves a request alike alone or after another; a
    recurrent model's conv/SSM or shift/WKV state carries the previous
    request's, and the request is served otherwise.  Both engines do the
    same (kept for parity: a fix changes both packages' outputs)."""
    out = _second_request_alone_and_after(arch, lambda: _engines(arch, 1, 32))
    assert (out["alone"] != out["after"]) == inherits, out


def test_the_references_engine_has_the_quirk_too():
    """The reference's own engine on rwkv6: the second request differs
    from its solo run (the quirk is the reference's, not the port's)."""
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 512, 5).astype(np.int32) for _ in range(2))
    outs = []
    for prompts in ([b], [a, b]):
        ref, _ = _engines("rwkv6-1.6b", 1, 32)
        reqs = [jserve.Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        pending = list(reqs)
        while pending or any(s is not None for s in ref.slots):
            while pending and ref.add_request(pending[0]):
                pending.pop(0)
            ref.step()
        outs.append(reqs[-1].out)
    assert outs[0] != outs[1]
