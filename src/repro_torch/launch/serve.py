"""Batched serving: decode with continuous batching.

Serves a model with a fixed decode batch; requests queue up, fill free
slots after each decode step (continuous batching), and finished
sequences retire on max-new/max-len.  The decode step is one call of
`models.decoder.decode_step` regardless of how many requests are active,
under ``torch.inference_mode()``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --device cpu \\
      --requests 8 --max-new 16

Two behaviours are the reference's and kept for parity: ``--smoke`` is on
whatever the command line says (a ``store_true`` flag whose default is
True), so the CLI serves the smoke config (a full-width model goes through
`ServeEngine` and ``get_config(arch)``); and ``step`` decodes every slot at
the first active slot's length.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import decoder


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous batching over decoder.decode_step.

    ``params`` is a `models.decoder.Decoder` on ``device``."""

    def __init__(self, cfg, params, batch_slots: int, max_len: int, greedy=True, seed=0,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.max_len = max_len
        self.caches = decoder.init_decode_caches(cfg, batch_slots, max_len, self.device)
        self.pos = np.zeros(batch_slots, np.int32)  # per-slot lengths
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        cfg_d = dataclasses.replace(cfg, max_target_length=max_len)
        self._decode = lambda p, t, c, l: decoder.decode_step(p, t, c, l, cfg_d)
        self.cur_token = np.zeros((batch_slots, 1), np.int32)

    def add_request(self, req: Request) -> bool:
        for i, slot in enumerate(self.slots):
            if slot is None:
                self.slots[i] = req
                # The prompt is consumed by decode steps, one token a step.
                self.pos[i] = 0
                self.cur_token[i, 0] = req.prompt[0]
                req._prompt_cursor = 1
                return True
        return False

    def step(self):
        """One global decode step across all active slots."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        # Every slot decodes at the first active slot's length (the
        # reference's engine; prompts are consumed token by token).
        cur_len = int(self.pos[active[0]])
        with torch.inference_mode():
            token = torch.from_numpy(self.cur_token).to(self.device)
            logits, self.caches = self._decode(self.params, token, self.caches, cur_len)
            logits = logits[:, 0].float().cpu().numpy()
        for i in active:
            req = self.slots[i]
            if req._prompt_cursor < len(req.prompt):
                nxt = req.prompt[req._prompt_cursor]
                req._prompt_cursor += 1
            else:
                if self.greedy:
                    nxt = int(np.argmax(logits[i, : self.cfg.vocab_size]))
                else:
                    p = np.exp(logits[i, : self.cfg.vocab_size] - logits[i].max())
                    p /= p.sum()
                    nxt = int(self.rng.choice(len(p), p=p))
                req.out.append(nxt)
                if len(req.out) >= req.max_new:
                    req.done = True
            self.cur_token[i, 0] = nxt
            self.pos[i] += 1
        for i in active:
            if self.slots[i].done or self.pos[i] >= self.max_len - 1:
                self.slots[i].done = True
                self.slots[i] = None  # slot freed for the next request


def make_requests(cfg, count: int, prompt_len: int, max_new: int, seed: int) -> List[Request]:
    """The CLI's requests: prompts of ``prompt_len`` tokens drawn from
    ``default_rng(seed)``, as the reference draws them."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32),
            max_new=max_new,
        )
        for i in range(count)
    ]


def drain(engine: ServeEngine, pending: List[Request]) -> tuple:
    """Serve ``pending`` to the end: ``(requests in admission order, decode
    steps)``."""
    pending = list(pending)
    finished = []
    steps = 0
    while pending or any(s is not None for s in engine.slots):
        while pending and engine.add_request(pending[0]):
            finished.append(pending.pop(0))
        engine.step()
        steps += 1
        if steps > 10000:
            raise RuntimeError("serve loop did not converge")
    return finished, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    params = decoder.init_params(generator, cfg, device=args.device).hold_compute_dtype()
    engine = ServeEngine(cfg, params, args.slots, max_len=128, seed=args.seed,
                         device=args.device)

    pending = make_requests(cfg, args.requests, args.prompt_len, args.max_new, args.seed)
    t0 = time.perf_counter()
    finished, steps = drain(engine, pending)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in finished)
    print(f"served {len(finished)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, {steps} decode steps)")
    for r in finished[:3]:
        print(f"  req {r.rid}: {r.out[:10]}...")
    return finished


if __name__ == "__main__":
    main()
