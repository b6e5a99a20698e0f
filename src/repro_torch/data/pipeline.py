"""Deterministic, shardable, resumable synthetic-token data pipeline.

Production contract (what matters at 1000+ nodes):

* Determinism — batch ``i`` is a pure function of (seed, step), so a
  restarted / rescheduled job consumes byte-identical data with NO
  coordination: the checkpointed ``step`` alone restores the stream.
* Host sharding — each host materializes only its slice of the global
  batch (``host_id / num_hosts``), which is what
  ``jax.make_array_from_process_local_data`` expects in multi-host runs.
* Prefetch — a background thread keeps ``prefetch`` batches ready so the
  accelerator never waits on host-side generation (async input pipeline).

The generator is a counter-based (stateless) PRNG — splittable like
threefry, so arbitrary (step, position) elements are addressable O(1).
A real deployment swaps ``SyntheticLMDataset`` for a tokenized corpus
reader with the same interface.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _counter_rng(seed: int, step: int, host: int) -> np.random.Generator:
    # Philox is counter-based: O(1) jump to any (step, host) stream.
    return np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, step, host]))


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    extra_specs: Optional[Dict[str, tuple]] = None  # e.g. frames/visual stubs

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.host_batch = self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local slice of global batch ``step`` (pure function)."""
        rng = _counter_rng(self.seed, step, self.host_id)
        # Markov-ish synthetic tokens: makes loss decrease measurably, unlike
        # uniform noise, so smoke training runs show real learning signal.
        base = rng.integers(0, self.vocab_size, size=(self.host_batch, 1))
        drift = rng.integers(0, 7, size=(self.host_batch, self.seq_len))
        toks = (base + np.cumsum(drift, axis=1)) % self.vocab_size
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100  # ignore last position
        out = {"tokens": tokens, "labels": labels}
        for name, shape in (self.extra_specs or {}).items():
            out[name] = rng.standard_normal(
                size=(self.host_batch,) + tuple(shape), dtype=np.float32
            )
        return out


class PrefetchIterator:
    """Background-thread prefetching iterator with checkpointable position."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._next_to_produce = start_step
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.dataset.batch_at(self._next_to_produce)
            while not self._stop.is_set():
                try:
                    self._q.put((self._next_to_produce, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:
                return
            self._next_to_produce += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1  # checkpoint this; restart resumes exactly here
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.dataset.seed}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
