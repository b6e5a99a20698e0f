"""MT19937 in PyTorch: scalar-compatible and V-way interlaced (paper §3).

The paper's key RNG optimization interlaces independent MT19937
generators so one vector op advances all of them.  Here the state is
``(624, V)`` words — one generator per column — and a single blocked
"twist" advances all V generators with whole-row tensor ops.  On the
card the CUDA kernel gives each generator column to one thread, so every
state row is read by a warp as one coalesced access (the paper's GPU
lesson).

Storage: the state is an **int32 tensor holding the uint32 bit pattern**
(the same bytes as a uint32 array, so ``t.numpy().view(np.uint32)``
compares directly with any uint32 reference).  PyTorch's CPU build has no
uint32 shifts or adds, so the arithmetic runs in int64 masked to 32 bits
and converts back at the storage boundary.

The in-place twist has a sequential dependency (``mt[i]`` reads
``mt[(i+397) % 624]`` which may already be updated), so the vectorized
twist is split into three statically-sliced chunks plus the final
element — the same blocking a hand-vectorized SSE implementation uses:

    new[0:227]   = T(old[0:227],   old[1:228],   old[397:624])
    new[227:454] = T(old[227:454], old[228:455], new[0:227])
    new[454:623] = T(old[454:623], old[455:624], new[227:396])
    new[623]     = T(old[623],     new[0],       new[396])

Lane ``k`` of the interlaced generator reproduces, bit-exactly, a scalar
MT19937 seeded with ``seeds[k]`` (`ScalarMT19937Ref`, which matches
C++ ``std::mt19937``).
"""

from __future__ import annotations

import numpy as np
import torch

N = 624
M = 397
MATRIX_A = 0x9908B0DF
UPPER_MASK = 0x80000000
LOWER_MASK = 0x7FFFFFFF
INIT_MULT = 1812433253
DEFAULT_SEED = 5489
MASK32 = 0xFFFFFFFF

# Tempering constants.
TEMPER_B = 0x9D2C5680
TEMPER_C = 0xEFC60000


def to_u32(state: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern storage -> int64 words in [0, 2^32)."""
    return state.to(torch.int64) & MASK32


def from_u32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit-pattern storage."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def mt_init(seeds, device="cuda") -> torch.Tensor:
    """Initialise interlaced state from per-lane seeds.

    Knuth-style seeding runs as vectorised numpy on the host (the
    recurrence is sequential in the row but vector across lanes; numpy's
    uint32 arithmetic wraps exactly as the algorithm needs), then one copy
    to ``device``.

    Args:
      seeds: scalar or (V,) array-like of uint32 seeds.
    Returns:
      (624,) int32 state if scalar seed, else (624, V).
    """
    seeds = np.asarray(seeds, dtype=np.uint32)
    state = np.empty((N,) + seeds.shape, np.uint32)
    state[0] = seeds
    mult = np.uint32(INIT_MULT)
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        for i in range(1, N):
            prev = state[i - 1]
            state[i] = mult * (prev ^ (prev >> np.uint32(30))) + np.uint32(i)
    return torch.from_numpy(state.view(np.int32)).to(device)


def _twist_chunk(u, v, m):
    """One vectorized twist step: u=mt[i], v=mt[i+1], m=mt[i+M mod N]."""
    y = (u & UPPER_MASK) | (v & LOWER_MASK)
    # (y & 1) ? MATRIX_A : 0 — branch-free, exactly the paper's Figure 10.
    return m ^ (y >> 1) ^ ((y & 1) * MATRIX_A)


def _twist_words(s: torch.Tensor) -> torch.Tensor:
    """`mt_twist` on int64 words (no storage conversion)."""
    p1 = _twist_chunk(s[0:227], s[1:228], s[397:624])  # new[0:227]
    p2 = _twist_chunk(s[227:454], s[228:455], p1[0:227])  # new[227:454]
    p3 = _twist_chunk(s[454:623], s[455:624], p2[0:169])  # new[454:623]
    last = _twist_chunk(s[623:624], p1[0:1], p2[169:170])  # new[623]
    return torch.cat([p1, p2, p3, last], dim=0)


def _temper_words(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & TEMPER_B)
    y = y ^ ((y << 15) & TEMPER_C)
    return y ^ (y >> 18)


def mt_twist(state: torch.Tensor) -> torch.Tensor:
    """Advance the full 624-entry state block ((624,) or (624, V))."""
    return from_u32(_twist_words(to_u32(state)))


def mt_temper(y: torch.Tensor) -> torch.Tensor:
    """MT19937 output tempering (pure elementwise ops), int32 storage."""
    return from_u32(_temper_words(to_u32(y)))


def mt_next_block(state: torch.Tensor):
    """Advance state and emit 624 tempered outputs per lane.

    Returns ``(new_state, outputs)`` with shapes matching ``state``, both
    int32 storage of uint32 bits.
    """
    w = _twist_words(to_u32(state))
    return from_u32(w), from_u32(_temper_words(w))


def uniforms_from_u32(u32: torch.Tensor) -> torch.Tensor:
    """Map uint32 randoms (int32 storage) to float32 uniforms in [0, 1).

    Uses the 24 high bits (exactly representable in float32), the standard
    choice for Metropolis accept tests.
    """
    return _uniforms_from_words(to_u32(u32))


def _uniforms_from_words(w: torch.Tensor) -> torch.Tensor:
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def mt_uniform_blocks(state: torch.Tensor, num_blocks: int):
    """Generate ``num_blocks`` blocks of 624 uniforms per lane.

    Returns ``(new_state, uniforms)`` where uniforms has shape
    ``(num_blocks * 624,) + state.shape[1:]``.
    """
    w = to_u32(state)
    outs = []
    for _ in range(num_blocks):
        w = _twist_words(w)
        outs.append(_uniforms_from_words(_temper_words(w)))
    return from_u32(w), torch.cat(outs, dim=0)


def mt_uniforms_count(state: torch.Tensor, count: int):
    """Exactly ``count`` uniforms per lane: ceil(count/624) fresh blocks,
    tail discarded.

    THE draw pattern every sweep consumer uses (the plain path and the
    CUDA kernel alike): discarding the tail keeps each call's stream
    position a pure function of (state, count), which is what makes the
    host-side and in-kernel generation bit-exact replayable.

    Returns ``(new_state, uniforms)`` with uniforms shape
    ``(count,) + state.shape[1:]``.
    """
    state, u = mt_uniform_blocks(state, -(-count // N))
    return state, u[:count]


# ----------------------------------------------------------------------------
# Pure-NumPy scalar reference (the textbook sequential algorithm) used as the
# oracle in tests; deliberately written in the unvectorized in-place style of
# the original Matsumoto-Nishimura code.
# ----------------------------------------------------------------------------


class ScalarMT19937Ref:
    """Sequential in-place MT19937, matching C++ std::mt19937 output."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.mt = np.empty(N, dtype=np.uint32)
        self.mt[0] = np.uint32(seed)
        mult = np.uint32(INIT_MULT)
        with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
            for i in range(1, N):
                prev = self.mt[i - 1]
                self.mt[i] = mult * (prev ^ (prev >> np.uint32(30))) + np.uint32(i)
        self.index = N

    def _twist_inplace(self):
        mt = self.mt
        for i in range(N):
            y = (mt[i] & np.uint32(UPPER_MASK)) | (mt[(i + 1) % N] & np.uint32(LOWER_MASK))
            mag = np.uint32(MATRIX_A) if (y & np.uint32(1)) else np.uint32(0)
            mt[i] = mt[(i + M) % N] ^ (y >> np.uint32(1)) ^ mag
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= N:
            self._twist_inplace()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(TEMPER_B)
        y ^= (y << np.uint32(15)) & np.uint32(TEMPER_C)
        y ^= y >> np.uint32(18)
        return int(y)
