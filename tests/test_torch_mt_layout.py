"""The premise of the MT19937 block kernel's layout (csrc/mt_next_block.cu),
on the CPU.

The kernel gives each CTA a tile of T neighbouring generator columns (the
last tile partial, its columns past V zero), copies the tile's 624 old
rows into shared memory and twists it in place in MT19937's three
dependence phases (mt19937.cuh: twist_block): each phase's rows are split
into W runs, one for each group of threads; the runs of a phase run at
once, so a run's last row reads the next run's first row, which that run
rewrites: each run loads it before the first barrier (the in-place guard,
ROADMAP §3i).  Inside a run the rows go in batches of 4, loads ahead of
stores, loads past the run's end clamped to its last row (twist_rows); each
new row is written out with its tempered word or uniform (uniform_of) as
it is stored.

Here a plain emulation of exactly that (`_block`) is held bit for bit to
the port's plain version (`ref.mt_next_block_ref`, `ref.mt_uniforms_ref`)
at every tile width and run count, in place and out of place, with the
runs of each phase taken in the order that exposes the race; the plain
version is held to the JAX package's `repro.kernels.ref.mt_next_block_ref`
and its Pallas kernel in interpret mode.  Columns are independent, so the
emulation twists all tiles side by side in one (624, tiles, T) tensor.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mt19937 as jmt
from repro.kernels import mt19937_kernel as jkern
from repro.kernels import ref as jref
from repro_torch.core import mt19937 as tmt
from repro_torch.kernels import _build, ref

N, M = tmt.N, tmt.M
SPAN = N - M  # 227 rows a twist phase
AHEAD = 4  # rows a run loads before it stores (mt19937.cuh: TWIST4_AHEAD)
V_CASES = [1, 31, 32, 33, 128, 200, 1024]
TILES = [16, 32, 64]
RUNS = [1, 3, 8, 32]  # 32: the kernel's own count (GROUPS)
BLOCKS = 5


def _twist(u, v, m):
    y = (u & tmt.UPPER_MASK) | (v & tmt.LOWER_MASK)
    return m ^ (y >> 1) ^ ((y & 1) * tmt.MATRIX_A)


def _phase_run(p: int, w: int, runs: int) -> tuple[int, int]:
    """Rows [lo, hi) of phase p that run w of ``runs`` twists (phase_run)."""
    a = p * SPAN
    length = (N if p == 2 else a + SPAN) - a
    return a + length * w // runs, a + length * (w + 1) // runs


def _twist_rows(src, dst, mbase, mshift, lo, hi, v_hi, emitted):
    """twist_rows: rows [lo, hi) in batches of AHEAD, each batch's loads
    (clamped to hi - 1) before its stores; v_hi stands for row hi."""
    for i0 in range(lo, hi, AHEAD):
        at = [min(i0 + k, hi - 1) for k in range(AHEAD + 1)]
        x = [src[i].clone() for i in at]
        m = [mbase[i + mshift].clone() for i in at[:AHEAD]]
        for k in range(AHEAD):
            i = i0 + k
            if i < hi:
                w = _twist(x[k], x[k + 1] if i + 1 < hi else v_hi, m[k])
                dst[i] = w
                emitted[i] = w


def _twist_tiles(tiles, runs: int, in_place: bool, reverse: bool, guard: bool = True):
    """twist_block on (624, ...) words: returns (the tile buffer the new
    words were stored in, the words as emitted)."""
    src = tiles
    dst = tiles if in_place else torch.zeros_like(tiles)
    emitted = torch.full_like(tiles, -1)
    spans = [[_phase_run(p, w, runs) for w in range(runs)] for p in range(3)]
    # Before the first barrier: each run's first row past its end.
    edge = [[src[hi].clone() if hi < N else None for _, hi in spans[p]] for p in range(3)]
    for p in range(3):
        # The runs of a phase run at once; in reverse order the next run
        # has rewritten a run's row hi before the run reaches it.
        for w in (reversed(range(runs)) if reverse else range(runs)):
            lo, hi = spans[p][w]
            if hi < N:
                v_hi = edge[p][w] if guard else src[hi].clone()
            else:
                v_hi = dst[0].clone()  # new row 0, from phase 0
            _twist_rows(src, dst, src if p == 0 else dst, M if p == 0 else -SPAN, lo, hi,
                        v_hi, emitted)
    return dst, emitted


def _uniform_of(words: torch.Tensor) -> torch.Tensor:
    """mt19937.cuh: uniform_of on tempered int64 words."""
    k = words >> 8
    f = tmt.from_u32(k + 0x4B000000).view(torch.float32)
    return torch.where(k < 0x800000, (f - 8388608.0) * 2.0**-24, f * 2.0**-25)


def _block(state: torch.Tensor, T: int, runs: int, in_place: bool = True, reverse: bool = True,
           guard: bool = True):
    """One launch of the block kernel, emulated: ``(new_state, tempered
    words, uniforms)`` from the (624, V) int32 state."""
    V = state.shape[1]
    ntiles = -(-V // T)
    tiles = torch.zeros((N, ntiles * T), dtype=torch.int64)
    tiles[:, :V] = tmt.to_u32(state)  # columns past V read as zero
    tiles = tiles.reshape(N, ntiles, T)
    dst, emitted = _twist_tiles(tiles, runs, in_place, reverse, guard)
    assert torch.equal(dst, emitted), "the tile holds what was written out"
    new = emitted.reshape(N, ntiles * T)[:, :V]  # columns past V are dropped
    words = tmt._temper_words(new)
    return tmt.from_u32(new), tmt.from_u32(words), _uniform_of(words)


def _state(V: int, seed: int = 0) -> torch.Tensor:
    seeds = np.random.default_rng(seed + V).integers(0, 2**32, V, dtype=np.uint64)
    return tmt.mt_init(seeds.astype(np.uint32), device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("T", TILES)
@pytest.mark.parametrize("V", V_CASES)
def test_block_emulation_equals_plain(V, T):
    """At every tile width and run count, in place (with the guard) and out
    of place, one block and five chained blocks of the emulated kernel equal
    the plain version: state, tempered words and uniforms (bit patterns)."""
    start = _state(V)
    want, s = [], start
    for _ in range(BLOCKS):
        s_words, words = ref.mt_next_block_ref(s)
        s_u, u = ref.mt_uniforms_ref(s)
        assert torch.equal(s_words, s_u)
        want.append((s_words, words, u))
        s = s_words
    for runs in RUNS:
        for in_place in (True, False):
            s = start
            for b in range(BLOCKS):
                new, words, u = _block(s, T, runs, in_place)
                for got, exp in zip((new, words, u), want[b]):
                    np.testing.assert_array_equal(
                        _bits(got), _bits(exp),
                        err_msg=f"V={V} T={T} runs={runs} in_place={in_place} block {b + 1}")
                s = new


@pytest.mark.parametrize("V", [33, 200])
def test_in_place_needs_the_guard(V):
    """Without the guard (each run reading row hi when it reaches it) the
    in-place twist goes wrong as soon as a phase has two runs; the guard
    makes every run order right."""
    s = _state(V)
    want = ref.mt_next_block_ref(s)[0]
    assert torch.equal(_block(s, 32, 1, guard=False)[0], want)  # one run: no neighbour
    for runs in (3, 8, 32):
        assert not torch.equal(_block(s, 32, runs, guard=False)[0], want)
        for reverse in (True, False):
            assert torch.equal(_block(s, 32, runs, reverse=reverse)[0], want)


@pytest.mark.parametrize("V", V_CASES)
def test_plain_block_equals_jax(V):
    """The plain version the emulation is held to equals the JAX package's
    reference over five chained blocks (and its Pallas kernel, in interpret
    mode, where V is a multiple of 128, the kernel's lane count)."""
    ts = _state(V)
    js = jnp.asarray(ts.numpy().view(np.uint32))
    for _ in range(BLOCKS):
        jn, jw = jref.mt_next_block_ref(js)
        tn, tw = ref.mt_next_block_ref(ts)
        tnu, tu = ref.mt_uniforms_ref(ts)
        for a, b in ((jn, tn), (jw, tw), (jn, tnu)):
            np.testing.assert_array_equal(np.asarray(a).view(np.int32), _bits(b))
        ju = np.asarray(jmt.uniforms_from_u32(jw))
        np.testing.assert_array_equal(ju.view(np.int32), _bits(tu))
        if V % jkern.LANES == 0:
            kn, kw = jkern.mt_next_block_kernel(js, interpret=True)
            kun, ku = jkern.mt_uniforms_kernel(js, interpret=True)
            np.testing.assert_array_equal(np.asarray(kn).view(np.int32), _bits(tn))
            np.testing.assert_array_equal(np.asarray(kw).view(np.int32), _bits(tw))
            np.testing.assert_array_equal(np.asarray(kun).view(np.int32), _bits(tn))
            np.testing.assert_array_equal(np.asarray(ku).view(np.int32), _bits(tu))
        js, ts = jn, tn


def test_kernel_constants_are_the_emulated_ones():
    """The kernel twists in place, with a tile width, run count and batch
    depth emulated here."""
    src = (_build.CSRC / "mt_next_block.cu").read_text()
    header = (_build.CSRC / "mt19937.cuh").read_text()
    assert int(re.search(r"constexpr int T = (\d+);", src).group(1)) in TILES
    assert re.search(r"constexpr int GROUPS = (\d+);", src).group(1) == str(RUNS[-1])
    assert re.search(r"constexpr int TWIST4_AHEAD = (\d+);", header).group(1) == str(AHEAD)
    assert "twist_block(col, col," in src  # in place
