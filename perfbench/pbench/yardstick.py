"""Work counts and peaks of the sweep kernels, frozen here.

Copied from ``chip_smoke.py`` (``colored_counts``, ``a4_counts``,
``bound`` and the H100 peaks), so that a later change to the program
cannot move the yardstick.  A launch of ``sweeps`` sweeps over ``B``
replicas of ``rows`` lane rows of 128 lanes with ``sd`` space neighbours
a site: (bytes, int32 operations, float32 operations).
"""

from __future__ import annotations

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
#: 67 TFLOP/s float32 outside the tensor cores, which counts a fused
#: multiply-add as two operations; single float32 operations issue at
#: half of it and int32 ones at a quarter (64 int32 lanes an SM, on the
#: float32 pipe).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
LANES, MT_N = 128, 624


def colored_counts(B: int, rows: int, sd: int, sweeps: int) -> tuple[int, int, int]:
    """One colored (cb) multisweep launch: spins and the generator state in;
    spins, both fields and the generator state out; per sweep the twists,
    the tempering of the words drawn and the class update of every spin;
    after the last sweep the dense field pass."""
    blocks = -(-rows // MT_N)
    spins = rows * LANES
    nbytes = 4 * B * (spins + 2 * MT_N * LANES + 3 * spins)
    int_ops = sweeps * (blocks * MT_N * LANES * 8 + spins * (12 + 2))
    fp_ops = sweeps * spins * (1 + 2 * sd + 9) + spins * (2 * sd + 2)
    return nbytes, B * int_ops, B * fp_ops


def a4_counts(B: int, rows: int, sd: int, sweeps: int) -> tuple[int, int, int]:
    """One fused a4 multisweep launch: spins and both fields in and out and
    the generator state in and out; per sweep the twists and tempering and
    the row step of every spin (14 int32 and 2 sd + 16 float32 operations)."""
    blocks = -(-rows // MT_N)
    spins = rows * LANES
    nbytes = 4 * B * (6 * spins + 2 * MT_N * LANES)
    int_ops = sweeps * (blocks * MT_N * LANES * 8 + spins * 14)
    fp_ops = sweeps * spins * (2 * sd + 16)
    return nbytes, B * int_ops, B * fp_ops


COUNTS = {"cb": colored_counts, "a4": a4_counts}


def ops_seconds(int_ops: int, fp_ops: int) -> float:
    return max(int_ops / INT32_OPS_PER_S, (int_ops + fp_ops) / FP32_OPS_PER_S)


def bound_s(counts: tuple[int, int, int]) -> float:
    """The least seconds the card could take for the counts: the larger of
    the bytes at the memory peak and the operations at the compute peak."""
    nbytes, int_ops, fp_ops = counts
    return max(nbytes / HBM_BYTES_PER_S, ops_seconds(int_ops, fp_ops))


def launches_bound_s(rung: str, B: int, rows: int, sd: int, chunks: dict) -> float:
    """The bound of launches ``{sweeps: count}`` of rung ``rung``, summed."""
    count = COUNTS[rung]
    return sum(n * bound_s(count(B, rows, sd, int(k))) for k, n in chunks.items())
