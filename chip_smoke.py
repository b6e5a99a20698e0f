#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA device; ~1 minute
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --profile  # also trace one serving run (torch.profiler)

Phases (any failure raises, so the script exits non-zero and never prints
its final ok line):

  1. environment: Python / torch / CUDA versions and the card's name and
     power limit (nvidia-smi);
  2. build every kernel of the serving path from csrc/ (nvcc, sm_90a) and
     print ptxas's register / shared-memory lines;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs: bit-equal (torch.equal) at the main path's shape
     (n=96, L=256, B=8, 8 sweeps) and at a two-generator-block shape
     (n=320, L=256); the plain version on the card is also held against
     the plain version on the CPU at the main shape;
  4. the main path: `anneal_serve.main` serves 12 anneal jobs (constants
     and ramps, 64-256 sweeps) at the paper's per-model width (96 spins x
     256 layers) on 8 slots in chunks of 8 sweeps; every job must be
     served, each energy must equal `observables.energies` of its spins,
     every result must be bit-identical to the same jobs served with
     the plain version on the card, and the kernel must have been
     launched once per served chunk (launch counts are zeroed just
     before and read just after);
  5. timings from CUDA events: kernel and plain-version ms per launch at
     B=8 and B=115 (8 sweeps each), the bytes bound, the achieved rate,
     and the serving phase's sweeps/s and spin-flips/s.

The last three lines of standard output are the nvidia-smi line, one JSON
line ``{"kernels": [...]}`` and the final ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
#: 67 TFLOP/s float32 outside the tensor cores.  That rate counts a fused
#: multiply-add as two operations (132 SMs x 128 float32 lanes x 2 at the
#: 1.98 GHz boost clock); the operations here are single adds, multiplies,
#: compares and bit operations, so a float32 one issues at half of it and
#: an int32 one at a quarter (64 int32 lanes per SM, which the float32
#: pipe shares).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
SMS = 132

MAIN_N, MAIN_L, MAIN_SLOTS, MAIN_CHUNK = 96, 256, 8, 8
LANES, MT_N = 128, 624

SERVE_ARGS = [
    "--jobs", "12", "--slots", str(MAIN_SLOTS), "--chunk", str(MAIN_CHUNK),
    "--n", str(MAIN_N), "--L", str(MAIN_L), "--V", str(LANES),
    "--budget-min", "64", "--budget-max", "256", "--seed", "0", "--quiet",
]


def bytes_moved(B: int, rows: int) -> int:
    """Bytes the colored multisweep must move per launch: spins in, the
    generator state in and out, spins/h_space/h_tau out (float32 / uint32)."""
    return 4 * B * (rows * LANES + 2 * MT_N * LANES + 3 * rows * LANES)


def ops_done(B: int, rows: int, sd: int, sweeps: int) -> tuple[int, int]:
    """(int32, float32) operations per launch.  Per sweep: ceil(rows/624)
    twists of 624 generator words (8 int ops each); tempering of the
    ``rows`` words drawn (10 int ops, the >> 8 and the int->float
    conversion, then one float multiply); the class update of every spin
    (a multiply and an add per space neighbour, then the tau sum and
    product, the field sum, the two products of x, the exp's scale,
    conversion (int), bias add (int) and centre product, the accept
    compare and the flip).  After the last sweep, the dense field pass."""
    blocks = -(-rows // MT_N)
    spins = rows * LANES
    int_ops = sweeps * (blocks * MT_N * LANES * 8 + spins * (12 + 2))
    fp_ops = sweeps * spins * (1 + 2 * sd + 9) + spins * (2 * sd + 2)
    return B * int_ops, B * fp_ops


def ops_seconds(int_ops: int, fp_ops: int) -> float:
    """Least time for the operations: int32 ops on their own lanes, and all
    of them on the float32 pipe that those lanes are part of."""
    return max(int_ops / INT32_OPS_PER_S, (int_ops + fp_ops) / FP32_OPS_PER_S)


def bound(B: int, rows: int, sd: int, sweeps: int) -> tuple[float, str, float]:
    """(least ms the card could take, which of bytes/operations bounds it,
    least ms with one CTA per replica: the operations on min(B, 132) SMs)."""
    t_bytes = bytes_moved(B, rows) / HBM_BYTES_PER_S * 1e3
    t_ops = ops_seconds(*ops_done(B, rows, sd, sweeps)) * 1e3
    t_occ = t_ops * SMS / min(B, SMS)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_occ)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def colored_case(n: int, L: int, B: int, device, seed: int = 0):
    """A model, its kernel entry, its plain entry and one batch of inputs."""
    from repro_torch.core import engine, ising, metropolis
    from repro_torch.kernels import ops, ref

    m = ising.random_layered_model(n=n, L=L, seed=seed, beta=1.1)
    eng = engine.SweepEngine.create(m, rung="cb", backend="torch", batch=B, V=LANES, device=device)
    carry = eng.init_carry(seed=seed + 1)
    # Spread the betas so replicas differ in acceptance rate.
    betas = torch.linspace(0.3, 1.5, B, device=device, dtype=torch.float32)
    kernel = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=n)
    classes = metropolis.classes_to(eng.classes, device)
    tabs = dict(
        h=torch.as_tensor(m.h, device=device),
        base_nbr=torch.as_tensor(m.space_nbr, dtype=torch.int64, device=device),
        base_J=torch.as_tensor(m.space_J, device=device),
        tau_J=torch.as_tensor(m.tau_J, device=device),
    )

    def plain(spins, rng, beta, sweeps):
        return ref.colored_multisweep_ref(
            spins, rng, beta, classes, **tabs, n=n, num_sweeps=sweeps
        )

    return m, eng.rows, kernel, plain, (carry.spins, carry.rng, betas)


def assert_same(got, want, what: str) -> float:
    """Raise unless every output is bit-equal; return the max |difference|
    over the float outputs (0.0 when equal)."""
    names = ("spins", "h_space", "h_tau", "rng")
    err = 0.0
    for name, a, b in zip(names, got, want):
        if a.dtype.is_floating_point:
            err = max(err, float((a.double() - b.double()).abs().max()))
        if not torch.equal(a, b):
            bad = (a != b).nonzero()
            raise AssertionError(
                f"{what}: {name} differs at {bad.shape[0]} of {a.numel()} places, "
                f"first {bad[0].tolist()}: {a[tuple(bad[0])].item()} vs {b[tuple(bad[0])].item()}"
            )
    return err


def profile_serve() -> None:
    """Trace one kernel-served run with torch.profiler: device time of
    every kernel against the drain's wall time (the device busy share)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import anneal_serve

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        report = anneal_serve.main(SERVE_ARGS + ["--device", "cuda", "--backend", "cuda"])
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in rows)
    ours = sum(e.self_device_time_total for e in rows if "colored_multisweep" in e.key)
    wall_us = report.seconds * 1e6
    print(f"[profile] serving drain under the profiler: {report.seconds:.3f} s wall, device busy "
          f"{total_us / 1e3:.3f} ms ({total_us / wall_us:.3f} of wall), of which "
          f"colored_multisweep {ours / 1e3:.3f} ms; top device ops:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:70]}")


def main(argv: list[str]) -> int:
    quick = "--quick" in argv
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to test", file=sys.stderr)
        return 2
    from repro_torch.core import observables
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import anneal_serve

    dev = torch.device("cuda:0")
    # -- 1. environment ----------------------------------------------------
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(["colored_multisweep"])
    print(f"[build] colored_multisweep.cu in {time.perf_counter() - t0:.1f} s")
    print(_build.ptxas_report("colored_multisweep"))

    # -- 3. kernel vs plain, on the card -----------------------------------
    _, rows, kernel, plain, inputs = colored_case(MAIN_N, MAIN_L, MAIN_SLOTS, dev)
    err = assert_same(kernel(*inputs, 8), plain(*inputs, 8), "main shape")
    cpu_in = tuple(t.cpu() for t in inputs)
    _, _, _, plain_cpu, _ = colored_case(MAIN_N, MAIN_L, MAIN_SLOTS, "cpu")
    assert_same([t.cpu() for t in plain(*inputs, 8)], plain_cpu(*cpu_in, 8), "plain cuda vs cpu")
    print(f"[check] n={MAIN_N} L={MAIN_L} B={MAIN_SLOTS} rows={rows} 8 sweeps: kernel == plain "
          f"(bit-equal), plain on card == plain on CPU")
    _, rows2, kernel2, plain2, inputs2 = colored_case(320, 256, 4, dev, seed=5)
    err = max(err, assert_same(kernel2(*inputs2, 3), plain2(*inputs2, 3), "two-block shape"))
    assert_same(kernel2(*inputs2, 0), plain2(*inputs2, 0), "zero sweeps")
    print(f"[check] n=320 L=256 B=4 rows={rows2} (2 generator blocks/sweep) 3 sweeps and 0 sweeps: "
          f"kernel == plain (bit-equal)")
    if quick:
        print("quick checks passed")
        return 0

    # -- 4. the main path: serve through the CLI entry point ---------------
    ops.reset_launches()
    report = anneal_serve.main(SERVE_ARGS + ["--device", "cuda", "--backend", "cuda"])
    launches = dict(ops.launches)
    served = report.server.stats()
    if launches["colored_multisweep"] == 0:
        raise AssertionError("the serving path never launched colored_multisweep")
    if launches["colored_multisweep"] != served["launches"]:
        raise AssertionError(f"kernel launches {launches} != server launches {served['launches']}")
    if len(report.results) != 12:
        raise AssertionError(f"served {len(report.results)} of 12 jobs")
    N = MAIN_N * MAIN_L
    for r in report.results:
        if r.spins.shape != (N,) or not np.all(np.abs(r.spins) == 1.0):
            raise AssertionError(f"job {r.jid}: spins not +-1 of shape ({N},)")
        if not np.isfinite(r.energy) or r.energy != observables.energies(report.model, r.spins):
            raise AssertionError(f"job {r.jid}: energy {r.energy} disagrees with its spins")
    plain_report = anneal_serve.main(SERVE_ARGS + ["--device", "cuda", "--backend", "torch"])
    got = {r.jid: r for r in report.results}
    for r in plain_report.results:
        g = got[r.jid]
        if not (np.array_equal(g.spins, r.spins) and g.energy == r.energy
                and g.sweeps_done == r.sweeps_done and g.chunks == r.chunks
                and g.extras["final_beta"] == r.extras["final_beta"]):
            raise AssertionError(f"job {r.jid}: kernel-served result != plain-served result")
    if list(report.server._retired) != list(plain_report.server._retired):
        raise AssertionError("retirement order differs between kernel and plain serving")
    sweeps_s = served["busy_slot_sweeps"] / report.seconds
    flips_s = served["spin_flips"] / report.seconds
    print(f"[serve] 12 jobs, n={MAIN_N} L={MAIN_L}, {MAIN_SLOTS} slots, chunk {MAIN_CHUNK}: "
          f"{served['launches']} launches == {launches['colored_multisweep']} kernel launches, "
          f"{report.seconds:.3f} s, {sweeps_s:.0f} slot-sweeps/s, {flips_s / 1e6:.2f}M spin-flips/s, "
          f"{len(report.results) / report.seconds:.1f} jobs/s; plain-served on the card: "
          f"{plain_report.seconds:.3f} s; results bit-identical")

    # -- 5. timings (CUDA events) ------------------------------------------
    times = {}
    for B in (MAIN_SLOTS, 115):
        mB, rowsB, kB, pB, inB = colored_case(MAIN_N, MAIN_L, B, dev, seed=B)
        t_k = cuda_ms(lambda: kB(*inB, 8), reps=20)
        t_p = cuda_ms(lambda: pB(*inB, 8), reps=3, warmup=1)
        b_ms, b_by, occ_ms = bound(B, rowsB, mB.space_degree, 8)
        gbs = bytes_moved(B, rowsB) / (t_k * 1e-3) / 1e9
        times[B] = (t_k, t_p, b_ms, b_by)
        print(f"[time] B={B} n={MAIN_N} L={MAIN_L} 8 sweeps: kernel {t_k:.4f} ms/launch, "
              f"plain {t_p:.4f} ms, bound {b_ms:.5f} ms ({b_by}; bytes "
              f"{bytes_moved(B, rowsB) / HBM_BYTES_PER_S * 1e3:.5f} ms), one-CTA-per-replica "
              f"bound {occ_ms:.5f} ms on {min(B, SMS)} of {SMS} SMs, "
              f"{bytes_moved(B, rowsB)} B -> {gbs:.2f} GB/s achieved")
    # Where a launch's time goes, B=8: fixed cost (0 sweeps), per-sweep
    # cost (1 vs 8 sweeps), and its split between the generator twist
    # (independent of rows) and the class walk (linear in rows).
    split = {}
    for n_s in (48, MAIN_N, 192):
        _, rowsS, kS, _, inS = colored_case(n_s, MAIN_L, MAIN_SLOTS, dev, seed=n_s)
        for S in ((0, 1, 8) if n_s == MAIN_N else (8,)):
            split[rowsS, S] = cuda_ms(lambda: kS(*inS, S), reps=10)
    per_sweep = (split[2 * MAIN_N, 8] - split[2 * MAIN_N, 1]) / 7
    per_row = (split[384, 8] - split[96, 8]) / (384 - 96) / 8
    print(f"[split] B={MAIN_SLOTS} rows={2 * MAIN_N}: launch {split[2 * MAIN_N, 0]:.4f} ms at 0 sweeps, "
          f"{per_sweep:.4f} ms per sweep = {per_row * 2 * MAIN_N:.4f} ms class walk "
          f"({per_row * 1e3:.3f} us/row) + {per_sweep - per_row * 2 * MAIN_N:.4f} ms generator; "
          f"8-sweep launch at rows 96/192/384: {split[96, 8]:.4f}/{split[192, 8]:.4f}/{split[384, 8]:.4f} ms")
    if profile:
        profile_serve()
    t_k, t_p, b_ms, b_by = times[MAIN_SLOTS]
    # Launches of the serving run times the B=8 kernel time above (chunks
    # of 8 sweeps; shorter remainder chunks make this an upper estimate).
    share = launches["colored_multisweep"] * t_k * 1e-3 / report.seconds
    print(f"[serve] kernel share of the drain's wall time <= {share:.3f} "
          f"({launches['colored_multisweep']} launches x {t_k:.4f} ms / {report.seconds:.3f} s)")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "colored_multisweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/colored_multisweep.cu",
        "replaces": "src/repro/kernels/metropolis_kernel.py:523",
        "launches": launches["colored_multisweep"],
        "max_abs_err": err,
        "bit_equal": err == 0.0,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
