"""Quickstart: the paper's technique in five minutes.

1. Build a layered QMC Ising model (the paper's workload).
2. Run the optimization ladder a1 -> a4 and show they agree.
3. Run kernel #5, the a4 sweep on the caller's uniforms
   (kernels/csrc/metropolis_sweep.cu), and show it is bit-exact against
   its plain version (on the CPU the wrapper runs the plain version).

  PYTHONPATH=src python -m repro_torch.examples.quickstart              # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.core import ising, metropolis
from repro_torch.kernels import ops, ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    # The paper's production geometry, scaled down: L layers x n spins.
    m = ising.random_layered_model(n=24, L=64, seed=0, beta=1.0)
    spins0 = ising.init_spins(m, seed=1)
    print(f"model: {m.L} layers x {m.n} spins = {m.num_spins} spins, "
          f"space degree {m.space_degree}")
    e0 = ising.energy(m, spins0)

    # --- the ladder (paper Table 1), on the plain backend ---
    results = {}
    for impl in ("a1", "a2", "a3", "a4"):
        t0 = time.perf_counter()
        spins, _ = metropolis.run_sweeps(m, spins0, impl, 5, seed=42, V=4, device=dev)
        dt = time.perf_counter() - t0
        results[impl] = (spins, dt)
        print(f"  {impl}: 5 sweeps in {dt*1e3:7.1f} ms   "
              f"energy {e0:9.2f} -> {ising.energy(m, spins):9.2f}")
    # a3 and a4 share the RNG layout -> identical results.
    assert np.array_equal(results["a3"][0], results["a4"][0])

    # --- kernel #5 (128-lane layout) against its plain version ---
    m128 = ising.random_layered_model(n=6, L=256, seed=5, beta=1.1)
    inputs = ops.make_kernel_inputs(m128, batch=2, seed=9, device=dev)
    out_kernel = ops.metropolis_sweep(*inputs, n=m128.n)
    out_plain = ref.metropolis_sweep_ref(*inputs, n=m128.n)
    for a, b in zip(out_kernel, out_plain):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    where = "CUDA kernel #5" if dev == "cuda" else "the wrapper (plain version on the CPU)"
    print(f"{where} == a4 plain version: bit-exact over 2 replicas "
          f"({m128.L} layers interlaced across 128 lanes)")
    return results, [t.cpu().numpy() for t in out_kernel]


if __name__ == "__main__":
    main()
