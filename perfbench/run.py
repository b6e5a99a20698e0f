"""Run one benchmark cell once; prints one JSON line last on stdout.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program is ``src/repro_torch``, the
cell and everything it names are found from ``BENCHMARK.json``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "out" / "cache"
# Every build and kernel cache inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# One process a card with few threads; nothing may pull in JAX.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))

from pbench.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
