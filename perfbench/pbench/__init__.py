"""The benchmark harness of the PyTorch and CUDA annealing service.

`cli.main` runs one cell of ``BENCHMARK.json`` once; everything a cell
names (its configuration, its traffic mix, its metrics) is found by name
in the files beside this package (``configs/``, ``traffic/``,
``metrics/``, ``reference/``).
"""
