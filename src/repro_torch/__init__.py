"""PyTorch + CUDA port of the `repro` annealing system.

The same module tree as the JAX reference package, without importing it
(or JAX): core (model, lane layout, MT19937, fast exp, the colored
sweep, the engine), kernels (the hand-written CUDA kernel, its plain
PyTorch version and its wrapper), serve_mc (the continuous-batching
server), obs (telemetry) and launch (the CLI).  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
