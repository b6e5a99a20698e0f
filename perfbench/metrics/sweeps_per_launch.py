"""Sweeps a launch over the window (``serve.sweeps_elapsed`` over
``serve.launches``): how far the chunk is cut below its 64 sweeps."""

from pbench.readers import delta


def read(rec):
    n = delta(rec, "serve.launches")
    return delta(rec, "serve.sweeps_elapsed") / n if n else None
