"""job_latency_p95_s.queue: the 95th percentile, over every job due in the
window, of the return of the step that retired it minus its due time; a
job that never retired counts as still waiting at the end of the grace."""

import numpy as np


def read(rec):
    due = [(r["due"], r["done"]) for r in rec["jobs"].values() if r["due"] is not None]
    if not due:
        return None
    end = max([d for _, d in due if d is not None] + [rec["t1"]])
    lat = np.asarray([(d if d is not None else end) - t for t, d in due], np.float64)
    return float(np.percentile(lat, 95))
