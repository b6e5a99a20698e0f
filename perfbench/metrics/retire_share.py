"""Percent of the window's wall spent retiring jobs: the server's own
``sched.retire`` spans (each retiring job's `finalize`, its spins and
observables to the host, and the release of its slots)."""

from pbench.readers import span_share


def read(rec):
    return span_share(rec, rec.get("spans", {}).get("sched.retire"))
