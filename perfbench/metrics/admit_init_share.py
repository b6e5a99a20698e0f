"""Percent of the window's wall in which admission builds the admitted
jobs' slot carries: the server's own ``sched.admit.init`` spans
(`job.init_carries`, on the host)."""

from pbench.readers import span_share


def read(rec):
    return span_share(rec, rec.get("spans", {}).get("sched.admit.init"))
