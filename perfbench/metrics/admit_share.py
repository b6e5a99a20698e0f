"""Percent of the window's wall spent in admission: the server's own
``sched.admit`` spans (policy plan, park, splice of admitted jobs)."""

from pbench.readers import span_share


def read(rec):
    return span_share(rec, rec.get("spans", {}).get("sched.admit"))
