"""swap_share: percent of the window's wall that the host spends in the
ladders' swap phase (`PTJob.on_segment` of the benchmark's own jobs)."""

from pbench.readers import span_share


def read(rec):
    seg = rec.get("segments")
    return span_share(rec, seg) if seg else None
