"""Percent of the profiler window in which no kernel, copy or memset ran
on a card, the mean over the cell's cards (a card with no activity is
idle throughout)."""

from pbench.readers import device_idle


def read(rec):
    return device_idle(rec)
