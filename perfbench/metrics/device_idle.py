"""Percent of the profiler window in which no kernel, copy or memset ran
on the device."""

from pbench.readers import device_idle


def read(rec):
    return device_idle(rec)
