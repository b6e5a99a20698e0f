"""card_skew: how far the slowest card's device time of the window's
launches lies above the cards' mean, in percent: 100 x (largest - mean) /
mean over the window's growth of ``serve.launch_device_s{device=d}`` (each
mesh device's launches timed on the card) on each of the record's cards
(mesh device d is the record's d-th card where the mesh names each card
once).  None where fewer than two cards' series grew: a one-card record,
or a program that counts no such series."""

from statistics import fmean

from pbench.readers import delta


def read(rec):
    grown = [delta(rec, f"serve.launch_device_s{{device={d}}}") for d in range(len(rec["cards"]))]
    grown = [g for g in grown if g > 0]
    if len(grown) < 2:
        return None
    mean = fmean(grown)
    return 100.0 * (max(grown) - mean) / mean
