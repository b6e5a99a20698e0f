"""slot_sweeps_per_s: useful slot-sweeps (sweeps that advanced a job,
``serve.busy_slot_sweeps``) over the window, partial jobs included, per
second of its wall."""

from pbench.readers import delta


def read(rec):
    return delta(rec, "serve.busy_slot_sweeps") / rec["wall_s"]
