"""step_mfu: percent of the window's wall, times the cell's cards, that the
frozen bound of all the sweeps it launched (idle slots included: the kernel
sweeps them) would take at one card's published peaks; it bounds
sweep_roofline from below."""

from pbench.readers import bound_s, launch_chunks


def read(rec):
    bound = bound_s(rec, launch_chunks(rec))
    return None if not bound else 100.0 * bound / (rec["wall_s"] * len(rec["cards"]))
