"""sweep_roofline: percent of the device time of the sweep kernels (those
launched inside the engine's launches, in the profiler window) that the
frozen bound of their work would take at the card's published peaks."""

from pbench.readers import bound_s


def read(rec):
    dev = rec.get("device")
    if not dev or not dev.get("engine_kernel_s"):
        return None
    chunks: dict = {}
    for t, k in rec.get("launches", []):
        if dev["t0"] <= t <= dev["t1"]:
            chunks[k] = chunks.get(k, 0) + 1
    bound = bound_s(rec, chunks)
    return None if not bound else 100.0 * bound / dev["engine_kernel_s"]
