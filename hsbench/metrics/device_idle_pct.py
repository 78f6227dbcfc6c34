"""Share of the traced slice in which no kernel, copy or set ran on the
device (``torch.profiler``'s trace, the union of those intervals)."""


def read(r):
    s = r["slice"]
    if not s or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
