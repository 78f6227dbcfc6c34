"""Mean wait in the admission queue of the requests dispatched in the window
(``hs_admission_wait_seconds``, this server's series: sum over count)."""


def read(r):
    d = r["delta"]
    return 1e3 * d["wait_sum"] / d["wait_count"] if d["wait_count"] else None
