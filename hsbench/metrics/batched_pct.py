"""Share of the requests the server completed in the window that it served
inside a shared-scan micro-batch (``stats()``: batchedRequests over completed)."""


def read(r):
    d = r["delta"]
    return 100.0 * d["batched"] / d["completed"] if d["completed"] else None
