"""Host time decoding index and source files per completed request: the
scan decode, its prefetch thread's, and the bucketed join's per-bucket decode."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("decode", "prefetch_decode", "join_decode")


def read(r):
    return per_request_ms(r, KEYS)
