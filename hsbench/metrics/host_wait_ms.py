"""Wall minus thread CPU time of a request's outermost host stages (the
device programs' and the producer threads' aside) per completed request:
the share of host wall a request spent waiting for the GIL, a lock or the
disk rather than working. None from a program without it."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("host_wait",)


def read(r):
    return per_request_ms(r, KEYS) if "request" in r["delta"]["stages"] else None
