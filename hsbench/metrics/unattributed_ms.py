"""A served request's wall that lies in no stage per completed request: from
entry to ``QueryServer.submit`` to its seal, less the admission queue's wait
and its outermost stages. None from a program without it."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("unattributed",)


def read(r):
    return per_request_ms(r, KEYS) if "request" in r["delta"]["stages"] else None
