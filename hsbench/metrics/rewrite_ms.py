"""Host time in the rewrite (``query_stage_seconds["rewrite"]``) per
completed request; a plan-cache hit skips it."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("rewrite",)


def read(r):
    return per_request_ms(r, KEYS)
