"""Host time in the plan-and-rewrite layer per completed request: the
server's ``parse`` (the SQL text's parse and memo, the plan fingerprint) and
``resolve`` (the plan-cache lookup and bind, the compile on a miss; a
``rewrite`` nests in it). None from a program whose stage clock keeps no
``request`` key."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("parse", "resolve")


def read(r):
    return per_request_ms(r, KEYS) if "request" in r["delta"]["stages"] else None
