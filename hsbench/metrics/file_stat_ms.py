"""Host time in stat sweeps of a query's files per completed request: the
device scan cache's identity (``scan_identity``), the streamed paths' size
gate (``stream_gate``), the broadcast join's size estimate
(``broadcast_gate``) and its build cache's identity (``build_identity``).
None from a program whose stage clock keeps no ``request`` key."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("scan_identity", "stream_gate", "broadcast_gate", "build_identity")


def read(r):
    return per_request_ms(r, KEYS) if "request" in r["delta"]["stages"] else None
