"""Host time in the host operators per completed request: the pandas
aggregate, host predicates and row masks, the generic merge, and the joins'
host expansion, verification and gather."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("agg_host", "host_predicate", "mask_rows", "join_merge", "join_host_expand", "join_verify", "join_gather")


def read(r):
    return per_request_ms(r, KEYS)
