"""Host wall time around the device programs per completed request, their
waits included: uploads, launches, waits for masks and results, the joins'
device stages and the top-k fold."""

from hsbench.metrics._stages import per_request_ms

KEYS = ("upload", "agg_upload", "predicate_launch", "wait_copy_mask", "agg_program", "join_upload", "join_span",
        "join_materialize", "join_build", "join_probe", "topk_fold")


def read(r):
    return per_request_ms(r, KEYS)
