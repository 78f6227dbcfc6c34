"""Host seconds per completed request of a set of ``Session.query_stage_seconds``
keys, summed over the server's worker threads, as milliseconds."""


def per_request_ms(r, keys):
    d = r["delta"]
    if not d["completed"]:
        return None
    return 1e3 * sum(d["stages"].get(k, 0.0) for k in keys) / d["completed"]
