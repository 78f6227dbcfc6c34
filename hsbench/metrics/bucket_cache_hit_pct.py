"""Share of the server's bucket-cache lookups in the window that hit
(``stats()["bucketCache"]``); nothing when no lookup was made."""


def read(r):
    d = r["delta"]
    n = d["bucket_hits"] + d["bucket_misses"]
    return 100.0 * d["bucket_hits"] / n if n else None
