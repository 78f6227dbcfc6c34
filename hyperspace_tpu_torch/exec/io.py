"""Scan-side IO: parquet files -> columnar batches, through pyarrow.

Files decode concurrently on a shared thread pool (pyarrow releases the
GIL), and every decoded file — and every multi-file concatenation — stays
in a byte-capped cache keyed on (path, mtime, size, columns), so repeated
scans of the same immutable index files skip decode entirely and any rewrite
of a file invalidates its entries.

The JAX package's native row-group decoder, its on-device dictionary
expansion and its parquet row-group pruning are not in the port yet: every
file decodes whole with pyarrow, which yields the same numpy arrays, and the
Filter above a scan applies the whole predicate, so answers are unchanged.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.utils.lru import BytesLRU

# ---------------------------------------------------------------------------
# Per-file decoded-batch cache (the framework's buffer pool). Entries key on
# (path, mtime_ns, size, columns) so any rewrite invalidates naturally.
# ---------------------------------------------------------------------------

_io_cache = BytesLRU(int(os.environ.get("HS_IO_CACHE_BYTES", 1 << 31)))


def _batch_nbytes(batch: B.Batch) -> int:
    total = 0
    for a in batch.values():
        if a.dtype == object and len(a):
            # strings: numpy reports pointer size only; estimate payload by
            # scaling a bounded sample to the full length
            k = min(len(a), 64)
            sample = sum(len(str(v)) for v in a[:k])
            total += int(a.nbytes) + int(sample * len(a) / k)
        else:
            total += int(a.nbytes)
    return total


def _io_cache_key(path: str, columns: Optional[List[str]]):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (path, st.st_mtime_ns, st.st_size, tuple(columns) if columns is not None else None)


def _io_cache_get(key) -> Optional[B.Batch]:
    if key is None:
        return None
    got = _io_cache.get(key)
    if got is not None:
        return dict(got)  # callers may add/remove dict keys
    return None


def _io_cache_put(key, batch: B.Batch) -> None:
    if key is None:
        return
    # cached buffers are shared with every future reader of this file —
    # freeze them so an in-place mutation of a collected result raises
    # instead of silently corrupting the cache
    for a in batch.values():
        a.setflags(write=False)
    _io_cache.put(key, dict(batch), _batch_nbytes(batch))


def clear_io_cache() -> None:
    _io_cache.clear()


_DECODE_POOL = None
_DECODE_POOL_LOCK = threading.Lock()
_DECODE_THREADS = 8  # hyperspace.exec.io.decodeThreads, via set_decode_threads


def set_decode_threads(n: int) -> None:
    """Record the conf's pool width (called on Session construction). The
    pool is process-global and is built at this width by the first scan
    that decodes more than one file."""
    global _DECODE_THREADS
    _DECODE_THREADS = max(1, int(n))


def _decode_pool():
    """Shared decode thread pool — per-call pools would pay thread spin-up on
    every scan."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        with _DECODE_POOL_LOCK:
            if _DECODE_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _DECODE_POOL = ThreadPoolExecutor(max_workers=_DECODE_THREADS, thread_name_prefix="hs-decode")
    return _DECODE_POOL


def read_parquet_batch(files: List[str], columns: Optional[List[str]]) -> B.Batch:
    """Read ``columns`` of ``files`` into one concatenated batch, in file
    order.

    Schema-evolved datasets (a file missing a requested column, or differing
    per-file schemas when ``columns`` is None) null-fill against the unified
    schema: per file where some files carry every column, as one dataset
    read where none do.
    """

    def _dataset_read() -> B.Batch:
        trace.record("decode", "pyarrow-dataset")
        schema = pa.unify_schemas([pq.read_schema(f) for f in files])
        return B.table_to_batch(pads.dataset(files, format="parquet", schema=schema).to_table(columns=columns))

    # a multi-file scan's CONCATENATED batch is itself cacheable (same
    # immutability argument as the per-file entries); trace events mirror
    # the per-file cached path
    concat_key = None
    if columns is not None and len(files) > 1:
        per_file = [_io_cache_key(f, columns) for f in files]
        # a None per-file key (stat failed) disables caching everywhere
        # else; embedding it in the tuple would collide unrelated scans
        if all(k is not None for k in per_file):
            concat_key = ("concat", tuple(per_file))
            got = _io_cache_get(concat_key)
            if got is not None:
                for _ in files:
                    trace.record("decode", "cached")
                return got

    # fully-cached scan with an explicit projection: every cached batch holds
    # exactly ``columns``, so concatenation is schema-safe and the schema
    # pre-scan can be skipped
    cached = [_io_cache_get(_io_cache_key(f, columns)) for f in files]
    if columns is not None and cached and all(b is not None for b in cached):
        for _ in cached:
            trace.record("decode", "cached")
        if len(cached) == 1:
            return cached[0]
        out = B.concat(cached)
        _io_cache_put(concat_key, out)
        return out

    # pre-scan schemas; any inconsistency -> unified read
    try:
        schemas = [pq.read_schema(f) for f in files]
    except OSError:
        return _dataset_read()
    evolved: set = set()
    unified: Optional[pa.Schema] = None
    if columns is None:
        names0 = list(schemas[0].names)
        if any(list(s.names) != names0 for s in schemas[1:]):
            return _dataset_read()
    else:
        missing = [f for f, s in zip(files, schemas) if any(c not in s.names for c in columns)]
        if missing:
            if len(missing) == len(files):
                return _dataset_read()
            unified = pa.unify_schemas(schemas)
            if any(c not in unified.names for c in columns):
                return _dataset_read()
            evolved = set(missing)

    def read_one(f: str) -> B.Batch:
        ckey = _io_cache_key(f, columns)
        got = _io_cache_get(ckey)
        if got is not None:
            trace.record("decode", "cached")
            return got
        # an evolved file decodes against the unified schema so its missing
        # columns null-fill with their siblings' types
        schema = unified if f in evolved else None
        trace.record("decode", "pyarrow")
        got = B.table_to_batch(pads.dataset([f], format="parquet", schema=schema).to_table(columns=columns))
        _io_cache_put(ckey, got)
        return got

    # decode files concurrently; list order — bucket sortedness — is
    # preserved by mapping, not by completion
    if len(files) > 1:
        batches = list(_decode_pool().map(read_one, files))
    else:
        batches = [read_one(f) for f in files]
    if len(batches) == 1:
        return batches[0]
    out = B.concat(batches)
    _io_cache_put(concat_key, out)
    return out
