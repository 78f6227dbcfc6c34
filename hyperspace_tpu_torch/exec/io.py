"""Scan-side IO: parquet files -> columnar batches, through pyarrow.

Files decode concurrently on a shared thread pool (pyarrow releases the
GIL), and every decoded file — and every multi-file concatenation — stays
in a byte-capped cache keyed on (path, mtime, size, columns), so repeated
scans of the same immutable index files skip decode entirely and any rewrite
of a file invalidates its entries.

A read under a pushed-down predicate decodes only the row groups whose
footer min/max statistics may hold a match (``prune_row_groups``, the
data-skipping rule's evaluator over one "row" per row group); the Filter
above the scan still applies the whole predicate, so a full-file batch is
always an acceptable answer.

The JAX package's native row-group decoder and its on-device dictionary
expansion are not in the port yet: every kept row group decodes with
pyarrow, which yields the same numpy arrays.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np
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
    _PRUNE_MEMO.clear()


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


def _stats_array(vals: List) -> np.ndarray:
    """Per-row-group min or max values as an array the sketch evaluator's
    comparisons understand. None entries (absent statistics) survive as
    object-array nulls, which the evaluator keeps unconditionally."""
    import datetime

    if not vals or any(v is None for v in vals):
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out
    v0 = vals[0]
    if isinstance(v0, datetime.datetime):
        return np.array(vals, dtype="datetime64[us]")
    if isinstance(v0, datetime.date):
        return np.array(vals, dtype="datetime64[D]")
    if isinstance(v0, bytes):
        vals = [v.decode("utf-8", "surrogateescape") for v in vals]
    out = np.asarray(vals)
    if out.dtype.kind in ("U", "S"):
        out = out.astype(object)
    return out


#: kept row groups by (path, mtime, size, predicate text): a repeated query
#: over the same files skips their footer reads
_PRUNE_MEMO: dict = {}
_UNSEEN = object()


def prune_row_groups(path: str, predicate) -> Optional[List[int]]:
    """Row-group indices of ``path`` that *might* hold rows matching
    ``predicate``, judged by footer min/max statistics; None when nothing can
    be pruned (every group kept). Columns without statistics — or predicate
    shapes outside the evaluator's language — keep their groups."""
    refs = sorted(set(predicate.references()))
    if not refs:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (path, st.st_mtime_ns, st.st_size, repr(predicate))
    kept = _PRUNE_MEMO.get(key, _UNSEEN)
    if kept is _UNSEEN:
        kept = _prune_by_footer(path, predicate, refs)
        if len(_PRUNE_MEMO) > 65536:
            _PRUNE_MEMO.clear()
        _PRUNE_MEMO[key] = kept
    return None if kept is None else list(kept)


def _prune_by_footer(path: str, predicate, refs: List[str]) -> Optional[List[int]]:
    from hyperspace_tpu_torch.indexes.dataskipping import MinMaxSketch
    from hyperspace_tpu_torch.rules.dataskipping_rule import _SketchEvaluator

    try:
        md = pq.read_metadata(path)
    except (OSError, pa.ArrowInvalid):
        # pruning is an optimization: the full decode still answers (and
        # surfaces a genuinely bad file)
        return None
    n_rg = md.num_row_groups
    if n_rg == 0:
        return None
    rg0 = md.row_group(0)
    col_idx = {rg0.column(j).path_in_schema: j for j in range(rg0.num_columns)}
    lower_idx = {name.lower(): j for name, j in col_idx.items()}
    sketches, table = [], {}
    for c in refs:
        j = col_idx.get(c, lower_idx.get(c.lower()))
        if j is None:
            continue  # partition / computed column: no file statistics
        mins: List = []
        maxs: List = []
        for i in range(n_rg):
            st = md.row_group(i).column(j).statistics
            if st is not None and st.has_min_max:
                mins.append(st.min)
                maxs.append(st.max)
            else:
                mins.append(None)
                maxs.append(None)
        s = MinMaxSketch(c)
        mn_name, mx_name = s.output_names()
        table[mn_name] = _stats_array(mins)
        table[mx_name] = _stats_array(maxs)
        sketches.append(s)
    if not sketches:
        return None
    try:
        mask = _SketchEvaluator(sketches, table, n_rg).eval(predicate)
    except Exception:
        return None  # pruning must never break a read the full decode answers
    if mask is None or mask.all():
        return None
    return [int(i) for i in np.nonzero(mask)[0]]


def _read_row_groups(f: str, columns: Optional[List[str]], schema: pa.Schema, keep: List[int]) -> B.Batch:
    """Decode only the kept row groups of one file. A fully pruned file
    gives a typed empty batch from the file schema."""
    if not keep:
        trace.record("decode", "rowgroup-pruned")
        t = schema.empty_table()
        if columns is not None:
            t = t.select(columns)
        return B.table_to_batch(t)
    ckey = _io_cache_key(f, columns)
    ckey = ckey + (("rg",) + tuple(keep),) if ckey is not None else None
    got = _io_cache_get(ckey)
    if got is not None:
        trace.record("decode", "cached")
        return got
    trace.record("decode", "pyarrow-rowgroups")
    got = B.table_to_batch(pq.ParquetFile(f).read_row_groups(keep, columns=columns))
    _io_cache_put(ckey, got)
    return got


def read_parquet_batch(files: List[str], columns: Optional[List[str]], predicate=None) -> B.Batch:
    """Read ``columns`` of ``files`` into one concatenated batch, in file
    order.

    Schema-evolved datasets (a file missing a requested column, or differing
    per-file schemas when ``columns`` is None) null-fill against the unified
    schema: per file where some files carry every column, as one dataset
    read where none do.

    ``predicate`` (a pushed-down filter Expr) enables row-group min/max
    pruning: groups its statistics definitively exclude are never decoded.
    The caller's Filter still applies the predicate, so a cached full-file
    batch (more rows) is always an acceptable answer, and is served before
    any pruning.
    """

    def _dataset_read() -> B.Batch:
        trace.record("decode", "pyarrow-dataset")
        schema = pa.unify_schemas([pq.read_schema(f) for f in files])
        ds = pads.dataset(files, format="parquet", schema=schema)
        cols = columns
        if columns is not None and any("." in c and c not in ds.schema.names for c in columns):
            # nested struct paths (hybrid scan's appended-file side of a
            # nested index): project leaves into flat columns
            import pyarrow.compute as pc

            from hyperspace_tpu_torch.plan.expr import strip_nested_prefix

            def resolve_path(dotted: str):
                # case-insensitive per segment (the resolver only exact-cases
                # the root; pc.field is case-sensitive)
                parts = dotted.split(".")
                out, fields = [], list(ds.schema)
                for i, p in enumerate(parts):
                    hit = next((f for f in fields if f.name.lower() == p.lower()), None)
                    if hit is None:
                        return parts  # let arrow raise its own error
                    out.append(hit.name)
                    if i < len(parts) - 1:
                        t = hit.type
                        fields = [t.field(j) for j in range(t.num_fields)] if pa.types.is_struct(t) else []
                return out

            cols = {}
            for c in columns:
                if c in ds.schema.names:
                    cols[c] = pc.field(c)
                else:
                    cols[c] = pc.field(*resolve_path(strip_nested_prefix(c)))
        return B.table_to_batch(ds.to_table(columns=cols))

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
            if got is None and predicate is not None:
                # the pruned concatenation, under a key of its own: it holds
                # fewer rows than the full one, so only the same predicate
                # may read it
                got = _io_cache_get(concat_key + (("rg-pred", repr(predicate)),))
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

    def read_one(f: str, schema: pa.Schema) -> B.Batch:
        ckey = _io_cache_key(f, columns)
        got = _io_cache_get(ckey)
        if got is not None:
            trace.record("decode", "cached")
            return got
        if predicate is not None and f not in evolved:
            keep = prune_row_groups(f, predicate)
            if keep is not None:
                return _read_row_groups(f, columns, schema, keep)
        # an evolved file decodes against the unified schema so its missing
        # columns null-fill with their siblings' types
        trace.record("decode", "pyarrow")
        ds = pads.dataset([f], format="parquet", schema=unified if f in evolved else None)
        got = B.table_to_batch(ds.to_table(columns=columns))
        _io_cache_put(ckey, got)
        return got

    # decode files concurrently; list order — bucket sortedness — is
    # preserved by mapping, not by completion
    if len(files) > 1:
        batches = list(_decode_pool().map(read_one, files, schemas))
    else:
        batches = [read_one(f, s) for f, s in zip(files, schemas)]
    if len(batches) == 1:
        return batches[0]
    out = B.concat(batches)
    # a pruned concatenation holds fewer rows than the full scan; caching it
    # under the unpruned concat key would serve predicate-less readers of
    # the same files with rows missing
    if predicate is None:
        _io_cache_put(concat_key, out)
    elif concat_key is not None:
        _io_cache_put(concat_key + (("rg-pred", repr(predicate)),), out)
    return out
