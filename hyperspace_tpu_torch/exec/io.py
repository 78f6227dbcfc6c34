"""Scan-side IO: parquet files -> columnar batches, native-first.

Files in the native decoder's dialect (PLAIN or dictionary pages,
uncompressed, snappy, gzip or zstd; flat columns) decode through the port's
build of the C++ reader (``hyperspace_tpu_torch.native``): a whole scan fans
out over (file x row group x column) chunks on the decode pool, each chunk
written straight into its slot of one buffer per column
(``_native_rg_scan``). While a CUDA session is live those buffers are pinned
host memory (``set_pinned_decode``), so the device staging path
(exec/device.py) copies them to the card without a pinning copy of its own.
String columns whose every chunk is dictionary-encoded under
``maxDictEntries`` come back as ``B.DictBackedArray``, and the staging path
ships their int32 codes and expands them on the device ("dict-expand").
Scans the row-group path cannot take decode per file, native first with a
pyarrow fallback (``read_parquet_batch``); every fallback is counted under
``hs_native_fallback_total{reason}``.

Every decoded file and every multi-file concatenation stays in a byte-capped
cache keyed on (path, mtime, size, columns), so repeated scans of the same
immutable index files skip decode, and any rewrite of a file invalidates its
entries (``purge_io_cache`` drops them at a commit).

A read under a pushed-down predicate decodes only the row groups whose
footer min/max statistics may hold a match (``prune_row_groups``, the
data-skipping rule's evaluator over one "row" per row group); the Filter
above the scan still applies the whole predicate, so a full-file batch is
always an acceptable answer.

Lake IO failures are typed (reliability/errors.py): corrupt bytes raise
``CorruptDataError`` and strike the owning index's quarantine breaker, a
transient failure is retried under the retry policy, and the fault seams
``io.footer`` and ``io.decode`` sit where the JAX package has them.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.obs import spans
from hyperspace_tpu_torch.reliability import errors as rerr
from hyperspace_tpu_torch.reliability.degrade import QUARANTINE
from hyperspace_tpu_torch.reliability.faults import FAULTS
from hyperspace_tpu_torch.reliability.retry import with_retry
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


def _key_mentions_path(key, paths) -> bool:
    # cache keys are nested tuples whose leaves include the source path
    # string: file keys are (path, mtime, size, cols), concatenation keys
    # wrap a tuple of per-file keys, row-group keys append a suffix tuple
    if isinstance(key, str):
        return key in paths
    if isinstance(key, tuple):
        return any(_key_mentions_path(part, paths) for part in key)
    return False


def purge_io_cache(paths) -> int:
    """Drop every cached batch derived from any of ``paths`` (commit
    invalidation, lifecycle/invalidation.py); returns the entries removed."""
    wanted = set(paths)
    if not wanted:
        return 0
    removed = 0
    for key in _io_cache.keys():
        if _key_mentions_path(key, wanted) and _io_cache.discard(key):
            removed += 1
    return removed


_DECODE_POOL = None
_DECODE_POOL_LOCK = threading.Lock()
_DECODE_POOL_SIZE: Optional[int] = None  # width the live pool was built with
_DECODE_THREADS = 8  # hyperspace.exec.io.decodeThreads, via set_decode_threads


def decode_threads() -> int:
    """The decode pool's width: ``hyperspace.exec.io.decodeThreads`` of the
    session constructed last (default 8)."""
    return _DECODE_THREADS


def set_decode_threads(n: Optional[int]) -> None:
    """Record the conf's pool width (called on Session construction). A
    live pool of another width is retired (its decodes in flight finish on
    the old threads), and the next scan builds the new one."""
    global _DECODE_THREADS, _DECODE_POOL, _DECODE_POOL_SIZE
    with _DECODE_POOL_LOCK:
        _DECODE_THREADS = max(1, int(n)) if n else 8
        if _DECODE_POOL is not None and _DECODE_POOL_SIZE != _DECODE_THREADS:
            _DECODE_POOL.shutdown(wait=False)
            _DECODE_POOL = None
            _DECODE_POOL_SIZE = None


def _decode_pool():
    """Shared decode thread pool — per-call pools would pay thread spin-up on
    every scan."""
    global _DECODE_POOL, _DECODE_POOL_SIZE
    if _DECODE_POOL is None:
        with _DECODE_POOL_LOCK:
            if _DECODE_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _DECODE_POOL_SIZE = decode_threads()
                _DECODE_POOL = ThreadPoolExecutor(max_workers=_DECODE_POOL_SIZE, thread_name_prefix="hs-decode")
    return _DECODE_POOL


def _dtype_hints(schema: pa.Schema, columns: List[str]) -> Optional[Dict[str, np.dtype]]:
    """Numpy dtypes for the native decoder's INT32/INT64-backed logical
    types (timestamps, dates); None when a requested column's arrow type
    has no faithful numpy mapping (decimal, nested, ...), and the caller
    then reads with pyarrow."""
    hints: Dict[str, np.dtype] = {}
    for c in columns:
        t = schema.field(c).type
        if pa.types.is_timestamp(t):
            hints[c] = np.dtype(f"datetime64[{t.unit}]")
        elif pa.types.is_date32(t):
            # INT32 days since the epoch; pyarrow gives datetime64[D], and
            # the decode widens int32 into it
            hints[c] = np.dtype("datetime64[D]")
        elif pa.types.is_date64(t):
            hints[c] = np.dtype("datetime64[ms]")
        elif (
            pa.types.is_time(t)  # time32/time64 surface as datetime.time objects
            or pa.types.is_duration(t)
            or pa.types.is_decimal(t)
            or pa.types.is_nested(t)
            or pa.types.is_dictionary(t)
        ):
            return None
    return hints


# ---------------------------------------------------------------------------
# Row-group pruning: a scan's pushed-down predicate is evaluated against the
# footers' per-row-group min/max statistics before any decode, through the
# data-skipping rule's three-valued evaluator: "definitely no match" skips
# the row group, anything uncertain decodes it.
# ---------------------------------------------------------------------------


def _rg_counters():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return (
        REGISTRY.counter(
            "hs_rowgroups_scanned_total",
            "Parquet row groups decoded by predicate-pushdown scans",
        ),
        REGISTRY.counter(
            "hs_rowgroups_skipped_total",
            "Parquet row groups skipped by min/max statistics pruning",
        ),
        REGISTRY.counter(
            "hs_rowgroup_bytes_skipped_total",
            "Bytes of parquet row groups skipped by min/max statistics pruning",
        ),
    )


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
        if FAULTS.active:
            FAULTS.check("io.footer", path)
        st = os.stat(path)
    except OSError as exc:
        # pruning is an optimization: the full decode still answers (and
        # classifies a genuinely bad file), but the failure is counted
        rerr.count_io_error("io.footer", exc, swallowed=True)
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
    except (OSError, pa.ArrowInvalid) as exc:
        rerr.count_io_error("io.footer", exc, swallowed=True)
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


def _count_pruned(path: str, keep: List[int], dsp) -> int:
    """Count one pruned file's kept and skipped row groups (and set them on
    its decode span, if any); returns the bytes skipped."""
    scanned_c, skipped_c, bytes_c = _rg_counters()
    md = pq.read_metadata(path)
    n_rg = md.num_row_groups
    kept = set(keep)
    sk_bytes = sum(md.row_group(i).total_byte_size for i in range(n_rg) if i not in kept)
    scanned_c.inc(len(keep))
    skipped_c.inc(n_rg - len(keep))
    bytes_c.inc(sk_bytes)
    if dsp is not None:
        dsp.set(rowgroups_skipped=n_rg - len(keep), rowgroup_bytes_skipped=int(sk_bytes))
    return int(sk_bytes)


class _FileNote:
    __slots__ = ("facts",)

    def __init__(self, facts: dict):
        self.facts = facts

    def set(self, **attrs) -> "_FileNote":
        self.facts.update(attrs)
        return self


def _file_note(f: str):
    """One file's decode facts (``rows``, the row groups skipped), noted on
    the context's current span, the decode stage's (obs/stages.py), as one
    entry of its ``decoded`` list; a no-op without a trace."""
    sp = spans.current_span()
    if sp is None:
        return spans.NULL_SPAN
    facts = {"file": os.path.basename(f)}
    sp.attrs.setdefault("decoded", []).append(facts)  # list.append: atomic under the GIL
    return _FileNote(facts)


def _read_row_groups(f: str, columns: Optional[List[str]], schema: pa.Schema, keep: List[int], dsp) -> B.Batch:
    """Decode only the kept row groups of one file (pyarrow). A fully pruned
    file gives a typed empty batch from the file schema."""
    _count_pruned(f, keep, dsp)
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
    dsp.set(rows=B.num_rows(got))
    _io_cache_put(ckey, got)
    return got


# ---------------------------------------------------------------------------
# Native row-group fast path: one scan decodes every surviving (file x row
# group x column) chunk in parallel on the decode pool, each chunk written
# straight into its slot of one buffer per column. Assembly is concat-free:
# the batch's columns are those buffers. The port pads nothing (torch has no
# shape-keyed compile cache), so a buffer holds exactly the scan's rows.
# ---------------------------------------------------------------------------

_NATIVE_ENABLED = True  # hyperspace.exec.io.native.enabled
_NATIVE_RG = True  # hyperspace.exec.io.native.rowGroupDecode
_MAX_DICT = 4096  # hyperspace.exec.io.native.maxDictEntries
_PINNED = False  # a CUDA session is live: decode buffers are pinned
_STAGING_PAD = 1  # shard-count multiple of the decode buffers (set_staging_pad)
#: a scan whose row groups average fewer rows decodes on the calling thread:
#: a pool task's hand-off and the threads' contention for the interpreter
#: lock then cost more than the chunk's decode (on an eight-core host, index
#: runs of a few thousand rows decode about 1.8x faster inline, and source
#: files of 125 000-row groups about 1.6x faster on the pool)
_FANOUT_MIN_ROWS = 32768


def set_native_options(
    enabled: Optional[bool] = None,
    rowgroup: Optional[bool] = None,
    max_dict_entries: Optional[int] = None,
) -> None:
    """Record the conf's native decode keys (called on Session construction;
    the session constructed last wins, as for the decode pool)."""
    global _NATIVE_ENABLED, _NATIVE_RG, _MAX_DICT
    if enabled is not None:
        _NATIVE_ENABLED = bool(enabled)
    if rowgroup is not None:
        _NATIVE_RG = bool(rowgroup)
    if max_dict_entries is not None:
        _MAX_DICT = int(max_dict_entries)


def set_pinned_decode(on: bool) -> None:
    """Decode fixed-width columns into pinned host memory (torch's caching
    host allocator) from now on: set by a CUDA session on construction, off
    for a CPU one. A pinned column goes to the card without the staging
    path's own pinning copy."""
    global _PINNED
    _PINNED = bool(on)


def set_staging_pad(m: int) -> None:
    """Shard-count multiple that decode buffers are allocated to (wired
    when a sharded executor takes its mesh, parallel/executor.py): the
    column is a prefix view of its buffer, so the sharded programs' equal
    row blocks of the staged copy never need a padding copy. A stale value
    costs nothing but the unused rows."""
    global _STAGING_PAD
    _STAGING_PAD = max(1, int(m))


def _decode_buffer(n: int, dtype: np.dtype) -> np.ndarray:
    """An uninitialized ``n``-row buffer the decoder writes into: pinned
    under a CUDA session, else ordinary host memory; allocated to a
    multiple of the staging pad, of which the first ``n`` rows are
    returned."""
    rows = n + (-n) % _STAGING_PAD
    if _PINNED and n > 0:
        import torch

        raw = torch.empty(rows * dtype.itemsize, dtype=torch.uint8, pin_memory=True)
        return raw.numpy().view(dtype)[:n]
    return np.empty(rows, dtype=dtype)[:n]


def _native_decode_counter(codec: str):
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY.counter(
        "hs_native_decode_total",
        "Column chunks decoded by the native row-group fast path",
        codec=codec,
    )


def _native_bytes_counter():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY.counter(
        "hs_native_decode_bytes_total",
        "Logical bytes written into decode buffers by the native fast path",
    )


def _native_fallback_counter(reason: str):
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY.counter(
        "hs_native_fallback_total",
        "Decode attempts that left the native path for pyarrow",
        reason=reason,
    )


def _native_rg_scan(
    files: List[str],
    columns: Optional[List[str]],
    schemas: List[pa.Schema],
    predicate,
    concat_key,
) -> Optional[B.Batch]:
    """Decode a whole scan natively at row-group granularity; None when the
    scan cannot be answered natively end to end (the caller then takes the
    per-file path, which is native-first on its own).

    Every file must open in the native dialect, every requested column must
    decode to one dtype across files, and nothing of the scan may be cached.
    Row-group pruning applies per file with the counters of
    ``_read_row_groups``; a pruned scan's batch is cached only under its
    predicate's key (under an unpruned key it would hand later readers
    missing rows)."""
    from hyperspace_tpu_torch import native

    env = os.environ.get("HS_NATIVE_RG")
    if env is not None and env.strip().lower() in ("0", "false", "off"):
        return None
    if not (_NATIVE_ENABLED and _NATIVE_RG) or not files:
        return None
    cols = list(columns) if columns is not None else list(schemas[0].names)
    if not cols:
        return None
    hints = _dtype_hints(schemas[0], cols)
    if hints is None:
        return None  # the per-file path counts the dtype fallback
    # one shared buffer per column needs one dtype: identical arrow types
    # across files (a column that changed type goes through the per-file path)
    t0 = {c: schemas[0].field(c).type for c in cols}
    for s in schemas[1:]:
        if any(not s.field(c).type.equals(t0[c]) for c in cols):
            return None

    handles: List = []
    try:
        try:
            for f in files:
                handles.append(native.NativeParquetFile(f))
        except native.NativeUnsupported:
            return None  # the per-file path retries native and counts the fallback
        except OSError as exc:
            rerr.count_io_error("io.decode", exc, swallowed=True)
            _native_fallback_counter("io-error").inc()
            return None
        return _native_rg_decode(files, cols, columns, hints, predicate, concat_key, handles)
    finally:
        for h in handles:
            h.close()


def _native_rg_decode(
    files: List[str],
    cols: List[str],
    columns: Optional[List[str]],
    hints: Dict[str, np.dtype],
    predicate,
    concat_key,
    handles,
) -> Optional[B.Batch]:
    from hyperspace_tpu_torch import native

    # -- per-column plan: buffer dtype (None = strings -> object array) ------
    col_dtype: Dict[str, Optional[np.dtype]] = {}
    col_scratch32 = set()  # date32: int32 chunk scratch widened into datetime64[D]
    col_opt: Dict[str, bool] = {}
    try:
        for c in cols:
            nd = handles[0].column_numpy_dtype(c)
            hint = hints.get(c)
            if nd is None:
                dt = None
            elif hint is not None and nd.kind in ("i", "u"):
                if hint.itemsize == nd.itemsize:
                    dt = hint  # timestamps/date64: decode int64 straight into the view
                elif hint.kind == "M":
                    dt = hint
                    col_scratch32.add(c)
                else:
                    dt = nd
            else:
                dt = nd
            col_dtype[c] = dt
            col_opt[c] = any(h.column_optional(c) for h in handles)
    except native.NativeUnsupported:
        return None  # the per-file path retries native and counts the fallback

    # -- per-file row plan and pruning (the counters of _read_row_groups) ----
    per_file_keep: List[List[int]] = []
    file_rows: List[int] = []
    file_skip: List[Optional[tuple]] = []  # (groups skipped, bytes skipped)
    fully_pruned: List[bool] = []
    pruned_any = False
    try:
        for f, h in zip(files, handles):
            keep = prune_row_groups(f, predicate) if predicate is not None else None
            if keep is None:
                ks = list(range(h.num_row_groups))
                file_skip.append(None)
            else:
                pruned_any = True
                ks = keep
                sk_bytes = _count_pruned(f, ks, None)
                file_skip.append((h.num_row_groups - len(ks), sk_bytes))
            per_file_keep.append(ks)
            fully_pruned.append(keep is not None and not ks)
            file_rows.append(sum(h.rg_rows[g] for g in ks))
    except (OSError, pa.ArrowInvalid) as exc:
        rerr.count_io_error("io.footer", exc, swallowed=True)
        _native_fallback_counter("io-error").inc()
        return None

    total = sum(file_rows)
    starts: List[int] = []
    acc = 0
    for r in file_rows:
        starts.append(acc)
        acc += r

    # -- shared decode buffers, one per column, exactly ``total`` rows -------
    buffers: Dict[str, np.ndarray] = {}
    validity: Dict[str, np.ndarray] = {}
    for c in cols:
        dt = col_dtype[c]
        if dt is None:
            buffers[c] = np.empty(total, dtype=object)
        else:
            buffers[c] = _decode_buffer(total, dt)
            if col_opt[c]:
                validity[c] = np.ones(total, dtype=np.uint8)

    # -- dictionary-shipping plan for low-cardinality string columns ---------
    # every surviving chunk must be fully dictionary-encoded with a dictionary
    # within maxDictEntries; chunk dictionaries remap into one global one so
    # codes are consistent across files and row groups
    chunks = [(fi, g) for fi in range(len(files)) for g in per_file_keep[fi]]
    dict_plan: Dict[str, tuple] = {}  # c -> (codes buffer, remaps, global uniques)
    if _MAX_DICT > 0:
        for c in cols:
            if col_dtype[c] is not None:
                continue
            try:
                if not all(0 < handles[fi].rg_dict_count(g, c) <= _MAX_DICT for fi, g in chunks):
                    continue
                dicts = [handles[fi].read_dict_rg_arrow(g, c) for fi, g in chunks]
            # not a pyarrow fallback: the column still decodes natively below,
            # with materialized strings instead of shipped codes
            except native.NativeUnsupported:
                continue
            # one global dictionary and per-chunk remaps from one C++ hash
            # pass (arrow's dictionary_encode over the decoder's buffers);
            # only the global entries become Python strings
            remaps: Dict[tuple, np.ndarray] = {}
            if dicts:
                ends = np.cumsum([len(d) for d in dicts])
                enc = (pa.concat_arrays(dicts) if len(dicts) > 1 else dicts[0]).dictionary_encode()
                gu = enc.dictionary.to_numpy(zero_copy_only=False)
                inv = enc.indices.to_numpy().astype(np.int32, copy=False)
                remaps = {key: inv[end - len(d) : end] for key, d, end in zip(chunks, dicts, ends)}
            else:
                gu = np.empty(0, dtype=object)
            dict_plan[c] = (_decode_buffer(total, np.dtype(np.int32)), remaps, gu)

    # -- parallel chunk decode ------------------------------------------------
    decoded: List[tuple] = []  # (codec, bytes) per chunk; list.append is atomic

    def _decode_chunk(fi: int, g: int, c: str, start: int, nrows: int) -> None:
        h = handles[fi]
        codec = h.rg_codec(g, c)
        plan = dict_plan.get(c)
        if plan is not None:
            cbuf, remaps, _gu = plan
            codes = h.read_codes_rg(g, c)
            rm = remaps[(fi, g)]
            cbuf[start : start + nrows] = np.where(codes >= 0, rm[np.maximum(codes, 0)], np.int32(-1))
            nb = nrows * 4
        elif col_dtype[c] is None:
            vals, v8, nb = h.read_binary_rg(g, c)
            if v8 is not None and not v8.all():
                vals[v8 == 0] = None
            buffers[c][start : start + nrows] = vals
        else:
            dst = buffers[c][start : start + nrows]
            v8 = validity[c][start : start + nrows] if c in validity else None
            if c in col_scratch32:
                scratch = np.empty(nrows, dtype=np.int32)
                h.read_fixed_rg_into(g, c, scratch, v8)
                dst[...] = scratch.astype(col_dtype[c])
            else:
                h.read_fixed_rg_into(g, c, dst, v8)
            nb = nrows * col_dtype[c].itemsize
        decoded.append((codec, int(nb)))

    # per-file scans (partition columns, file-name columns) call
    # read_parquet_batch from a decode-pool worker; submitting chunk tasks
    # back onto that pool and blocking would deadlock once every worker is
    # such a caller, so they decode inline on this thread. So does a scan of
    # small row groups, whose chunks cost less to decode than a pool task's
    # hand-off and its contention for the interpreter lock
    n_chunks = sum(len(k) for k in per_file_keep)
    inline = (threading.current_thread().name.startswith("hs-decode")
              or total < _FANOUT_MIN_ROWS * max(1, n_chunks))
    pool = None if inline else _decode_pool()
    errors: Dict[int, List[BaseException]] = {}
    futs_by_file: List[list] = []
    all_futs: list = []
    try:
        for fi, f in enumerate(files):
            futs: list = []
            futs_by_file.append(futs)
            try:
                if FAULTS.active:
                    FAULTS.check("io.decode", f)  # the seam before the C calls
            except Exception as exc:
                errors.setdefault(fi, []).append(exc)
                continue
            row = starts[fi]
            for g in per_file_keep[fi]:
                nrows = handles[fi].rg_rows[g]
                for c in cols:
                    if inline:
                        try:
                            _decode_chunk(fi, g, c, row, nrows)
                        except Exception as exc:
                            errors.setdefault(fi, []).append(exc)
                    else:
                        futs.append(pool.submit(_decode_chunk, fi, g, c, row, nrows))
                row += nrows
            all_futs.extend(futs)
        for fi, f in enumerate(files):
            for fut in futs_by_file[fi]:
                try:
                    fut.result()
                except Exception as exc:
                    errors.setdefault(fi, []).append(exc)
            if fi not in errors and FAULTS.active:
                try:
                    FAULTS.check("io.decode", f)  # the seam after the C calls
                except Exception as exc:
                    errors.setdefault(fi, []).append(exc)
    finally:
        # the handles close right after this returns: nothing may still decode
        if all_futs:
            from concurrent.futures import wait as _futures_wait

            _futures_wait(all_futs)
        by_codec: Dict[str, int] = {}
        for codec, _nb in decoded:
            by_codec[codec] = by_codec.get(codec, 0) + 1
        for codec, n in by_codec.items():
            _native_decode_counter(codec).inc(n)
        if decoded:
            _native_bytes_counter().inc(sum(nb for _codec, nb in decoded))

    if errors:
        # corrupt data raises typed and strikes quarantine: a fallback would
        # re-read the same bad bytes
        for fi, es in errors.items():
            for e in es:
                err = (
                    e
                    if isinstance(e, rerr.ReliabilityError)
                    else rerr.classify(e, path=files[fi])
                    if isinstance(e, (OSError, pa.ArrowInvalid, pa.ArrowTypeError))
                    else None
                )
                if isinstance(err, rerr.CorruptDataError):
                    rerr.count_io_error("io.decode", err)
                    if QUARANTINE.enabled:
                        QUARANTINE.note_corrupt(files[fi])
                    raise err from e
        # transient and dialect failures: counted, then the per-file path
        # answers (with retry)
        for es in errors.values():
            for e in es:
                if isinstance(e, native.NativeUnsupported):
                    _native_fallback_counter("dialect").inc()
                else:
                    rerr.count_io_error("io.decode", e, swallowed=True)
                    _native_fallback_counter("io-error").inc()
        return None

    # -- assemble, with pyarrow's null conventions ---------------------------
    out: B.Batch = {}
    for c in cols:
        plan = dict_plan.get(c)
        if plan is not None:
            codes_v, _remaps, gu = plan
            if gu.size:
                nulls = codes_v < 0
                if nulls.any():
                    exp = gu[np.where(nulls, np.int32(0), codes_v)]
                    exp[nulls] = None
                else:
                    exp = gu[codes_v]
            else:
                exp = np.full(total, None, dtype=object)
            out[c] = B.dict_backed(np.asarray(exp, dtype=object), codes_v, gu)
        elif col_dtype[c] is None:
            out[c] = buffers[c]
        else:
            vals = buffers[c]
            v8 = validity.get(c)
            if v8 is not None and not v8.all():
                # pyarrow's to_numpy: NaN for floats, NaT for dates, object
                # with None for bools, float64 with NaN for integers
                if vals.dtype.kind == "f":
                    vals = vals.copy()
                    vals[v8 == 0] = np.nan
                elif vals.dtype.kind == "M":
                    vals = vals.copy()
                    vals[v8 == 0] = np.datetime64("NaT")
                elif vals.dtype.kind == "b":
                    vals = vals.astype(object)
                    vals[v8 == 0] = None
                elif vals.dtype.kind in ("i", "u"):
                    vals = vals.astype(np.float64)
                    vals[v8 == 0] = np.nan
            out[c] = vals

    for fi, f in enumerate(files):
        dsp = _file_note(f).set(rows=file_rows[fi])
        if file_skip[fi] is not None:
            dsp.set(rowgroups_skipped=file_skip[fi][0], rowgroup_bytes_skipped=file_skip[fi][1])
        trace.record("decode", "rowgroup-pruned" if fully_pruned[fi] else "native-rg")
        if QUARANTINE.enabled:
            QUARANTINE.note_ok(f)

    if not pruned_any:
        for fi, f in enumerate(files):
            s, e = starts[fi], starts[fi] + file_rows[fi]
            _io_cache_put(_io_cache_key(f, columns), {c: out[c][s:e] for c in cols})
        if concat_key is not None:
            _io_cache_put(concat_key, dict(out))
    elif concat_key is not None:
        # the pruned concatenation under a key of its own, which only a read
        # under the same predicate looks up (read_parquet_batch), as the
        # per-file path caches it: a repeated pruned scan decodes nothing
        _io_cache_put(concat_key + (("rg-pred", repr(predicate)),), dict(out))
    return out


def read_parquet_batch(files: List[str], columns: Optional[List[str]], predicate=None) -> B.Batch:
    """Read ``columns`` of ``files`` into one concatenated batch, in file
    order, native-first.

    Schema-evolved datasets (a file missing a requested column, or differing
    per-file schemas when ``columns`` is None) null-fill against the unified
    schema: per file where some files carry every column (the others keep
    the native path), as one dataset read where none do.

    ``predicate`` (a pushed-down filter Expr) enables row-group min/max
    pruning: groups its statistics definitively exclude are never decoded.
    The caller's Filter still applies the predicate, so a cached full-file
    batch (more rows) is always an acceptable answer, and is served before
    any pruning.
    """
    from hyperspace_tpu_torch import native

    def _dataset_read() -> B.Batch:
        trace.record("decode", "pyarrow-dataset")
        try:
            # unify per-file schemas so evolved columns survive whatever the
            # file order (a bare dataset takes the first fragment's schema)
            schema = pa.unify_schemas([pq.read_schema(f) for f in files])
            ds = pads.dataset(files, format="parquet", schema=schema)
        except (OSError, pa.ArrowInvalid, pa.ArrowTypeError) as exc:
            # unification is best-effort; a truly bad file still raises out
            # of to_table below
            rerr.count_io_error("io.footer", exc, swallowed=True)
            ds = pads.dataset(files, format="parquet")
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

    # pre-scan schemas; any inconsistency -> unified read. A corrupt footer
    # is not an inconsistency: a fallback would re-read the same bad bytes,
    # so it raises typed (and strikes the owning index's breaker)
    try:
        schemas = []
        for f in files:
            if FAULTS.active:
                FAULTS.check("io.footer", f)
            try:
                schemas.append(pq.read_schema(f))
            except (pa.ArrowInvalid, pa.ArrowTypeError) as exc:
                err = rerr.classify(exc, path=f)
                rerr.count_io_error("io.footer", err)
                if QUARANTINE.enabled and isinstance(err, rerr.CorruptDataError):
                    QUARANTINE.note_corrupt(f)
                raise err from exc
    except OSError as exc:
        rerr.count_io_error("io.footer", exc, swallowed=True)
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
            try:
                unified = pa.unify_schemas(schemas)
            except (pa.ArrowInvalid, pa.ArrowTypeError) as exc:
                rerr.count_io_error("io.footer", exc, swallowed=True)
                return _dataset_read()
            if any(c not in unified.names for c in columns):
                return _dataset_read()
            evolved = set(missing)
            _native_fallback_counter("schema-evolved").inc(len(missing))

    if not evolved and not any(b is not None for b in cached):
        got = _native_rg_scan(files, columns, schemas, predicate, concat_key)
        if got is not None:
            return got

    def read_one(f: str, schema: pa.Schema) -> B.Batch:
        dsp = _file_note(f)
        ckey = _io_cache_key(f, columns)
        got = _io_cache_get(ckey)
        if got is not None:
            trace.record("decode", "cached")
            return got
        if predicate is not None and f not in evolved:
            keep = prune_row_groups(f, predicate)
            if keep is not None:
                return _read_row_groups(f, columns, schema, keep, dsp)

        def _decode() -> B.Batch:
            if FAULTS.active:
                FAULTS.check("io.decode", f)
            if f in evolved:
                # decode against the unified schema so this file's
                # missing columns null-fill with their siblings' types
                trace.record("decode", "pyarrow")
                ds = pads.dataset([f], format="parquet", schema=unified)
                return B.table_to_batch(ds.to_table(columns=columns))
            out = None
            try:
                cols = list(columns) if columns is not None else list(schema.names)
                hints = _dtype_hints(schema, cols) if _NATIVE_ENABLED else None
                if hints is None:
                    if _NATIVE_ENABLED:
                        _native_fallback_counter("dtype").inc()
                else:
                    out = native.read_columns(f, cols, hints)
            except (native.NativeUnsupported, OSError, KeyError) as e:
                # a dialect mismatch is the expected fallback; a real IO
                # failure before the pyarrow re-read is counted too
                if isinstance(e, native.NativeUnsupported):
                    _native_fallback_counter("dialect").inc()
                else:
                    rerr.count_io_error("io.decode", e, swallowed=True)
                    _native_fallback_counter("io-error").inc()
                out = None
            if out is None:
                trace.record("decode", "pyarrow")
                return B.table_to_batch(pads.dataset([f], format="parquet").to_table(columns=columns))
            trace.record("decode", "native")
            return out

        try:
            got = with_retry(_decode, op="io.decode")
        except rerr.ReliabilityError as exc:
            rerr.count_io_error("io.decode", exc)
            if QUARANTINE.enabled and isinstance(exc, rerr.CorruptDataError):
                QUARANTINE.note_corrupt(f)
            raise
        except (OSError, pa.ArrowInvalid, pa.ArrowTypeError) as exc:
            err = rerr.classify(exc, path=f)
            rerr.count_io_error("io.decode", err)
            if QUARANTINE.enabled and isinstance(err, rerr.CorruptDataError):
                QUARANTINE.note_corrupt(f)
            raise err from exc
        if QUARANTINE.enabled:
            QUARANTINE.note_ok(f)
        dsp.set(rows=B.num_rows(got))
        _io_cache_put(ckey, got)
        return got

    # decode files concurrently (pyarrow and the native decoder release the
    # GIL); list order — bucket sortedness — is preserved by mapping, not by
    # completion. A fully cached read (columns=None, now known
    # schema-consistent) skips the pool
    if cached and all(b is not None for b in cached):
        for _ in cached:
            trace.record("decode", "cached")
        batches = cached
    elif len(files) > 1:
        # spans.wrap carries the caller's span into the pool's threads
        batches = list(_decode_pool().map(spans.wrap(read_one), files, schemas))
    else:
        batches = [read_one(f, s) for f, s in zip(files, schemas)]
    if not batches:
        return _dataset_read()
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
