"""CoveringIndex — the flagship index.

A vertical slice (indexed + included columns) of the source data,
hash-bucketed on the indexed columns into ``num_buckets`` bucket files and
sorted by the indexed columns within each bucket, so that

  - filter queries scan only the index slice (and only the matching bucket,
    when bucket pruning applies), and
  - equi-joins on the indexed columns run without any shuffle.

(ref: HS/index/covering/CoveringIndex.scala:30-280,
 HS/index/covering/CoveringIndexConfig.scala:39-200)

The build replaces Spark's ``repartition(numBuckets, cols)`` shuffle +
per-partition sort + bucketed Parquet write
(ref: CoveringIndex.scala:54-69, DataFrameWriterExtensions.scala:50-68) with a
one device pass per chunk: encode -> hash -> bucket -> sort
(ops/sort.bucket_sort_build) -> host gather -> per-bucket Parquet write.
Optional lineage materializes a ``_data_file_id`` column mapping each index
row to its source file (ref: CoveringIndex.scala:227-279); the id is
attached at decode time. A nested struct leaf (``a.b``) is stored as the flat
column ``__hs_nested.a.b``.

Under ``hyperspace.parallel.enabled`` and ``hyperspace.parallel.build.enabled``,
a session mesh of more than one shard and at least
``hyperspace.tpu.build.distributedMinRows`` rows, each chunk takes the mesh
build instead (``_mesh_stages``): the key planes shard over the mesh, each
shard hashes its rows, one all-to-all routes every row to the shard that
owns its bucket (ops/bucketize.py), each shard sorts its buckets, and an
exchange that overflows its slots is redone at doubled capacity. The bucket
files are those of the single-device build, byte for byte.

Bucket id is encoded in the data file name: ``part-<bucket>-<tag>.parquet``.
"""

from __future__ import annotations

import collections
import itertools
import os
import re
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.indexes import registry
from hyperspace_tpu_torch.indexes.base import CreateContext, Index, IndexConfig
from hyperspace_tpu_torch.models.log_entry import DerivedDataset
from hyperspace_tpu_torch.plan.logical import BucketSpec
from hyperspace_tpu_torch.plan.resolver import ResolvedColumn, resolve_columns_against_schema
from hyperspace_tpu_torch.sources import schema as schema_codec

_BUCKET_FILE_RE = re.compile(r"part-(\d+)-")

#: Version of the bucket hash function the index's data files were
#: partitioned with. Bumped whenever ops/hashing changes bucket placement
#: (v2 = round-5 value-consistent int/float normalization). An index
#: stamped with an older version still serves correct index-only scans,
#: but the optimizer must not trust its bucket LAYOUT (no bucket pruning,
#: no shuffle-free joins) until a full refresh/optimize re-buckets it —
#: see rules/utils.transform_plan_to_use_index.
BUCKET_HASH_VERSION = 2
_BUCKET_HASH_VERSION_PROP = "bucketHashVersion"


def _add_stage(seconds: collections.Counter, stage: str, t0: float) -> float:
    """Add the time since ``t0`` to ``seconds[stage]``; returns now."""
    now = time.perf_counter()
    seconds[stage] += now - t0
    return now


def bucket_of_file(path: str) -> Optional[int]:
    m = _BUCKET_FILE_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


def _bucket_file_name(bucket: int) -> str:
    return f"part-{bucket:05d}-{uuid.uuid4().hex[:12]}.parquet"


class CoveringIndex(Index):
    kind = "CoveringIndex"
    kind_abbr = "CI"

    def __init__(
        self,
        indexed_columns: List[str],
        included_columns: List[str],
        num_buckets: int,
        schema_json: str = "",
        lineage: bool = False,
        extra_properties: Optional[Dict[str, Any]] = None,
    ):
        self._indexed = list(indexed_columns)
        self._included = list(included_columns)
        self.num_buckets = int(num_buckets)
        self.schema_json = schema_json
        self.lineage = bool(lineage)
        self._extra = dict(extra_properties or {})

    # --- identity ----------------------------------------------------------
    @property
    def indexed_columns(self) -> List[str]:
        return list(self._indexed)

    @property
    def included_columns(self) -> List[str]:
        return list(self._included)

    @property
    def referenced_columns(self) -> List[str]:
        return self._indexed + self._included

    @property
    def properties(self) -> Dict[str, Any]:
        props = {
            "indexedColumns": self._indexed,
            "includedColumns": self._included,
            "numBuckets": self.num_buckets,
            "schemaJson": self.schema_json,
            C.LINEAGE_PROPERTY: str(self.lineage).lower(),
        }
        props.update(self._extra)
        return props

    def with_new_properties(self, properties: Dict[str, Any]) -> "CoveringIndex":
        extra = {k: v for k, v in properties.items()
                 if k not in ("indexedColumns", "includedColumns", "numBuckets", "schemaJson", C.LINEAGE_PROPERTY)}
        return CoveringIndex(self._indexed, self._included, self.num_buckets,
                             self.schema_json, self.lineage, extra)

    @classmethod
    def from_derived_dataset(cls, dd: DerivedDataset) -> "CoveringIndex":
        p = dd.properties
        extra = {k: v for k, v in p.items()
                 if k not in ("indexedColumns", "includedColumns", "numBuckets", "schemaJson", C.LINEAGE_PROPERTY)}
        return cls(
            list(p["indexedColumns"]),
            list(p.get("includedColumns", [])),
            int(p["numBuckets"]),
            p.get("schemaJson", ""),
            str(p.get(C.LINEAGE_PROPERTY, "false")).lower() == "true",
            extra,
        )

    def bucket_spec(self) -> BucketSpec:
        """(ref: HS/index/covering/CoveringIndex.scala:173-177)"""
        return BucketSpec(self.num_buckets, tuple(self._indexed), tuple(self._indexed))

    @property
    def bucket_hash_version(self) -> int:
        """Hash-function version the data files were bucketed with; entries
        predating the property default to 1 (the pre-normalization hash)."""
        return int(self._extra.get(_BUCKET_HASH_VERSION_PROP, 1))

    def can_handle_deleted_files(self) -> bool:
        return self.lineage

    def stats(self) -> Dict[str, Any]:
        return {
            "indexedColumns": self._indexed,
            "includedColumns": self._included,
            "numBuckets": self.num_buckets,
        }

    # --- build -------------------------------------------------------------
    def write(self, ctx: CreateContext, df) -> None:
        """Build index data for ``df`` into ``ctx.index_data_path``
        (ref: CoveringIndex.scala:54-69 write = repartition + saveWithBuckets).

        Without lineage the build is pipelined: only the key columns are
        decoded before the device program launches; the payload columns decode
        while the permutation rides back from the device."""
        from hyperspace_tpu_torch.plan.logical import Scan

        # write() re-buckets ALL data (create, full refresh, overwrite-mode
        # incremental): the index is now consistent with the current hash
        self._extra[_BUCKET_HASH_VERSION_PROP] = str(BUCKET_HASH_VERSION)

        plan = df.plan
        if isinstance(plan, Scan) and not self.lineage:
            # STREAMING build: source files are decoded in groups of
            # ~batchRows rows and fed straight into the pipelined device
            # build, so host memory is bounded by O(2 chunks + largest
            # file), never by table size — the discipline that lets a
            # TPC-H SF100 (600M-row) build run on a bounded-RAM host. The
            # reference gets this for free from Spark's streaming executors
            # (ref: CoveringIndex.scala:54-69 repartition+saveWithBuckets);
            # here the build owns its own out-of-core chunking.
            relation = plan.relation
            resolved = self._resolve_all(ctx, relation.schema)
            columns = [r.normalized_name for r in resolved]
            key_res = [r for r in resolved if r.normalized_name in self._indexed]
            payload = [r for r in resolved if r.normalized_name not in self._indexed]
            batch_rows = ctx.session.conf.build_batch_rows
            files = [fi.name for fi in relation.all_file_infos()]
            # per-file reads lose the unified-dataset schema the one-shot
            # path had (Arrow casts/null-fills fragments against it); conform
            # every per-file projection to the resolved schema so sources
            # with per-file schema drift still build one consistent index
            key_schema = pa.schema([_arrow_field_for(r, relation.schema) for r in key_res])
            payload_schema = pa.schema([_arrow_field_for(r, relation.schema) for r in payload])

            def groups():
                # each file's dataset is constructed ONCE and serves both the
                # key and payload projections (the group holds its files'
                # datasets until the chunk is written — bounded by group
                # size, same O(chunk) discipline)
                pending_ds: List = []
                pending_keys: List[pa.Table] = []
                rows = 0

                def emit():
                    kt = (
                        pa.concat_tables(pending_keys)
                        if len(pending_keys) > 1
                        else pending_keys[0]
                    )
                    grp_ds = list(pending_ds)

                    def group_payload_fn() -> Optional[pa.Table]:
                        if not payload:
                            return None
                        parts = [
                            _project_conform(d, payload, payload_schema) for d in grp_ds
                        ]
                        return pa.concat_tables(parts) if len(parts) > 1 else parts[0]

                    return kt, group_payload_fn

                for f in files:
                    t = time.perf_counter()
                    ds_f = relation.arrow_dataset([f])
                    kt = _project_conform(ds_f, key_res, key_schema)
                    _add_stage(ctx.session.build_stage_seconds, "key_decode", t)
                    # emit BEFORE a file that would cross batchRows: groups
                    # stay under the cap (only a single file larger than
                    # batchRows exceeds it, and that group slices evenly),
                    # so no group leaves a sliver chunk paying a full
                    # device launch for a handful of rows
                    if batch_rows and pending_ds and rows + kt.num_rows > batch_rows:
                        yield emit()
                        pending_ds, pending_keys, rows = [], [], 0
                    pending_ds.append(ds_f)
                    pending_keys.append(kt)
                    rows += kt.num_rows
                    if batch_rows and rows >= batch_rows:
                        yield emit()
                        pending_ds, pending_keys, rows = [], [], 0
                if pending_ds:
                    yield emit()

            # the mesh-or-single-device decision needs the TOTAL rows
            # (distributedMinRows), which streaming never sees at once;
            # parquet footers give it, other formats size by the first chunk
            total_rows = None
            if relation.physical_format == "parquet":
                try:
                    total_rows = sum(pq.read_metadata(f).num_rows for f in files)
                except Exception:
                    total_rows = None

            write_bucketed_groups(
                groups(),
                self._indexed,
                self.num_buckets,
                ctx.index_data_path,
                column_order=columns,
                batch_rows=batch_rows,
                session=ctx.session,
                total_rows=total_rows,
            )
            schema = pa.schema([_arrow_field_for(r, relation.schema) for r in resolved])
            self.schema_json = schema_codec.schema_to_json(schema)
            return

        table = self._index_data_table(ctx, df)
        write_bucketed(
            table,
            self._indexed,
            self.num_buckets,
            ctx.index_data_path,
            batch_rows=ctx.session.conf.build_batch_rows,
            session=ctx.session,
        )
        self.schema_json = schema_codec.schema_to_json(table.schema)

    def _resolve_all(self, ctx: CreateContext, schema: pa.Schema):
        """Resolve indexed/included columns, normalizing nested paths with the
        ``__hs_nested.`` prefix; nested indexing is gated on conf
        (ref: CoveringIndexConfig nested normalization, ResolverUtils.scala:44-105).

        Names may arrive already normalized (refresh/optimize revive the index
        from its log entry) — strip the prefix before re-resolving against the
        source schema."""

        def denorm(names):
            return [ResolvedColumn.from_normalized(n).name for n in names]

        resolved = resolve_columns_against_schema(denorm(self.referenced_columns), schema)
        if any(r.is_nested for r in resolved):
            conf = getattr(getattr(ctx, "session", None), "conf", None)
            if conf is not None and not conf.nested_column_enabled:
                raise ValueError(
                    "Indexing nested columns requires "
                    f"{C.keys.NESTED_COLUMN_ENABLED}=true"
                )
        self._indexed = [r.normalized_name for r in resolve_columns_against_schema(denorm(self._indexed), schema)]
        self._included = [r.normalized_name for r in resolve_columns_against_schema(denorm(self._included), schema)]
        return resolved

    def _index_data_table(self, ctx: CreateContext, df) -> pa.Table:
        """The vertical slice (+ optional lineage column) as one arrow table
        (ref: createIndexData, CoveringIndex.scala:227-279)."""
        from hyperspace_tpu_torch.plan.logical import Scan

        plan = df.plan
        if not isinstance(plan, Scan):
            raise ValueError(
                "createIndex expects a plain source scan (project/filter on top "
                "of a supported relation); got: " + type(plan).__name__
            )
        relation = plan.relation
        resolved = self._resolve_all(ctx, relation.schema)
        projection = _nested_projection(resolved)

        if not self.lineage:
            return relation.arrow_dataset().to_table(columns=projection)

        # lineage: attach _data_file_id per source file at decode time
        # (arrow_dataset so hive-partition columns resolve per file)
        tables = []
        for fi in relation.all_file_infos():
            fid = ctx.file_id_tracker.add_file(fi)
            t = relation.arrow_dataset([fi.name]).to_table(columns=projection)
            t = t.append_column(C.DATA_FILE_NAME_ID, pa.array(np.full(t.num_rows, fid, dtype=np.int64)))
            tables.append(t)
        return pa.concat_tables(tables)


def _project_conform(ds, resolved, schema: pa.Schema) -> pa.Table:
    """Project ``resolved`` columns out of one file's dataset and conform the
    result to the unified ``schema`` (cast drifted dtypes; null-fill columns
    the file predates), so sources with per-file schema drift still build one
    consistent index."""
    try:
        t = ds.to_table(columns=_nested_projection(resolved))
    except (KeyError, pa.ArrowInvalid, pa.ArrowKeyError):
        # a projected column is missing from this file (schema evolution):
        # decode what the file has, extract what resolves (nested leaves via
        # struct_field — the normalized __hs_nested. name never matches a
        # physical column), and null-fill only what's genuinely absent
        full = ds.to_table()
        arrays = []
        for r, f in zip(resolved, schema):
            parts = r.name.split(".")
            arr = full.column(parts[0]) if parts[0] in full.column_names else None
            for seg in parts[1:]:
                if arr is None:
                    break
                try:
                    arr = pc.struct_field(arr, seg)
                except (KeyError, pa.ArrowInvalid, pa.ArrowKeyError, TypeError):
                    arr = None
            arrays.append(arr if arr is not None else pa.nulls(full.num_rows, f.type))
        return pa.table(dict(zip(schema.names, arrays))).cast(schema)
    if t.schema != schema:
        t = t.cast(schema)
    return t


def _nested_projection(resolved) -> Dict[str, Any]:
    """Arrow dataset projection dict: normalized output name -> field ref
    (nested paths project the struct leaf into a flat column)."""
    out: Dict[str, Any] = {}
    for r in resolved:
        out[r.normalized_name] = pc.field(*r.name.split(".")) if r.is_nested else pc.field(r.name)
    return out


def _arrow_field_for(resolved_col, schema: pa.Schema) -> pa.Field:
    """The (leaf) arrow field a resolved column projects to, named by its
    normalized (flat) name."""
    parts = resolved_col.name.split(".")
    field = schema.field(parts[0])
    for p in parts[1:]:
        field = field.type.field(p)
    return pa.field(resolved_col.normalized_name, field.type)


def _device_of(session):
    """The build's device: the session's, else the default (CUDA, raising
    when there is none)."""
    from hyperspace_tpu_torch.session import resolve_device

    return resolve_device(None) if session is None else session.device


def _build_mesh(session, total_rows: int):
    """The mesh a build of ``total_rows`` rows runs on, as the JAX package
    decides it: under ``parallel.enabled`` and ``parallel.build.enabled``,
    a session mesh of more than one shard and at least
    ``tpu.build.distributedMinRows`` rows; else None (the single-device
    build, which a one-device mesh is)."""
    if session is None:
        return None
    conf = session.conf
    if not (conf.parallel_enabled and conf.parallel_build_enabled):
        return None
    mesh = session.mesh
    if mesh.size > 1 and total_rows >= conf.distributed_build_min_rows:
        return mesh
    return None


def _chunk_stages(bucket_sort_columns: List[str], num_buckets: int, out_dir: str,
                  column_order: Optional[List[str]], session, total_rows: int):
    """The two stages of one chunk's build: ``launch`` (host encode, upload,
    device hash/sort/histogram) and ``finish`` (fetch the permutation and
    counts, then per-bucket take + parquet write). Their host time goes to
    the session's ``build_stage_seconds``."""
    import torch

    from hyperspace_tpu_torch.exec.batch import table_to_batch
    from hyperspace_tpu_torch.ops import encode
    from hyperspace_tpu_torch.ops.sort import bucket_sort_build

    device = _device_of(session)
    seconds = session.build_stage_seconds if session is not None else collections.Counter()
    mesh = _build_mesh(session, total_rows)
    if mesh is not None:
        return _mesh_stages(bucket_sort_columns, num_buckets, out_dir, column_order, session, mesh, seconds)

    def launch(chunk: pa.Table) -> dict:
        """Host encode + device pass. The device work is queued on the
        current stream; nothing here waits for it."""
        t = time.perf_counter()
        batch = table_to_batch(chunk.select(bucket_sort_columns))
        keys, kinds, host_hashes = encode.encode_sort_columns(
            [batch[c] for c in bucket_sort_columns]
        )
        t = _add_stage(seconds, "encode_keys", t)
        dev_keys = [torch.from_numpy(k).to(device) for k in keys]
        dev_hashes = [torch.from_numpy(h.view(np.int32)).to(device) for h in host_hashes]
        perm, counts = bucket_sort_build(dev_keys, dev_hashes, kinds, num_buckets, chunk.num_rows)
        _add_stage(seconds, "upload_launch", t)
        return {"chunk": chunk, "perm": perm, "counts": counts}

    def finish(state: dict, chunk_payload_fn) -> List[str]:
        """Attach the lazily-decoded payload, fetch the permutation, and
        write the per-bucket sorted parquet files; host-heavy, overlapped
        with the NEXT chunk's device work."""
        t = time.perf_counter()
        chunk = _prepare_chunk(state["chunk"], chunk_payload_fn, column_order)
        t = _add_stage(seconds, "payload_decode", t)
        perm_np = state["perm"].cpu().numpy()
        boundaries = np.concatenate([[0], np.cumsum(state["counts"].cpu().numpy())])
        t = _add_stage(seconds, "device_wait_fetch", t)

        def _take_write(b: int, lo: int, hi: int) -> str:
            return _write_bucket_file(chunk, out_dir, b, perm_np[lo:hi])

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as ex:
            futures = [
                ex.submit(_take_write, b, int(boundaries[b]), int(boundaries[b + 1]))
                for b in range(num_buckets)
                if boundaries[b + 1] > boundaries[b]
            ]
            out = [f.result() for f in futures]
        _add_stage(seconds, "take_write", t)
        return out

    return launch, finish


def _prepare_chunk(chunk: pa.Table, chunk_payload_fn, column_order) -> pa.Table:
    """A chunk's key columns with its lazily decoded payload attached, in
    the output column order, as single-chunk columns (so per-bucket takes
    do not re-resolve chunk offsets)."""
    if chunk_payload_fn is not None:
        payload = chunk_payload_fn()
        if payload is not None:
            for name in payload.column_names:
                chunk = chunk.append_column(payload.schema.field(name), payload.column(name))
    if column_order:
        chunk = chunk.select(column_order)
    return chunk.combine_chunks()


def _write_bucket_file(chunk: pa.Table, out_dir: str, b: int, rows) -> str:
    path = os.path.join(out_dir, _bucket_file_name(b))
    # uncompressed PLAIN is the index-file dialect: the JAX package's native
    # decoder mmaps these and memcpys column chunks with zero decompression
    # work
    pq.write_table(chunk.take(pa.array(rows)), path, use_dictionary=False, compression="NONE")
    return path


def _mesh_stages(bucket_sort_columns: List[str], num_buckets: int, out_dir: str,
                 column_order: Optional[List[str]], session, mesh, seconds: collections.Counter):
    """The mesh build's two stages of one chunk (the JAX package's
    ``_launch_mesh`` / ``_finish_mesh``): ``launch`` shards the encoded key
    planes over the mesh (each padded to one row count per shard) and runs
    the exchange program; ``finish`` redoes an exchange that overflowed at
    doubled slot capacity, then writes each shard's buckets. Buckets live
    wholly on their owner shard, sorted by (bucket, keys, row), so each
    shard's valid prefix holds its buckets' rows in the single-device
    build's order."""
    import torch

    from hyperspace_tpu_torch.exec.batch import table_to_batch
    from hyperspace_tpu_torch.ops import encode
    from hyperspace_tpu_torch.ops.bucketize import _next_pow2, distributed_bucket_sort_build
    from hyperspace_tpu_torch.ops.sort import padded_size

    n_dev = mesh.size
    capacity_factor = session.conf.rebucket_capacity_factor

    def shards_of(arr: np.ndarray, per_dev: int, fill=0) -> list:
        padded = np.full(per_dev * n_dev, fill, dtype=arr.dtype)
        padded[: arr.shape[0]] = arr
        return [torch.from_numpy(padded[d * per_dev:(d + 1) * per_dev]).to(mesh.device_of(d))
                for d in mesh.local_shards()]

    def launch(chunk: pa.Table) -> dict:
        t = time.perf_counter()
        batch = table_to_batch(chunk.select(bucket_sort_columns))
        keys, kinds, host_hashes = encode.encode_sort_columns([batch[c] for c in bucket_sort_columns])
        t = _add_stage(seconds, "encode_keys", t)
        cn = chunk.num_rows
        per_dev = padded_size(-(-cn // n_dev))
        dev_keys = [shards_of(k, per_dev) for k in keys]
        dev_hashes = [shards_of(h.view(np.int32), per_dev) for h in host_hashes]
        row_idx = shards_of(np.arange(per_dev * n_dev, dtype=np.int32), per_dev)
        capacity = min(_next_pow2(int(per_dev / n_dev * capacity_factor)), _next_pow2(per_dev))
        out = distributed_bucket_sort_build(mesh, dev_keys, dev_hashes, kinds, row_idx, cn, num_buckets, capacity)
        _add_stage(seconds, "upload_launch", t)
        return {"chunk": chunk, "out": out, "capacity": capacity, "per_dev": per_dev,
                "retry": (dev_keys, dev_hashes, kinds, row_idx, cn)}

    def finish(state: dict, chunk_payload_fn) -> List[str]:
        t = time.perf_counter()
        chunk = _prepare_chunk(state["chunk"], chunk_payload_fn, column_order)
        t = _add_stage(seconds, "payload_decode", t)
        out, capacity, per_dev = state["out"], state["capacity"], state["per_dev"]
        while sum(int(v[3].sum()) for v in out.values()) > 0:
            # skew overflowed a destination's slots: double the capacity
            # and redo (a source shard holds per_dev rows, so a capacity of
            # per_dev always fits and the loop ends)
            if capacity >= per_dev:
                raise RuntimeError(
                    f"distributed build exchange overflow at full capacity (capacity={capacity}, per_dev={per_dev})"
                )
            capacity = min(_next_pow2(capacity * 2), _next_pow2(per_dev))
            dev_keys, dev_hashes, kinds, row_idx, cn = state["retry"]
            out = distributed_bucket_sort_build(mesh, dev_keys, dev_hashes, kinds, row_idx, cn, num_buckets,
                                                capacity)
        host = {g: tuple(v.cpu().numpy() for v in out[g][:3]) for g in out}
        t = _add_stage(seconds, "device_wait_fetch", t)

        from concurrent.futures import ThreadPoolExecutor

        futures = []
        with ThreadPoolExecutor(max_workers=8) as ex:
            for d in sorted(host):
                bkts, ridx, vld = host[d]
                nv = int(vld.sum())  # valid rows sort to the shard's prefix
                if nv == 0:
                    continue
                b_v, r_v = bkts[:nv], ridx[:nv]
                bounds = np.searchsorted(b_v, np.arange(num_buckets + 1))
                for b in range(d, num_buckets, n_dev):
                    lo, hi = int(bounds[b]), int(bounds[b + 1])
                    if hi > lo:
                        futures.append(ex.submit(_write_bucket_file, chunk, out_dir, b, r_v[lo:hi]))
            paths = [f.result() for f in futures]
        _add_stage(seconds, "take_write", t)
        return paths

    return launch, finish


def _sliced_chunks(table: pa.Table, payload_fn, batch_rows: int):
    """Yield (key_chunk, chunk_payload_fn) slices of one materialized table;
    the payload (if any) decodes ONCE lazily and is sliced per chunk. Chunks
    are EQUAL-size (ceil division) rather than batch_rows + remainder, so no
    sliver chunk pays a full device launch for a handful of rows."""
    payload_cell: List[Optional[pa.Table]] = []

    def full_payload() -> Optional[pa.Table]:
        if not payload_cell:
            payload_cell.append(payload_fn() if payload_fn is not None else None)
        return payload_cell[0]

    n = table.num_rows
    n_chunks = max(1, -(-n // batch_rows))
    size = -(-n // n_chunks)
    for off in range(0, n, size):
        chunk_pf = None
        if payload_fn is not None:

            def chunk_pf(off=off):
                p = full_payload()
                return p.slice(off, size) if p is not None else None

        yield table.slice(off, size), chunk_pf


def _pipelined_chunks(chunks, launch, finish) -> List[str]:
    """Drive (key_chunk, payload_fn) pairs through the launch/finish pipeline
    one chunk deep: chunk k+1's device program runs while chunk k's host side
    drains and writes parquet."""
    paths: List[str] = []
    in_flight: Optional[tuple] = None
    for key_chunk, chunk_payload_fn in chunks:
        state = launch(key_chunk)
        if in_flight is not None:
            paths.extend(finish(*in_flight))
        in_flight = (state, chunk_payload_fn)
    if in_flight is not None:
        paths.extend(finish(*in_flight))
    return paths


def write_bucketed(
    table: pa.Table,
    bucket_sort_columns: List[str],
    num_buckets: int,
    out_dir: str,
    batch_rows: Optional[int] = None,
    session=None,
) -> List[str]:
    """Device-accelerated bucketed + sorted Parquet write of one in-memory
    table, in its column order: the writer of incremental refresh, optimize
    and the lineage build.

    ``batch_rows`` (> 0) caps rows per device pass
    (ops/sort.bucket_sort_build: hash -> bucket -> lexicographic sort ->
    histogram kernel): a larger table is sliced into equal chunks, each
    writing its own sorted run per bucket, pipelined one chunk deep. Without
    it the table is one chunk, as optimize needs (one file per bucket).
    Returns the written file paths: bucket order within each chunk,
    chunk-major."""
    os.makedirs(out_dir, exist_ok=True)
    if table.num_rows == 0:
        return []
    launch, finish = _chunk_stages(bucket_sort_columns, num_buckets, out_dir, None, session, table.num_rows)
    if batch_rows is not None and 0 < batch_rows < table.num_rows:
        return _pipelined_chunks(_sliced_chunks(table, None, batch_rows), launch, finish)
    return finish(launch(table), None)


def write_bucketed_groups(
    groups,
    bucket_sort_columns: List[str],
    num_buckets: int,
    out_dir: str,
    column_order: Optional[List[str]] = None,
    batch_rows: Optional[int] = None,
    session=None,
    total_rows: Optional[int] = None,
) -> List[str]:
    """Device-accelerated bucketed + sorted Parquet write, out of core.

    ``groups`` is an ITERABLE of ``(key_table, payload_fn)`` pairs: each
    key_table holds the bucket/sort columns for one group of source rows;
    ``payload_fn()`` (or None) lazily decodes that group's remaining
    columns, row-aligned. ``column_order`` fixes the output column order.
    Groups are consumed strictly in order and sliced into equal chunks of at
    most ``batch_rows`` (> 0) rows, so peak host memory is O(2 chunks + one
    group's payload) regardless of total table size.

    One device pass per chunk (ops/sort.bucket_sort_build: hash -> bucket ->
    lexicographic sort -> histogram kernel) gives the clustering permutation
    and per-bucket counts; the host then takes each bucket's rows and writes
    them, eight buckets at a time (arrow take and parquet write release the
    GIL). Each chunk writes its own sorted run per bucket — the multi-run
    state the reference's incremental refresh also produces
    (ref: actions/RefreshIncrementalAction.scala:115-128); optimize compacts
    runs. Returns the written file paths: bucket order within each chunk,
    chunk-major.

    The build path streams source FILES through this (``CoveringIndex.write``);
    the reference inherits the same bounded-memory property from Spark's
    streaming executors (ref: CoveringIndex.scala:54-69). ``total_rows``
    sizes the mesh decision (``_build_mesh``); without it the first chunk
    does."""
    os.makedirs(out_dir, exist_ok=True)

    def flattened():
        for key_table, payload_fn in groups:
            kn = key_table.num_rows
            if kn == 0:
                continue
            if batch_rows is not None and 0 < batch_rows < kn:
                yield from _sliced_chunks(key_table, payload_fn, batch_rows)
            else:
                yield key_table, payload_fn

    flat = flattened()
    first = next(flat, None)
    if first is None:
        return []
    rows = total_rows if total_rows is not None else first[0].num_rows
    stages = _chunk_stages(bucket_sort_columns, num_buckets, out_dir, column_order, session, rows)
    return _pipelined_chunks(itertools.chain([first], flat), *stages)


class CoveringIndexConfig(IndexConfig):
    """(ref: HS/index/covering/CoveringIndexConfig.scala:39-200)"""

    def __init__(self, index_name: str, indexed_columns: List[str], included_columns: Optional[List[str]] = None):
        if not index_name:
            raise ValueError("Index name must not be empty")
        if not indexed_columns:
            raise ValueError("indexed_columns must not be empty")
        included_columns = list(included_columns or [])
        lowered = [c.lower() for c in indexed_columns + included_columns]
        if len(set(lowered)) != len(lowered):
            raise ValueError("Duplicate columns across indexed/included columns are not allowed")
        self._name = index_name
        self._indexed = list(indexed_columns)
        self._included = included_columns

    @property
    def index_name(self) -> str:
        return self._name

    @property
    def indexed_columns(self) -> List[str]:
        return list(self._indexed)

    @property
    def included_columns(self) -> List[str]:
        return list(self._included)

    @property
    def referenced_columns(self) -> List[str]:
        return self._indexed + self._included

    def create_index(self, ctx: CreateContext, df, properties: Dict[str, str]) -> CoveringIndex:
        """(ref: CoveringIndexConfig createIndex :92-116)"""
        index = CoveringIndex(
            self._indexed,
            self._included,
            num_buckets=ctx.session.conf.num_buckets,
            lineage=ctx.session.conf.lineage_enabled,
            extra_properties=dict(properties),
        )
        index.write(ctx, df)
        return index

    def __repr__(self) -> str:
        return f"CoveringIndexConfig({self._name!r}, indexed={self._indexed}, included={self._included})"

    class Builder:
        """Fluent builder (ref: CoveringIndexConfig builder, :118-200)."""

        def __init__(self):
            self._name: Optional[str] = None
            self._indexed: List[str] = []
            self._included: List[str] = []

        def indexName(self, name: str) -> "CoveringIndexConfig.Builder":
            if self._name:
                raise ValueError("indexName is already set")
            self._name = name
            return self

        index_name = indexName

        def indexBy(self, *columns: str) -> "CoveringIndexConfig.Builder":
            self._indexed.extend(columns)
            return self

        index_by = indexBy

        def include(self, *columns: str) -> "CoveringIndexConfig.Builder":
            self._included.extend(columns)
            return self

        def create(self) -> "CoveringIndexConfig":
            if not self._name:
                raise ValueError("indexName must be set")
            return CoveringIndexConfig(self._name, self._indexed, self._included)

    @staticmethod
    def builder() -> "CoveringIndexConfig.Builder":
        return CoveringIndexConfig.Builder()


registry.register(CoveringIndex.kind, CoveringIndex.from_derived_dataset)
