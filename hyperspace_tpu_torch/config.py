"""Configuration system.

The keys, defaults and typed accessors the index build and lifecycle, the
filter query, the join, the aggregate, scan pruning, hybrid scan and the
source providers read, under the same names and with the same defaults as the JAX package's
``hyperspace_tpu/config.py`` so one conf dict drives either package; the
port ignores the keys it does not read. Keys are namespaced ``hyperspace.*``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class keys:
    """Configuration keys read by the build, lifecycle, query, join and
    aggregate paths."""

    SYSTEM_PATH = "hyperspace.system.path"
    NUM_BUCKETS = "hyperspace.index.numBuckets"
    LINEAGE_ENABLED = "hyperspace.index.lineage.enabled"
    OPTIMIZE_FILE_SIZE_THRESHOLD = "hyperspace.index.optimize.fileSizeThreshold"
    HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
    HYBRID_SCAN_MAX_DELETED_RATIO = "hyperspace.index.hybridscan.maxDeletedRatio"
    HYBRID_SCAN_MAX_APPENDED_RATIO = "hyperspace.index.hybridscan.maxAppendedRatio"
    SOURCE_BUILDERS = "hyperspace.index.sources.fileBasedBuilders"
    FILTER_RULE_USE_BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
    BUILD_BATCH_ROWS = "hyperspace.tpu.build.batchRows"
    DEVICE_EXECUTION = "hyperspace.tpu.query.deviceExecution"
    DEVICE_MIN_ROWS = "hyperspace.tpu.query.deviceMinRows"
    PARALLEL_ENABLED = "hyperspace.parallel.enabled"
    IO_DECODE_THREADS = "hyperspace.exec.io.decodeThreads"
    JOIN_DEVICE_MATERIALIZE = "hyperspace.tpu.join.deviceMaterialize"
    JOIN_DEVICE_MATERIALIZE_MAX_BYTES = "hyperspace.tpu.join.deviceMaterializeMaxBytes"
    JOIN_DEVICE_SPAN_MAX_BYTES = "hyperspace.tpu.join.deviceSpanMaxBytes"
    STREAM_JOIN_MIN_BYTES = "hyperspace.exec.stream.joinMinBytes"
    JOIN_SPILL_MIN_ROWS = "hyperspace.exec.join.spillMinRows"
    STREAM_AGG_MIN_BYTES = "hyperspace.exec.stream.aggMinBytes"
    STREAM_CHUNK_BYTES = "hyperspace.exec.stream.chunkBytes"
    AGG_ENABLED = "hyperspace.exec.agg.enabled"
    AGG_MAX_GROUPS = "hyperspace.exec.agg.maxGroups"
    AGG_CAPACITY_FLOOR = "hyperspace.exec.agg.capacityFloor"
    FUSION_ENABLED = "hyperspace.exec.fusion.enabled"
    JOIN_BROADCAST_MAX_BYTES = "hyperspace.exec.join.broadcastMaxBytes"
    JOIN_PIPELINE_ENABLED = "hyperspace.exec.join.pipeline.enabled"
    PIPELINE_ENABLED = "hyperspace.exec.pipeline.enabled"
    PIPELINE_DEPTH = "hyperspace.exec.pipeline.depth"
    PIPELINE_MAX_BUFFERED_BYTES = "hyperspace.exec.pipeline.maxBufferedBytes"
    EXEC_IO_ROWGROUP_PRUNING = "hyperspace.exec.io.rowGroupPruning"
    LIFECYCLE_DEVICE_LINEAGE_ENABLED = "hyperspace.lifecycle.deviceLineage.enabled"
    LIFECYCLE_DEVICE_LINEAGE_MIN_ROWS = "hyperspace.lifecycle.deviceLineage.minRows"


DEFAULTS: Dict[str, Any] = {
    keys.SYSTEM_PATH: None,  # resolved by PathResolver; must be set per session
    keys.NUM_BUCKETS: 200,
    keys.LINEAGE_ENABLED: False,
    # quick optimize compacts only index files below this size
    keys.OPTIMIZE_FILE_SIZE_THRESHOLD: 256 * 1024 * 1024,
    # hybrid scan: an index whose source gained or lost files since its last
    # refresh still serves, as the index minus the deleted files' rows plus
    # the appended files re-bucketed on the fly, while the deleted bytes
    # stay under maxDeletedRatio of the indexed bytes and the appended bytes
    # under maxAppendedRatio of the current bytes
    keys.HYBRID_SCAN_ENABLED: False,
    keys.HYBRID_SCAN_MAX_DELETED_RATIO: 0.2,
    keys.HYBRID_SCAN_MAX_APPENDED_RATIO: 0.3,
    # source providers, by class name; the port resolves each name through a
    # static table of its own builders and takes the JAX package's names as
    # aliases, so one conf dict drives either package
    keys.SOURCE_BUILDERS: (
        "hyperspace_tpu_torch.sources.default.DefaultFileBasedSourceBuilder,"
        "hyperspace_tpu_torch.sources.delta.DeltaLakeSourceBuilder,"
        "hyperspace_tpu_torch.sources.iceberg.IcebergSourceBuilder"
    ),
    # equality/IN predicates on the first indexed column read only the
    # matching buckets' files
    keys.FILTER_RULE_USE_BUCKET_SPEC: False,
    # rows per device program of a covering build; each chunk writes one
    # sorted run per bucket
    keys.BUILD_BATCH_ROWS: 2_000_000,
    # the filter of a query over an index runs on the session's device;
    # False keeps every filter on the host
    keys.DEVICE_EXECUTION: True,
    # below this many rows a filter stays on the host, where the upload and
    # the mask's copy back would cost more than the predicate; 0 sends every
    # filter over an index to the device
    keys.DEVICE_MIN_ROWS: 1 << 25,
    keys.PARALLEL_ENABLED: False,
    # width of the parquet decode pool (exec/io.py), set when a Session is
    # constructed
    keys.IO_DECODE_THREADS: 8,
    # inner-join pair expansion and numeric column gather on the device (the
    # host gathers only string columns); False expands every join on the host
    keys.JOIN_DEVICE_MATERIALIZE: True,
    # a device-materialized join copies its whole output back; above this
    # many estimated output bytes (at the padded size, as the JAX package
    # estimates it) the expansion runs on the host instead. Raise it on a
    # directly attached card
    keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES: 256 * 1024 * 1024,
    # above this estimated span round trip (key rectangles up, [lo, hi)
    # down) the host span walk runs instead of the device span program
    keys.JOIN_DEVICE_SPAN_MAX_BYTES: 256 * 1024 * 1024,
    # above this many input bytes (both sides' files) a compatible bucketed
    # join streams bucket by bucket: peak host memory is one bucket pair and
    # the output, not both whole sides
    keys.STREAM_JOIN_MIN_BYTES: 1 << 30,
    # above this many rows on a generic-join side the hash merge runs in hash
    # partitions, each merged alone (grace-join style)
    keys.JOIN_SPILL_MIN_ROWS: 1 << 26,
    # above this many source bytes (a scan chain of at least two files that
    # split into at least two chunks of chunkBytes) an aggregate runs in file
    # chunks and merges partial states (Spark's partial/final split)
    keys.STREAM_AGG_MIN_BYTES: 1 << 30,
    # target bytes per streamed scan chunk (file groups round up to it)
    keys.STREAM_CHUNK_BYTES: 256 * 1024 * 1024,
    # grouped aggregates over an index scan run on the session's device as
    # one filter, rank-compression and segment-reduction program; False
    # routes every group-by to the host pandas aggregate
    keys.AGG_ENABLED: True,
    # above this many groups the device grouped aggregate spills to the host
    keys.AGG_MAX_GROUPS: 1 << 20,
    # the smallest group capacity; capacities grow by powers of sqrt(2)
    keys.AGG_CAPACITY_FLOOR: 256,
    # whole-stage fusion is not in the port yet: an aggregate that would
    # take it raises
    keys.FUSION_ENABLED: False,
    # a join side whose leaf files hold at most this many bytes is the
    # broadcast side of the JAX package's broadcast hash join and of its
    # fused join aggregate; 0 disables both. The port has neither tier yet:
    # it reads the key only to raise where the fused join aggregate would run
    keys.JOIN_BROADCAST_MAX_BYTES: 64 * 1024 * 1024,
    # the streamed bucketed join decodes bucket b+1's two sides on the
    # prefetch pipeline while bucket b's pairs expand; False keeps the
    # serial loop
    keys.JOIN_PIPELINE_ENABLED: True,
    # streamed scans (exec/pipeline.py): while chunk k executes, up to
    # ``depth`` later chunks decode (and stage their columns on the device)
    # on the pipeline's threads; decoded but unconsumed chunks are capped at
    # ``maxBufferedBytes`` (one chunk ahead is always allowed)
    keys.PIPELINE_ENABLED: True,
    keys.PIPELINE_DEPTH: 2,
    keys.PIPELINE_MAX_BUFFERED_BYTES: 1 << 30,
    # a parquet read under a pushed-down predicate decodes only the row
    # groups whose footer min/max may hold a match (the Filter above still
    # applies the whole predicate)
    keys.EXEC_IO_ROWGROUP_PRUNING: True,
    # hybrid scan's deleted-row filter (NOT IN over the lineage column) runs
    # on the session's device as the lineage-antijoin program at or above
    # minRows rows; below, or with it off, numpy evaluates it on the host
    keys.LIFECYCLE_DEVICE_LINEAGE_ENABLED: True,
    keys.LIFECYCLE_DEVICE_LINEAGE_MIN_ROWS: 4096,
}

REFRESH_MODE_INCREMENTAL = "incremental"
REFRESH_MODE_FULL = "full"
REFRESH_MODE_QUICK = "quick"
REFRESH_MODES = (REFRESH_MODE_INCREMENTAL, REFRESH_MODE_FULL, REFRESH_MODE_QUICK)

OPTIMIZE_MODE_QUICK = "quick"
OPTIMIZE_MODE_FULL = "full"
OPTIMIZE_MODES = (OPTIMIZE_MODE_QUICK, OPTIMIZE_MODE_FULL)

# Operation-log layout constants (ref: HS/index/IndexConstants.scala:93-95).
HYPERSPACE_LOG_DIR = "_hyperspace_log"
INDEX_VERSION_DIR_PREFIX = "v__"
INDEXES_DIR = "indexes"

# Lineage column name (ref: HS/index/IndexConstants.scala:104).
DATA_FILE_NAME_ID = "_data_file_id"
# Default id for a file whose id is unknown (ref: HS/index/IndexConstants.scala:116).
UNKNOWN_FILE_ID = -1

# Index metadata property names (ref: HS/index/IndexConstants.scala:118-127).
LINEAGE_PROPERTY = "lineage"
HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY = "hasParquetAsSourceFormat"
HYPERSPACE_VERSION_PROPERTY = "hyperspaceVersion"
INDEX_LOG_VERSION_PROPERTY = "indexLogVersion"


def _coerce(value: Any, like: Any) -> Any:
    """Coerce a raw (possibly string) conf value to the type of the default."""
    if value is None or like is None:
        return value
    if isinstance(like, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes")
        return bool(value)
    if isinstance(like, int):
        return int(value)
    return value


class HyperspaceConf:
    """A mutable string-keyed configuration with typed accessors; every
    accessor reads the raw key and falls back to the default."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._conf: Dict[str, Any] = dict(overrides or {})

    def set(self, key: str, value: Any) -> "HyperspaceConf":
        self._conf[key] = value
        return self

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._conf:
            return _coerce(self._conf[key], DEFAULTS.get(key, default))
        if key in DEFAULTS:
            return DEFAULTS[key] if default is None else default
        return default

    @property
    def system_path(self) -> Optional[str]:
        return self.get(keys.SYSTEM_PATH)

    @property
    def num_buckets(self) -> int:
        return int(self.get(keys.NUM_BUCKETS))

    @property
    def lineage_enabled(self) -> bool:
        return bool(self.get(keys.LINEAGE_ENABLED))

    @property
    def optimize_file_size_threshold(self) -> int:
        return int(self.get(keys.OPTIMIZE_FILE_SIZE_THRESHOLD))

    @property
    def hybrid_scan_enabled(self) -> bool:
        return bool(self.get(keys.HYBRID_SCAN_ENABLED))

    @property
    def hybrid_scan_deleted_ratio_threshold(self) -> float:
        return float(self.get(keys.HYBRID_SCAN_MAX_DELETED_RATIO))

    @property
    def hybrid_scan_appended_ratio_threshold(self) -> float:
        return float(self.get(keys.HYBRID_SCAN_MAX_APPENDED_RATIO))

    @property
    def source_builders(self) -> str:
        return str(self.get(keys.SOURCE_BUILDERS))

    @property
    def rowgroup_pruning_enabled(self) -> bool:
        return bool(self.get(keys.EXEC_IO_ROWGROUP_PRUNING))

    @property
    def lifecycle_device_lineage_enabled(self) -> bool:
        return bool(self.get(keys.LIFECYCLE_DEVICE_LINEAGE_ENABLED))

    @property
    def lifecycle_device_lineage_min_rows(self) -> int:
        return int(self.get(keys.LIFECYCLE_DEVICE_LINEAGE_MIN_ROWS))

    @property
    def use_bucket_spec(self) -> bool:
        return bool(self.get(keys.FILTER_RULE_USE_BUCKET_SPEC))

    @property
    def build_batch_rows(self) -> int:
        return int(self.get(keys.BUILD_BATCH_ROWS))

    @property
    def device_execution_enabled(self) -> bool:
        return bool(self.get(keys.DEVICE_EXECUTION))

    @property
    def device_exec_min_rows(self) -> int:
        return int(self.get(keys.DEVICE_MIN_ROWS))

    @property
    def io_decode_threads(self) -> int:
        return int(self.get(keys.IO_DECODE_THREADS))

    @property
    def parallel_enabled(self) -> bool:
        return bool(self.get(keys.PARALLEL_ENABLED))

    @property
    def join_device_materialize(self) -> bool:
        return bool(self.get(keys.JOIN_DEVICE_MATERIALIZE))

    @property
    def join_device_materialize_max_bytes(self) -> int:
        return int(self.get(keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES))

    @property
    def join_device_span_max_bytes(self) -> int:
        return int(self.get(keys.JOIN_DEVICE_SPAN_MAX_BYTES))

    @property
    def stream_join_min_bytes(self) -> int:
        return int(self.get(keys.STREAM_JOIN_MIN_BYTES))

    @property
    def join_spill_min_rows(self) -> int:
        return int(self.get(keys.JOIN_SPILL_MIN_ROWS))

    @property
    def stream_agg_min_bytes(self) -> int:
        return int(self.get(keys.STREAM_AGG_MIN_BYTES))

    @property
    def stream_chunk_bytes(self) -> int:
        return int(self.get(keys.STREAM_CHUNK_BYTES))

    @property
    def agg_device_grouped_enabled(self) -> bool:
        return bool(self.get(keys.AGG_ENABLED))

    @property
    def agg_max_groups(self) -> int:
        return int(self.get(keys.AGG_MAX_GROUPS))

    @property
    def agg_capacity_floor(self) -> int:
        return int(self.get(keys.AGG_CAPACITY_FLOOR))

    @property
    def fusion_enabled(self) -> bool:
        return bool(self.get(keys.FUSION_ENABLED))

    @property
    def join_broadcast_max_bytes(self) -> int:
        return int(self.get(keys.JOIN_BROADCAST_MAX_BYTES))

    @property
    def join_pipeline_enabled(self) -> bool:
        return bool(self.get(keys.JOIN_PIPELINE_ENABLED))

    @property
    def pipeline_enabled(self) -> bool:
        return bool(self.get(keys.PIPELINE_ENABLED))

    @property
    def pipeline_depth(self) -> int:
        return int(self.get(keys.PIPELINE_DEPTH))

    @property
    def pipeline_max_buffered_bytes(self) -> int:
        return int(self.get(keys.PIPELINE_MAX_BUFFERED_BYTES))
