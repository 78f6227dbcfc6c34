"""Configuration system.

The keys, defaults and typed accessors the index build and lifecycle, the
filter query, the joins, the aggregate, the top-k, scan pruning, hybrid scan,
the source providers, native decode, the reliability layer, the serving
runtime, observability and the refresh manager read, under the same names
and with the same defaults as the JAX package's ``hyperspace_tpu/config.py``
so one conf dict drives either package; the port ignores the keys it does
not read. Keys are namespaced ``hyperspace.*``.
"""

from __future__ import annotations

import os
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
    FUSION_DONATION = "hyperspace.exec.fusion.donation"
    JOIN_BROADCAST_MAX_BYTES = "hyperspace.exec.join.broadcastMaxBytes"
    EXEC_TOPK_ENABLED = "hyperspace.exec.topk.enabled"
    EXEC_TOPK_MAX_K = "hyperspace.exec.topk.maxK"
    EXEC_TOPK_THRESHOLD_PUSHDOWN = "hyperspace.exec.topk.thresholdPushdown"
    JOIN_PIPELINE_ENABLED = "hyperspace.exec.join.pipeline.enabled"
    PIPELINE_ENABLED = "hyperspace.exec.pipeline.enabled"
    PIPELINE_DEPTH = "hyperspace.exec.pipeline.depth"
    PIPELINE_MAX_BUFFERED_BYTES = "hyperspace.exec.pipeline.maxBufferedBytes"
    EXEC_IO_ROWGROUP_PRUNING = "hyperspace.exec.io.rowGroupPruning"
    LIFECYCLE_DEVICE_LINEAGE_ENABLED = "hyperspace.lifecycle.deviceLineage.enabled"
    LIFECYCLE_DEVICE_LINEAGE_MIN_ROWS = "hyperspace.lifecycle.deviceLineage.minRows"
    NESTED_COLUMN_ENABLED = "hyperspace.index.nestedColumn.enabled"
    GLOBBING_PATTERN = "hyperspace.source.globbingPattern"
    CACHE_EXPIRY_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
    DATASKIPPING_TARGET_FILE_SIZE = "hyperspace.index.dataskipping.targetIndexDataFileSize"
    DISPLAY_MODE = "hyperspace.explain.displayMode"
    HIGHLIGHT_BEGIN_TAG = "hyperspace.explain.displayMode.highlight.beginTag"
    HIGHLIGHT_END_TAG = "hyperspace.explain.displayMode.highlight.endTag"
    TPU_BUILD_DISTRIBUTED_MIN_ROWS = "hyperspace.tpu.build.distributedMinRows"
    PARALLEL_MESH_DEVICES = "hyperspace.parallel.mesh.devices"
    PARALLEL_MIN_ROWS = "hyperspace.parallel.minRows"
    PARALLEL_BUILD_ENABLED = "hyperspace.parallel.build.enabled"
    TPU_MESH_AXIS = "hyperspace.tpu.mesh.axis"
    TPU_ROWS_PER_SHARD_CAPACITY_FACTOR = "hyperspace.tpu.rebucket.capacityFactor"
    EXEC_IO_NATIVE_ENABLED = "hyperspace.exec.io.native.enabled"
    EXEC_IO_NATIVE_ROWGROUP = "hyperspace.exec.io.native.rowGroupDecode"
    EXEC_IO_NATIVE_MAX_DICT = "hyperspace.exec.io.native.maxDictEntries"
    RELIABILITY_FAULTS_ENABLED = "hyperspace.reliability.faults.enabled"
    RELIABILITY_FAULTS_SPEC = "hyperspace.reliability.faults.spec"
    RELIABILITY_FAULTS_SEED = "hyperspace.reliability.faults.seed"
    RELIABILITY_RETRY_ENABLED = "hyperspace.reliability.retry.enabled"
    RELIABILITY_RETRY_MAX_ATTEMPTS = "hyperspace.reliability.retry.maxAttempts"
    RELIABILITY_RETRY_BASE_MS = "hyperspace.reliability.retry.baseMs"
    RELIABILITY_RETRY_CAP_MS = "hyperspace.reliability.retry.capMs"
    RELIABILITY_QUARANTINE_ENABLED = "hyperspace.reliability.quarantine.enabled"
    RELIABILITY_QUARANTINE_THRESHOLD = "hyperspace.reliability.quarantine.threshold"
    RELIABILITY_QUARANTINE_COOLDOWN_SECONDS = "hyperspace.reliability.quarantine.cooldownSeconds"
    FABRIC_ENABLED = "hyperspace.fabric.enabled"
    EVENT_LOGGER_CLASS = "hyperspace.eventLoggerClass"
    EXEC_JOIN_BUILD_CACHE_MAX_BYTES = "hyperspace.exec.join.buildCache.maxBytes"
    SERVING_QUEUE_DEPTH = "hyperspace.serving.queueDepth"
    SERVING_WORKERS = "hyperspace.serving.workers"
    SERVING_DEFAULT_TIMEOUT_SECONDS = "hyperspace.serving.defaultTimeoutSeconds"
    SERVING_PLAN_CACHE_ENABLED = "hyperspace.serving.planCache.enabled"
    SERVING_PLAN_CACHE_MAX_ENTRIES = "hyperspace.serving.planCache.maxEntries"
    SERVING_MICRO_BATCH_ENABLED = "hyperspace.serving.microBatch.enabled"
    SERVING_MICRO_BATCH_MAX_REQUESTS = "hyperspace.serving.microBatch.maxRequests"
    SERVING_MICRO_BATCH_MAX_WAIT_MS = "hyperspace.serving.microBatch.maxWaitMs"
    SERVING_BUCKET_CACHE_BYTES = "hyperspace.serving.bucketCache.bytes"
    SERVING_PREFETCH_ENABLED = "hyperspace.serving.prefetch.enabled"
    SERVING_PREFETCH_WORKERS = "hyperspace.serving.prefetch.workers"
    SERVING_SCHED_ENABLED = "hyperspace.serving.sched.enabled"
    SERVING_SCHED_INTERACTIVE_MS = "hyperspace.serving.sched.interactiveMs"
    SERVING_SCHED_HEAVY_MS = "hyperspace.serving.sched.heavyMs"
    SERVING_SCHED_MIN_CONFIDENCE = "hyperspace.serving.sched.minConfidence"
    SERVING_SCHED_MAX_QUEUED_SECONDS = "hyperspace.serving.sched.maxQueuedSeconds"
    SERVING_SCHED_TENANT_WEIGHTS = "hyperspace.serving.sched.tenantWeights"
    SERVING_SCHED_TENANT_RATE = "hyperspace.serving.sched.tenantRatePerSecond"
    SERVING_SCHED_TENANT_BURST = "hyperspace.serving.sched.tenantBurst"
    SERVING_SCHED_BURN_THRESHOLD = "hyperspace.serving.sched.burnBoostThreshold"
    SERVING_SCHED_BURN_FACTOR = "hyperspace.serving.sched.burnBoostFactor"
    SERVING_RESULT_CACHE_ENABLED = "hyperspace.serving.resultCache.enabled"
    SERVING_RESULT_CACHE_BYTES = "hyperspace.serving.resultCache.bytes"
    SERVING_RESULT_CACHE_MAX_ENTRY_BYTES = "hyperspace.serving.resultCache.maxEntryBytes"
    SERVING_RESULT_CACHE_SUBSUMPTION = "hyperspace.serving.resultCache.subsumption"
    OBS_TRACING_ENABLED = "hyperspace.obs.tracing.enabled"
    OBS_TRACE_MAX_SPANS = "hyperspace.obs.trace.maxSpans"
    OBS_METRICS_ENABLED = "hyperspace.obs.metrics.enabled"
    OBS_PROFILE_HISTORY = "hyperspace.obs.profile.history"
    OBS_PROFILE_WHY_NOT = "hyperspace.obs.profile.whyNot"
    OBS_HISTORY_ENABLED = "hyperspace.obs.history.enabled"
    OBS_HISTORY_MAX_FINGERPRINTS = "hyperspace.obs.history.maxFingerprints"
    OBS_HISTORY_PERSIST = "hyperspace.obs.history.persist"
    OBS_SLOW_QUERY_MS = "hyperspace.obs.slowQueryMs"
    OBS_SLOW_QUERY_MAX_ENTRIES = "hyperspace.obs.slowQuery.maxEntries"
    OBS_SLOW_QUERY_DIR = "hyperspace.obs.slowQuery.dir"
    OBS_SLO_TARGET_MS = "hyperspace.obs.slo.targetMs"
    OBS_SLO_OBJECTIVE = "hyperspace.obs.slo.objective"
    OBS_SLO_WINDOWS_SECONDS = "hyperspace.obs.slo.windowsSeconds"
    OBS_HTTP_PORT = "hyperspace.obs.http.port"
    OBS_HTTP_HOST = "hyperspace.obs.http.host"
    # Distributed observability over the serving fabric (obs/spans.py and
    # fabric/frontdoor.py): trace-context propagation on routed requests,
    # cross-process span-tree stitching, and federation fan-out bounds.
    OBS_FABRIC_PROPAGATE = "hyperspace.obs.fabric.propagate"
    OBS_FABRIC_STITCH_ENABLED = "hyperspace.obs.fabric.stitch.enabled"
    OBS_FABRIC_STITCH_MAX_SPANS = "hyperspace.obs.fabric.stitch.maxSpans"
    OBS_FABRIC_STITCH_MAX_BYTES = "hyperspace.obs.fabric.stitch.maxBytes"
    OBS_FABRIC_FEDERATION_TIMEOUT_SECONDS = "hyperspace.obs.fabric.federationTimeoutSeconds"
    # program contracts (check/program_lint.py): each device program's
    # recorded dispatch against its family's declared contract
    CHECK_HLO_ENABLED = "hyperspace.check.hlo.enabled"
    CHECK_LOCKS = "hyperspace.check.locks"
    LIFECYCLE_SNAPSHOT_ENABLED = "hyperspace.lifecycle.snapshot.enabled"
    LIFECYCLE_REFRESH_ENABLED = "hyperspace.lifecycle.refresh.enabled"
    LIFECYCLE_REFRESH_INTERVAL_SECONDS = "hyperspace.lifecycle.refresh.intervalSeconds"
    LIFECYCLE_REFRESH_MODE = "hyperspace.lifecycle.refresh.mode"
    FABRIC_NODE_ID = "hyperspace.fabric.nodeId"
    FABRIC_WATCHER_ENABLED = "hyperspace.fabric.watcher.enabled"
    FABRIC_POLL_INTERVAL_SECONDS = "hyperspace.fabric.watcher.pollIntervalSeconds"
    FABRIC_QUARANTINE_SHARED = "hyperspace.fabric.quarantine.shared"
    FABRIC_SLO_SHARED = "hyperspace.fabric.slo.shared"
    FABRIC_SLO_PUBLISH_INTERVAL_SECONDS = "hyperspace.fabric.slo.publishIntervalSeconds"
    # Fabric crash tolerance: lake-persisted refresh leases with fencing
    # tokens, health-aware FrontDoor failover, and fsck lake garbage
    # collection. All default-off on top of the fabric's own default-off.
    FABRIC_LEASE_ENABLED = "hyperspace.fabric.lease.enabled"
    FABRIC_LEASE_TTL_SECONDS = "hyperspace.fabric.lease.ttlSeconds"
    FABRIC_LEASE_RENEW_INTERVAL_SECONDS = "hyperspace.fabric.lease.renewIntervalSeconds"
    FABRIC_HEALTH_ENABLED = "hyperspace.fabric.health.enabled"
    FABRIC_HEALTH_FAILURE_THRESHOLD = "hyperspace.fabric.health.failureThreshold"
    FABRIC_HEALTH_PROBE_INTERVAL_SECONDS = "hyperspace.fabric.health.probeIntervalSeconds"
    FABRIC_HEALTH_HEARTBEAT_INTERVAL_SECONDS = "hyperspace.fabric.health.heartbeatIntervalSeconds"
    FABRIC_HEALTH_MISSED_BEATS = "hyperspace.fabric.health.missedBeats"
    FABRIC_HEALTH_MAX_COMMIT_LAG = "hyperspace.fabric.health.maxCommitLag"
    FABRIC_HEALTH_HEDGE_MS = "hyperspace.fabric.health.hedgeMs"
    FABRIC_FSCK_ENABLED = "hyperspace.fabric.fsck.enabled"
    FABRIC_FSCK_RETENTION_SECONDS = "hyperspace.fabric.fsck.retentionSeconds"
    FABRIC_FSCK_DEAD_NODE_SECONDS = "hyperspace.fabric.fsck.deadNodeSeconds"
    FABRIC_FSCK_INTERVAL_SECONDS = "hyperspace.fabric.fsck.intervalSeconds"

    # the JAX package's names for the keys above that the port names
    # otherwise (the same strings), so code written against either resolves
    TPU_BUILD_BATCH_ROWS = BUILD_BATCH_ROWS
    TPU_QUERY_DEVICE_EXECUTION = DEVICE_EXECUTION
    TPU_QUERY_DEVICE_MIN_ROWS = DEVICE_MIN_ROWS
    TPU_JOIN_DEVICE_MATERIALIZE = JOIN_DEVICE_MATERIALIZE
    TPU_JOIN_DEVICE_MATERIALIZE_MAX_BYTES = JOIN_DEVICE_MATERIALIZE_MAX_BYTES
    TPU_JOIN_DEVICE_SPAN_MAX_BYTES = JOIN_DEVICE_SPAN_MAX_BYTES
    EXEC_STREAM_JOIN_MIN_BYTES = STREAM_JOIN_MIN_BYTES
    EXEC_STREAM_AGG_MIN_BYTES = STREAM_AGG_MIN_BYTES
    EXEC_STREAM_CHUNK_BYTES = STREAM_CHUNK_BYTES
    EXEC_JOIN_SPILL_MIN_ROWS = JOIN_SPILL_MIN_ROWS
    EXEC_JOIN_BROADCAST_MAX_BYTES = JOIN_BROADCAST_MAX_BYTES
    EXEC_JOIN_PIPELINE_ENABLED = JOIN_PIPELINE_ENABLED
    EXEC_IO_DECODE_THREADS = IO_DECODE_THREADS
    EXEC_PIPELINE_ENABLED = PIPELINE_ENABLED
    EXEC_PIPELINE_DEPTH = PIPELINE_DEPTH
    EXEC_PIPELINE_MAX_BUFFERED_BYTES = PIPELINE_MAX_BUFFERED_BYTES
    EXEC_AGG_DEVICE_GROUPED = AGG_ENABLED
    EXEC_AGG_MAX_GROUPS = AGG_MAX_GROUPS
    EXEC_AGG_CAPACITY_FLOOR = AGG_CAPACITY_FLOOR
    EXEC_FUSION_ENABLED = FUSION_ENABLED
    EXEC_FUSION_DONATION = FUSION_DONATION


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
    # the sharded (multi-device) paths are not in the port: with this on, a
    # query raises where the JAX package would shard it (a chunk of at least
    # minRows rows, or a streamed path), and a build raises where it would
    # build on a mesh (build.enabled, more than one device in the mesh of
    # mesh.devices devices, 0 = all, and at least distributedMinRows rows)
    keys.PARALLEL_ENABLED: False,
    keys.PARALLEL_MIN_ROWS: 1 << 16,
    keys.PARALLEL_BUILD_ENABLED: True,
    keys.PARALLEL_MESH_DEVICES: 0,
    keys.TPU_BUILD_DISTRIBUTED_MIN_ROWS: 0,
    # the mesh's axis name, and the exchange's slots per source and
    # destination as a multiple of the even share (ops/bucketize.py)
    keys.TPU_MESH_AXIS: "buckets",
    keys.TPU_ROWS_PER_SHARD_CAPACITY_FACTOR: 2.0,
    # a struct leaf named by its dotted path (``a.b``) may be indexed; it is
    # stored as the flat column ``__hs_nested.a.b``
    keys.NESTED_COLUMN_ENABLED: False,
    # the JAX package's key, read by neither package: a glob path matches
    # its files whatever this says
    keys.GLOBBING_PATTERN: None,
    # seconds the index manager serves its cached roster before re-reading
    # the operation logs (read on every lookup; 0 re-reads every time)
    keys.CACHE_EXPIRY_SECONDS: 300,
    # the JAX package's target size of a data-skipping index's sketch
    # files, with its default; neither package's sketch writer reads it
    keys.DATASKIPPING_TARGET_FILE_SIZE: 256 * 1024 * 1024,
    # explain's display keys, with the JAX package's defaults
    keys.DISPLAY_MODE: "console",
    keys.HIGHLIGHT_BEGIN_TAG: "",
    keys.HIGHLIGHT_END_TAG: "",
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
    # whole-stage fusion (exec/stage_ir.py): a streamed chunk's grouped
    # aggregate, top-k or broadcast join-aggregate folds into the running
    # state with ONE program; results are byte-identical either way
    keys.FUSION_ENABLED: False,
    # with fusion on, the fold state is updated in place (the JAX package
    # donates it); only consulted when fusion is on
    keys.FUSION_DONATION: True,
    # a join side whose leaf files hold at most this many bytes is built
    # into one sorted hash table on the device and the other side streams
    # through it (exec/join_stream.py); 0 sends such joins to the generic
    # merge. The fused join aggregate (exec/stage_ir.py) takes the same
    # decision
    keys.JOIN_BROADCAST_MAX_BYTES: 64 * 1024 * 1024,
    # ORDER BY ... LIMIT k over a multi-chunk scan folds a candidate buffer
    # on the device (exec/topk.py) instead of a host sort of every row;
    # maxK is the largest k it serves, and thresholdPushdown feeds the
    # running k-th candidate's key into row-group pruning of later chunks
    keys.EXEC_TOPK_ENABLED: True,
    keys.EXEC_TOPK_MAX_K: 4096,
    keys.EXEC_TOPK_THRESHOLD_PUSHDOWN: True,
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
    # native parquet decode (exec/io.py over the C++ decoder of native/,
    # built into _build/ at first use): `enabled` gates all of it (the
    # row-group fast path and the per-file native-first read);
    # `rowGroupDecode` gates the parallel row-group fast path alone;
    # string columns whose every chunk has a dictionary of at most
    # `maxDictEntries` entries ship codes and the dictionary, and expand on
    # the device (0 turns that off)
    keys.EXEC_IO_NATIVE_ENABLED: True,
    keys.EXEC_IO_NATIVE_ROWGROUP: True,
    keys.EXEC_IO_NATIVE_MAX_DICT: 4096,
    # fault injection at the lake IO seams (reliability/faults.py): off, the
    # registry stays empty and every seam costs one attribute read; the spec
    # installs seeded rules ("site:kind[:glob=..][:nth=N][:p=F][:delay=S]
    # [:max=N]" joined by ";")
    keys.RELIABILITY_FAULTS_ENABLED: False,
    keys.RELIABILITY_FAULTS_SPEC: "",
    keys.RELIABILITY_FAULTS_SEED: 0,
    # retry of transient IO errors with decorrelated-jitter backoff
    # (reliability/retry.py); off, a failing read surfaces at once
    keys.RELIABILITY_RETRY_ENABLED: False,
    keys.RELIABILITY_RETRY_MAX_ATTEMPTS: 4,
    keys.RELIABILITY_RETRY_BASE_MS: 5.0,
    keys.RELIABILITY_RETRY_CAP_MS: 100.0,
    # the index quarantine breaker (reliability/degrade.py): this many
    # corrupt reads of one index's files take it out of planning (queries
    # read the source) until a half-open probe after the cooldown reads clean
    keys.RELIABILITY_QUARANTINE_ENABLED: False,
    keys.RELIABILITY_QUARANTINE_THRESHOLD: 3,
    keys.RELIABILITY_QUARANTINE_COOLDOWN_SECONDS: 30.0,
    # Master fabric switch. Off: no commit records are written, no watcher
    # or sidecar thread starts, every hook is one conf read; single-process
    # behavior is byte-identical to a build without the subsystem.
    keys.FABRIC_ENABLED: False,
    # Byte budget of the shared build-side LRU (serving/build_cache.py):
    # micro-batched requests joining the same dimension table reuse one
    # built hash table instead of rebuilding per request. Entries key on
    # (scan signature, keys, data-version brand) and purge on brand
    # rotation, like the result cache.
    keys.EXEC_JOIN_BUILD_CACHE_MAX_BYTES: 256 * 1024 * 1024,
    keys.EVENT_LOGGER_CLASS: None,
    # Serving runtime. Queue depth bounds memory under overload: submits
    # beyond it are REJECTED (AdmissionRejected), never silently queued.
    keys.SERVING_QUEUE_DEPTH: 64,
    keys.SERVING_WORKERS: 4,
    # None = no deadline; floats are seconds from submit to result.
    keys.SERVING_DEFAULT_TIMEOUT_SECONDS: 30.0,
    keys.SERVING_PLAN_CACHE_ENABLED: True,
    keys.SERVING_PLAN_CACHE_MAX_ENTRIES: 256,
    keys.SERVING_MICRO_BATCH_ENABLED: True,
    keys.SERVING_MICRO_BATCH_MAX_REQUESTS: 16,
    # How long a worker lingers draining the queue to fill a batch; the
    # latency cost of coalescing is bounded by this.
    keys.SERVING_MICRO_BATCH_MAX_WAIT_MS: 2.0,
    keys.SERVING_BUCKET_CACHE_BYTES: 1 << 30,
    keys.SERVING_PREFETCH_ENABLED: True,
    keys.SERVING_PREFETCH_WORKERS: 2,
    # Cost-aware scheduler. Off by default: with both sched and resultCache
    # disabled the server is byte-for-byte the FIFO runtime above.
    keys.SERVING_SCHED_ENABLED: False,
    # Predicted-latency class cut points: under interactiveMs -> interactive,
    # over heavyMs -> heavy, between -> standard. Estimates whose confidence
    # is below minConfidence classify as "unknown" (scheduled after standard
    # but before heavy — unknown shapes must not starve, nor jump the line).
    keys.SERVING_SCHED_INTERACTIVE_MS: 50.0,
    keys.SERVING_SCHED_HEAVY_MS: 500.0,
    keys.SERVING_SCHED_MIN_CONFIDENCE: 0.3,
    # Shed when the confident predicted work already queued exceeds this many
    # seconds (0 = depth-only shedding, the FIFO discipline).
    keys.SERVING_SCHED_MAX_QUEUED_SECONDS: 0.0,
    # "tenantA=4,tenantB=1" weighted fair shares; unlisted tenants weigh 1.
    keys.SERVING_SCHED_TENANT_WEIGHTS: "",
    # Per-tenant token-bucket admission rate (requests/s); 0 = unlimited.
    keys.SERVING_SCHED_TENANT_RATE: 0.0,
    keys.SERVING_SCHED_TENANT_BURST: 32,
    # A tenant whose own SLO burn rate >= threshold gets its weight
    # multiplied by factor (recovery boost); a tenant hogging the most work
    # while ANOTHER tenant burns gets its weight divided by factor.
    keys.SERVING_SCHED_BURN_THRESHOLD: 2.0,
    keys.SERVING_SCHED_BURN_FACTOR: 2.0,
    # Semantic result cache. Off by default (see sched.enabled note).
    keys.SERVING_RESULT_CACHE_ENABLED: False,
    keys.SERVING_RESULT_CACHE_BYTES: 256 * 1024 * 1024,
    keys.SERVING_RESULT_CACHE_MAX_ENTRY_BYTES: 16 * 1024 * 1024,
    # Serve a request whose predicate provably implies a cached superset
    # predicate by re-filtering the cached batch.
    keys.SERVING_RESULT_CACHE_SUBSUMPTION: True,
    # Span tracing is opt-in: when off, each instrumentation point costs one
    # contextvar read (bench.py --obs-overhead pins the bar at <= 3%).
    keys.OBS_TRACING_ENABLED: False,
    # Per-trace span budget; beyond it the tree stops growing and the trace
    # reports droppedSpans (bounded memory under pathological plans).
    keys.OBS_TRACE_MAX_SPANS: 100_000,
    keys.OBS_METRICS_ENABLED: True,
    # How many per-request QueryProfiles a QueryServer retains.
    keys.OBS_PROFILE_HISTORY: 16,
    # Run the why-not analysis on traced queries (extra optimizer passes per
    # query — diagnostic sessions only).
    keys.OBS_PROFILE_WHY_NOT: False,
    # Fold every completed query into the fingerprint-keyed ProfileHistory
    # (streaming stats + cost estimates). O(1) per query, bounded memory —
    # on by default; tracing is NOT required (latency/rows fold regardless).
    keys.OBS_HISTORY_ENABLED: True,
    # LRU bound on distinct fingerprints retained by a history instance.
    keys.OBS_HISTORY_MAX_FINGERPRINTS: 512,
    # Append one JSON line per completed query to
    # <system.path>/_telemetry/profile_history.jsonl (the workload log the
    # index advisor replays). Off by default: it is per-query disk IO.
    keys.OBS_HISTORY_PERSIST: False,
    # Flight-record queries slower than this many milliseconds (and every
    # errored/rejected request). 0 disables the recorder entirely.
    keys.OBS_SLOW_QUERY_MS: 0.0,
    # Bound on the flight recorder's in-memory and on-disk rings.
    keys.OBS_SLOW_QUERY_MAX_ENTRIES: 32,
    # On-disk ring directory; None derives <system.path>/_telemetry/slow
    # when a system path is configured, "" keeps entries memory-only.
    keys.OBS_SLOW_QUERY_DIR: None,
    # Latency-SLO target per served request, in milliseconds; 0 disables
    # SLO tracking. Good/bad counters and burn-rate gauges are per-tenant.
    keys.OBS_SLO_TARGET_MS: 1000.0,
    # Fraction of requests that must meet the target (error budget = 1-x).
    keys.OBS_SLO_OBJECTIVE: 0.999,
    # Comma-separated burn-rate window lengths in seconds.
    keys.OBS_SLO_WINDOWS_SECONDS: "300,3600",
    # Port for the JAX package's HTTP telemetry endpoint, which a
    # QueryServer starts alongside itself. None disables it; the endpoint
    # (obs/export.py) is not in the port yet, so a server raises "not yet in
    # the port" while this is set.
    keys.OBS_HTTP_PORT: None,
    keys.OBS_HTTP_HOST: "127.0.0.1",
    # Stamp a W3C traceparent header (plus the stitch budget header when
    # stitching is on) onto FrontDoor /query requests whenever the router is
    # tracing. Off: routed requests are byte-identical to a build without
    # distributed tracing.
    keys.OBS_FABRIC_PROPAGATE: True,
    # Ship the worker's serialized span tree back in the /query response so
    # the router can graft it into one end-to-end trace. Off by default:
    # it grows every traced response by up to stitch.maxBytes.
    keys.OBS_FABRIC_STITCH_ENABLED: False,
    # Bounds on the stitched payload a worker may return: spans survive
    # tree-prefix truncation up to maxSpans, and the JSON encoding degrades
    # to the root alone past maxBytes (droppedSpans/truncated stay visible).
    keys.OBS_FABRIC_STITCH_MAX_SPANS: 512,
    keys.OBS_FABRIC_STITCH_MAX_BYTES: 262_144,
    # Per-worker HTTP timeout for /profilez and /statusz federation sweeps.
    keys.OBS_FABRIC_FEDERATION_TIMEOUT_SECONDS: 30.0,
    # Wrap named internal mutexes in the lock-order watcher (cross-thread
    # acquisition-order cycle detection). Construction-time flag: locks
    # created before a Session enabled it stay plain.
    # Verify every device program, once per (program key, shape signature),
    # against its family's registered ProgramContract: the aten ops and
    # collectives one live call dispatched (check/program_lint.py), counted
    # in hs_check_violations_total on breach. Off, it costs one conf lookup
    # per program. HS_CHECK_HLO=1 flips the default on for a whole process.
    keys.CHECK_HLO_ENABLED: os.environ.get("HS_CHECK_HLO", "") not in ("", "0"),
    keys.CHECK_LOCKS: False,
    # Pin a SnapshotHandle (index-log roster frozen at admission) per served
    # request, so a refresh committing mid-flight never changes a running
    # query's answer (docs/lifecycle.md).
    keys.LIFECYCLE_SNAPSHOT_ENABLED: True,
    # Run the background RefreshManager alongside serving; off by default —
    # refreshes are an explicit operational decision.
    keys.LIFECYCLE_REFRESH_ENABLED: False,
    # Seconds between RefreshManager drift polls.
    keys.LIFECYCLE_REFRESH_INTERVAL_SECONDS: 5.0,
    # Refresh mode the manager schedules: "auto" picks incremental when the
    # appended/deleted ratios exceed the hybrid-scan thresholds (the index
    # would stop qualifying for hybrid scan) and quick otherwise; or pin
    # "incremental" / "quick" / "full" explicitly.
    keys.LIFECYCLE_REFRESH_MODE: "auto",
    # Stable identity stamped as the origin of this process's commit
    # records (self-commit dedupe) and its sidecar node file. Empty means
    # "<hostname>:<pid>", which is unique per process on one host.
    keys.FABRIC_NODE_ID: "",
    # Run the CommitWatcher thread when the fabric is on. A pure writer
    # process (one that only refreshes) can turn this off and only publish.
    keys.FABRIC_WATCHER_ENABLED: True,
    # Watcher poll interval, the cross-process staleness bound: a commit
    # in process A is replayed in process B within one interval.
    keys.FABRIC_POLL_INTERVAL_SECONDS: 0.25,
    # Merge remote quarantine strikes/trips from peers' commit records and
    # sidecar files, so one process's corrupt reads protect the others.
    keys.FABRIC_QUARANTINE_SHARED: True,
    # Publish/merge per-tenant SLO good/bad counts and token-bucket drains
    # through the sidecar, so burn rates and rate limits hold globally.
    keys.FABRIC_SLO_SHARED: True,
    # Seconds between sidecar publish/merge rounds.
    keys.FABRIC_SLO_PUBLISH_INTERVAL_SECONDS: 1.0,
    # Lake-persisted refresh lease: when on (and the fabric is on), the
    # RefreshManager acquires a per-index lease before building, so exactly
    # one *process* refreshes an index, and the lease's fencing token is
    # verified at every operation-log write: a holder that paused past
    # expiry and was taken over fails its late commit instead of landing it.
    keys.FABRIC_LEASE_ENABLED: False,
    # How long an unrenewed lease stays exclusive; also the takeover bound
    # for a holder killed mid-refresh.
    keys.FABRIC_LEASE_TTL_SECONDS: 30.0,
    # Heartbeat renewal cadence while a refresh holds its lease. Keep well
    # under the TTL (a renewal extends the expiry by one full TTL).
    keys.FABRIC_LEASE_RENEW_INTERVAL_SECONDS: 10.0,
    # Health-aware FrontDoor membership: consecutive failures / missed
    # sidecar heartbeats / commit-seq staleness eject a worker from the
    # rendezvous set (tenants re-hash to survivors); a half-open probe
    # re-admits it. Also enables retry-on-next-candidate failover.
    keys.FABRIC_HEALTH_ENABLED: False,
    # Consecutive transport/transient failures before ejection.
    keys.FABRIC_HEALTH_FAILURE_THRESHOLD: 3,
    # Cooldown before an ejected worker gets one half-open probe request.
    keys.FABRIC_HEALTH_PROBE_INTERVAL_SECONDS: 5.0,
    # Expected sidecar heartbeat cadence (the ledger publish interval of
    # the workers being watched); beat age is judged against this.
    keys.FABRIC_HEALTH_HEARTBEAT_INTERVAL_SECONDS: 1.0,
    # A worker whose ledger heartbeat is older than this many intervals is
    # ejected as dead: the failover detection bound is 2 intervals.
    keys.FABRIC_HEALTH_MISSED_BEATS: 2,
    # Eject a worker whose /healthz last-applied commit_seq lags the fleet
    # max by more than this (a wedged watcher serves stale answers while
    # looking alive). 0 disables staleness ejection.
    keys.FABRIC_HEALTH_MAX_COMMIT_LAG: 0,
    # Hedged reads: if the primary worker hasn't answered within this many
    # milliseconds, mirror the (idempotent) query to the next rendezvous
    # candidate and take whichever answers first. 0 disables hedging.
    keys.FABRIC_HEALTH_HEDGE_MS: 0.0,
    # Run the fsck garbage collector (fabric/fsck.py) at session start and
    # then periodically: compacts old/torn commit records, superseded lease
    # tokens, expired leases, and dead-node ledgers.
    keys.FABRIC_FSCK_ENABLED: False,
    # Commit records older than this are compacted (the newest record per
    # index is always kept so watcher cursors stay monotonic).
    keys.FABRIC_FSCK_RETENTION_SECONDS: 3600.0,
    # Node ledgers silent for longer than this are removed.
    keys.FABRIC_FSCK_DEAD_NODE_SECONDS: 600.0,
    # Seconds between periodic fsck passes when enabled.
    keys.FABRIC_FSCK_INTERVAL_SECONDS: 300.0,
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
    if isinstance(like, float):
        return float(value)
    return value


class HyperspaceConf:
    """A mutable string-keyed configuration with typed accessors; every
    accessor reads the raw key and falls back to the default."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._conf: Dict[str, Any] = dict(overrides or {})

    def set(self, key: str, value: Any) -> "HyperspaceConf":
        self._conf[key] = value
        return self

    def unset(self, key: str) -> "HyperspaceConf":
        self._conf.pop(key, None)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._conf:
            return _coerce(self._conf[key], DEFAULTS.get(key, default))
        if key in DEFAULTS:
            return DEFAULTS[key] if default is None else default
        return default

    def copy(self) -> "HyperspaceConf":
        return HyperspaceConf(dict(self._conf))

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
    def dataskipping_target_file_size(self) -> int:
        return int(self.get(keys.DATASKIPPING_TARGET_FILE_SIZE))

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
    def parallel_min_rows(self) -> int:
        return int(self.get(keys.PARALLEL_MIN_ROWS))

    @property
    def parallel_build_enabled(self) -> bool:
        return bool(self.get(keys.PARALLEL_BUILD_ENABLED))

    @property
    def parallel_mesh_devices(self) -> int:
        return int(self.get(keys.PARALLEL_MESH_DEVICES))

    @property
    def distributed_build_min_rows(self) -> int:
        return int(self.get(keys.TPU_BUILD_DISTRIBUTED_MIN_ROWS))

    @property
    def mesh_axis(self) -> str:
        return str(self.get(keys.TPU_MESH_AXIS))

    @property
    def rebucket_capacity_factor(self) -> float:
        return float(self.get(keys.TPU_ROWS_PER_SHARD_CAPACITY_FACTOR))

    @property
    def nested_column_enabled(self) -> bool:
        return bool(self.get(keys.NESTED_COLUMN_ENABLED))

    @property
    def cache_expiry_seconds(self) -> int:
        return int(self.get(keys.CACHE_EXPIRY_SECONDS))

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
    def fusion_donation(self) -> bool:
        return bool(self.get(keys.FUSION_DONATION))

    @property
    def join_broadcast_max_bytes(self) -> int:
        return int(self.get(keys.JOIN_BROADCAST_MAX_BYTES))

    @property
    def topk_enabled(self) -> bool:
        return bool(self.get(keys.EXEC_TOPK_ENABLED))

    @property
    def topk_max_k(self) -> int:
        return int(self.get(keys.EXEC_TOPK_MAX_K))

    @property
    def topk_threshold_pushdown(self) -> bool:
        return bool(self.get(keys.EXEC_TOPK_THRESHOLD_PUSHDOWN))

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

    @property
    def io_native_enabled(self) -> bool:
        return bool(self.get(keys.EXEC_IO_NATIVE_ENABLED))

    @property
    def io_native_rowgroup(self) -> bool:
        return bool(self.get(keys.EXEC_IO_NATIVE_ROWGROUP))

    @property
    def io_native_max_dict_entries(self) -> int:
        return int(self.get(keys.EXEC_IO_NATIVE_MAX_DICT))

    @property
    def reliability_faults_enabled(self) -> bool:
        return bool(self.get(keys.RELIABILITY_FAULTS_ENABLED))

    @property
    def reliability_faults_spec(self) -> str:
        return str(self.get(keys.RELIABILITY_FAULTS_SPEC) or "")

    @property
    def reliability_faults_seed(self) -> int:
        return int(self.get(keys.RELIABILITY_FAULTS_SEED))

    @property
    def reliability_retry_enabled(self) -> bool:
        return bool(self.get(keys.RELIABILITY_RETRY_ENABLED))

    @property
    def reliability_retry_max_attempts(self) -> int:
        return int(self.get(keys.RELIABILITY_RETRY_MAX_ATTEMPTS))

    @property
    def reliability_retry_base_ms(self) -> float:
        return float(self.get(keys.RELIABILITY_RETRY_BASE_MS))

    @property
    def reliability_retry_cap_ms(self) -> float:
        return float(self.get(keys.RELIABILITY_RETRY_CAP_MS))

    @property
    def reliability_quarantine_enabled(self) -> bool:
        return bool(self.get(keys.RELIABILITY_QUARANTINE_ENABLED))

    @property
    def reliability_quarantine_threshold(self) -> int:
        return int(self.get(keys.RELIABILITY_QUARANTINE_THRESHOLD))

    @property
    def reliability_quarantine_cooldown_seconds(self) -> float:
        return float(self.get(keys.RELIABILITY_QUARANTINE_COOLDOWN_SECONDS))

    @property
    def fabric_enabled(self) -> bool:
        return bool(self.get(keys.FABRIC_ENABLED))

    @property
    def join_build_cache_max_bytes(self) -> int:
        return int(self.get(keys.EXEC_JOIN_BUILD_CACHE_MAX_BYTES))

    # Serving runtime --------------------------------------------------------
    @property
    def serving_queue_depth(self) -> int:
        return int(self.get(keys.SERVING_QUEUE_DEPTH))

    @property
    def serving_workers(self) -> int:
        return int(self.get(keys.SERVING_WORKERS))

    @property
    def serving_default_timeout_seconds(self) -> Optional[float]:
        v = self.get(keys.SERVING_DEFAULT_TIMEOUT_SECONDS)
        return None if v is None else float(v)

    @property
    def serving_plan_cache_enabled(self) -> bool:
        return bool(self.get(keys.SERVING_PLAN_CACHE_ENABLED))

    @property
    def serving_plan_cache_max_entries(self) -> int:
        return int(self.get(keys.SERVING_PLAN_CACHE_MAX_ENTRIES))

    @property
    def serving_micro_batch_enabled(self) -> bool:
        return bool(self.get(keys.SERVING_MICRO_BATCH_ENABLED))

    @property
    def serving_micro_batch_max_requests(self) -> int:
        return int(self.get(keys.SERVING_MICRO_BATCH_MAX_REQUESTS))

    @property
    def serving_micro_batch_max_wait_ms(self) -> float:
        return float(self.get(keys.SERVING_MICRO_BATCH_MAX_WAIT_MS))

    @property
    def serving_bucket_cache_bytes(self) -> int:
        return int(self.get(keys.SERVING_BUCKET_CACHE_BYTES))

    @property
    def serving_prefetch_enabled(self) -> bool:
        return bool(self.get(keys.SERVING_PREFETCH_ENABLED))

    @property
    def serving_prefetch_workers(self) -> int:
        return int(self.get(keys.SERVING_PREFETCH_WORKERS))

    @property
    def serving_sched_enabled(self) -> bool:
        return bool(self.get(keys.SERVING_SCHED_ENABLED))

    @property
    def serving_sched_interactive_ms(self) -> float:
        return float(self.get(keys.SERVING_SCHED_INTERACTIVE_MS))

    @property
    def serving_sched_heavy_ms(self) -> float:
        return float(self.get(keys.SERVING_SCHED_HEAVY_MS))

    @property
    def serving_sched_min_confidence(self) -> float:
        return float(self.get(keys.SERVING_SCHED_MIN_CONFIDENCE))

    @property
    def serving_sched_max_queued_seconds(self) -> float:
        return float(self.get(keys.SERVING_SCHED_MAX_QUEUED_SECONDS))

    @property
    def serving_sched_tenant_weights(self) -> Dict[str, float]:
        raw = str(self.get(keys.SERVING_SCHED_TENANT_WEIGHTS) or "")
        out: Dict[str, float] = {}
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition("=")
            try:
                out[name.strip()] = float(w)
            except ValueError:
                raise ValueError(
                    f"bad tenant weight {part!r} in {keys.SERVING_SCHED_TENANT_WEIGHTS}"
                ) from None
        return out

    @property
    def serving_sched_tenant_rate(self) -> float:
        return float(self.get(keys.SERVING_SCHED_TENANT_RATE))

    @property
    def serving_sched_tenant_burst(self) -> int:
        return int(self.get(keys.SERVING_SCHED_TENANT_BURST))

    @property
    def serving_sched_burn_threshold(self) -> float:
        return float(self.get(keys.SERVING_SCHED_BURN_THRESHOLD))

    @property
    def serving_sched_burn_factor(self) -> float:
        return float(self.get(keys.SERVING_SCHED_BURN_FACTOR))

    @property
    def serving_result_cache_enabled(self) -> bool:
        return bool(self.get(keys.SERVING_RESULT_CACHE_ENABLED))

    @property
    def serving_result_cache_bytes(self) -> int:
        return int(self.get(keys.SERVING_RESULT_CACHE_BYTES))

    @property
    def serving_result_cache_max_entry_bytes(self) -> int:
        return int(self.get(keys.SERVING_RESULT_CACHE_MAX_ENTRY_BYTES))

    @property
    def serving_result_cache_subsumption(self) -> bool:
        return bool(self.get(keys.SERVING_RESULT_CACHE_SUBSUMPTION))

    # Observability ----------------------------------------------------------
    @property
    def obs_tracing_enabled(self) -> bool:
        return bool(self.get(keys.OBS_TRACING_ENABLED))

    @property
    def obs_trace_max_spans(self) -> int:
        return int(self.get(keys.OBS_TRACE_MAX_SPANS))

    @property
    def obs_metrics_enabled(self) -> bool:
        return bool(self.get(keys.OBS_METRICS_ENABLED))

    @property
    def obs_profile_history(self) -> int:
        return int(self.get(keys.OBS_PROFILE_HISTORY))

    @property
    def obs_profile_why_not(self) -> bool:
        return bool(self.get(keys.OBS_PROFILE_WHY_NOT))

    @property
    def obs_history_enabled(self) -> bool:
        return bool(self.get(keys.OBS_HISTORY_ENABLED))

    @property
    def obs_history_max_fingerprints(self) -> int:
        return int(self.get(keys.OBS_HISTORY_MAX_FINGERPRINTS))

    @property
    def obs_history_persist(self) -> bool:
        return bool(self.get(keys.OBS_HISTORY_PERSIST))

    @property
    def obs_slow_query_ms(self) -> float:
        return float(self.get(keys.OBS_SLOW_QUERY_MS))

    @property
    def obs_slow_query_max_entries(self) -> int:
        return int(self.get(keys.OBS_SLOW_QUERY_MAX_ENTRIES))

    @property
    def obs_slow_query_dir(self) -> Optional[str]:
        v = self.get(keys.OBS_SLOW_QUERY_DIR)
        return None if v is None else str(v)

    @property
    def obs_slo_target_ms(self) -> float:
        return float(self.get(keys.OBS_SLO_TARGET_MS))

    @property
    def obs_slo_objective(self) -> float:
        return float(self.get(keys.OBS_SLO_OBJECTIVE))

    @property
    def obs_slo_windows_seconds(self) -> tuple:
        raw = str(self.get(keys.OBS_SLO_WINDOWS_SECONDS))
        out = []
        for part in raw.split(","):
            part = part.strip()
            if part:
                out.append(float(part))
        return tuple(out) or (300.0, 3600.0)

    @property
    def obs_http_port(self) -> Optional[int]:
        v = self.get(keys.OBS_HTTP_PORT)
        return None if v is None else int(v)

    @property
    def obs_http_host(self) -> str:
        return str(self.get(keys.OBS_HTTP_HOST))

    @property
    def check_hlo_enabled(self) -> bool:
        return bool(self.get(keys.CHECK_HLO_ENABLED))

    @property
    def check_locks_enabled(self) -> bool:
        return bool(self.get(keys.CHECK_LOCKS))

    @property
    def lifecycle_snapshot_enabled(self) -> bool:
        return bool(self.get(keys.LIFECYCLE_SNAPSHOT_ENABLED))

    @property
    def lifecycle_refresh_enabled(self) -> bool:
        return bool(self.get(keys.LIFECYCLE_REFRESH_ENABLED))

    @property
    def lifecycle_refresh_interval_seconds(self) -> float:
        return float(self.get(keys.LIFECYCLE_REFRESH_INTERVAL_SECONDS))

    @property
    def lifecycle_refresh_mode(self) -> str:
        return str(self.get(keys.LIFECYCLE_REFRESH_MODE)).lower()

    @property
    def fabric_node_id(self) -> str:
        return str(self.get(keys.FABRIC_NODE_ID) or "")

    @property
    def fabric_lease_enabled(self) -> bool:
        return bool(self.get(keys.FABRIC_LEASE_ENABLED))

    @property
    def obs_fabric_propagate(self) -> bool:
        return bool(self.get(keys.OBS_FABRIC_PROPAGATE))

    @property
    def obs_fabric_stitch_enabled(self) -> bool:
        return bool(self.get(keys.OBS_FABRIC_STITCH_ENABLED))

    @property
    def obs_fabric_stitch_max_spans(self) -> int:
        return int(self.get(keys.OBS_FABRIC_STITCH_MAX_SPANS))

    @property
    def obs_fabric_stitch_max_bytes(self) -> int:
        return int(self.get(keys.OBS_FABRIC_STITCH_MAX_BYTES))

    @property
    def obs_fabric_federation_timeout_seconds(self) -> float:
        return float(self.get(keys.OBS_FABRIC_FEDERATION_TIMEOUT_SECONDS))

    @property
    def fabric_watcher_enabled(self) -> bool:
        return bool(self.get(keys.FABRIC_WATCHER_ENABLED))

    @property
    def fabric_poll_interval_seconds(self) -> float:
        return float(self.get(keys.FABRIC_POLL_INTERVAL_SECONDS))

    @property
    def fabric_quarantine_shared(self) -> bool:
        return bool(self.get(keys.FABRIC_QUARANTINE_SHARED))

    @property
    def fabric_slo_shared(self) -> bool:
        return bool(self.get(keys.FABRIC_SLO_SHARED))

    @property
    def fabric_slo_publish_interval_seconds(self) -> float:
        return float(self.get(keys.FABRIC_SLO_PUBLISH_INTERVAL_SECONDS))

    @property
    def fabric_lease_ttl_seconds(self) -> float:
        return float(self.get(keys.FABRIC_LEASE_TTL_SECONDS))

    @property
    def fabric_lease_renew_interval_seconds(self) -> float:
        return float(self.get(keys.FABRIC_LEASE_RENEW_INTERVAL_SECONDS))

    @property
    def fabric_health_enabled(self) -> bool:
        return bool(self.get(keys.FABRIC_HEALTH_ENABLED))

    @property
    def fabric_health_failure_threshold(self) -> int:
        return int(self.get(keys.FABRIC_HEALTH_FAILURE_THRESHOLD))

    @property
    def fabric_health_probe_interval_seconds(self) -> float:
        return float(self.get(keys.FABRIC_HEALTH_PROBE_INTERVAL_SECONDS))

    @property
    def fabric_health_heartbeat_interval_seconds(self) -> float:
        return float(self.get(keys.FABRIC_HEALTH_HEARTBEAT_INTERVAL_SECONDS))

    @property
    def fabric_health_missed_beats(self) -> int:
        return int(self.get(keys.FABRIC_HEALTH_MISSED_BEATS))

    @property
    def fabric_health_max_commit_lag(self) -> int:
        return int(self.get(keys.FABRIC_HEALTH_MAX_COMMIT_LAG))

    @property
    def fabric_health_hedge_ms(self) -> float:
        return float(self.get(keys.FABRIC_HEALTH_HEDGE_MS))

    @property
    def fabric_fsck_enabled(self) -> bool:
        return bool(self.get(keys.FABRIC_FSCK_ENABLED))

    @property
    def fabric_fsck_retention_seconds(self) -> float:
        return float(self.get(keys.FABRIC_FSCK_RETENTION_SECONDS))

    @property
    def fabric_fsck_dead_node_seconds(self) -> float:
        return float(self.get(keys.FABRIC_FSCK_DEAD_NODE_SECONDS))

    @property
    def fabric_fsck_interval_seconds(self) -> float:
        return float(self.get(keys.FABRIC_FSCK_INTERVAL_SECONDS))

    def deltas(self) -> Dict[str, Any]:
        """Explicitly-set keys whose value differs from the centralized
        default — the "what is non-standard about this session" record the
        flight recorder stamps on every captured query."""
        out: Dict[str, Any] = {}
        for k, v in self._conf.items():
            default = DEFAULTS.get(k)
            if _coerce(v, default) != default:
                out[k] = v
        return out
