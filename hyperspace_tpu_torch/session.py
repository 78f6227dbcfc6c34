"""Session: configuration, source providers, the optimizer kill-switch and
the device.

Plays the role of SparkSession in the reference: carries conf, hosts the
provider manager and the (caching) index collection manager, and owns the
"Hyperspace enabled" flag that installs the optimizer rule
(ref: ``spark.enableHyperspace()``, HS/package.scala:29-69).

The session owns one torch device. It is CUDA unless the caller asks for
the CPU (``Session(device="cpu")``, as the tests do); with no CUDA device
present, a session that was not asked for the CPU raises instead of quietly
running there. Every tensor the build and the query create is placed on
this device.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Any, Dict, Optional

import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.sources.manager import FileBasedSourceProviderManager


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device: CUDA when None. Raises when a CUDA
    device is asked for (or implied) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless the "
            "caller asks for the CPU with Session(device='cpu')"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


class Session:
    def __init__(self, conf: Optional[Dict[str, Any]] = None, device=None):
        # a multi-process world comes up before any device is touched, and
        # only when the environment configures one (HS_NUM_PROCESSES and
        # HS_PROCESS_ID), so Session() has no such side effect otherwise
        from hyperspace_tpu_torch.parallel.distributed import configured_from_env, initialize_from_env

        if configured_from_env():
            initialize_from_env()
        self.device = resolve_device(device)
        self.conf = HyperspaceConf(conf)
        # the decode pool and the native decode keys are process-global:
        # the session constructed last wins
        from hyperspace_tpu_torch.exec import io as _io

        _io.set_decode_threads(self.conf.io_decode_threads)
        _io.set_native_options(
            enabled=self.conf.io_native_enabled,
            rowgroup=self.conf.io_native_rowgroup,
            max_dict_entries=self.conf.io_native_max_dict_entries,
        )
        # a CUDA session's native decode writes pinned host buffers, which
        # the device staging copies without pinning them again
        _io.set_pinned_decode(self.device.type == "cuda")
        # the reliability registries (fault injection, the retry policy, the
        # quarantine breakers) are process-global like the decode pool, and
        # all off by default
        from hyperspace_tpu_torch import reliability as _reliability

        _reliability.configure(self)
        # program-contract verification for sites with no session in scope
        # (the exchange build): the session constructed last wins
        from hyperspace_tpu_torch.check import program_lint as _program_lint

        _program_lint.set_default_enabled(self.conf.check_hlo_enabled)
        # lock watching is enable-only: locks wrap at construction, so a
        # later session with the flag off cannot unwrap them
        if self.conf.check_locks_enabled:
            from hyperspace_tpu_torch.check import locks as _locks

            _locks.watcher.enable()
        self.provider_manager = FileBasedSourceProviderManager(self)
        # context-local override beats the session-wide default, so a scoped
        # toggle never leaks into queries racing on other threads
        self._hyperspace_override: contextvars.ContextVar = contextvars.ContextVar(
            "hyperspace_enabled_override", default=None
        )
        self.hyperspace_enabled = False
        self._index_manager = None
        self._lifecycle_bus = None
        self._mesh = None
        #: host wall seconds per covering-build stage, summed over every chunk
        #: this session built: key_decode, encode_keys, upload_launch,
        #: payload_decode, device_wait_fetch (waits for the device pass and
        #: copies the permutation back), take_write
        self.build_stage_seconds: collections.Counter = collections.Counter()
        #: host wall seconds per query layer, summed over every collect() of
        #: this session: rewrite, decode, scan_identity, upload (encode and
        #: copy of columns the device cache misses), predicate_launch
        #: (compile, literal upload, enqueue), wait_copy_mask (waits for the
        #: device program and copies the mask back), host_predicate,
        #: mask_rows; and for joins (exec/join.py): join_plan (compatibility,
        #: footer row counts and the input-size stat), join_decode (both
        #: sides' per-bucket decode, sort and side filters), join_keys (key
        #: encoding, the key cache's stat of both sides' files, the key
        #: rectangles), join_upload (host-to-device copies of key and payload
        #: rectangles), join_span (the span program's launch),
        #: join_materialize (pair totals, which wait for the span program;
        #: expand-gather; the copies back), join_host_expand (host spans,
        #: pair expansion and gathers), join_merge (the generic merge)
        self.query_stage_seconds: collections.Counter = collections.Counter()
        #: views registered for ``sql()`` (name -> DataFrame)
        self._temp_views: Dict[str, Any] = {}
        # most recent QueryProfile from a traced collect() (obs tracing on)
        self._last_profile = None
        # lazily built fingerprint-keyed ProfileHistory for ad-hoc queries
        # (each QueryServer owns its own, labeled per server)
        self._profile_history = None
        # the torch.profiler run between start_profile and stop_profile
        self._profiler = None
        # scale-out fabric runtime (commit watcher and coherence sidecar):
        # None by default; wired last so its bus subscription and watcher
        # see a fully constructed session
        from hyperspace_tpu_torch import fabric as _fabric

        self._fabric = _fabric.configure(self)

    # --- reading data ------------------------------------------------------
    def read(self, paths, file_format: str, **options) -> "DataFrame":  # noqa: F821
        from hyperspace_tpu_torch.plan.dataframe import DataFrame
        from hyperspace_tpu_torch.plan.logical import Scan

        if isinstance(paths, str):
            paths = [paths]
        relation = self.provider_manager.create_relation((list(paths), file_format, options))
        return DataFrame(Scan(relation), self)

    def read_parquet(self, *paths, **options) -> "DataFrame":  # noqa: F821
        return self.read(list(paths), "parquet", **options)

    def read_csv(self, *paths, **options) -> "DataFrame":  # noqa: F821
        return self.read(list(paths), "csv", **options)

    def read_json(self, *paths, **options) -> "DataFrame":  # noqa: F821
        return self.read(list(paths), "json", **options)

    def read_orc(self, *paths, **options) -> "DataFrame":  # noqa: F821
        return self.read(list(paths), "orc", **options)

    def read_avro(self, *paths, **options) -> "DataFrame":  # noqa: F821
        return self.read(list(paths), "avro", **options)

    def read_text(self, *paths, **options) -> "DataFrame":  # noqa: F821
        return self.read(list(paths), "text", **options)

    def read_delta(self, path, version: Optional[int] = None) -> "DataFrame":  # noqa: F821
        from hyperspace_tpu_torch.plan.dataframe import DataFrame
        from hyperspace_tpu_torch.plan.logical import Scan
        from hyperspace_tpu_torch.sources.delta import DeltaLakeRelation

        return DataFrame(Scan(DeltaLakeRelation(path, version=version)), self)

    def read_iceberg(self, path, snapshot_id: Optional[int] = None) -> "DataFrame":  # noqa: F821
        from hyperspace_tpu_torch.plan.dataframe import DataFrame
        from hyperspace_tpu_torch.plan.logical import Scan
        from hyperspace_tpu_torch.sources.iceberg import IcebergRelation

        return DataFrame(Scan(IcebergRelation(path, snapshot_id=snapshot_id)), self)

    # --- SQL (the reference's users drive Hyperspace through Spark SQL) ----
    def sql(self, query: str) -> "DataFrame":  # noqa: F821
        from hyperspace_tpu_torch.plan.sql import run_sql

        return run_sql(query, self)

    def register_view(self, name: str, df: "DataFrame") -> None:  # noqa: F821
        self._temp_views[name] = df

    def drop_view(self, name: str) -> None:
        self._temp_views.pop(name, None)

    # --- hyperspace toggle (ref: HS/package.scala:36-43) -------------------
    @property
    def hyperspace_enabled(self) -> bool:
        override = self._hyperspace_override.get()
        return self._hyperspace_default if override is None else override

    @hyperspace_enabled.setter
    def hyperspace_enabled(self, value: bool) -> None:
        self._hyperspace_default = bool(value)

    def enable_hyperspace(self) -> "Session":
        self.hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "Session":
        self.hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self.hyperspace_enabled

    # reference-API aliases (ref: HS/package.scala:36-43 spark.enableHyperspace());
    # delegating defs so subclass overrides stay authoritative
    def enableHyperspace(self) -> "Session":
        return self.enable_hyperspace()

    def disableHyperspace(self) -> "Session":
        return self.disable_hyperspace()

    def isHyperspaceEnabled(self) -> bool:
        return self.is_hyperspace_enabled()

    @contextlib.contextmanager
    def hyperspace_scope(self, enabled: bool):
        """Pin the hyperspace flag for this thread/context only; other
        threads keep the session default."""
        token = self._hyperspace_override.set(bool(enabled))
        try:
            yield self
        finally:
            self._hyperspace_override.reset(token)

    def with_hyperspace_disabled(self):
        """The scope every lifecycle action runs in, so that a build never
        reads another index in place of its source
        (ref: Hyperspace.scala:193-200 withHyperspaceRuleDisabled)."""
        return self.hyperspace_scope(False)

    # --- index manager ------------------------------------------------------
    @property
    def index_manager(self):
        if self._index_manager is None:
            from hyperspace_tpu_torch.manager import CachingIndexCollectionManager

            self._index_manager = CachingIndexCollectionManager(self)
        return self._index_manager

    # --- lifecycle commit bus ----------------------------------------------
    @property
    def lifecycle_bus(self):
        """The session's commit/invalidation bus (lazy, one per session):
        every index mutation and every quarantine trip publishes here, and
        it purges the roster, IO and device caches of the files involved
        (lifecycle/invalidation.py)."""
        if self._lifecycle_bus is None:
            from hyperspace_tpu_torch.lifecycle.invalidation import InvalidationBus

            self._lifecycle_bus = InvalidationBus(self)
        return self._lifecycle_bus

    # --- scale-out fabric ---------------------------------------------------
    @property
    def fabric(self):
        """This session's :class:`~hyperspace_tpu_torch.fabric.FabricRuntime`
        (commit watcher and coherence sidecar), or None while
        ``hyperspace.fabric.enabled`` is off."""
        return self._fabric

    # --- query profiles (obs) ----------------------------------------------
    def last_query_profile(self):
        """The ``QueryProfile`` of the most recent traced ``collect()`` on
        this session, or None. Requires ``hyperspace.obs.tracing.enabled``."""
        return self._last_profile

    @property
    def profile_history(self):
        """The session's fingerprint-keyed :class:`ProfileHistory` (traced
        ad-hoc ``collect()`` calls fold into it), or None when
        ``hyperspace.obs.history.enabled`` is false."""
        if self._profile_history is None and self.conf.obs_history_enabled:
            from hyperspace_tpu_torch.obs.history import ProfileHistory

            self._profile_history = ProfileHistory(
                max_fingerprints=self.conf.obs_history_max_fingerprints
            )
        return self._profile_history

    def estimate_cost(self, query):
        """Learned latency estimate for a SQL string or DataFrame from this
        session's profile history (``ProfileHistory.estimate_cost``); None
        when the history is disabled or the fingerprint is unseen."""
        history = self.profile_history
        if history is None:
            return None
        from hyperspace_tpu_torch.serving.fingerprint import plan_fingerprint

        df = self.sql(query) if isinstance(query, str) else query
        fp = plan_fingerprint(getattr(df, "plan", df))
        return history.estimate_cost(fp.structure)

    def data_version_brand(self, query):
        """The data-version brand a served result of ``query`` (SQL string or
        DataFrame) would be cached under: a digest of the session's active
        index roster, the rewrite conf and every scan leaf's source snapshot
        signature. None when any source cannot be signed. Two calls that
        return the same brand observe the same data version."""
        from hyperspace_tpu_torch.serving.result_cache import version_brand

        df = self.sql(query) if isinstance(query, str) else query
        return version_brand(self, getattr(df, "plan", df), bool(self.hyperspace_enabled))

    # --- profiling ----------------------------------------------------------
    # The JAX package traces through the XLA profiler; the port traces host
    # and (on a CUDA session) device activity through torch.profiler and
    # writes a Chrome trace into ``log_dir``, viewable in Perfetto.
    def start_profile(self, log_dir: str) -> None:
        import os

        from torch.profiler import ProfilerActivity, profile

        if self._profiler is not None:
            raise RuntimeError("a profile is already running on this session")
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
        self._profiler = (prof, log_dir)

    def stop_profile(self) -> None:
        import os
        import time

        if self._profiler is None:
            raise RuntimeError("no profile is running on this session")
        prof, log_dir = self._profiler
        self._profiler = None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))

    @contextlib.contextmanager
    def profile(self, log_dir: str):
        self.start_profile(log_dir)
        try:
            yield
        finally:
            self.stop_profile()

    # --- device mesh ----------------------------------------------------------
    @property
    def mesh(self):
        """The 1-D device mesh over every local device of the session's kind
        (every card; ``parallel.mesh.SHARD_COUNT`` shards of the CPU),
        created at first use; the axis name comes from
        ``hyperspace.tpu.mesh.axis``."""
        if self._mesh is None:
            from hyperspace_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh(axis=self.conf.mesh_axis, device_type=self.device.type)
            self._note_mesh(self._mesh)
        return self._mesh

    def set_mesh(self, mesh) -> "Session":
        self._mesh = mesh
        self._note_mesh(mesh)
        return self

    @staticmethod
    def _note_mesh(mesh) -> None:
        # decode buffers pad to the mesh's shard count (exec/io.py)
        from hyperspace_tpu_torch.exec import io as _io

        _io.set_staging_pad(mesh.size)


_current: Optional[Session] = None


def get_session() -> Session:
    global _current
    if _current is None:
        _current = Session()
    return _current


def set_session(session: Optional[Session]) -> None:
    global _current
    _current = session
