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
        self.device = resolve_device(device)
        self.conf = HyperspaceConf(conf)
        # the decode pool is process-global: it takes the width of the
        # session constructed last before the first multi-file scan
        from hyperspace_tpu_torch.exec import io as _io

        _io.set_decode_threads(self.conf.io_decode_threads)
        self.provider_manager = FileBasedSourceProviderManager(self)
        # context-local override beats the session-wide default, so a scoped
        # toggle never leaks into queries racing on other threads
        self._hyperspace_override: contextvars.ContextVar = contextvars.ContextVar(
            "hyperspace_enabled_override", default=None
        )
        self.hyperspace_enabled = False
        self._index_manager = None
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

    # --- index manager ------------------------------------------------------
    @property
    def index_manager(self):
        if self._index_manager is None:
            from hyperspace_tpu_torch.manager import CachingIndexCollectionManager

            self._index_manager = CachingIndexCollectionManager(self)
        return self._index_manager


_current: Optional[Session] = None


def get_session() -> Session:
    global _current
    if _current is None:
        _current = Session()
    return _current


def set_session(session: Optional[Session]) -> None:
    global _current
    _current = session
