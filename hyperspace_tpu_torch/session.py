"""Session: configuration, source providers, and the device.

Plays the role of SparkSession in the reference: carries conf, hosts the
provider manager and the (caching) index collection manager.

The session owns one torch device. It is CUDA unless the caller asks for
the CPU (``Session(device="cpu")``, as the tests do); with no CUDA device
present, a session that was not asked for the CPU raises instead of quietly
running there. Every tensor the build creates is placed on this device.
"""

from __future__ import annotations

import collections
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
        self.provider_manager = FileBasedSourceProviderManager(self)
        self._index_manager = None
        #: host wall seconds per covering-build stage, summed over every chunk
        #: this session built: key_decode, encode_keys, upload_launch,
        #: payload_decode, device_wait_fetch (waits for the device pass and
        #: copies the permutation back), take_write
        self.build_stage_seconds: collections.Counter = collections.Counter()

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
