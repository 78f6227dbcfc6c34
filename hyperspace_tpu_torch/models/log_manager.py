"""Operation-log manager.

Numbered immutable JSON entries ``_hyperspace_log/0..n`` plus a
``latestStable`` snapshot file; writers race via create-exclusive semantics —
the first writer of a given id wins, later writers observe failure and abort
(optimistic concurrency; ref: HS/index/IndexLogManager.scala:34-195).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.utils.file_utils import write_atomic, write_atomic_exclusive

LATEST_STABLE = "latestStable"


class IndexLogManager:
    """Manages the operation log of one index (ref: HS/index/IndexLogManager.scala:57-195)."""

    def __init__(self, index_path: str):
        self.index_path = str(index_path)
        self.log_dir = os.path.join(self.index_path, C.HYPERSPACE_LOG_DIR)
        self.index_name = os.path.basename(os.path.normpath(self.index_path))

    def _path(self, log_id: int) -> str:
        return os.path.join(self.log_dir, str(log_id))

    def _read_classified(self, path: str):
        """``(entry, corrupt)``: an absent or unreadable file is ``(None,
        False)``; bytes that do not parse are ``(None, True)``, so a torn
        trailing entry degrades to the prior version instead of making the
        index vanish."""
        try:
            with open(path, "rb") as f:
                return IndexLogEntry.from_json(f.read().decode("utf-8")), False
        except OSError:
            return None, False
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError, ValueError):
            return None, True

    def _read(self, path: str) -> Optional[IndexLogEntry]:
        return self._read_classified(path)[0]

    def get_log(self, log_id: int) -> Optional[IndexLogEntry]:
        return self._read(self._path(log_id))

    def get_latest_id(self) -> Optional[int]:
        """Highest numeric log id present, or None
        (ref: HS/index/IndexLogManager.scala:88-100). Raw directory-listing
        semantics: writers derive the *next* id from this, so a torn trailing
        entry must still count."""
        try:
            names = os.listdir(self.log_dir)
        except OSError:
            return None
        ids = [int(n) for n in names if n.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        """Newest *readable* entry: a corrupt trailing entry degrades to the
        prior parseable version; a missing id reports the index absent."""
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry, corrupt = self._read_classified(self._path(log_id))
            if not corrupt:
                return entry
        return None

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        """Prefer the ``latestStable`` snapshot; if missing or unstable, scan
        backwards from the latest id for a stable-state entry
        (ref: HS/index/IndexLogManager.scala:102-127)."""
        snapshot = self._read(os.path.join(self.log_dir, LATEST_STABLE))
        if snapshot is not None and snapshot.state in states.STABLE_STATES:
            return snapshot
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry = self.get_log(log_id)
            if entry is not None and entry.state in states.STABLE_STATES:
                return entry
        return None

    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        """Write entry at ``log_id`` iff no entry with that id exists yet.
        Returns False when another writer won (ref: HS/index/IndexLogManager.scala:178-194)."""
        entry.id = log_id
        return write_atomic_exclusive(self._path(log_id), entry.to_json().encode("utf-8"))

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Snapshot entry ``log_id`` as ``latestStable``
        (ref: HS/index/IndexLogManager.scala:144-160)."""
        entry = self.get_log(log_id)
        if entry is None or entry.state not in states.STABLE_STATES:
            return False
        write_atomic(os.path.join(self.log_dir, LATEST_STABLE), entry.to_json().encode("utf-8"))
        return True


class IndexLogManagerFactory:
    """Injection point so tests can substitute mock managers
    (ref: HS/index/factories.scala:23-53)."""

    def create(self, index_path: str) -> IndexLogManager:
        return IndexLogManager(index_path)
