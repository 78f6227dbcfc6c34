"""Operation-log manager.

Numbered immutable JSON entries ``_hyperspace_log/0..n`` plus a
``latestStable`` snapshot file; writers race via create-exclusive semantics —
the first writer of a given id wins, later writers observe failure and abort
(optimistic concurrency; ref: HS/index/IndexLogManager.scala:34-195).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.utils.file_utils import write_atomic, write_atomic_exclusive

LATEST_STABLE = "latestStable"

#: _read_classified statuses: distinguishing missing from corrupt is what
#: lets a torn trailing entry degrade to the prior version instead of
#: making the whole index silently vanish
READ_OK, READ_MISSING, READ_CORRUPT = "ok", "missing", "corrupt"


def _count_corrupt(index: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_log_corrupt_total",
        "operation-log entries that failed to parse (torn/corrupt writes)",
        index=index,
    ).inc()


class IndexLogManager:
    """Manages the operation log of one index (ref: HS/index/IndexLogManager.scala:57-195)."""

    def __init__(self, index_path: str):
        self.index_path = str(index_path)
        self.log_dir = os.path.join(self.index_path, C.HYPERSPACE_LOG_DIR)
        self.index_name = os.path.basename(os.path.normpath(self.index_path))

    def _path(self, log_id: int) -> str:
        return os.path.join(self.log_dir, str(log_id))

    def _read_classified(self, path: str):
        """``(entry, status)`` — status distinguishes a file that is absent
        (READ_MISSING) from one whose bytes don't parse (READ_CORRUPT, which
        bumps ``hs_log_corrupt_total`` and strikes the quarantine breaker)."""
        from hyperspace_tpu_torch.reliability.degrade import QUARANTINE
        from hyperspace_tpu_torch.reliability.faults import FAULTS
        from hyperspace_tpu_torch.reliability.retry import with_retry

        def _load() -> bytes:
            with open(path, "rb") as f:
                raw = f.read()
            if FAULTS.active:
                raw = FAULTS.mangle_bytes("log.read", path, raw)
            return raw

        try:
            entry = IndexLogEntry.from_json(
                with_retry(_load, op="log.read").decode("utf-8")
            )
        except FileNotFoundError:
            return None, READ_MISSING
        except OSError:
            # unreadable, not provably torn: treated as missing (the prior
            # behavior), but a transient here never marks the entry corrupt
            return None, READ_MISSING
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError, ValueError):
            _count_corrupt(self.index_name)
            if QUARANTINE.enabled:
                QUARANTINE.note_corrupt(path)
            return None, READ_CORRUPT
        if QUARANTINE.enabled:
            QUARANTINE.note_ok(path)
        return entry, READ_OK

    def _read(self, path: str) -> Optional[IndexLogEntry]:
        return self._read_classified(path)[0]

    def get_log(self, log_id: int) -> Optional[IndexLogEntry]:
        return self._read(self._path(log_id))

    def get_latest_id(self) -> Optional[int]:
        """Highest numeric log id present, or None
        (ref: HS/index/IndexLogManager.scala:88-100). Raw directory-listing
        semantics: writers derive the *next* id from this, so a torn trailing
        entry must still count — skipping it here would hand two writers the
        same id. Readers wanting the newest *readable* entry use
        :meth:`get_latest_log`, which walks past torn tails."""
        try:
            names = os.listdir(self.log_dir)
        except OSError:
            return None
        ids = [int(n) for n in names if n.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        """Newest *readable* entry: a corrupt (torn) trailing entry degrades
        to the prior parseable version instead of reporting the index absent;
        a genuinely missing id keeps the old absent semantics."""
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry, status = self._read_classified(self._path(log_id))
            if status == READ_CORRUPT:
                continue
            return entry  # READ_OK entry, or None for READ_MISSING
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

    def get_index_versions(self, accepted_states: List[str]) -> List[int]:
        """Log ids of entries in the given states, newest first
        (ref: HS/index/IndexLogManager.scala:129-142)."""
        latest = self.get_latest_id()
        if latest is None:
            return []
        out = []
        for log_id in range(latest, -1, -1):
            entry = self.get_log(log_id)
            if entry is not None and entry.state in accepted_states:
                out.append(log_id)
        return out

    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        """Write entry at ``log_id`` iff no entry with that id exists yet.
        Returns False when another writer won (ref: HS/index/IndexLogManager.scala:178-194).

        When a fabric refresh lease is in scope (``fabric/lease.py``
        ``fence_scope``), its fencing token is verified first: a holder
        whose lease expired and was taken over raises ``LeaseLostError``
        here — the commit point — so a zombie writer can never land a log
        entry over its successor's."""
        entry.id = log_id
        data = entry.to_json().encode("utf-8")
        from hyperspace_tpu_torch.reliability.faults import FAULTS

        if FAULTS.active:
            FAULTS.check("log.write", self._path(log_id))
        from hyperspace_tpu_torch.fabric.lease import current_fence

        # fencing check adjacent to the write itself: everything slow (the
        # build, injected latency above) happens before the token is judged
        fence = current_fence()
        if fence is not None:
            fence.verify()
        return write_atomic_exclusive(self._path(log_id), data)

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Snapshot entry ``log_id`` as ``latestStable``
        (ref: HS/index/IndexLogManager.scala:144-160)."""
        entry = self.get_log(log_id)
        if entry is None or entry.state not in states.STABLE_STATES:
            return False
        write_atomic(os.path.join(self.log_dir, LATEST_STABLE), entry.to_json().encode("utf-8"))
        return True

    def delete_latest_stable_log(self) -> bool:
        try:
            os.unlink(os.path.join(self.log_dir, LATEST_STABLE))
            return True
        except FileNotFoundError:
            return True
        except OSError:
            return False


class IndexLogManagerFactory:
    """Injection point so tests can substitute mock managers
    (ref: HS/index/factories.scala:23-53)."""

    def create(self, index_path: str) -> IndexLogManager:
        return IndexLogManager(index_path)
