"""The user-facing ``Hyperspace`` facade
(ref: HS/Hyperspace.scala:27-231).

Maintenance operations run with the optimizer rule disabled so that index
builds never recursively consult indexes
(ref: Hyperspace.scala:193-200 withHyperspaceRuleDisabled).
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.manager import CachingIndexCollectionManager
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.session import Session, get_session


class Hyperspace:
    def __init__(self, session: Optional[Session] = None):
        self.session = session or get_session()

    @property
    def _manager(self) -> CachingIndexCollectionManager:
        return self.session.index_manager

    # --- index management (ref: Hyperspace.scala:43-150) -------------------
    def create_index(self, df, index_config) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.create(df, index_config)

    def delete_index(self, name: str) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.delete(name)

    def restore_index(self, name: str) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.restore(name)

    def vacuum_index(self, name: str) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.vacuum(name)

    def cancel(self, name: str) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.cancel(name)

    def refresh_index(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.refresh(name, mode)

    def optimize_index(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> IndexLogEntry:
        with self.session.with_hyperspace_disabled():
            return self._manager.optimize(name, mode)

    # --- introspection (ref: Hyperspace.scala indexes/index/explain/whyNot) -
    def indexes(self):
        return self._manager.indexes()

    def index(self, name: str):
        return self._manager.index_stats(name, extended=True)

    def explain(self, df, verbose: bool = False, mode: str = "plaintext") -> str:
        """``mode`` is one of plaintext / console / html
        (ref: plananalysis/DisplayMode.scala:61-89)."""
        from hyperspace_tpu_torch.analysis.explain import explain_string

        return explain_string(df, self.session, verbose, mode=mode)

    def why_not(self, df, index_name: Optional[str] = None, extended: bool = False) -> str:
        from hyperspace_tpu_torch.analysis.why_not import why_not_string

        return why_not_string(df, self.session, index_name, extended)

    # --- reference-API aliases ---------------------------------------------
    # The reference's JVM/PySpark binding exposes camelCase method names
    # (ref: HS/Hyperspace.scala:27-231, python/hyperspace/hyperspace.py:9-192);
    # users migrating from it can keep their call sites. Thin delegating defs
    # so subclass overrides of the snake_case methods stay authoritative.
    def createIndex(self, df, index_config) -> IndexLogEntry:
        return self.create_index(df, index_config)

    def deleteIndex(self, name: str) -> IndexLogEntry:
        return self.delete_index(name)

    def restoreIndex(self, name: str) -> IndexLogEntry:
        return self.restore_index(name)

    def vacuumIndex(self, name: str) -> IndexLogEntry:
        return self.vacuum_index(name)

    def refreshIndex(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> IndexLogEntry:
        return self.refresh_index(name, mode)

    def optimizeIndex(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> IndexLogEntry:
        return self.optimize_index(name, mode)

    def whyNot(self, df, index_name: Optional[str] = None, extended: bool = False) -> str:
        return self.why_not(df, index_name, extended)
