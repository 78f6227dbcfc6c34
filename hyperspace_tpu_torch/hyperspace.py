"""The user-facing ``Hyperspace`` facade (ref: HS/Hyperspace.scala:27-231).

Every lifecycle operation reaches the index collection manager. The JAX
package runs them with the optimizer rule disabled; the port's actions read
their source plans directly and never consult the optimizer.
"""

from __future__ import annotations

from typing import Optional

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
        return self._manager.create(df, index_config)

    def delete_index(self, name: str) -> IndexLogEntry:
        return self._manager.delete(name)

    def restore_index(self, name: str) -> IndexLogEntry:
        return self._manager.restore(name)

    def vacuum_index(self, name: str) -> IndexLogEntry:
        return self._manager.vacuum(name)

    def cancel(self, name: str) -> IndexLogEntry:
        return self._manager.cancel(name)

    def refresh_index(self, name: str, mode: str = "full") -> IndexLogEntry:
        return self._manager.refresh(name, mode)

    def optimize_index(self, name: str, mode: str = "quick") -> IndexLogEntry:
        return self._manager.optimize(name, mode)

    # --- introspection (ref: Hyperspace.scala indexes/index) ---------------
    def indexes(self):
        return self._manager.indexes()

    def index(self, name: str):
        return self._manager.index_stats(name, extended=True)
