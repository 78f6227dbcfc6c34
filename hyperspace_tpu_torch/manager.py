"""Index collection management.

``IndexCollectionManager`` routes each API call to the right Action with
per-index log/data managers (ref: HS/index/IndexCollectionManager.scala:28-196);
``CachingIndexCollectionManager`` adds a TTL cache of all log entries,
invalidated by any mutating call
(ref: HS/index/CachingIndexCollectionManager.scala:38-173).

The JAX package's manager also consults a snapshot pin on every read and
publishes a commit event on the session's lifecycle bus after every
mutation (``hyperspace_tpu/lifecycle/``); neither is in the port yet
(ROADMAP A9), so reads see the latest stable entries and a mutation only
clears the cache.
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.actions.base import HyperspaceActionException
from hyperspace_tpu_torch.actions.create import CreateAction
from hyperspace_tpu_torch.actions.maintenance import CancelAction, DeleteAction, RestoreAction, VacuumAction
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.data_manager import IndexDataManagerFactory
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.models.log_manager import IndexLogManagerFactory
from hyperspace_tpu_torch.models.path_resolver import PathResolver
from hyperspace_tpu_torch.utils.cache import TTLCache


class IndexCollectionManager:
    def __init__(
        self,
        session,
        log_manager_factory: Optional[IndexLogManagerFactory] = None,
        data_manager_factory: Optional[IndexDataManagerFactory] = None,
    ):
        self.session = session
        self.path_resolver = PathResolver(session.conf)
        self.log_factory = log_manager_factory or IndexLogManagerFactory()
        self.data_factory = data_manager_factory or IndexDataManagerFactory()

    def _managers(self, name: str):
        path = self.path_resolver.get_index_path(name)
        return self.log_factory.create(path), self.data_factory.create(path), path

    # --- mutations (ref: IndexCollectionManager.scala:36-101) --------------
    def create(self, df, index_config) -> IndexLogEntry:
        log_m, data_m, path = self._managers(index_config.index_name)
        return CreateAction(self.session, df, index_config, log_m, data_m, path).run()

    def delete(self, name: str) -> IndexLogEntry:
        log_m, data_m, _ = self._managers(name)
        return DeleteAction(self.session, name, log_m, data_m).run()

    def restore(self, name: str) -> IndexLogEntry:
        log_m, data_m, _ = self._managers(name)
        return RestoreAction(self.session, name, log_m, data_m).run()

    def vacuum(self, name: str) -> IndexLogEntry:
        log_m, data_m, _ = self._managers(name)
        return VacuumAction(self.session, name, log_m, data_m).run()

    def cancel(self, name: str) -> IndexLogEntry:
        log_m, data_m, _ = self._managers(name)
        return CancelAction(self.session, name, log_m, data_m).run()

    def refresh(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> IndexLogEntry:
        from hyperspace_tpu_torch.actions.refresh import (
            RefreshFullAction,
            RefreshIncrementalAction,
            RefreshQuickAction,
        )

        log_m, data_m, _ = self._managers(name)
        mode = mode.lower()
        if mode == C.REFRESH_MODE_FULL:
            action = RefreshFullAction(self.session, name, log_m, data_m)
        elif mode == C.REFRESH_MODE_INCREMENTAL:
            action = RefreshIncrementalAction(self.session, name, log_m, data_m)
        elif mode == C.REFRESH_MODE_QUICK:
            action = RefreshQuickAction(self.session, name, log_m, data_m)
        else:
            raise HyperspaceActionException(f"Unsupported refresh mode {mode!r}")
        return action.run()

    def optimize(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> IndexLogEntry:
        from hyperspace_tpu_torch.actions.optimize import OptimizeAction

        log_m, data_m, _ = self._managers(name)
        if mode.lower() not in C.OPTIMIZE_MODES:
            raise HyperspaceActionException(f"Unsupported optimize mode {mode!r}")
        return OptimizeAction(self.session, name, log_m, data_m, mode.lower()).run()

    # --- reads (ref: IndexCollectionManager.scala indexes) -----------------
    def get_index(self, name: str) -> Optional[IndexLogEntry]:
        log_m, _, _ = self._managers(name)
        return log_m.get_latest_stable_log()

    def get_indexes(self, accepted_states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        accepted = set(accepted_states or states.STABLE_STATES)
        out = []
        for path in self.path_resolver.all_index_paths():
            entry = self.log_factory.create(path).get_latest_stable_log()
            if entry is not None and entry.state in accepted:
                out.append(entry)
        return out

    def index_stats(self, name: str, extended: bool = False):
        from hyperspace_tpu_torch.stats import index_statistics

        entry = self.get_index(name)
        if entry is None:
            raise HyperspaceActionException(f"Index {name!r} does not exist.")
        return index_statistics(self.session, entry, extended)

    def indexes(self):
        """Summary of all indexes as a pandas DataFrame; vacuumed
        (DOESNOTEXIST) entries are filtered out
        (ref: IndexCollectionManager.scala:109-118)."""
        import pandas as pd

        from hyperspace_tpu_torch.stats import index_statistics

        rows = [
            index_statistics(self.session, e, False)
            for e in self.get_indexes(list(states.STABLE_STATES))
            if e.state != states.DOESNOTEXIST
        ]
        return pd.DataFrame(rows)


#: Lifetime of the cached log entries: the default of the JAX package's
#: ``hyperspace.index.cache.expiryDurationInSeconds`` (hyperspace_tpu/config.py).
CACHE_EXPIRY_SECONDS = 300


class CachingIndexCollectionManager(IndexCollectionManager):
    """TTL cache over get_indexes, invalidated on any mutating API
    (ref: HS/index/CachingIndexCollectionManager.scala:38-126)."""

    def __init__(self, session, **kwargs):
        super().__init__(session, **kwargs)
        self._cache: TTLCache = TTLCache(CACHE_EXPIRY_SECONDS)

    def clear_cache(self) -> None:
        self._cache.clear()

    def get_indexes(self, accepted_states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        cached = self._cache.get()
        if cached is None:
            cached = super().get_indexes(list(states.STABLE_STATES))
            self._cache.set(cached)
        accepted = set(accepted_states or states.STABLE_STATES)
        return [e for e in cached if e.state in accepted]

    def _invalidating(self, fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        finally:
            self.clear_cache()

    def create(self, df, index_config):
        return self._invalidating(super().create, df, index_config)

    def delete(self, name):
        return self._invalidating(super().delete, name)

    def restore(self, name):
        return self._invalidating(super().restore, name)

    def vacuum(self, name):
        return self._invalidating(super().vacuum, name)

    def cancel(self, name):
        return self._invalidating(super().cancel, name)

    def refresh(self, name, mode=C.REFRESH_MODE_FULL):
        return self._invalidating(super().refresh, name, mode)

    def optimize(self, name, mode=C.OPTIMIZE_MODE_QUICK):
        return self._invalidating(super().optimize, name, mode)
