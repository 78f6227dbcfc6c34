"""Compiled-plan cache: canonical fingerprint -> optimized, pruned plan.

Two lookup tiers share one LRU:

- **exact** — (session token, structure hash, literal vector): the same query
  repeated verbatim returns the stored plan with zero rewriting;
- **parameterized** — (session token, structure hash): a query differing only
  in predicate literals binds its literals into the stored template
  (prepared-statement execution). A template is parameterized only when the
  optimizer's rewrite provably does not depend on the literal values — a
  data-skipping prune (``FileScan.via_index``) or a bucket prune
  (``IndexScan.pruned_buckets``) chose *files* from the literal, so those
  templates fall back to exact-only reuse. Subquery-bearing plans are also
  exact-only: the inner plan's result depends on its literals.

The session token folds in everything that can change what "compiled" means:
the hyperspace flag, the ACTIVE index set (name + log version), and the conf
knobs the rewrite rules read. Index lifecycle actions therefore invalidate
naturally — a refreshed index has a new log version, so old entries simply
stop being reachable and age out of the LRU.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

from hyperspace_tpu_torch.check.locks import named_lock
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.serving.fingerprint import (
    Fingerprint,
    Unparameterizable,
    bind_literals,
    plan_fingerprint,
    slot_mapping,
)


def session_token(session, enabled: bool) -> Tuple:
    """Hashable summary of the compilation environment."""
    if not enabled:
        return ("off",)
    from hyperspace_tpu_torch.models import states

    try:
        idx = tuple(
            sorted((e.name, e.id) for e in session.index_manager.get_indexes([states.ACTIVE]))
        )
    except Exception:
        idx = ("indexes-unavailable",)
    conf = session.conf
    return (
        "on",
        idx,
        conf.hybrid_scan_enabled,
        conf.use_bucket_spec,
        conf.nested_column_enabled,
    )


def _literal_dependent_rewrite(plan: L.LogicalPlan) -> bool:
    """True when the optimized plan's *shape* encodes literal values — then a
    different literal could have produced a different file set, so the
    template must not be re-bound."""
    if L.collect(plan, lambda p: isinstance(p, L.FileScan) and p.via_index is not None):
        return True
    if L.collect(plan, lambda p: isinstance(p, L.IndexScan) and p.pruned_buckets is not None):
        return True
    return False


class CompiledPlan:
    """One cache entry: the optimized+pruned template and how to reuse it."""

    __slots__ = ("template", "fp", "parameterizable", "output_columns")

    def __init__(self, template: L.LogicalPlan, fp: Fingerprint, parameterizable: bool):
        self.template = template
        self.fp = fp
        self.parameterizable = parameterizable
        self.output_columns = tuple(template.output_columns)

    def bind(self, request_fp: Fingerprint) -> L.LogicalPlan:
        """Template plan with this request's literals bound in (raises
        ``Unparameterizable`` when the slots cannot be aligned)."""
        mapping = slot_mapping(self.fp, request_fp)
        values = [request_fp.literals[j] for j in mapping]
        if not values:
            return self.template
        return bind_literals(self.template, values)


class PlanCache:
    """Bounded LRU over compiled plans with hit/miss/eviction accounting.

    ``lookup`` and ``insert`` are separate so compilation (optimizer rewrite,
    potentially slow) runs outside the lock; a racing duplicate compile is
    benign — last insert wins.
    """

    def __init__(self, max_entries: int = 256):
        self.max_entries = int(max_entries)
        self._lock = named_lock("serving.planCache")
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # hits split by tier, for telemetry / tests
        self.exact_hits = 0
        self.param_hits = 0

    # -- lookup --------------------------------------------------------------
    def lookup(self, token: Tuple, fp: Fingerprint) -> Optional[Tuple[L.LogicalPlan, CompiledPlan]]:
        """(bound plan, entry) on a hit, None on a miss."""
        exact_key = ("exact", token, fp.exact)
        param_key = ("param", token, fp.structure)
        with self._lock:
            got = self._entries.get(exact_key)
            if got is not None:
                self._entries.move_to_end(exact_key)
                self.hits += 1
                self.exact_hits += 1
                return got.template, got
            entry = self._entries.get(param_key)
        if entry is not None:
            try:
                bound = entry.bind(fp)
            except Unparameterizable:
                bound = None
            if bound is not None:
                with self._lock:
                    if param_key in self._entries:
                        self._entries.move_to_end(param_key)
                    self.hits += 1
                    self.param_hits += 1
                return bound, entry
        with self._lock:
            self.misses += 1
        return None

    # -- insert --------------------------------------------------------------
    def insert(self, token: Tuple, fp: Fingerprint, template: L.LogicalPlan) -> CompiledPlan:
        """Store a freshly compiled ``template`` for ``fp`` and return the
        entry. Decides the reuse tier here: parameterized when safe, exact
        otherwise."""
        parameterizable = not fp.has_subquery and not _literal_dependent_rewrite(template)
        entry = CompiledPlan(template, fp, parameterizable)
        if parameterizable:
            # re-fingerprint the template so its slot order/signatures match
            # what bind() walks (the optimizer may have reshaped the tree);
            # if its slots no longer align with the request's, fall back
            tfp = plan_fingerprint(template)
            entry.fp = tfp
            try:
                slot_mapping(tfp, fp)
            except Unparameterizable:
                entry.parameterizable = False
        key = (
            ("param", token, fp.structure)
            if entry.parameterizable
            else ("exact", token, fp.exact)
        )
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
        return entry

    # -- stats ---------------------------------------------------------------
    def bind_registry(self, registry, **labels) -> None:
        """Publish cache accounting as callback gauges (see
        ``AdmissionController.bind_registry`` for the equality rationale)."""
        registry.gauge("hs_plan_cache_entries", "compiled plans resident", fn=self.__len__, **labels)
        registry.gauge("hs_plan_cache_hits", "plan-cache hits", fn=lambda: self.hits, **labels)
        registry.gauge("hs_plan_cache_misses", "plan-cache misses", fn=lambda: self.misses, **labels)
        registry.gauge("hs_plan_cache_evictions", "plan-cache evictions", fn=lambda: self.evictions, **labels)
        registry.gauge(
            "hs_plan_cache_hit_rate", "hits / lookups",
            fn=lambda: self.stats()["hitRate"], **labels,
        )

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "exactHits": self.exact_hits,
                "paramHits": self.param_hits,
                "evictions": self.evictions,
                "hitRate": (self.hits / total) if total else 0.0,
            }
