"""Semantic result cache: version-branded query results above the plan cache.

The plan cache proved repeated-*shape* traffic dominates served workloads;
this layer closes the loop for repeated-*result* traffic. A byte-budgeted LRU
keyed by (version brand, plan fingerprint, literal bindings) serves:

- **exact hits** — the same query (same structure, same literals) against the
  same data version returns the cached batch without touching the executor;
- **subsumed-predicate hits** — a request whose predicate provably *implies*
  a cached superset predicate (``price > 7`` against a cached ``price > 5``)
  re-filters the cached batch instead of re-scanning. Subsumption is only
  attempted on simple Project/Filter chains over one scan leaf whose
  conjuncts are all column-vs-literal comparisons (``plan.expr
  comparison_atom``); anything else is exact-only — conservatism over reach.

**Staleness is impossible by construction.** The brand —
:func:`version_brand` — folds the session's compilation token (hyperspace
flag + ACTIVE index name/log-version roster + rewrite conf) with every scan
leaf's source-snapshot ``relation.signature()`` (file path/mtime/size
digest). It is computed at *submit time*, before the request is admitted, and
both ``get`` and ``put`` key on it: a result can only be served to a request
whose observed data version matches the version the result was computed
from. A refresh committing a new index-log version (or files
appearing/changing under a source) changes the brand, so stale entries
become unreachable immediately — and are purged wholesale (counted in
``hs_result_cache_invalidations_total``) the first time the new brand is
observed for that structure. An unsignable source yields brand ``None`` and
the request bypasses the cache entirely.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import as_bool_mask, comparison_atom, split_conjuncts
from hyperspace_tpu_torch.serving.fingerprint import Fingerprint, _lit_token

from hyperspace_tpu_torch.check.locks import named_lock

__all__ = ["ResultCache", "version_brand", "chain_atoms", "atoms_imply"]


def version_brand(session, plan, enabled: bool) -> Optional[str]:
    """Hash of everything that decides *which data version* ``plan`` reads:
    the session compilation token (hyperspace flag, ACTIVE index name + log
    id roster, rewrite conf) plus each raw scan leaf's source snapshot
    signature. None when any leaf cannot be signed — the caller must then
    bypass the cache (serving possibly-stale bytes is never an option)."""
    from hyperspace_tpu_torch.serving.plan_cache import session_token

    token = session_token(session, enabled)
    sigs: List[str] = []
    for leaf in L.collect(plan, lambda p: isinstance(p, L.Scan)):
        try:
            sigs.append(str(leaf.relation.signature()))
        except Exception:
            return None
    h = hashlib.sha1(repr((token, sorted(sigs))).encode()).hexdigest()
    return h


def chain_atoms(plan) -> Optional[Tuple[List, List]]:
    """``(filter conditions, normalized atoms)`` when ``plan`` is a simple
    Project*/Filter* chain over one scan leaf whose every conjunct is a
    column-vs-literal comparison; None otherwise (no subsumption — Rename,
    Compute, joins, aggregates, and opaque predicates are out of scope)."""
    conds = []
    p = plan
    while True:
        if isinstance(p, L.Project):
            p = p.child
        elif isinstance(p, L.Filter):
            conds.append(p.condition)
            p = p.child
        elif isinstance(p, (L.Scan, L.IndexScan, L.FileScan)):
            break
        else:
            return None
    atoms = []
    for c in conds:
        for conj in split_conjuncts(c):
            a = comparison_atom(conj)
            if a is None:
                return None
            atoms.append(a)
    return conds, atoms


def _implies(req, cached) -> bool:
    """Does request atom ``req`` imply cached atom ``cached`` (same column)?"""
    _, rop, rv = req
    _, cop, cv = cached
    try:
        if cop == ">":
            return (rop == ">" and rv >= cv) or (rop == ">=" and rv > cv)
        if cop == ">=":
            return rop in (">", ">=") and rv >= cv
        if cop == "<":
            return (rop == "<" and rv <= cv) or (rop == "<=" and rv < cv)
        if cop == "<=":
            return rop in ("<", "<=") and rv <= cv
        if cop == "=":
            return (rop == "=" and rv == cv) or (rop == "in" and rv <= {cv})
        if cop == "!=":
            return (rop == "!=" and rv == cv) or (rop == "=" and rv != cv)
        if cop == "in":
            return (rop == "=" and rv in cv) or (rop == "in" and rv <= cv)
    except TypeError:
        return False  # incomparable value types: no implication claimed
    return False


def atoms_imply(request_atoms: List, cached_atoms: List) -> bool:
    """True when the conjunction of ``request_atoms`` implies the conjunction
    of ``cached_atoms`` — i.e. the cached batch is a superset of the request's
    rows. Every cached atom must be implied by some request atom on the same
    column; extra request atoms only narrow further."""
    for cached in cached_atoms:
        if not any(req[0] == cached[0] and _implies(req, cached) for req in request_atoms):
            return False
    return True


def _batch_nbytes(batch: Dict[str, np.ndarray]) -> int:
    total = 0
    for a in batch.values():
        total += int(a.nbytes)
        if a.dtype == object:
            # nbytes counts pointers only; approximate the payload
            total += sum(len(str(v)) for v in a[: min(len(a), 1024)]) * max(
                1, len(a) // max(1, min(len(a), 1024))
            )
    return total


class _Entry:
    __slots__ = ("batch", "output_columns", "atoms", "nbytes", "structure", "brand")

    def __init__(self, batch, output_columns, atoms, nbytes, structure, brand):
        self.batch = batch
        self.output_columns = output_columns
        self.atoms = atoms
        self.nbytes = nbytes
        self.structure = structure
        self.brand = brand


class ResultCache:
    """Byte-budgeted LRU of served result batches with brand invalidation."""

    def __init__(
        self,
        max_bytes: int = 256 * 1024 * 1024,
        max_entry_bytes: int = 16 * 1024 * 1024,
        subsumption: bool = True,
    ):
        self.max_bytes = int(max_bytes)
        self.max_entry_bytes = int(max_entry_bytes)
        self.subsumption = bool(subsumption)
        self._lock = named_lock("serving.resultCache")
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        # (structure) -> {brand -> [exact keys]} so a new brand can purge the
        # structure's stale-version entries wholesale
        self._by_struct: Dict[str, Dict[str, List[Tuple]]] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.subsumed_hits = 0
        self.invalidations = 0
        self.evictions = 0
        self._hits_c = self._misses_c = self._sub_c = self._inv_c = None

    # -- keys ----------------------------------------------------------------
    @staticmethod
    def _key(brand: str, fp: Fingerprint) -> Tuple:
        return (brand, fp.structure, tuple(_lit_token(v) for v in fp.literals))

    # -- lookup --------------------------------------------------------------
    def get(self, fp: Fingerprint, brand: str, plan=None) -> Optional[Dict[str, np.ndarray]]:
        """The cached batch for this request (already relabeled to the
        request's output aliases), or None. ``plan`` (the raw request plan)
        enables subsumed-predicate matching."""
        key = self._key(brand, fp)
        with self._lock:
            self._note_brand_locked(fp.structure, brand)
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                if self._hits_c is not None:
                    self._hits_c.inc()
                return self._relabel(entry.batch, entry.output_columns, fp)
            candidates = []
            if self.subsumption and plan is not None:
                for k in self._by_struct.get(fp.structure, {}).get(brand, []):
                    e = self._entries.get(k)
                    if e is not None and e.atoms is not None:
                        candidates.append((k, e))
        if candidates:
            req = chain_atoms(plan)
            if req is not None:
                conds, request_atoms = req
                for k, e in candidates:
                    got = self._try_subsume(e, conds, request_atoms, fp)
                    if got is not None:
                        with self._lock:
                            if k in self._entries:
                                self._entries.move_to_end(k)
                            self.hits += 1
                            self.subsumed_hits += 1
                            if self._sub_c is not None:
                                self._sub_c.inc()
                            if self._hits_c is not None:
                                self._hits_c.inc()
                        return got
        with self._lock:
            self.misses += 1
            if self._misses_c is not None:
                self._misses_c.inc()
        return None

    def _try_subsume(self, entry: _Entry, conds, request_atoms, fp: Fingerprint):
        """Re-filter ``entry``'s superset batch with the request's full
        predicate; None unless implication holds and every referenced column
        is present in the cached batch."""
        if not atoms_imply(request_atoms, entry.atoms):
            return None
        if len(entry.output_columns) != len(fp.output_columns):
            return None
        for c in conds:
            if not c.references() <= set(entry.batch):
                return None
        from hyperspace_tpu_torch.exec.batch import mask_rows

        batch = entry.batch
        for c in conds:
            mask = as_bool_mask(c.eval(batch))
            batch = mask_rows(batch, mask)
        return self._relabel(batch, entry.output_columns, fp)

    @staticmethod
    def _relabel(batch, stored_columns, fp: Fingerprint):
        """Positional relabel from the stored aliases to the request's (the
        structure hash is alias-invariant, so positions correspond — the same
        discipline ``QueryServer._finish`` applies to plan-cache templates)."""
        if tuple(stored_columns) == tuple(fp.output_columns):
            return dict(batch)
        return {
            want: batch[have] for want, have in zip(fp.output_columns, stored_columns)
        }

    # -- store ---------------------------------------------------------------
    def put(self, fp: Fingerprint, brand: str, batch: Dict[str, np.ndarray], plan=None) -> bool:
        """Store a served result under its submit-time brand. Arrays are
        frozen (read-only) — a mutation of a served result must raise, not
        corrupt the cache. Returns False when the entry is over budget."""
        nbytes = _batch_nbytes(batch)
        if nbytes > self.max_entry_bytes or nbytes > self.max_bytes:
            return False
        frozen = {}
        for name, a in batch.items():
            a = np.asarray(a)
            a.flags.writeable = False
            frozen[name] = a
        atoms = None
        if self.subsumption and plan is not None:
            got = chain_atoms(plan)
            if got is not None:
                atoms = got[1]
        key = self._key(brand, fp)
        entry = _Entry(frozen, tuple(fp.output_columns), atoms, nbytes, fp.structure, brand)
        with self._lock:
            self._note_brand_locked(fp.structure, brand)
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = entry
            self.bytes += nbytes
            self._by_struct.setdefault(fp.structure, {}).setdefault(brand, [])
            if key not in self._by_struct[fp.structure][brand]:
                self._by_struct[fp.structure][brand].append(key)
            while self.bytes > self.max_bytes and self._entries:
                k, e = self._entries.popitem(last=False)
                self.bytes -= e.nbytes
                self.evictions += 1
                self._unindex_locked(k, e)
        return True

    # -- invalidation --------------------------------------------------------
    def _note_brand_locked(self, structure: str, brand: str) -> None:
        """First observation of a new brand for a structure purges every
        entry the structure holds under other (stale) brands."""
        brands = self._by_struct.get(structure)
        if not brands:
            return
        stale = [b for b in brands if b != brand]
        for b in stale:
            for k in brands.pop(b):
                e = self._entries.pop(k, None)
                if e is not None:
                    self.bytes -= e.nbytes
                    self.invalidations += 1
                    if self._inv_c is not None:
                        self._inv_c.inc()

    def _unindex_locked(self, key: Tuple, entry: _Entry) -> None:
        brands = self._by_struct.get(entry.structure)
        if brands is not None:
            keys = brands.get(entry.brand)
            if keys is not None and key in keys:
                keys.remove(key)

    def invalidate_all(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_struct.clear()
            self.bytes = 0
            self.invalidations += n
            if self._inv_c is not None:
                self._inv_c.inc(n)
            return n

    # -- observability -------------------------------------------------------
    def bind_registry(self, registry, **labels) -> None:
        self._hits_c = registry.counter(
            "hs_result_cache_hits_total", "result-cache hits (exact + subsumed)", **labels
        )
        self._misses_c = registry.counter(
            "hs_result_cache_misses_total", "result-cache misses", **labels
        )
        self._sub_c = registry.counter(
            "hs_result_cache_subsumed_hits_total",
            "result-cache hits served by re-filtering a cached superset predicate",
            **labels,
        )
        self._inv_c = registry.counter(
            "hs_result_cache_invalidations_total",
            "entries purged because a new data-version brand was observed",
            **labels,
        )
        registry.gauge(
            "hs_result_cache_bytes", "bytes resident in the result cache",
            fn=lambda: self.bytes, **labels,
        )
        registry.gauge(
            "hs_result_cache_entries", "entries resident in the result cache",
            fn=self.__len__, **labels,
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "hits": self.hits,
                "misses": self.misses,
                "subsumedHits": self.subsumed_hits,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "hitRate": (self.hits / total) if total else 0.0,
            }
