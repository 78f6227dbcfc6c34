"""Candidate index collection.

Per source leaf (Scan), chain ``ColumnSchemaFilter`` then
``FileSignatureFilter`` (ref: HS/index/rules/CandidateIndexCollector.scala:28-60,
ColumnSchemaFilter.scala:28-45, FileSignatureFilter.scala:33-192).

``FileSignatureFilter`` is where hybrid scan eligibility is decided: when
the exact signature match fails, compare file sets; the appended and
deleted byte ratios must stay under their thresholds, and deletes need an
index that can drop the deleted files' rows (a covering index with
lineage). What it learns about each (index, scan) pair goes into the
``RuleContext``. The reliability layer's quarantine filter is not in the
port yet.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.rules.context import HybridFacts, RuleContext
from hyperspace_tpu_torch.sources.signatures import INDEX_SIGNATURE_PROVIDER, index_signature


def _referenced_columns(entry: IndexLogEntry) -> List[str]:
    """Kind-polymorphic referenced columns via the index registry (covering:
    indexed+included; data-skipping: sketched columns)."""
    from hyperspace_tpu_torch.indexes import registry

    try:
        return [str(c) for c in registry.index_of_entry(entry).referenced_columns]
    except Exception:
        props = entry.derived_dataset.properties
        return [str(c) for c in props.get("indexedColumns", [])] + [
            str(c) for c in props.get("includedColumns", [])
        ]


def _schema_filter(scan: L.Scan, indexes: List[IndexLogEntry]) -> List[IndexLogEntry]:
    """Index's referenced columns ⊆ relation output (ref: ColumnSchemaFilter.scala:29-44)."""
    from hyperspace_tpu_torch.plan.expr import strip_nested_prefix

    relation_cols = {c.lower() for c in scan.output_columns}
    return [
        entry
        for entry in indexes
        if all(strip_nested_prefix(c).lower() in relation_cols for c in _referenced_columns(entry))
    ]


def _signature_filter(ctx: RuleContext, scan: L.Scan, indexes: List[IndexLogEntry]) -> List[IndexLogEntry]:
    """Signature equality, or the hybrid-scan file-set comparison
    (ref: FileSignatureFilter.scala:49-191). A signature recorded under
    another provider is not comparable and never matches: the index needs a
    refresh."""
    conf = ctx.session.conf
    current_sig = index_signature(scan)
    current_files = {fi.key: fi for fi in scan.relation.all_file_infos()}
    total_bytes = sum(fi.size for fi in current_files.values())

    out = []
    for e in indexes:
        entry = scan.relation.closest_index(e)
        sig0 = entry.signature.signatures[0] if entry.signature.signatures else None
        if sig0 is not None and sig0.provider != INDEX_SIGNATURE_PROVIDER:
            continue
        if sig0 is not None and sig0.value == current_sig:
            ctx.set_hybrid_facts(entry, scan, HybridFacts(required=False, common_bytes=entry.source_files_size()))
            out.append(entry)
            continue
        if not conf.hybrid_scan_enabled:
            continue

        # hybrid scan eligibility: file-level diff (ref: :108-191)
        indexed_files = {fi.key: fi for fi in entry.source_file_infos()}
        common_keys = current_files.keys() & indexed_files.keys()
        if not common_keys:
            continue
        appended = [current_files[k] for k in current_files.keys() - indexed_files.keys()]
        deleted = [indexed_files[k] for k in indexed_files.keys() - current_files.keys()]
        if deleted:
            # kind-polymorphic: a covering index needs its lineage column to
            # drop deleted rows; a data-skipping index prunes over the
            # current files and handles deletes naturally
            from hyperspace_tpu_torch.indexes import registry

            if not registry.index_of_entry(entry).can_handle_deleted_files():
                continue
            deleted_ratio = sum(f.size for f in deleted) / max(1, entry.source_files_size())
            if deleted_ratio > conf.hybrid_scan_deleted_ratio_threshold:
                continue
        appended_ratio = sum(f.size for f in appended) / max(1, total_bytes)
        if appended_ratio > conf.hybrid_scan_appended_ratio_threshold:
            continue
        ctx.set_hybrid_facts(
            entry,
            scan,
            HybridFacts(
                required=True,
                common_bytes=sum(indexed_files[k].size for k in common_keys),
                appended=[f.name for f in appended],
                deleted=[f.name for f in deleted],
            ),
        )
        out.append(entry)
    return out


def collect_candidates(
    ctx: RuleContext, plan: L.LogicalPlan, indexes: List[IndexLogEntry]
) -> Dict[int, Tuple[L.Scan, List[IndexLogEntry]]]:
    """Map each Scan leaf (by plan key) to its eligible index entries
    (ref: CandidateIndexCollector.scala:49-59)."""
    out: Dict[int, Tuple[L.Scan, List[IndexLogEntry]]] = {}
    for scan in L.collect(plan, lambda p: isinstance(p, L.Scan)):
        eligible = _signature_filter(ctx, scan, _schema_filter(scan, indexes))
        if eligible:
            out[L.plan_key(scan)] = (scan, eligible)
    return out
