"""Candidate index collection.

Per source leaf (Scan), chain ``ColumnSchemaFilter`` then
``FileSignatureFilter`` (ref: HS/index/rules/CandidateIndexCollector.scala:28-60,
ColumnSchemaFilter.scala:28-45, FileSignatureFilter.scala:33-192).

Only an exact signature match makes an index a candidate: hybrid scan (an
index over a source that has since gained or lost files) is not in the port
yet, and neither is the reliability layer's quarantine filter.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import logical as L
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


def _signature_filter(scan: L.Scan, indexes: List[IndexLogEntry]) -> List[IndexLogEntry]:
    """Signature equality (ref: FileSignatureFilter.scala:49-107). A
    signature recorded under another provider is not comparable and never
    matches: the index needs a refresh."""
    current_sig = index_signature(scan)
    out = []
    for entry in indexes:
        sig0 = entry.signature.signatures[0] if entry.signature.signatures else None
        if sig0 is not None and sig0.provider == INDEX_SIGNATURE_PROVIDER and sig0.value == current_sig:
            out.append(entry)
    return out


def collect_candidates(
    plan: L.LogicalPlan, indexes: List[IndexLogEntry]
) -> Dict[int, Tuple[L.Scan, List[IndexLogEntry]]]:
    """Map each Scan leaf (by plan key) to its eligible index entries
    (ref: CandidateIndexCollector.scala:49-59)."""
    out: Dict[int, Tuple[L.Scan, List[IndexLogEntry]]] = {}
    for scan in L.collect(plan, lambda p: isinstance(p, L.Scan)):
        eligible = _signature_filter(scan, _schema_filter(scan, indexes))
        if eligible:
            out[L.plan_key(scan)] = (scan, eligible)
    return out
