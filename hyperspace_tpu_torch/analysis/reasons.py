"""whyNot filter reasons (ref: HS/index/plananalysis/FilterReason.scala:19-151
— 14 reason case classes with code + verbose strings)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(frozen=True)
class FilterReason:
    code: str
    args: tuple = ()
    verbose: str = ""

    @property
    def arg_str(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.args)

    def __str__(self) -> str:
        return f"[{self.code}] {self.verbose or self.arg_str}"


def col_schema_mismatch(required, available) -> FilterReason:
    return FilterReason(
        "COL_SCHEMA_MISMATCH",
        (("requiredCols", ",".join(required)), ("availableCols", ",".join(available))),
        f"Index does not contain required columns. Required: {list(required)}, available: {list(available)}",
    )


def source_data_changed() -> FilterReason:
    return FilterReason("SOURCE_DATA_CHANGED", (), "Index signature does not match the current source data.")


def signature_provider_mismatch(recorded: str) -> FilterReason:
    return FilterReason(
        "SIGNATURE_PROVIDER_MISMATCH",
        (("recordedProvider", recorded),),
        f"Index was recorded under signature provider {recorded!r}; refresh the index to re-sign it.",
    )


def no_delete_support() -> FilterReason:
    return FilterReason("NO_DELETE_SUPPORT", (), "Index doesn't support deleted files (no lineage).")


def too_many_deleted(ratio: float, threshold: float) -> FilterReason:
    return FilterReason(
        "TOO_MANY_DELETED",
        (("deletedRatio", f"{ratio:.3f}"), ("threshold", f"{threshold}")),
        f"Deleted bytes ratio {ratio:.3f} exceeds threshold {threshold}.",
    )


def too_many_appended(ratio: float, threshold: float) -> FilterReason:
    return FilterReason(
        "TOO_MANY_APPENDED",
        (("appendedRatio", f"{ratio:.3f}"), ("threshold", f"{threshold}")),
        f"Appended bytes ratio {ratio:.3f} exceeds threshold {threshold}.",
    )


def no_first_indexed_col_cond(first_col: str, pred_cols) -> FilterReason:
    return FilterReason(
        "NO_FIRST_INDEXED_COL_COND",
        (("firstIndexedCol", first_col), ("predicateCols", ",".join(pred_cols))),
        f"The first indexed column {first_col!r} does not appear in the filter condition.",
    )


def missing_required_col(required, indexed_and_included) -> FilterReason:
    return FilterReason(
        "MISSING_REQUIRED_COL",
        (("requiredCols", ",".join(required)), ("indexCols", ",".join(indexed_and_included))),
        f"Index does not cover all required columns: required {list(required)}.",
    )


def no_filter_on_scan() -> FilterReason:
    return FilterReason("NO_FILTER_ON_SCAN", (), "Plan is not a filter over a supported scan.")


def not_eligible_join(reason: str) -> FilterReason:
    return FilterReason("NOT_ELIGIBLE_JOIN", (("reason", reason),), f"Join query is not eligible: {reason}.")


def not_all_join_cols_indexed(side: str, join_cols, indexed) -> FilterReason:
    return FilterReason(
        "NOT_ALL_JOIN_COLS_INDEXED",
        (("side", side), ("joinCols", ",".join(join_cols)), ("indexedCols", ",".join(indexed))),
        f"{side}: indexed columns {list(indexed)} must exactly match join columns {list(join_cols)}.",
    )


def missing_indexed_col(side: str, required, indexed) -> FilterReason:
    return FilterReason(
        "MISSING_INDEXED_COL",
        (("side", side), ("requiredIndexedCols", ",".join(required)), ("indexedCols", ",".join(indexed))),
        f"{side}: join columns {list(required)} not covered by indexed columns {list(indexed)}.",
    )


def no_avail_join_index_pair(side: str) -> FilterReason:
    return FilterReason(
        "NO_AVAIL_JOIN_INDEX_PAIR",
        (("side", side),),
        f"No compatible index pair found (failed on {side} side).",
    )


def another_index_applied(applied: str) -> FilterReason:
    return FilterReason(
        "ANOTHER_INDEX_APPLIED",
        (("appliedIndex", applied),),
        f"Another candidate index {applied!r} was chosen by the ranker.",
    )


def index_not_eligible(reason: str) -> FilterReason:
    return FilterReason("INDEX_NOT_ELIGIBLE", (("reason", reason),), reason)


def index_quarantined(name: str) -> FilterReason:
    """The reliability circuit breaker quarantined this index after repeated
    corrupt-data errors on its files (hyperspace_tpu_torch/reliability/degrade.py);
    queries re-plan against source until a half-open probe reads clean."""
    return FilterReason(
        "INDEX_QUARANTINED",
        (("index", name),),
        f"Index {name!r} is quarantined after repeated corrupt reads; "
        "queries fall back to source until a clean probe un-quarantines it.",
    )


def sort_order_not_covered(reason: str) -> FilterReason:
    """Sort elimination (streamed merge of sorted index runs,
    plan/ordering.sort_run_eligibility) could not fire for a Sort node."""
    return FilterReason("SORT_ORDER_NOT_COVERED", (("reason", reason),), reason)


# Tag names (ref: HS/index/IndexLogEntryTags.scala:23-70)
FILTER_REASONS = "FILTER_REASONS"
COMMON_SOURCE_SIZE_IN_BYTES = "COMMON_SOURCE_SIZE_IN_BYTES"
HYBRIDSCAN_REQUIRED = "HYBRIDSCAN_REQUIRED"
HYBRIDSCAN_APPENDED = "HYBRIDSCAN_APPENDED"
HYBRIDSCAN_DELETED = "HYBRIDSCAN_DELETED"
APPLICABLE_INDEX_RULES = "APPLICABLE_INDEX_RULES"
