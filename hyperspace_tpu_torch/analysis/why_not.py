"""whyNot API: report, per candidate index, why the optimizer did not apply
it to the given query
(ref: HS/index/plananalysis/CandidateIndexAnalyzer.scala:29-346).

Mechanism mirrors the reference: enable analysis mode, re-run the collector +
optimizer so the filter chain tags each entry with ``FilterReason``s and the
rules tag their ranker winners with ``APPLICABLE_INDEX_RULES``, then render
the reference's four sections (applied / applicable-but-not-applied /
outdated / no-applicable-plan, ref: CandidateIndexAnalyzer.scala:178-255)
followed by the per-subplan reasons table.
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch.analysis import reasons as R
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.plan import logical as L


def why_not_string(df, session, index_name: Optional[str] = None, extended: bool = False) -> str:
    from hyperspace_tpu_torch.rules.apply import ApplyHyperspace

    applier = ApplyHyperspace(session, analysis_enabled=True)
    indexes = session.index_manager.get_indexes([states.ACTIVE])
    if index_name is not None:
        missing = index_name not in {e.name for e in indexes}
        if missing:
            return f"Index {index_name!r} does not exist or is not ACTIVE."
    from hyperspace_tpu_torch.rules.apply import plans_including_subqueries, used_index_names

    # entries are shared across queries (TTL cache): wipe analysis tags from
    # previous runs or the sections misclassify indexes
    # (ref: CandidateIndexAnalyzer.scala:64-80 prepare/cleanupAnalysisTags)
    for entry in indexes:
        entry.unset_tag_for_all_plans(R.FILTER_REASONS)
        entry.unset_tag_for_all_plans(R.APPLICABLE_INDEX_RULES)
    plan = df.plan
    new_plan = applier.apply(plan)
    applied = set(used_index_names(new_plan))
    scans = []
    for p in plans_including_subqueries(plan):
        scans.extend(L.collect(p, lambda x: isinstance(x, L.Scan)))
    # unique scans by plan key; disambiguate label collisions across distinct
    # scans (two datasets can share a directory basename)
    by_key = {}
    for s in scans:
        by_key.setdefault(L.plan_key(s), s)
    scans = list(by_key.values())
    labels = {}
    used_labels: dict = {}
    for s in scans:
        base = _subplan_label(s)
        ordinal = used_labels.get(base, 0)
        used_labels[base] = ordinal + 1
        labels[L.plan_key(s)] = base if ordinal == 0 else f"{base[:24]}#{ordinal + 1}"

    selected = [e for e in indexes if index_name is None or e.name == index_name]

    # reasons per entry, deduplicated rows for the table AND the section logic
    rows = {}  # entry.name -> list of (label, reason)
    for entry in selected:
        seen = set()
        out = []
        for scan in scans:
            label = labels[L.plan_key(scan)]
            for reason in entry.get_tag(L.plan_key(scan), R.FILTER_REASONS) or []:
                if (label, reason.code, reason.arg_str) in seen:
                    continue
                seen.add((label, reason.code, reason.arg_str))
                out.append((label, reason))
        rows[entry.name] = out

    # "applicable, but not applied due to priority": a rule's ranker picked
    # the index for some sub-plan, but the score-based optimizer chose a
    # different rewrite (ref: CandidateIndexAnalyzer.scala:193-197)
    applicable_not_applied = sorted(
        e.name
        for e in selected
        if e.name not in applied
        and any(e.get_tag(L.plan_key(s), R.APPLICABLE_INDEX_RULES) for s in scans)
    )
    outdated = sorted(
        name
        for name, rs in rows.items()
        if name not in applied
        and name not in applicable_not_applied
        and any(r.code == "SOURCE_DATA_CHANGED" for _, r in rs)
    )
    no_applicable_plan = sorted(
        name
        for name, rs in rows.items()
        if name not in applied
        and name not in applicable_not_applied
        and name not in outdated
        and any(r.code not in ("COL_SCHEMA_MISMATCH", "SOURCE_DATA_CHANGED") for _, r in rs)
    )

    def names_section(buf: List[str], title: str, names) -> None:
        buf.append(title)
        for n in names:
            buf.append(f"- {n}")
        if not names:
            buf.append("- No such index found.")
        buf.append("")

    buf: List[str] = []
    buf.append("=" * 64)
    buf.append("whyNot report")
    buf.append("=" * 64)
    names_section(buf, "Applied indexes:", sorted(applied))
    names_section(
        buf, "Applicable indexes, but not applied due to priority:", applicable_not_applied
    )
    names_section(buf, "Non-applicable indexes - index is outdated:", outdated)
    names_section(buf, "Non-applicable indexes - no applicable query plan:", no_applicable_plan)

    header = f"{'Index':<24} {'Subplan':<28} Reason"
    buf.append(header)
    buf.append("-" * len(header))
    for entry in selected:
        if entry.name in applied:
            buf.append(f"{entry.name:<24} {'-':<28} (applied)")
            continue
        if not rows[entry.name]:
            buf.append(
                f"{entry.name:<24} {'-':<28} [NO_CANDIDATE] not a candidate for any sub-plan"
            )
            continue
        shown = 0
        for label, reason in rows[entry.name]:
            # non-extended drops schema-mismatch noise, like the reference's
            # table filter (CandidateIndexAnalyzer.scala:229-233)
            if not extended and reason.code == "COL_SCHEMA_MISMATCH":
                continue
            text = str(reason) if extended else f"[{reason.code}] {reason.arg_str}"
            buf.append(f"{entry.name:<24} {label:<28} {text}")
            shown += 1
        if not shown:
            buf.append(
                f"{entry.name:<24} {'-':<28} [COL_SCHEMA_MISMATCH] "
                "(details with extended=True)"
            )
    buf.append("=" * 64)
    buf.extend(_sort_elimination_lines(new_plan))
    for entry in indexes:
        entry.unset_tag_for_all_plans(R.FILTER_REASONS)
        entry.unset_tag_for_all_plans(R.APPLICABLE_INDEX_RULES)
    return "\n".join(buf)


def _sort_elimination_lines(new_plan: L.LogicalPlan) -> List[str]:
    """Per-Sort verdicts over the OPTIMIZED plan: eliminated in favor of the
    streamed sorted-run merge, or the reason it cannot fire (the planner half
    lives in plan/ordering.sort_run_eligibility; the executor records the
    same outcomes in dispatch traces)."""
    from hyperspace_tpu_torch.plan import ordering as ORD
    from hyperspace_tpu_torch.rules.apply import plans_including_subqueries

    lines: List[str] = []
    try:
        sorts = []
        for p in plans_including_subqueries(new_plan):
            sorts.extend(L.collect(p, lambda x: isinstance(x, L.Sort)))
        for s in sorts:
            keys = ", ".join(f"{c}{'' if a else ' DESC'}" for c, a in s.keys)
            leaf, _chain, reason = ORD.sort_run_eligibility(s)
            if leaf is not None:
                lines.append(
                    f"Sort({keys}): eliminated — streamed merge of sorted index runs"
                )
            elif reason is not None:
                lines.append(f"Sort({keys}): {R.sort_order_not_covered(reason)}")
            else:
                lines.append(
                    f"Sort({keys}): "
                    f"{R.sort_order_not_covered('child is not an index scan chain')}"
                )
    except Exception:
        return []
    if not lines:
        return []
    return ["Sort elimination:", "-" * len("Sort elimination:"), *lines, "=" * 64]


def _subplan_label(scan: L.Scan) -> str:
    """Short, machine-stable label for a source sub-plan: the dataset's last
    path component (absolute temp paths would make golden files unstable)."""
    import os

    paths = getattr(scan.relation, "root_paths", None) or []
    base = os.path.basename(str(paths[0]).rstrip("/")) if paths else "?"
    return f"Scan({base})"[:28]
