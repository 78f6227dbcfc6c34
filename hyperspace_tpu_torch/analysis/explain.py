"""explain API: run the optimizer with and without Hyperspace, show both
plans, highlight the differing subtrees, and list the indexes used
(ref: HS/index/plananalysis/PlanAnalyzer.scala:36-411).

Three display modes, as in the reference (ref: plananalysis/DisplayMode.scala:61-89):
``plaintext`` (markers stripped), ``console`` (differing subtrees suffixed with
``<----``), and ``html`` (``<b>`` highlights, ``<br/>`` newlines).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from hyperspace_tpu_torch.plan import logical as L


class DisplayMode:
    """(ref: plananalysis/DisplayMode.scala)"""

    name = "plaintext"
    highlight_begin = ""
    highlight_end = ""
    newline = "\n"

    def wrap(self, text: str) -> str:
        return text


class PlainTextMode(DisplayMode):
    pass


class ConsoleMode(DisplayMode):
    name = "console"
    highlight_end = " <----"


class HTMLMode(DisplayMode):
    name = "html"
    highlight_begin = "<b>"
    highlight_end = "</b>"
    newline = "<br/>"

    def wrap(self, text: str) -> str:
        return "<pre>" + text + "</pre>"


_MODES = {
    "plaintext": PlainTextMode,
    "console": ConsoleMode,
    "html": HTMLMode,
}


def _subtree_strings(plan: L.LogicalPlan) -> set:
    return {p.pretty() for p in L.collect(plan, lambda p: True)}


def _pretty_highlighted(plan: L.LogicalPlan, other_subtrees: set, mode: DisplayMode) -> str:
    """Pretty-print ``plan``, highlighting each node whose subtree does not
    appear in the other plan — i.e. the differing region, while identical
    sub-plans (e.g. the untouched side of a join) stay unmarked
    (ref: PlanAnalyzer highlight of differing sub-plans)."""
    lines: List[str] = []

    def walk(p: L.LogicalPlan, indent: int) -> None:
        differs = p.pretty() not in other_subtrees
        line = "  " * indent + p.describe()
        if differs:
            line = mode.highlight_begin + line + mode.highlight_end
        lines.append(line)
        for c in p.children():
            walk(c, indent + 1)

    walk(plan, 0)
    return "\n".join(lines)


def _operator_counts(plan: L.LogicalPlan) -> Counter:
    from hyperspace_tpu_torch.rules.apply import plans_including_subqueries

    return Counter(
        type(p).__name__
        for sub in plans_including_subqueries(plan)
        for p in L.collect(sub, lambda x: True)
    )


def physical_operator_stats(plan_with: L.LogicalPlan, plan_without: L.LogicalPlan) -> List[Tuple[str, int, int]]:
    """Per-operator (name, count with indexes, count without) rows for every
    operator whose count differs, plus all shared ones
    (ref: plananalysis/PhysicalOperatorAnalyzer.scala:30)."""
    cw = _operator_counts(plan_with)
    co = _operator_counts(plan_without)
    names = sorted(set(cw) | set(co))
    return [(n, cw.get(n, 0), co.get(n, 0)) for n in names]


def _used_indexes(plan: L.LogicalPlan) -> List[str]:
    from hyperspace_tpu_torch.rules.apply import used_index_names

    return used_index_names(plan)


def _bucket_summary(plan: L.LogicalPlan) -> List[str]:
    from hyperspace_tpu_torch.rules.apply import plans_including_subqueries

    out = []
    for p in plans_including_subqueries(plan):
        for node in L.collect(p, lambda x: isinstance(x, (L.IndexScan, L.BucketUnion))):
            out.append(node.describe())
    return out


def explain_string(df, session, verbose: bool = False, mode: str = "plaintext") -> str:
    """(ref: PlanAnalyzer.explainString :47-115 — builds the plan twice, runs
    the optimizer only (no execution), and diffs the trees)."""
    from hyperspace_tpu_torch.rules.apply import ApplyHyperspace

    if mode not in _MODES:
        raise ValueError(f"Unsupported display mode {mode!r}; expected one of {sorted(_MODES)}")
    dm = _MODES[mode]()
    plan_without = df.plan
    plan_with = ApplyHyperspace(session).apply(plan_without)

    with_sub = _subtree_strings(plan_with)
    without_sub = _subtree_strings(plan_without)

    used = _used_indexes(plan_with)
    buf = []
    buf.append("=" * 64)
    buf.append("Plan with indexes:")
    buf.append(_pretty_highlighted(plan_with, without_sub, dm))
    buf.append("")
    buf.append("Plan without indexes:")
    buf.append(_pretty_highlighted(plan_without, with_sub, dm))
    buf.append("")
    buf.append("Indexes used:")
    if used:
        manager = session.index_manager
        for name in used:
            entry = manager.get_index(name)
            location = entry.content.files[0].rsplit("/", 2)[0] if entry and entry.content.files else ""
            buf.append(f"  {name}: {location}")
    else:
        buf.append("  (none)")
    if verbose:
        buf.append("")
        buf.append("Physical operator stats:")
        rows = physical_operator_stats(plan_with, plan_without)
        name_w = max([len("Physical Operator")] + [len(r[0]) for r in rows])
        buf.append(f"  {'Physical Operator':<{name_w}} | Hyperspace Disabled | Hyperspace Enabled | Difference")
        for n, w, o in rows:
            buf.append(f"  {n:<{name_w}} | {o:>19} | {w:>18} | {w - o:>10}")
        buf.append("")
        buf.append("Index-side operators:")
        for line in _bucket_summary(plan_with) or ["  (none)"]:
            buf.append(f"  {line}")
    buf.append("=" * 64)
    text = "\n".join(buf)
    if dm.newline != "\n":
        text = text.replace("\n", dm.newline)
    return dm.wrap(text)
