"""QueryProfile: one query's span tree joined with plan-level facts.

A profile is the user-facing artifact of a traced query: the finished span
tree (timings, rows/bytes per operator, dispatch events), which indexes the
optimizer applied, a one-line plan summary, and — when
``hyperspace.obs.profile.whyNot`` is on — the why-not reasons for indexes
that were *not* applied. ``Session.last_query_profile()`` returns the most
recent one; ``QueryServer`` futures carry one per request.

``report()`` renders a readable indented tree; ``chrome_trace()`` /
``save_chrome_trace()`` export the Perfetto-loadable JSON.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.obs import spans as _spans

__all__ = ["QueryProfile", "build_profile"]

#: span attrs surfaced inline in the report, in display order
_REPORT_ATTRS = ("rows", "bytes", "files", "buckets", "index", "indexes", "rule", "error")


class QueryProfile:
    """Immutable-ish record of one executed query."""

    __slots__ = (
        "root",
        "query",
        "indexes_applied",
        "plan_summary",
        "why_not",
        "rule_timings",
        "error",
    )

    def __init__(
        self,
        root: _spans.Span,
        query: str = "",
        indexes_applied: Optional[List[str]] = None,
        plan_summary: str = "",
        why_not: Optional[str] = None,
        rule_timings: Optional[Dict[str, float]] = None,
        error: Optional[str] = None,
    ):
        self.root = root
        self.query = query
        self.indexes_applied = list(indexes_applied or [])
        self.plan_summary = plan_summary
        self.why_not = why_not
        self.rule_timings = dict(rule_timings or {})
        self.error = error

    # -- aggregates ----------------------------------------------------------
    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def stage_seconds(self) -> Dict[str, float]:
        """Total seconds per span name across the tree (a span's own time
        includes its children's — these are inclusive stage totals)."""
        out: Dict[str, float] = {}
        for sp in self.root.walk():
            out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s
        return out

    def total(self, key: str) -> int:
        """Sum a numeric attr (``rows``, ``bytes``) over the whole tree."""
        acc = 0
        for sp in self.root.walk():
            v = sp.attrs.get(key)
            if isinstance(v, (int, float)):
                acc += int(v)
        return acc

    # -- renderings ----------------------------------------------------------
    def report(self, max_depth: Optional[int] = None) -> str:
        """Readable indented tree: durations in ms plus inline operator facts."""
        lines: List[str] = []
        head = f"Query profile: {self.duration_s * 1e3:.2f} ms"
        if self.error:
            head += f"  [error: {self.error}]"
        lines.append(head)
        if self.query:
            q = self.query if len(self.query) <= 200 else self.query[:197] + "..."
            lines.append(f"  query: {q}")
        if self.indexes_applied:
            lines.append(f"  indexes applied: {', '.join(self.indexes_applied)}")
        if self.plan_summary:
            lines.append(f"  plan: {self.plan_summary}")
        if self.rule_timings:
            ranked = sorted(self.rule_timings.items(), key=lambda kv: -kv[1])
            body = ", ".join(f"{r} {t * 1e3:.2f}ms" for r, t in ranked)
            lines.append(f"  rule timings: {body}")
        lines.append("  spans:")
        self._render(self.root, lines, depth=0, max_depth=max_depth)
        tr = self.root.trace
        if tr is not None and tr.dropped:
            lines.append(f"  ... {tr.dropped} span(s) dropped (budget {tr.max_spans})")
        if self.why_not:
            lines.append("  why-not:")
            for ln in self.why_not.splitlines():
                lines.append(f"    {ln}")
        return "\n".join(lines)

    def _render(self, sp: _spans.Span, lines: List[str], depth: int, max_depth: Optional[int]) -> None:
        if max_depth is not None and depth > max_depth:
            return
        pad = "    " + "  " * depth
        bits = [f"{sp.name} {sp.duration_s * 1e3:.2f} ms"]
        for k in _REPORT_ATTRS:
            if k in sp.attrs:
                bits.append(f"{k}={sp.attrs[k]}")
        for k, v in sp.attrs.items():
            if k not in _REPORT_ATTRS:
                bits.append(f"{k}={v}")
        if sp.events:
            bits.append(f"events={len(sp.events)}")
        lines.append(pad + "  ".join(str(b) for b in bits))
        for c in sp.children:
            self._render(c, lines, depth + 1, max_depth)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (see ``obs.spans.to_chrome_trace``)."""
        return _spans.to_chrome_trace(self.root)

    def save_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def to_json(self) -> Dict[str, Any]:
        """Structured summary (not the full tree — use ``chrome_trace`` for
        that): durations per stage, totals, plan facts."""
        return {
            "durationSeconds": self.duration_s,
            "query": self.query,
            "indexesApplied": list(self.indexes_applied),
            "planSummary": self.plan_summary,
            "stageSeconds": self.stage_seconds(),
            "rows": self.total("rows"),
            "bytes": self.total("bytes"),
            "ruleTimingsSeconds": dict(self.rule_timings),
            "error": self.error,
            "spanCount": (self.root.trace.count if self.root.trace else None),
            "droppedSpans": (self.root.trace.dropped if self.root.trace else 0),
        }

    def __repr__(self) -> str:
        return (
            f"QueryProfile({self.duration_s * 1e3:.2f} ms, "
            f"indexes={self.indexes_applied!r}, spans={self.root.trace.count if self.root.trace else '?'})"
        )


def build_profile(root: _spans.Span, query: str = "", error: Optional[str] = None) -> QueryProfile:
    """Assemble a profile from a finished root span, pulling plan facts the
    instrumentation stashed as attrs (``indexes``, ``plan``, rule timings)."""
    root.finish()
    indexes: List[str] = []
    plan_summary = ""
    rule_timings: Dict[str, float] = {}
    for sp in root.walk():
        v = sp.attrs.get("indexes")
        if v:
            for name in v if isinstance(v, (list, tuple)) else [v]:
                if name not in indexes:
                    indexes.append(name)
        if not plan_summary and sp.attrs.get("plan"):
            plan_summary = str(sp.attrs["plan"])
        rt = sp.attrs.get("rule_timings")
        if isinstance(rt, dict):
            for r, t in rt.items():
                rule_timings[r] = rule_timings.get(r, 0.0) + float(t)
    return QueryProfile(
        root,
        query=query,
        indexes_applied=indexes,
        plan_summary=plan_summary,
        rule_timings=rule_timings,
        error=error,
    )
