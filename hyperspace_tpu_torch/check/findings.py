"""The one result type every check pass emits."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class Finding:
    """A single violation: which rule fired, where, and why.

    ``path`` is repo-relative for AST findings and a program label (e.g.
    ``hlo:grouped-agg-chunk``) for compiled-program findings; ``line`` is 0
    when a finding has no meaningful source line (doc drift, HLO contracts).
    """

    rule: str
    path: str
    line: int
    message: str
    detail: Dict[str, Any] = field(default_factory=dict, compare=False)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "detail": dict(self.detail),
        }
