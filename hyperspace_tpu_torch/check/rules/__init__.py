"""Rule registry for the AST codebase lint.

A rule is a module-level :class:`Rule` with a unique kebab-case name, a
one-paragraph doc (rendered by ``--list`` and docs/static-analysis.md), and
a ``check(ctx) -> List[Finding]``. Add a rule by dropping a module here,
defining ``RULE = Rule(...)``, and listing it in :data:`_RULE_MODULES` and
in :func:`all_rules`'s imports —
the fixture-pair convention in tests/fixtures/check/ (one seeded-violation
file that must fire, one clean file that must not) keeps it honest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

from hyperspace_tpu_torch.check.findings import Finding

_RULE_MODULES = (
    "conf_keys",
    "metric_families",
    "lock_blocking",
    "cache_branding",
    "jit_purity",
    "snapshot_pin",
    "io_error_swallow",
    "process_local_state",
    "trace_context_drop",
    "donated_buffer_reuse",
    "native_fallback",
)


@dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    check: Callable[["LintContext"], List[Finding]]  # noqa: F821


def all_rules() -> Dict[str, Rule]:
    # imported by name, not through importlib: the port loads no module
    # from a string (tests/test_torch_isolation.py). Each import binds its
    # submodule in this package's namespace.
    from hyperspace_tpu_torch.check.rules import (  # noqa: F401
        cache_branding,
        conf_keys,
        donated_buffer_reuse,
        io_error_swallow,
        jit_purity,
        lock_blocking,
        metric_families,
        native_fallback,
        process_local_state,
        snapshot_pin,
        trace_context_drop,
    )

    out: Dict[str, Rule] = {}
    for mod in _RULE_MODULES:
        rule = globals()[mod].RULE
        if rule.name in out:
            raise ValueError(f"duplicate rule name {rule.name!r}")
        out[rule.name] = rule
    return out
