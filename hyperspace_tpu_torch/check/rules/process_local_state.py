"""``process-local-state``: serving/reliability registries must declare scope.

In a fabric deployment (docs/scale-out.md) N server processes share one
lake; anything accumulated in a module-level mutable object — a breaker
map, a counter registry, a memo dict — is silently per-process unless the
coherence sidecar publishes it. This rule makes that choice explicit:
every module-level mutable registry in ``serving/`` and ``reliability/``
must either

- be **fabric-published**: listed by name in the module's
  ``__fabric_published__`` tuple (e.g. ``reliability/degrade.py``'s
  ``QUARANTINE``, whose strikes the sidecar shares), or
- be **annotated as intentionally process-local** with
  ``# hscheck: disable=process-local-state`` on the assignment line (e.g.
  the per-process ``qsN`` server-name counter).

Flagged value shapes: dict/list/set literals and comprehensions, the
standard mutable-container factories (``dict()``, ``defaultdict()``,
``deque()``, ``itertools.count()``, ...), and constructor calls whose
class name ends in a registry-ish suffix (``*Registry``, ``*Cache``,
``*Tracker``, ``*History``, ``*Recorder``, ``*Bus``). Dunder assignments
(``__all__``) are exempt.

Scope: ``hyperspace_tpu_torch/serving/`` and ``hyperspace_tpu_torch/reliability/``
(the layers whose state the fabric must reason about); explicit fixture
paths are checked wherever they live.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "process-local-state"

#: directories whose module state the fabric must account for
_SCOPE_DIRS = ("serving", "reliability")

#: callables that build a mutable container
_MUTABLE_FACTORIES = {
    "dict", "list", "set", "defaultdict", "deque", "OrderedDict", "Counter",
    "count",
}

#: class-name suffixes that read as "stateful registry"
_REGISTRY_SUFFIXES = (
    "Registry", "Cache", "Tracker", "History", "Recorder", "Bus",
)


def _in_scope(rel: str) -> bool:
    parts = rel.replace(os.sep, "/").split("/")
    return (
        len(parts) >= 2
        and parts[0] == "hyperspace_tpu_torch"
        and parts[1] in _SCOPE_DIRS
    )


def _fabric_published(tree: ast.Module) -> Set[str]:
    """Names listed in the module's ``__fabric_published__`` tuple/list."""
    out: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "__fabric_published__"
            for t in node.targets
        ):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    out.add(elt.value)
    return out


def _callable_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def flag_reason(value: ast.expr) -> Optional[str]:
    """Why this assigned value is module-level mutable state, or None."""
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(value, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(value, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(value, ast.Call):
        name = _callable_name(value.func)
        if name in _MUTABLE_FACTORIES:
            return f"{name}()"
        if name and name.endswith(_REGISTRY_SUFFIXES):
            return f"{name}()"
    return None


def scan_module(tree: ast.Module) -> List[tuple]:
    """(name, reason, lineno) for every unexempted module-level mutable
    assignment (direct module body only — class/function bodies are
    instance or local state, not process-global)."""
    published = _fabric_published(tree)
    out: List[tuple] = []
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names:
            continue
        if all(n.startswith("__") and n.endswith("__") for n in names):
            continue  # __all__ and friends
        if all(n in published for n in names):
            continue
        reason = flag_reason(value)
        if reason is not None:
            out.append((names[0], reason, node.lineno))
    return out


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        if ctx.full_scope and not _in_scope(rel):
            continue
        for name, reason, lineno in scan_module(ctx.ast_of(path)):
            findings.append(
                Finding(
                    rule=NAME,
                    path=rel,
                    line=lineno,
                    message=(
                        f"module-level mutable state {name!r} ({reason}) is "
                        "invisible to fabric peer processes; publish it via "
                        "the coherence sidecar and list it in "
                        "__fabric_published__, or mark it intentionally "
                        "process-local with '# hscheck: "
                        "disable=process-local-state'"
                    ),
                )
            )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
