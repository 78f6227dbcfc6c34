"""``lock-blocking``: no blocking calls while holding a serving/obs mutex.

The serving path holds small mutexes on the request hot path (admission,
plan cache, result cache, scheduler) and the obs layer's registry/history
locks are taken by the telemetry endpoint. A ``time.sleep``, file/socket
IO, or a device sync (``.block_until_ready()``) inside such a critical
section turns a nanosecond mutex into a convoy: every concurrent request
queues behind one slow syscall. This rule walks every ``with`` statement
whose context expression *names* a lock (identifier containing ``lock`` or
``cv``/``cond``) in ``serving/`` and ``obs/`` modules and flags blocking
calls in the guarded block (without descending into nested function
definitions, which execute later, outside the lock).
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, List, Optional, Tuple

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "lock-blocking"

# Call patterns that block: (dotted-name-suffix-or-exact, description).
_BLOCKING_CALLS = {
    "time.sleep": "sleeps while holding a lock",
    "socket.socket": "opens a socket while holding a lock",
    "socket.create_connection": "opens a socket while holding a lock",
    "os.fsync": "performs file IO while holding a lock",
    "os.replace": "performs file IO while holding a lock",
    "os.rename": "performs file IO while holding a lock",
    "os.remove": "performs file IO while holding a lock",
    "shutil.copy": "performs file IO while holding a lock",
    "shutil.move": "performs file IO while holding a lock",
    "subprocess.run": "spawns a process while holding a lock",
    "subprocess.check_output": "spawns a process while holding a lock",
    "urlopen": "performs network IO while holding a lock",
}
_BLOCKING_BARE = {
    "open": "opens a file while holding a lock",
}
_BLOCKING_ATTRS = {
    "block_until_ready": "synchronizes with the device while holding a lock",
}


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return None


def _names_a_lock(expr: ast.AST) -> bool:
    """True when the with-item's context expression is a lock by name:
    ``self._lock``, ``plan_lock``, ``REGISTRY._lock``, ``cv``/``_cond``."""
    dotted = _dotted(expr)
    if dotted is None:
        return False
    leaf = dotted.rsplit(".", 1)[-1].lower().lstrip("_")
    return "lock" in leaf or leaf in ("cv", "cond", "condition")


def _walk_no_defs(body: List[ast.stmt]) -> Iterator[ast.AST]:
    """ast.walk over statements, skipping nested function/class bodies —
    code in a nested def runs later, not under the lock."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _blocking_reason(call: ast.Call) -> Optional[str]:
    dotted = _dotted(call.func)
    if dotted is not None:
        if dotted in _BLOCKING_BARE:
            return _BLOCKING_BARE[dotted]
        for pat, why in _BLOCKING_CALLS.items():
            if dotted == pat or dotted.endswith("." + pat):
                return why
    if isinstance(call.func, ast.Attribute) and call.func.attr in _BLOCKING_ATTRS:
        return _BLOCKING_ATTRS[call.func.attr]
    return None


def scan_tree(tree: ast.Module) -> List[Tuple[int, str]]:
    """(line, reason) for every blocking call under a lock-guarded with."""
    hits: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_names_a_lock(item.context_expr) for item in node.items):
            continue
        for inner in _walk_no_defs(node.body):
            if isinstance(inner, ast.Call):
                why = _blocking_reason(inner)
                if why is not None:
                    hits.append((inner.lineno, why))
    return sorted(set(hits))


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        norm = rel.replace(os.sep, "/")
        if "/serving/" not in norm and "/obs/" not in norm:
            continue
        for line, why in scan_tree(ctx.ast_of(path)):
            findings.append(Finding(rule=NAME, path=rel, line=line, message=why))
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
