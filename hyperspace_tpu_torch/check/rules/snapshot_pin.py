"""``snapshot-pin``: query-path code must not resolve log versions directly.

A serving request's answer is defined by the :class:`SnapshotHandle` pinned
at admission (hyperspace_tpu_torch/lifecycle/snapshot.py): every index-log
resolution downstream must go through ``session.index_manager`` (whose
reads consult :func:`current_snapshot`) or the handle itself. A call site
in the query path that invokes ``get_latest_stable_log()`` /
``get_latest_log()`` on a log manager directly bypasses the pin — it reads
the *live* log, so a refresh committing mid-flight hands the request a
torn mix of two data versions.

Scope: the query-path packages (``serving/``, ``rules/``, ``exec/``,
``plan/``, ``serve/``). The resolution and mutation layers —
``manager.py``, ``actions/``, ``models/``, ``lifecycle/`` — legitimately
read the live log and are exempt. A rare intentional site suppresses with
``# hscheck: disable=snapshot-pin``.
"""

from __future__ import annotations

import ast
import os
from typing import List

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "snapshot-pin"

#: direct log-version resolvers (models/log_manager.py API)
_RESOLVERS = {"get_latest_stable_log", "get_latest_log"}

#: package-relative directories whose code runs under a request's pin
_QUERY_PATH_DIRS = ("serving", "rules", "exec", "plan", "serve")


def _in_scope(rel: str) -> bool:
    parts = rel.replace(os.sep, "/").split("/")
    return (
        len(parts) >= 2
        and parts[0] == "hyperspace_tpu_torch"
        and parts[1] in _QUERY_PATH_DIRS
    )


def scan_tree(tree: ast.Module) -> List[ast.Call]:
    """Calls resolving a log version without going through the pin."""
    bad: List[ast.Call] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _RESOLVERS
        ):
            bad.append(node)
    return bad


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        if ctx.full_scope and not _in_scope(rel):
            continue
        for call in scan_tree(ctx.ast_of(path)):
            findings.append(
                Finding(
                    rule=NAME,
                    path=rel,
                    line=call.lineno,
                    message=(
                        f"direct {call.func.attr}() call bypasses the request's "
                        "SnapshotHandle pin; resolve through session.index_manager "
                        "(pin-aware) or the pinned handle itself"
                    ),
                )
            )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
