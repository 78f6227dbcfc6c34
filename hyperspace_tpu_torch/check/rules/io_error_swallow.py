"""``io-error-swallow``: lake IO failures must be classified, never dropped.

A broad ``except`` (bare, ``Exception``, or ``BaseException``) wrapped
around lake IO — file opens, parquet footer/metadata/schema reads, decodes,
directory listings — is how a torn write or a flaky mount silently became
"the index does not exist" (models/log_manager.py pre-reliability) or "no
rows" instead of a typed failure. In the IO-touching packages (``exec/``,
``serving/``, ``models/``) such a handler must do one of:

- re-raise (anything — the typed reliability error, or the original), or
- route through the reliability taxonomy: call
  ``classify``/``count_io_error`` (hyperspace_tpu_torch/reliability/errors.py) or
  a quarantine hook (``note_corrupt``), so the failure is counted and
  attributed even when a fallback answers, or
- carry an explicit ``# hscheck: disable=io-error-swallow`` pragma on the
  ``except`` line, making the deliberate swallow visible in review.

Narrow handlers (``except OSError``, ``except pa.ArrowInvalid``) are not
flagged: catching a *specific* failure mode for a *specific* fallback is
the designed pattern; this rule targets the catch-everything-say-nothing
shape.
"""

from __future__ import annotations

import ast
import os
from typing import List

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "io-error-swallow"

#: package-relative directories whose code touches the lake
_IO_DIRS = ("exec", "serving", "models")

#: call names (bare or attribute) that mark a try body as lake IO
_IO_CALLS = {
    "open",
    "listdir",
    "stat",
    "read_metadata",
    "read_schema",
    "read_row_groups",
    "read_columns",
    "read_table",
    "read_parquet_batch",
    "unify_schemas",
    "to_table",
    "ParquetFile",
    "from_json",
    "write_atomic",
    "write_atomic_exclusive",
}

#: handler calls that count as routing through the reliability taxonomy
_CLASSIFIERS = {
    "classify",
    "count_io_error",
    "note_corrupt",
    "note_ok",
    "_count_corrupt",
}

_BROAD = {"Exception", "BaseException"}


def _in_scope(rel: str) -> bool:
    parts = rel.replace(os.sep, "/").split("/")
    return len(parts) >= 2 and parts[0] == "hyperspace_tpu_torch" and parts[1] in _IO_DIRS


def _name_of(node: ast.expr) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(_name_of(e) in _BROAD for e in types)


def _touches_io(try_body: List[ast.stmt]) -> bool:
    for stmt in try_body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and _name_of(node.func) in _IO_CALLS:
                return True
    return False


def _handler_classifies(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and _name_of(node.func) in _CLASSIFIERS:
            return True
    return False


def scan_tree(tree: ast.Module) -> List[ast.ExceptHandler]:
    """Broad handlers around lake IO that neither re-raise nor classify."""
    bad: List[ast.ExceptHandler] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        if not _touches_io(node.body):
            continue
        for handler in node.handlers:
            if _is_broad(handler) and not _handler_classifies(handler):
                bad.append(handler)
    return bad


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        if ctx.full_scope and not _in_scope(rel):
            continue
        for handler in scan_tree(ctx.ast_of(path)):
            findings.append(
                Finding(
                    rule=NAME,
                    path=rel,
                    line=handler.lineno,
                    message=(
                        "broad except around lake IO swallows the failure "
                        "unclassified; re-raise a typed reliability error, "
                        "route through classify()/count_io_error()/"
                        "note_corrupt(), or carry an explicit pragma"
                    ),
                )
            )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
