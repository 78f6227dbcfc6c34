"""``native-fallback``: every pyarrow fallback off the native decoder is
accounted.

The native C decoder (``hyperspace_tpu_torch/native``) is a *fast path*: any
``except`` wrapped around its read entry points — ``native.read_columns``,
the per-row-group handle methods ``read_fixed_rg_into`` / ``read_codes_rg``
/ ``read_dict_rg`` / ``read_binary_rg`` — is by construction a fallback
decision, and an unaccounted fallback is how "native decode silently never
runs" hides: the suite stays green (pyarrow answers byte-identically) while
every scan quietly pays the slow path. Such a handler must do one of:

- re-raise (the typed reliability error or the original), or
- route through the reliability taxonomy (``classify`` /
  ``count_io_error`` / ``note_corrupt``), which attributes the failure even
  when a fallback answers, or
- count the reroute in ``hs_native_fallback_total`` — either through the
  ``_native_fallback_counter(reason)`` helper (exec/io.py) or a literal
  registration of that family, or
- carry an explicit ``# hscheck: disable=native-fallback`` pragma on the
  ``except`` line, making the deliberate swallow visible in review.

Unlike ``io-error-swallow`` this rule flags NARROW handlers too: catching
``NativeUnsupported`` for a clean fallback is exactly the designed shape —
but the reroute still has to be counted, or dialect drift (a writer
upgrade, a new codec) turns the fast path off fleet-wide with no signal.
"""

from __future__ import annotations

import ast
import os
from typing import List

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "native-fallback"

#: native decode entry points: module-level reader + per-row-group handle
#: methods (names are unique to hyperspace_tpu_torch/native's surface)
_NATIVE_READS = {
    "read_fixed_rg_into",
    "read_codes_rg",
    "read_dict_rg",
    "read_binary_rg",
}

#: handler calls that count as routing through the reliability taxonomy
_CLASSIFIERS = {"classify", "count_io_error", "note_corrupt", "note_ok"}

#: handler calls that count the reroute in hs_native_fallback_total
_FALLBACK_COUNTERS = {"_native_fallback_counter"}

_FALLBACK_FAMILY = "hs_native_fallback_total"


def _in_scope(rel: str) -> bool:
    parts = rel.replace(os.sep, "/").split("/")
    return len(parts) >= 2 and parts[0] == "hyperspace_tpu_torch" and parts[1] == "exec"


def _name_of(node: ast.expr) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _is_native_read(call: ast.Call) -> bool:
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr in _NATIVE_READS:
        return True
    # module-level reader: specifically native.read_columns(...) — the bare
    # name also appears on pyarrow surfaces, so require the native receiver
    return fn.attr == "read_columns" and _name_of(fn.value) == "native"


def _touches_native(try_body: List[ast.stmt]) -> bool:
    for stmt in try_body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and _is_native_read(node):
                return True
    return False


def _handler_accounts(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = _name_of(node.func)
            if name in _CLASSIFIERS or name in _FALLBACK_COUNTERS:
                return True
            # REGISTRY.counter("hs_native_fallback_total", ...) inline
            if (
                name == "counter"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == _FALLBACK_FAMILY
            ):
                return True
    return False


def scan_tree(tree: ast.Module) -> List[ast.ExceptHandler]:
    """Handlers around native decode calls that neither re-raise, classify,
    nor count the fallback."""
    bad: List[ast.ExceptHandler] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        if not _touches_native(node.body):
            continue
        for handler in node.handlers:
            if not _handler_accounts(handler):
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
                        "except around a native decode call is an unaccounted "
                        "pyarrow fallback; re-raise, route through classify()/"
                        "count_io_error()/note_corrupt(), count it in "
                        "hs_native_fallback_total, or carry an explicit pragma"
                    ),
                )
            )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
