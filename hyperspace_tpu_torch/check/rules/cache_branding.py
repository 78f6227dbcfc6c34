"""``cache-branding``: pruning provenance must reach the cache key.

Device-cache entries are branded by ``scan_key`` (immutable file-set
identity, extended with the pushed row-group predicate via
``_pruned_scan_key``). A call site that drops the branding kwarg doesn't
fail — it silently caches under the unpruned key, so a later scan with a
*different* pushed predicate reuses stale device buffers. This rule
enforces the three call-site contracts:

1. ``…._filter_mask(...)`` must pass ``pruned_by=`` explicitly,
2. ``device_filter_mask(...)`` must pass ``scan_key=`` (kwarg or the
   4th positional),
3. ``stage_filter_columns(...)`` must pass ``scan_key`` likewise.

``scan_key=None`` / ``pruned_by=None`` is fine — that is an explicit
"transient batch, don't cache" decision, visible at the call site.
"""

from __future__ import annotations

import ast
from typing import List

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "cache-branding"

# callee name -> (required kwarg, positional index that also satisfies it)
_CONTRACTS = {
    "_filter_mask": ("pruned_by", None),
    "device_filter_mask": ("scan_key", 3),
    "stage_filter_columns": ("scan_key", 3),
}


def _callee_name(fn: ast.AST):
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def scan_tree(tree: ast.Module) -> List[ast.Call]:
    """Calls in the tree that violate a branding contract."""
    bad: List[ast.Call] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _callee_name(node.func)
        contract = _CONTRACTS.get(name)
        if contract is None:
            continue
        kwarg, pos = contract
        if any(kw.arg == kwarg for kw in node.keywords):
            continue
        if any(kw.arg is None for kw in node.keywords):
            continue  # **kwargs forwarding — assume the caller threads it
        if pos is not None and len(node.args) > pos:
            continue
        bad.append(node)
    return bad


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        for call in scan_tree(ctx.ast_of(path)):
            name = _callee_name(call.func)
            kwarg, _ = _CONTRACTS[name]
            findings.append(
                Finding(
                    rule=NAME,
                    path=rel,
                    line=call.lineno,
                    message=(
                        f"call to {name}() drops the cache-branding kwarg {kwarg!r}; "
                        f"pass {kwarg}=... explicitly (None is fine, silence is not)"
                    ),
                )
            )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
