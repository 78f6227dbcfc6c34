"""``donated-buffer-reuse``: no reads of a donated device buffer after the
jitted call that donated it.

``donate_argnums`` tells XLA it may alias the argument's memory into the
outputs — after the call, the Python reference still exists but the buffer
is deleted. Reading it raises on TPU and (worse) works by accident on some
backends, so the bug ships silently. This rule tracks names bound to
donation-compiled callables — any call carrying a ``donate_argnums``
keyword, e.g. ``jitted = compile_stage(key, fn, donate_argnums=(0, 1))``
or ``jax.jit(fn, donate_argnums=0)`` — and flags any later read of a name
that was passed in a donated position, until the name is rebound.

Only plain-name positional arguments are tracked (``jitted(*args)`` and
attribute/subscript operands are conservatively skipped); rebinding the
name — idiomatically to the call's own result, ``state = jitted(state)`` —
clears it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "donated-buffer-reuse"


def _donate_positions(call: ast.Call) -> Optional[Tuple[int, ...]]:
    """The literal donate_argnums of a call, or None when absent/dynamic."""
    for kw in call.keywords:
        if kw.arg != "donate_argnums":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, int):
            return (v.value,)
        if isinstance(v, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, int)
            for e in v.elts
        ):
            return tuple(e.value for e in v.elts)
        # dynamic donate_argnums: assume every positional arg may be donated
        return ()
    return None


class _FnScanner:
    """Source-order walk of one function body: track names bound to
    donation-compiled callables, then names passed in donated positions,
    then reads of those names before any rebind."""

    def __init__(self) -> None:
        self.compiled: Dict[str, Tuple[int, ...]] = {}  # callable -> positions
        self.donated: Dict[str, int] = {}  # dead buffer name -> call lineno
        self.hits: List[Tuple[int, str]] = []

    def _note_donating_call(self, call: ast.Call, positions: Tuple[int, ...]) -> None:
        names = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                return  # starred call: positions unknowable, skip the call
            if isinstance(arg, ast.Name) and (not positions or i in positions):
                names.append(arg.id)
        for n in names:
            self.donated[n] = call.lineno

    def visit(self, node: ast.AST) -> None:
        # nested defs get their own scanner pass (scan_tree walks every def)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Assign):
            # evaluation order: value first, then the target stores — so
            # `state = jitted(state)` re-binds the donated name cleanly
            self.visit(node.value)
            if isinstance(node.value, ast.Call) and _donate_positions(node.value) is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.compiled[tgt.id] = _donate_positions(node.value)
            for tgt in node.targets:
                self.visit(tgt)
            return
        if isinstance(node, ast.Call):
            positions = None
            if isinstance(node.func, ast.Name) and node.func.id in self.compiled:
                positions = self.compiled[node.func.id]
            elif isinstance(node.func, ast.Call):
                # direct form: jax.jit(fn, donate_argnums=0)(state, x)
                positions = _donate_positions(node.func)
            if positions is not None:
                # operands of THIS call are the donation itself, not a reuse
                # (a previously-donated operand still flags, via the child
                # visit below, which runs before the donation is recorded)
                for child in ast.iter_child_nodes(node):
                    self.visit(child)
                self._note_donating_call(node, positions)
                return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                self.donated.pop(node.id, None)
            elif isinstance(node.ctx, ast.Load) and node.id in self.donated:
                self.hits.append((
                    node.lineno,
                    f"{node.id!r} was donated at line {self.donated[node.id]} "
                    f"(donate_argnums) — its buffer is deleted; rebind before reuse",
                ))
        for child in ast.iter_child_nodes(node):
            self.visit(child)


def scan_tree(tree: ast.Module) -> List[Tuple[int, str]]:
    hits: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scanner = _FnScanner()
            for stmt in node.body:
                scanner.visit(stmt)
            hits.extend(scanner.hits)
    return sorted(set(hits))


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        for line, msg in scan_tree(ctx.ast_of(path)):
            findings.append(Finding(rule=NAME, path=rel, line=line, message=msg))
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
