"""``jit-purity``: no host-side numpy/time/random calls inside jitted code.

A ``np.*`` call inside a jit-traced function either throws at trace time
(numpy can't handle tracers) or — worse — silently constant-folds against
the example operands and bakes a stale value into the compiled program.
``time.*`` and ``random.*`` always freeze: they run once at trace time and
the compiled executable replays the same value forever. This rule finds
functions that are jitted — decorated with ``jax.jit``/``jit``/
``partial(jax.jit, …)`` or passed by name into a ``*jit*`` wrapper like
``_cached_predicate_jit(key, fn)`` — and flags ``np.``/``numpy.``,
``time.`` and ``random.`` attribute *calls* in their bodies.

Dtype and constant references (``np.int64(n)`` on a concrete python int is
still trace-time, but ``np.float32``/``np.nan``/``np.iinfo`` as dtype
arguments are idiomatic and safe) are whitelisted.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "jit-purity"

_NP_NAMES = ("np", "numpy")
# dtype/constant attributes that are safe as jit-time arguments
_NP_SAFE = {
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool_", "complex64",
    "dtype", "iinfo", "finfo", "nan", "inf", "pi", "e", "newaxis",
}


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


# ``jit`` and ``jax.jit``, as name parts: the port names no module of JAX
# as a dotted string (tests/test_torch_isolation.py)
_JIT_NAMES = {("jit",), ("jax", "jit")}


def _is_jit_name(dotted: Optional[str]) -> bool:
    return dotted is not None and tuple(dotted.split(".")) in _JIT_NAMES


def _is_jit_decorator(dec: ast.AST) -> bool:
    dotted = _dotted(dec)
    if _is_jit_name(dotted):
        return True
    if isinstance(dec, ast.Call):
        callee = _dotted(dec.func)
        if _is_jit_name(callee):
            return True  # @jax.jit(donate_argnums=...)
        if callee in ("partial", "functools.partial") and dec.args:
            return _is_jit_name(_dotted(dec.args[0]))
    return False


def _jitted_by_name(tree: ast.Module) -> Set[str]:
    """Function names passed positionally into any ``*jit*``-named wrapper
    (``jax.jit(fn)``, ``_cached_predicate_jit(key, fn)``, …) or into any
    call carrying a ``donate_argnums`` keyword — the stage compiler
    (``compile_stage(skeleton, fn, donate_argnums=...)``) jits exactly like
    ``jax.jit`` does."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        donating = any(kw.arg == "donate_argnums" for kw in node.keywords)
        if not donating and (
            callee is None or "jit" not in callee.rsplit(".", 1)[-1]
        ):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Name):
                names.add(arg.id)
    return names


def _impure_calls(fn: ast.FunctionDef) -> List[Tuple[int, str]]:
    hits: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted is None or "." not in dotted:
            continue
        head, attr = dotted.split(".", 1)
        leaf = attr.split(".")[0]
        if head in _NP_NAMES and leaf not in _NP_SAFE:
            hits.append((node.lineno, f"host numpy call np.{attr}() inside jitted function {fn.name!r} (use jnp)"))
        elif head == "time":
            hits.append((node.lineno, f"time.{attr}() inside jitted function {fn.name!r} freezes at trace time"))
        elif head == "random" or dotted.startswith(("np.random.", "numpy.random.")):
            hits.append((node.lineno, f"{dotted}() inside jitted function {fn.name!r} freezes at trace time (use jax.random)"))
    return hits


def scan_tree(tree: ast.Module) -> List[Tuple[int, str]]:
    by_name = _jitted_by_name(tree)
    hits: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        jitted = node.name in by_name or any(_is_jit_decorator(d) for d in node.decorator_list)
        if jitted:
            hits.extend(_impure_calls(node))
    return sorted(set(hits))


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        for line, msg in scan_tree(ctx.ast_of(path)):
            findings.append(Finding(rule=NAME, path=rel, line=line, message=msg))
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
