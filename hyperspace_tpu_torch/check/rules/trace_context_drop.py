"""``trace-context-drop``: fabric request paths must carry the trace context.

Distributed traces (docs/observability.md) only stitch into one tree when
every hop carries the ``TraceContext``: the context lives in a contextvar,
so it silently evaporates at exactly two seams — a ``threading.Thread``
(contextvars do not cross thread creation unless the target is wrapped)
and an outbound HTTP hop (the remote process never sees the context unless
a ``traceparent`` header is sent). A dropped context is invisible in tests
that assert on results; it only shows up later as an orphaned worker tree.
This rule makes both seams explicit in ``fabric/`` and ``serving/``:

- **Thread spawn in a request-shaped function**: a ``Thread(...)``
  construction inside a function whose body handles request state (names
  ``sql``, ``query``, ``tenant`` or ``request`` appear) must show a
  propagation marker somewhere in that function — ``spans.attach(...)``,
  ``spans.wrap(...)`` or ``spans.bind_context(...)`` (the hedged-dispatch
  idiom in ``fabric/frontdoor.py``). Lifecycle threads (pollers,
  heartbeats, serve loops) reference no request state and stay clean.
- **``urlopen`` of a ``/query`` URL**: a function that fetches a worker's
  ``/query`` endpoint must reference ``traceparent`` (building the header
  inline), call a ``*trace_headers*`` helper, or call ``to_traceparent()``.
  Metrics/healthz/statusz/profilez fetches carry no request context and
  are out of scope by URL.

Intentionally context-free sites annotate the spawning/fetching line with
``# hscheck: disable=trace-context-drop``.

Scope: ``hyperspace_tpu_torch/fabric/`` and ``hyperspace_tpu_torch/serving/`` (the
layers that move requests between threads and processes); explicit fixture
paths are checked wherever they live.
"""

from __future__ import annotations

import ast
import os
from typing import List, Set, Tuple

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "trace-context-drop"

#: directories whose request paths must propagate trace context
_SCOPE_DIRS = ("fabric", "serving")

#: names whose presence marks a function as handling request state
_REQUEST_IDENTS = {"sql", "query", "tenant", "request"}

#: attribute/function names that count as context propagation across threads
_THREAD_MARKERS = {"attach", "wrap", "bind_context"}

#: attribute/function names that count as header propagation across HTTP
_HTTP_MARKER_SUBSTRINGS = ("trace_headers", "to_traceparent")


def _in_scope(rel: str) -> bool:
    parts = rel.replace(os.sep, "/").split("/")
    return (
        len(parts) >= 2
        and parts[0] == "hyperspace_tpu_torch"
        and parts[1] in _SCOPE_DIRS
    )


def _call_name(func: ast.expr) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _outer_functions(tree: ast.Module):
    """Module-level functions and class methods — the scope a spawned
    thread's closure actually shares, nested defs included in the subtree."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield sub


def scan_function(fn) -> List[Tuple[str, int]]:
    """(kind, lineno) for every context-dropping seam in this function."""
    thread_lines: List[int] = []
    urlopen_lines: List[int] = []
    idents: Set[str] = set()
    attrs: Set[str] = set()
    strings: List[str] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name == "Thread":
                thread_lines.append(node.lineno)
            elif name == "urlopen":
                urlopen_lines.append(node.lineno)
        if isinstance(node, ast.Name):
            idents.add(node.id)
        elif isinstance(node, ast.arg):
            idents.add(node.arg)
        elif isinstance(node, ast.Attribute):
            attrs.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)

    out: List[Tuple[str, int]] = []
    request_shaped = bool(_REQUEST_IDENTS & idents)
    thread_propagates = bool(_THREAD_MARKERS & (attrs | idents)) or (
        "TraceContext" in idents or "TraceContext" in attrs
    )
    if request_shaped and not thread_propagates:
        out.extend(("thread", ln) for ln in thread_lines)

    hits_query = any("/query" in s for s in strings)
    http_propagates = (
        any("traceparent" in s for s in strings)
        or any(
            sub in a for a in (attrs | idents) for sub in _HTTP_MARKER_SUBSTRINGS
        )
    )
    if hits_query and not http_propagates:
        out.extend(("http", ln) for ln in urlopen_lines)
    return out


_MESSAGES = {
    "thread": (
        "Thread spawned in a request-handling function without a trace "
        "propagation marker (spans.attach/spans.wrap/spans.bind_context): "
        "the contextvar trace context does not cross thread creation, so "
        "spans on the new thread orphan from the request tree; wrap the "
        "target or mark the spawn '# hscheck: disable=trace-context-drop'"
    ),
    "http": (
        "urlopen of a /query endpoint without a traceparent header: the "
        "remote worker starts a fresh trace instead of joining this one; "
        "send TraceContext.to_traceparent() (or a *trace_headers* helper), "
        "or mark the fetch '# hscheck: disable=trace-context-drop'"
    ),
}


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for path in ctx.files:
        rel = ctx.relpath(path)
        if ctx.full_scope and not _in_scope(rel):
            continue
        for fn in _outer_functions(ctx.ast_of(path)):
            for kind, lineno in scan_function(fn):
                findings.append(
                    Finding(rule=NAME, path=rel, line=lineno, message=_MESSAGES[kind])
                )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
