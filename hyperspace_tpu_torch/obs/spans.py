"""Hierarchical span tracer: context-propagated timing trees per query.

The reference delegates runtime introspection to the Spark UI (SURVEY.md
§5.1); this framework owns its execution layer, so it owns the equivalent
surface too. A *trace* is one tree of :class:`Span`s covering a query's
lifecycle (parse -> resolve -> rewrite -> compile -> per-operator execute);
the *current* span is carried in a :mod:`contextvars` variable, so

- concurrent queries (``QueryServer`` workers, one request per context) get
  **disjoint** span trees — unlike ``exec/trace.py``'s process-global
  recording, which interleaves events from concurrent queries;
- helper threads (the parquet decode pool, prefetchers) join the submitting
  request's tree via :func:`wrap`/:func:`attach` instead of a global.

Overhead discipline: when no trace is active, :func:`span` performs ONE
contextvar read and returns a shared no-op context manager — no allocation,
no lock. That is what lets instrumentation points stay unconditionally in
the hot paths (bench.py ``--obs-overhead`` pins the bar).

Export: :func:`to_chrome_trace` renders a finished trace as Chrome
trace-event JSON (``{"traceEvents": [...]}``, complete ``"ph": "X"`` events)
loadable in Perfetto / ``chrome://tracing``.

Distributed traces (docs/observability.md "Distributed tracing"): a
:class:`TraceContext` is the W3C-traceparent-shaped identity that crosses
process boundaries — the FrontDoor stamps it on ``/query`` requests, the
worker binds it via :func:`bind_context` so its tree carries the router's
``trace_id``, and :func:`to_wire`/:func:`from_wire`/:func:`graft_remote`
move the worker's finished (bounded) span tree back into the router's tree
with per-process ``pid`` attribution.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Trace",
    "TraceContext",
    "span",
    "trace",
    "start_trace",
    "current_span",
    "current_context",
    "bind_context",
    "parse_traceparent",
    "attach",
    "wrap",
    "add_manual",
    "to_wire",
    "from_wire",
    "graft_remote",
    "graft_span",
    "to_chrome_trace",
]

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "hs_obs_current_span", default=None
)

_context: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "hs_obs_trace_context", default=None
)


class TraceContext:
    """W3C-traceparent-shaped trace identity that crosses process hops.

    ``trace_id`` (32 hex chars) names the end-to-end request; ``span_id``
    (16 hex chars) names the sender's active span, which the receiver
    records as its parent. ``sampled`` carries the sender's keep/drop
    decision so a worker never traces a request its router is not keeping.
    """

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    @classmethod
    def new(cls, sampled: bool = True) -> "TraceContext":
        return cls(os.urandom(16).hex(), os.urandom(8).hex(), sampled)

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — what an attempt/hedge hop sends."""
        return TraceContext(self.trace_id, os.urandom(8).hex(), self.sampled)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    def __repr__(self) -> str:
        return f"TraceContext({self.to_traceparent()})"


def parse_traceparent(header: Optional[str]) -> Optional["TraceContext"]:
    """Parse a ``traceparent`` header; None on anything malformed (an
    unparseable header must degrade to an untraced request, never a 500)."""
    if not header:
        return None
    parts = str(header).strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(trace_id) != 32 or len(span_id) != 16 or len(version) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


def current_context() -> Optional[TraceContext]:
    """The context's active :class:`TraceContext` (None when untraced)."""
    return _context.get()


@contextlib.contextmanager
def bind_context(ctx: Optional[TraceContext]):
    """Make ``ctx`` the context's trace identity for the block; ``None`` is
    a no-op so callers can pass a maybe-absent context."""
    if ctx is None:
        yield None
        return
    token = _context.set(ctx)
    try:
        yield ctx
    finally:
        _context.reset(token)


class Trace:
    """Shared per-tree state: the span budget that bounds trace memory.

    ``count``/``dropped`` updates ride the GIL (int attribute bumps from
    worker threads may lose a tick under contention; the budget is a memory
    guard, not an invariant, and a lock here would tax every span).
    """

    __slots__ = ("max_spans", "count", "dropped")

    def __init__(self, max_spans: int):
        self.max_spans = int(max_spans)
        self.count = 1  # the root
        self.dropped = 0


class Span:
    """One timed node. ``t0``/``t1`` are ``time.perf_counter()`` readings;
    ``attrs`` carries operator facts (rows, bytes, index names); ``events``
    carries point annotations (the dispatch-trace kind/detail pairs)."""

    __slots__ = ("name", "cat", "t0", "t1", "attrs", "events", "children", "tid", "trace", "pid")

    def __init__(self, name: str, cat: str = "", trace: Optional[Trace] = None):
        self.name = name
        self.cat = cat
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = {}
        self.events: List = []
        self.children: List["Span"] = []
        self.tid = threading.get_ident()
        self.trace = trace
        # process attribution for stitched cross-process trees: None means
        # "this process"; grafted remote spans carry their origin's os pid
        self.pid: Optional[int] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, kind: str, detail: str) -> None:
        """Point annotation (no duration) — the dispatch-trace shape."""
        self.events.append((kind, detail))

    def finish(self) -> "Span":
        if self.t1 is None:
            self.t1 = time.perf_counter()
        return self

    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return max(0.0, end - self.t0)

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in list(self.children):
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.duration_s * 1e3:.3f} ms, children={len(self.children)})"


class _NullSpan:
    """Shared do-nothing span handed out when no trace is active."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def event(self, kind: str, detail: str) -> None:
        pass


class _NullCM:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()
_NULL_CM = _NullCM()


class _SpanCM:
    """Context manager creating a child of ``parent`` and making it current.

    Class-based (not a generator) so the disabled path stays allocation-free
    and the enabled path costs one object + one contextvar set/reset.
    """

    __slots__ = ("_parent", "_name", "_cat", "_attrs", "_span", "_token")

    def __init__(self, parent: Span, name: str, cat: str, attrs: Optional[dict]):
        self._parent = parent
        self._name = name
        self._cat = cat
        self._attrs = attrs
        self._span: Any = None
        self._token = None

    def __enter__(self):
        tr = self._parent.trace
        if tr is not None and tr.count >= tr.max_spans:
            # budget exhausted: keep timing the query via the existing spans,
            # just stop growing the tree (bounded memory under pathological
            # plans); droppage is visible on the trace for honesty
            tr.dropped += 1
            self._span = NULL_SPAN
            return NULL_SPAN
        if tr is not None:
            tr.count += 1
        sp = Span(self._name, self._cat, trace=tr)
        if self._attrs:
            sp.attrs.update(self._attrs)
        self._parent.children.append(sp)  # list.append: atomic under the GIL
        self._span = sp
        self._token = _current.set(sp)
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            if exc_type is not None:
                self._span.attrs.setdefault("error", exc_type.__name__)
            self._span.finish()
        return False


def current_span() -> Optional[Span]:
    """The context's active span, or None when no trace is running here."""
    return _current.get()


def span(name: str, cat: str = "", **attrs):
    """Open a child span of the context's current span.

    When no trace is active this is the near-zero-overhead no-op path: one
    contextvar read, a shared null context manager back.
    """
    parent = _current.get()
    if parent is None:
        return _NULL_CM
    return _SpanCM(parent, name, cat, attrs or None)


_DEFAULT_MAX_SPANS = 100_000


def start_trace(name: str, cat: str = "query", max_spans: Optional[int] = None, **attrs) -> Span:
    """Create a detached root span (NOT made current) — for request objects
    whose lifecycle crosses threads (``QueryServer``): the submitting thread
    creates the root, each worker :func:`attach`-es it around its stage.
    Call ``root.finish()`` when the request completes."""
    root = Span(name, cat, trace=Trace(max_spans or _DEFAULT_MAX_SPANS))
    if attrs:
        root.attrs.update(attrs)
    return root


@contextlib.contextmanager
def trace(name: str, cat: str = "query", max_spans: Optional[int] = None, **attrs):
    """Root a new trace in this context for the duration of the block."""
    root = start_trace(name, cat, max_spans=max_spans, **attrs)
    token = _current.set(root)
    try:
        yield root
    finally:
        _current.reset(token)
        root.finish()


@contextlib.contextmanager
def attach(sp: Optional[Span]):
    """Make ``sp`` the context's current span (worker-thread propagation).
    ``attach(None)`` is a no-op, so callers can pass a maybe-absent root."""
    if sp is None:
        yield None
        return
    token = _current.set(sp)
    try:
        yield sp
    finally:
        _current.reset(token)


def wrap(fn):
    """Bind the *caller's* current span into ``fn`` so pool workers land
    their spans in the submitting request's tree. Identity when no trace is
    active (no wrapper allocation on the disabled path)."""
    parent = _current.get()
    if parent is None:
        return fn

    def inner(*args, **kwargs):
        token = _current.set(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)

    return inner


def add_manual(parent: Span, name: str, cat: str, t0: float, t1: float, **attrs) -> Optional[Span]:
    """Append an already-timed child (perf_counter readings) to ``parent`` —
    for work executed once on behalf of several requests (shared-scan
    micro-batches), where each request's tree records its share after the
    fact. Returns None when the parent's span budget is exhausted."""
    tr = parent.trace
    if tr is not None:
        if tr.count >= tr.max_spans:
            tr.dropped += 1
            return None
        tr.count += 1
    sp = Span(name, cat, trace=tr)
    sp.t0, sp.t1 = t0, t1
    if attrs:
        sp.attrs.update(attrs)
    parent.children.append(sp)
    return sp


# --------------------------------------------------------------------------
# Cross-process stitching: bounded wire serialization + grafting
# --------------------------------------------------------------------------


def _span_to_dict(sp: Span, base: float, budget: List[int]) -> Optional[Dict[str, Any]]:
    """One span as a JSON-able dict with times relative to ``base`` (the
    serialized root's t0, in seconds). ``budget[0]`` is the remaining span
    allowance; a subtree past it is dropped (tree-prefix truncation keeps
    parentage valid) and counted in ``budget[1]``."""
    if budget[0] <= 0:
        budget[1] += sum(1 for _ in sp.walk())
        return None
    budget[0] -= 1
    end = sp.t1 if sp.t1 is not None else time.perf_counter()
    out: Dict[str, Any] = {
        "name": sp.name,
        "cat": sp.cat,
        "start": round(sp.t0 - base, 9),
        "dur": round(max(0.0, end - sp.t0), 9),
        "tid": sp.tid,
    }
    if sp.attrs:
        out["attrs"] = {k: _jsonable(v) for k, v in sp.attrs.items()}
    if sp.events:
        out["events"] = [[k, d] for k, d in sp.events]
    kids = []
    for c in list(sp.children):
        d = _span_to_dict(c, base, budget)
        if d is not None:
            kids.append(d)
    if kids:
        out["children"] = kids
    return out


def to_wire(
    root: Span, max_spans: int = 512, max_bytes: int = 262144
) -> Dict[str, Any]:
    """Serialize a finished span tree for the ``/query`` response.

    Doubly bounded: at most ``max_spans`` spans survive (tree-prefix
    truncation, remainder counted in ``droppedSpans``), and if the JSON
    encoding still exceeds ``max_bytes`` the payload degrades to the root
    alone with ``truncated: true`` — a worker must never inflate a response
    past the router's stated budget.
    """
    budget = [max(1, int(max_spans)), 0]
    tree = _span_to_dict(root, root.t0, budget)
    out: Dict[str, Any] = {"root": tree}
    dropped = budget[1]
    if root.trace is not None and root.trace.dropped:
        dropped += root.trace.dropped
    if dropped:
        out["droppedSpans"] = int(dropped)
    encoded = json.dumps(out, default=str)
    if len(encoded) > int(max_bytes):
        solo = dict(tree)
        solo.pop("children", None)
        out = {"root": solo, "truncated": True}
        if dropped:
            out["droppedSpans"] = int(dropped)
    return out


def _span_from_dict(
    d: Dict[str, Any], shift: float, pid: Optional[int], trace: Optional[Trace]
) -> Span:
    sp = Span.__new__(Span)
    sp.name = str(d.get("name", "?"))
    sp.cat = str(d.get("cat", ""))
    sp.t0 = float(d.get("start", 0.0)) + shift
    sp.t1 = sp.t0 + float(d.get("dur", 0.0))
    sp.attrs = dict(d.get("attrs") or {})
    sp.events = [tuple(e) for e in (d.get("events") or [])]
    sp.tid = int(d.get("tid", 0))
    sp.trace = trace
    sp.pid = pid
    sp.children = [
        _span_from_dict(c, shift, pid, trace) for c in (d.get("children") or [])
    ]
    return sp


def from_wire(
    wire: Dict[str, Any], anchor_t0: Optional[float] = None, pid: Optional[int] = None
) -> Optional[Span]:
    """Rebuild a :func:`to_wire` payload as a local Span tree.

    ``anchor_t0`` (a local ``perf_counter`` reading, normally the dispatch
    span's start) re-bases the remote tree's relative times onto this
    process's clock: remote offsets are exact *within* the remote tree, but
    the anchor inherits the network hop — cross-process alignment is
    approximate by one request latency, which is the honest best available
    without synchronized clocks.
    """
    tree = (wire or {}).get("root")
    if not isinstance(tree, dict):
        return None
    shift = time.perf_counter() if anchor_t0 is None else float(anchor_t0)
    return _span_from_dict(tree, shift, pid, None)


def graft_span(parent: Span, child_root: Optional[Span]) -> Optional[Span]:
    """Attach an existing span tree under ``parent``, charging the subtree
    against the parent's trace budget (overflow counts as dropped, and the
    subtree is kept whole — grafting never slices a remote tree)."""
    if child_root is None:
        return None
    size = sum(1 for _ in child_root.walk())
    tr = parent.trace
    if tr is not None:
        if tr.count + size > tr.max_spans:
            tr.dropped += size
            return None
        tr.count += size
        for sp in child_root.walk():
            sp.trace = tr
    parent.children.append(child_root)
    return child_root


def graft_remote(
    parent: Span,
    wire: Dict[str, Any],
    pid: Optional[int] = None,
    anchor_t0: Optional[float] = None,
) -> Optional[Span]:
    """Rebuild a worker's wire payload and graft it under ``parent`` (the
    router's dispatch span). Returns the grafted root, or None when the
    payload is empty/unparseable or the local budget rejects it."""
    remote = from_wire(
        wire, anchor_t0=parent.t0 if anchor_t0 is None else anchor_t0, pid=pid
    )
    if remote is None:
        return None
    dropped = int((wire or {}).get("droppedSpans", 0) or 0)
    if dropped:
        remote.attrs.setdefault("dropped_spans", dropped)
    if (wire or {}).get("truncated"):
        remote.attrs.setdefault("truncated", True)
    return graft_span(parent, remote)


# --------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# --------------------------------------------------------------------------


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def to_chrome_trace(root: Span, pid: Optional[int] = None) -> Dict[str, Any]:
    """Render a finished trace as the Chrome trace-event JSON object.

    Complete events (``"ph": "X"``) with microsecond ``ts``/``dur`` relative
    to the root's start; ``tid`` is the OS thread that ran the span, so
    decode-pool work shows on its own tracks. Dispatch events attach under
    ``args.events`` as ``"kind: detail"`` strings.
    """
    if pid is None:
        pid = os.getpid()
    base = root.t0
    events: List[Dict[str, Any]] = []
    events.append(
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "hyperspace_tpu_torch"},
        }
    )
    named_pids = {pid}
    for sp in root.walk():
        sp_pid = sp.pid if sp.pid is not None else pid
        if sp_pid not in named_pids:
            # stitched remote spans show on their own process track, named
            # by the worker that produced them when the graft recorded one
            named_pids.add(sp_pid)
            server = sp.attrs.get("server")
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": sp_pid,
                    "tid": 0,
                    "args": {
                        "name": f"hyperspace_tpu_torch worker {server}" if server
                        else f"hyperspace_tpu_torch pid {sp_pid}"
                    },
                }
            )
        end = sp.t1 if sp.t1 is not None else time.perf_counter()
        args = {k: _jsonable(v) for k, v in sp.attrs.items()}
        if sp.events:
            args["events"] = [f"{k}: {d}" for k, d in sp.events]
        events.append(
            {
                "name": sp.name,
                "cat": sp.cat or "span",
                "ph": "X",
                "ts": round((sp.t0 - base) * 1e6, 3),
                "dur": round(max(0.0, end - sp.t0) * 1e6, 3),
                "pid": sp_pid,
                "tid": sp.tid,
                "args": args,
            }
        )
    out: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    tr = root.trace
    if tr is not None and tr.dropped:
        out["otherData"] = {"droppedSpans": tr.dropped}
    return out
