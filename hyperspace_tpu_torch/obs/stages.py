"""The stage clock: the one way the port times a stage of a query or a build.

A stage is a named interval of host work (``decode``, ``agg_program``,
``resolve``, ...). Each key belongs to exactly one layer (:data:`LAYERS`,
the layers of ``PERF.md``'s table), and every stage does, always:

- add its wall seconds to the session's ``query_stage_seconds[key]`` (a
  build layer's to ``build_stage_seconds``) under one lock, so concurrent
  serving workers lose no update; on a scan pipeline's producer thread a
  query stage's key is ``prefetch_<key>``, since that time overlaps the
  consumer's;
- read the thread's CPU time at its start and end.

Besides, only when each is on:

- with request clocks bound in the context (:class:`bind`, which the
  serving workers enter wherever they attach a request's span root), it
  charges itself to each of them (:class:`RequestClock`);
- with an obs trace active, it opens a span named by its key whose ``cat``
  is its layer (and no other span times the same interval);
- under ``torch.profiler``, it opens a ``record_function`` range
  ``hs:<layer>:<key>``, so a profile recording CPU and CUDA activity shows
  the port's layers on the kernels' clock, each range's kernels beneath it.

With neither a trace nor a profiler on, a stage costs a ``perf_counter`` and
a ``thread_time`` pair, one lock, two contextvar reads and one thread-local
read, and makes no span and no ``record_function`` call.

Use it as a context manager, or in the chained style of the call sites::

    with stage(session, "join_keys") as st:
        ...
        st.next("join_upload")   # closes join_keys, opens join_upload
        ...

This module imports only the standard library; ``torch`` is looked up in
``sys.modules`` when a stage starts.
"""

from __future__ import annotations

import contextvars
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from hyperspace_tpu_torch.obs import spans

__all__ = ["LAYERS", "RequestClock", "Stage", "bind", "layer_of", "on_producer_thread", "seal", "stage",
           "start", "timed"]

SERVING = "serving"
ADMISSION = "serving admission"
PLAN = "plan and rewrite"
SOURCES = "sources and decode"
HOST_OPS = "host operators"
DEVICE = "device programs"
HOST_THREADS = "host threads"
BUILD = "index build"

#: every stage key (and derived key) -> its layer; ``prefetch_<key>`` is its
#: key's layer
LAYERS: Dict[str, str] = {
    # serving
    "finish": SERVING,  # relabel, result-cache put, profile, history, SLO, flight recorder, the future
    "request": SERVING,  # derived: a request's wall from entry to submit to its seal
    "unattributed": SERVING,  # derived: request less its queue wait and its outermost stages
    "admit": ADMISSION,  # in submit: snapshot capture, session token, cost class, result-cache brand
    # plan and rewrite
    "parse": PLAN,  # in submit: the SQL text's parse and memo, the plan fingerprint
    "resolve": PLAN,  # plan-cache lookup and bind; the optimize and prune on a miss
    "rewrite": PLAN,  # DataFrame.optimized_plan
    # sources and decode: file reads, stat sweeps, footer reads, waits for
    # a producer's decode
    "decode": SOURCES,  # a scan's file read
    "bucket_read": SOURCES,  # an index scan through the serving bucket cache (a miss decodes)
    "join_decode": SOURCES,  # both join sides' per-bucket decode, sort and side filters
    "scan_identity": SOURCES,  # stat sweep: the device column cache's key of a scan
    "stream_gate": SOURCES,  # stat sweep: a streamed path's size gate and file groups
    "broadcast_gate": SOURCES,  # stat sweep: the broadcast join's size estimate
    "build_identity": SOURCES,  # stat sweep and brand: the join build cache's key
    "join_plan": SOURCES,  # join compatibility, footer row counts, the input-size stat
    "stream_wait": SOURCES,  # the consumer's wait for a pipeline producer
    # host operators
    "mask_rows": HOST_OPS,
    "host_predicate": HOST_OPS,
    "agg_host": HOST_OPS,
    "agg_finalize": HOST_OPS,  # a device aggregate's result columns; the streamed combine
    "agg_join": HOST_OPS,  # aggregates over the bucketed join's spans
    "join_merge": HOST_OPS,  # the generic merge
    "join_keys": HOST_OPS,  # key encoding, the key cache's stat, the key rectangles
    "join_host_expand": HOST_OPS,  # host spans, pair expansion and gathers
    "join_verify": HOST_OPS,  # the broadcast join's exact key check
    "join_gather": HOST_OPS,
    "join_postjoin": HOST_OPS,
    "join_fold": HOST_OPS,  # the streamed join's concatenation
    # device programs: host wall around them, their waits included
    "upload": DEVICE,  # encode and copy of the columns the device cache misses
    "h2d_stage": DEVICE,  # a pipeline producer's staging of filter columns
    "agg_upload": DEVICE,
    "predicate_launch": DEVICE,  # compile, literal upload, enqueue
    "wait_copy_mask": DEVICE,  # the wait for the program and the mask's copy back
    "agg_program": DEVICE,
    "agg_merge": DEVICE,
    "lineage": DEVICE,
    "join_upload": DEVICE,
    "join_span": DEVICE,
    "join_materialize": DEVICE,  # pair totals, expand-gather, the copies back
    "join_build": DEVICE,
    "join_probe": DEVICE,
    "topk_fold": DEVICE,
    # host threads
    "host_wait": HOST_THREADS,  # derived: wall less thread CPU of a request's outermost host stages
    # index build (``build_stage_seconds``)
    "key_decode": BUILD,
    "encode_keys": BUILD,
    "upload_launch": BUILD,
    "payload_decode": BUILD,
    "device_wait_fetch": BUILD,  # the wait for the device pass, the permutation's copy back
    "take_write": BUILD,
}

PREFETCH = "prefetch_"

_LOCK = threading.Lock()
_CLOCKS: "contextvars.ContextVar[Tuple[RequestClock, ...]]" = contextvars.ContextVar(
    "hs_stage_request_clocks", default=()
)


class _Producer(threading.local):
    active = False  # a class default: a thread that never set it reads it without a miss


#: set by the scan pipeline around each producer task (exec/pipeline.py)
PRODUCER = _Producer()

_perf = time.perf_counter
_cpu = time.thread_time


def on_producer_thread() -> bool:
    """Whether the caller runs inside a pipeline task (its time overlaps the
    consumer's)."""
    return PRODUCER.active


def layer_of(key: str) -> str:
    """The layer of a stage key (``prefetch_<key>`` too); KeyError for a key
    :data:`LAYERS` does not name."""
    return LAYERS[key[len(PREFETCH):] if key.startswith(PREFETCH) else key]


class RequestClock:
    """One served request's account on ``time.perf_counter``: started on
    entry to ``QueryServer.submit``, sealed with its completion (:func:`seal`).

    ``attributed_s`` sums the outermost stages charged to the request (a
    nested stage's interval is its parent's); ``host_wait_s`` sums wall minus
    thread CPU time of those outside the device-program layer; ``seconds``
    holds every charged stage's wall by key, nested ones too. A clock is
    charged from one thread at a time: the submitting thread, then a worker.
    """

    __slots__ = ("root", "t0", "queue_s", "request_s", "attributed_s", "host_wait_s", "seconds", "sealed",
                 "_depth", "_open_key", "_open_t0", "_open_c0", "_open_host")

    def __init__(self, root=None):
        self.t0 = _perf()
        #: the request's obs span root, attached wherever the clock is bound
        self.root = root
        self.queue_s = 0.0
        self.request_s = 0.0
        self.attributed_s = 0.0
        self.host_wait_s = 0.0
        self.seconds: Dict[str, float] = {}
        self.sealed = False
        self._depth = 0
        self._open_key = ""
        self._open_t0 = 0.0
        self._open_c0 = 0.0
        self._open_host = False

    @property
    def unattributed_s(self) -> float:
        """The request's wall outside the admission queue and every stage."""
        return self.request_s - self.queue_s - self.attributed_s

    def _open(self, key: str, t0: float, c0: float, host: bool) -> None:
        if self._depth == 0:
            self._open_key, self._open_t0, self._open_c0, self._open_host = key, t0, c0, host
        self._depth += 1

    def _close(self, key: str, t1: float, c1: float, wall: float) -> None:
        self._depth -= 1
        if self.sealed:
            return
        self.seconds[key] = self.seconds.get(key, 0.0) + wall
        if self._depth == 0:
            self._charge(t1, c1)

    def _charge(self, t1: float, c1: float) -> None:
        self.attributed_s += t1 - self._open_t0
        if self._open_host:
            self.host_wait_s += max(0.0, (t1 - self._open_t0) - (c1 - self._open_c0))


def seal(session, clock: RequestClock, enqueued_at: Optional[float], dequeued_at: Optional[float]) -> None:
    """Stop ``clock`` now and add its ``request``, ``unattributed`` and
    ``host_wait`` seconds to the session's stage clock. A stage still open
    (the server's ``finish``) counts up to now. The queue wait runs from
    ``enqueued_at`` to ``dequeued_at`` (to the open stage's start for a
    request that expired in the queue); a request never queued waited none."""
    t1, c1 = _perf(), _cpu()
    if clock.sealed:
        return
    if clock._depth:
        # the outermost stage still open (the server's finish) counts to now
        clock._charge(t1, c1)
        key = clock._open_key
        clock.seconds[key] = clock.seconds.get(key, 0.0) + (t1 - clock._open_t0)
    clock.sealed = True
    if enqueued_at is not None:
        end = dequeued_at if dequeued_at is not None else (clock._open_t0 if clock._depth else t1)
        clock.queue_s = max(0.0, end - enqueued_at)
    clock.request_s = t1 - clock.t0
    c = session.query_stage_seconds
    with _LOCK:
        c["request"] += clock.request_s
        c["unattributed"] += clock.unattributed_s
        c["host_wait"] += clock.host_wait_s


class bind:
    """Charge the context's stages to ``clocks`` for the block; with one
    clock, its span root is the context's current span too (what
    ``spans.attach(root)`` did)."""

    __slots__ = ("_clocks", "_token", "_attach")

    def __init__(self, *clocks: RequestClock):
        self._clocks = clocks
        self._token = None
        self._attach = None

    def __enter__(self) -> "bind":
        self._token = _CLOCKS.set(self._clocks)
        if len(self._clocks) == 1 and self._clocks[0].root is not None:
            self._attach = spans.attach(self._clocks[0].root)
            self._attach.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._attach is not None:
            self._attach.__exit__(None, None, None)
            self._attach = None
        _CLOCKS.reset(self._token)
        return False


class Stage:
    """One timed stage; see the module docstring. Reusable through
    :meth:`next`, which closes it and opens the next key on the same
    object."""

    __slots__ = ("_session", "key", "_layer", "_attrs", "_counter", "_t0", "_c0", "_clocks", "_span_cm", "_span",
                 "_range")

    def __init__(self, session, key: str, attrs: Optional[dict] = None):
        self._session = session
        self.key = key
        self._layer = layer_of(key)
        self._attrs = attrs
        self._span_cm = self._span = self._range = None

    def _start(self) -> "Stage":
        key, layer, session = self.key, self._layer, self._session
        if layer == BUILD:
            self._counter = session.build_stage_seconds if session is not None else None
        else:
            self._counter = session.query_stage_seconds if session is not None else None
            if PRODUCER.active and not key.startswith(PREFETCH):
                key = self.key = PREFETCH + key
        if spans.current_span() is not None:
            self._span_cm = spans.span(key, layer, **(self._attrs or {}))
            self._span = self._span_cm.__enter__()
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            self._range = prof.record_function(f"hs:{layer}:{key}")
            self._range.__enter__()
        self._clocks = clocks = _CLOCKS.get()
        self._c0 = c0 = _cpu()
        self._t0 = t0 = _perf()
        for c in clocks:
            c._open(key, t0, c0, layer != DEVICE)
        return self

    def stop(self, error: Optional[BaseException] = None) -> None:
        """Close the stage (``error``: the exception that ends it, for its span)."""
        t1 = _perf()
        c1 = _cpu()
        wall = t1 - self._t0
        if self._counter is not None:
            with _LOCK:
                self._counter[self.key] += wall
        for c in self._clocks:
            c._close(self.key, t1, c1, wall)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._span_cm is not None:
            self._span_cm.__exit__(type(error) if error is not None else None, error, None)
            self._span_cm = self._span = None

    def next(self, key: str) -> "Stage":
        """Close this stage and open ``key`` in its place (chained style)."""
        self.stop()
        self.key = key
        self._layer = layer_of(key)
        self._attrs = None
        return self._start()

    def set(self, **attrs) -> "Stage":
        """Annotate the stage's span (a no-op without a trace)."""
        if self._span is not None:
            self._span.set(**attrs)
        return self

    def __enter__(self) -> "Stage":
        return self._start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop(exc)
        return False


def stage(session, key: str, **attrs) -> Stage:
    """A stage of ``session`` under ``key``, started on ``with`` entry;
    ``attrs`` go on its span."""
    return Stage(session, key, attrs or None)


def start(session, key: str, **attrs) -> Stage:
    """A stage started now; close it with :meth:`Stage.stop` (or
    :meth:`Stage.next`) on every path."""
    return Stage(session, key, attrs or None)._start()


def timed(session, key: str, iterable):
    """Iterate ``iterable``, timing each step's wait under ``key`` (no stage
    stays open across a yield)."""
    it = iter(iterable)
    while True:
        with Stage(session, key):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item
