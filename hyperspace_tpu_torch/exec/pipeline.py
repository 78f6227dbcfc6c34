"""Bounded prefetching pipeline: the streamed scan's decode, staging and
compute overlap.

The port of the JAX package's ``hyperspace_tpu/exec/pipeline.py``. Stages:

  1. **host decode**: chunk k+1's parquet decode runs on the pipeline pool
     (fanning out per file onto the decode pool of exec/io.py);
  2. **staging**: an optional ``stage`` hook runs right after the decode on
     the same worker thread, typically ``device.stage_filter_columns``: it
     encodes the chunk's predicate and aggregate columns and copies them to
     the device on a side stream of its own, so the consumer finds them in
     the device column cache;
  3. **compute**: the consumer thread runs chunk k's program while stages
     1-2 of chunk k+1 proceed.

Backpressure is double-ended: at most ``depth`` chunks are prefetched
ahead of the consumer, and completed but unconsumed results are byte-capped
by ``max_buffered_bytes`` (the chunk immediately ahead is always allowed,
so one oversized chunk can stall but never deadlock the stream).

The pool is a dedicated one: prefetch tasks block on the decode pool, and
running them there would deadlock once its threads <= the pipeline depth.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from hyperspace_tpu_torch.obs import spans
from hyperspace_tpu_torch.obs.stages import PRODUCER as _PRODUCER
from hyperspace_tpu_torch.obs.stages import on_producer_thread  # noqa: F401 (the pipeline's own test reads it here)
from hyperspace_tpu_torch.reliability.faults import FAULTS

_PIPELINE_POOL = None
_PIPELINE_POOL_LOCK = threading.Lock()


def _pipeline_pool():
    """Shared prefetch pool. Width 4 bounds concurrent chunk decodes
    process-wide; streams beyond that queue."""
    global _PIPELINE_POOL
    if _PIPELINE_POOL is None:
        with _PIPELINE_POOL_LOCK:
            if _PIPELINE_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _PIPELINE_POOL = ThreadPoolExecutor(max_workers=4, thread_name_prefix="hs-pipeline")
    return _PIPELINE_POOL


def _counters():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return (
        REGISTRY.counter(
            "hs_pipeline_chunks_total",
            "Chunks yielded by the pipelined scan engine",
        ),
        REGISTRY.counter(
            "hs_pipeline_wait_seconds_total",
            "Seconds stream consumers stalled waiting on a prefetched chunk",
        ),
    )


def _cancelled_counter():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY.counter(
        "hs_pipeline_cancelled_total",
        "Queued prefetch decodes cancelled by an early stream close (LIMIT "
        "reached, consumer abandoned the stream)",
    )


class ScanPipeline:
    """Ordered bounded prefetch over a list of chunk-producing thunks.

    ``tasks`` are zero-argument callables, one per chunk, run on the
    pipeline pool; iteration yields their results in list order.
    ``stage(i, result)`` runs on the producer thread right after task i.
    ``weigh(result)`` -> bytes feeds the buffer budget.

    Cancel-safe: ``close()`` (called by ``__exit__``, by the consumer's
    ``finally`` on generator close, and at exhaustion) cancels queued tasks
    and waits for the ones in flight, so no worker outlives the stream.
    A task's error (typed by the reliability layer where it is a lake IO
    failure) reaches the consumer through its chunk's ``result()``.
    """

    def __init__(
        self,
        tasks: Sequence[Callable[[], object]],
        *,
        depth: int = 1,
        max_buffered_bytes: Optional[int] = None,
        weigh: Optional[Callable[[object], int]] = None,
        stage: Optional[Callable[[int, object], None]] = None,
    ):
        self._tasks = list(tasks)
        self._depth = max(1, int(depth))
        self._budget = max_buffered_bytes
        self._weigh = weigh
        self._stage = stage
        self._futures: List[Optional[Future]] = [None] * len(self._tasks)
        self._sizes: Dict[int, int] = {}
        self._buffered = 0  # bytes of completed but unconsumed results
        self._lock = threading.Lock()
        self._closed = False

    # -- producer side -------------------------------------------------------

    def _run(self, i: int):
        _PRODUCER.active = True
        try:
            with spans.span("prefetch", cat="pipeline", chunk=i):
                if FAULTS.active:
                    FAULTS.check("pipeline.task")
                out = self._tasks[i]()
                if self._stage is not None:
                    self._stage(i, out)
                return out
        finally:
            _PRODUCER.active = False

    def _submit(self, i: int) -> None:
        # the task runs under the submitting thread's span context, so its
        # prefetch span lands in the stream's trace tree
        fut = _pipeline_pool().submit(spans.wrap(self._run), i)
        if self._weigh is not None:

            def _done(f: Future, i: int = i) -> None:
                if f.cancelled() or f.exception() is not None:
                    return
                try:
                    w = int(self._weigh(f.result()))
                except Exception:  # a weight is advice; the chunk still streams
                    w = 0
                with self._lock:
                    self._sizes[i] = w
                    self._buffered += w

            fut.add_done_callback(_done)
        self._futures[i] = fut

    def _pump(self, k: int) -> None:
        """Submit up through chunk k + depth: chunks k and k+1
        unconditionally (the double buffer), further ones only while the
        buffered bytes are under the budget."""
        if self._closed:
            return
        for i in range(len(self._tasks)):
            if self._futures[i] is not None:
                continue
            if i > k + self._depth:
                break
            if i > k + 1 and self._budget is not None:
                with self._lock:
                    over = self._buffered >= self._budget
                if over:
                    break
            self._submit(i)

    # -- consumer side -------------------------------------------------------

    def __iter__(self):
        chunks_c, wait_c = _counters()
        try:
            for k in range(len(self._tasks)):
                self._pump(k)
                t0 = time.monotonic()
                out = self._futures[k].result()
                wait_c.inc(time.monotonic() - t0)
                chunks_c.inc()
                with self._lock:
                    self._buffered -= self._sizes.pop(k, 0)
                self._pump(k)  # the consumed budget frees the next lookahead slot
                yield out
        finally:
            self.close()

    def close(self) -> None:
        """Cancel queued prefetches and wait for the ones in flight.
        Idempotent."""
        self._closed = True
        inflight = []
        cancelled = 0
        for f in self._futures:
            if f is not None and not f.done():
                if f.cancel():
                    cancelled += 1
                else:
                    inflight.append(f)
        if cancelled:
            _cancelled_counter().inc(cancelled)
        for f in inflight:
            try:
                f.result()
            except Exception:
                pass  # the consumer already saw (or abandoned) this error

    def __enter__(self) -> "ScanPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
