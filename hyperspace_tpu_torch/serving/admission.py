"""Admission control: a bounded request queue with explicit backpressure.

A request that cannot be queued is *rejected immediately* with
``AdmissionRejected`` — the caller learns the system is saturated instead of
piling work onto an unbounded queue. Each request carries a deadline; workers
drop a request whose deadline passed while it sat in the queue (the client
already gave up) and resolve its future with ``RequestTimeout``.

Dead queued entries are also expired *eagerly*: a submit that finds the queue
full first sweeps out requests whose deadline has already lapsed, so dead
entries never hold queue slots and cause spurious ``AdmissionRejected`` for
live traffic. Expiry accounting is centralized in :meth:`expire` — guarded by
``future.done()`` so a request counts as a timeout exactly once no matter how
many paths (sweep, worker pop, pre-execution check) observe it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from hyperspace_tpu_torch.check.locks import named_lock


class AdmissionRejected(RuntimeError):
    """Queue full at submit time — back off and retry."""


class RequestTimeout(TimeoutError):
    """The request's deadline expired before a result was produced."""


class ServerClosed(RuntimeError):
    """Submit after shutdown."""


class AdmissionController:
    """Thread-safe bounded queue + rejection/timeout accounting."""

    def __init__(self, depth: int, default_timeout: Optional[float]):
        if depth <= 0:
            raise ValueError("queue depth must be positive")
        self.depth = int(depth)
        self.default_timeout = default_timeout
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._lock = named_lock("serving.admission")
        self.submitted = 0
        self.rejected = 0
        self.timeouts = 0
        # called (outside any queue lock) with each eagerly-expired request so
        # the server can seal its telemetry; None = expiry only resolves the
        # future
        self.on_expired: Optional[Callable] = None

    def deadline_for(self, timeout: Optional[float]) -> Optional[float]:
        t = self.default_timeout if timeout is None else timeout
        return None if t is None else time.monotonic() + float(t)

    def submit(self, item) -> None:
        """Enqueue or reject — never blocks. A full queue is swept for
        already-expired entries before the rejection is final."""
        while True:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                if self._purge_expired():
                    continue  # a slot was freed; retry the enqueue
                with self._lock:
                    self.rejected += 1
                raise AdmissionRejected(
                    f"serving queue full (depth={self.depth}); retry later"
                ) from None
            break
        with self._lock:
            self.submitted += 1

    def expire(self, item) -> bool:
        """Resolve an expired request exactly once: set ``RequestTimeout`` on
        its future, count the timeout, and fire ``on_expired``. Returns False
        (and does nothing) when the item has no future or is already done —
        the exactly-once guard every expiry path shares."""
        fut = getattr(item, "future", None)
        if fut is None or fut.done():
            return False
        fut.set_exception(RequestTimeout("deadline expired in queue"))
        self.record_timeout()
        cb = self.on_expired
        if cb is not None:
            try:
                cb(item)
            except Exception:
                pass  # telemetry must never break admission
        return True

    def _purge_expired(self) -> int:
        """Remove queued items whose deadline already lapsed. Items without an
        ``expired()`` predicate (or a future) are never touched."""
        dead = []
        with self._q.mutex:
            kept = [it for it in self._q.queue if not self._is_dead(it, dead)]
            if dead:
                self._q.queue.clear()
                self._q.queue.extend(kept)
                self._q.not_full.notify(len(dead))
        for it in dead:
            self.expire(it)
        return len(dead)

    @staticmethod
    def _is_dead(item, dead: list) -> bool:
        check = getattr(item, "expired", None)
        if callable(check) and getattr(item, "future", None) is not None and check():
            dead.append(item)
            return True
        return False

    def take(self, timeout: float = 0.1):
        """Dequeue one item for a worker; None on idle timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def take_nowait(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    @property
    def queued(self) -> int:
        return self._q.qsize()

    def bind_registry(self, registry, **labels) -> None:
        """Publish this controller's accounting into an obs metrics registry
        as callback gauges: scrapes read the live counters themselves, so a
        Prometheus sample and ``stats()`` can never disagree."""
        registry.gauge(
            "hs_serving_queue_depth", "requests waiting in the admission queue",
            fn=lambda: self.queued, **labels,
        )
        registry.gauge(
            "hs_serving_queue_capacity", "admission queue bound",
            fn=lambda: self.depth, **labels,
        )
        registry.gauge(
            "hs_serving_rejected", "requests rejected at admission (queue full)",
            fn=lambda: self.rejected, **labels,
        )
        registry.gauge(
            "hs_serving_timeouts", "requests whose deadline expired",
            fn=lambda: self.timeouts, **labels,
        )
        registry.gauge(
            "hs_serving_submitted", "requests admitted",
            fn=lambda: self.submitted, **labels,
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self.depth,
                "queued": self.queued,
                "submitted": self.submitted,
                "rejected": self.rejected,
                "timeouts": self.timeouts,
            }
