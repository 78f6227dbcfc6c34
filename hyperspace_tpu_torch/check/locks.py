"""Runtime lock-order watcher (default-off, ``hyperspace.check.locks``).

The serving/obs layer is a seven-module thread soup (admission queue, plan
cache, bucket-prefetch LRU, result cache, scheduler, profile history, metrics
registry) where every module owns a mutex. Individual modules are careful,
but lock-ORDER hazards only exist across modules, where no one test looks.
This watcher records the cross-thread lock acquisition graph while real
workloads run (the existing concurrency stress tests) and reports cycles —
the necessary condition for ABBA deadlock.

Zero-overhead stance: locks are created through :func:`named_lock`, which
returns a plain ``threading.Lock`` unless the watcher was enabled FIRST
(``watcher.enable()``, or a ``Session`` constructed with
``hyperspace.check.locks`` true). Instrumentation is opt-in per process and
decided at lock construction, so the default path adds nothing — not even an
``if`` — to acquire/release.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple


class LockWatcher:
    """Records held-before edges between named locks across all threads."""

    def __init__(self):
        self._enabled = False
        self._graph_lock = threading.Lock()
        # (held, acquiring) -> count of observations
        self._edges: Dict[Tuple[str, str], int] = {}
        self._held = threading.local()

    # -- lifecycle -----------------------------------------------------------
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        with self._graph_lock:
            self._edges.clear()

    # -- recording -----------------------------------------------------------
    def _held_stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def note_acquired(self, name: str) -> None:
        stack = self._held_stack()
        if stack:
            edges = [(h, name) for h in stack if h != name]
            if edges:
                with self._graph_lock:
                    for e in edges:
                        self._edges[e] = self._edges.get(e, 0) + 1
        stack.append(name)

    def note_released(self, name: str) -> None:
        stack = self._held_stack()
        # remove the innermost matching hold (re-entrant same-name nesting of
        # DISTINCT lock objects is legal; pop the right frame)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- reporting -----------------------------------------------------------
    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._graph_lock:
            return dict(self._edges)

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the held-before graph — each is a potential
        ABBA deadlock (lock A held while taking B on one thread, B held while
        taking A on another). Deduplicated by rotation."""
        with self._graph_lock:
            adj: Dict[str, Set[str]] = {}
            for a, b in self._edges:
                adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str], visited: Set[str]):
            for nxt in adj.get(node, ()):
                if nxt == start:
                    cyc = path[:]
                    k = min(range(len(cyc)), key=lambda i: cyc[i])
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen:
                        seen.add(canon)
                        out.append(list(canon))
                elif nxt not in visited and nxt > start:
                    # only explore nodes ordered after start: each cycle is
                    # found exactly once, from its smallest member
                    visited.add(nxt)
                    dfs(start, nxt, path + [nxt], visited)
                    visited.discard(nxt)

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out

    def report(self) -> List[List[str]]:
        """Cycles, also counted into ``hs_check_violations_total`` so a
        scrape sees lock-order hazards the same way it sees HLO ones."""
        cycs = self.cycles()
        if cycs:
            from hyperspace_tpu_torch.obs.metrics import REGISTRY

            for c in cycs:
                REGISTRY.counter(
                    "hs_check_violations_total",
                    "Program-contract and invariant violations detected by hscheck",
                    rule="lock-order-cycle",
                    program=" -> ".join(c + [c[0]]),
                ).inc()
        return cycs


#: process-wide watcher instance
watcher = LockWatcher()


class WatchedLock:
    """A ``threading.Lock`` that reports acquire/release to the watcher.
    Supports the context-manager and acquire/release protocols the serving
    and obs modules use; it is NOT suitable as a Condition's underlying lock
    (``Condition.wait`` releases behind the wrapper's back)."""

    __slots__ = ("_inner", "name")

    def __init__(self, name: str):
        self._inner = threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            watcher.note_acquired(self.name)
        return got

    def release(self) -> None:
        watcher.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def named_lock(name: str):
    """The serving/obs lock constructor: a plain ``threading.Lock`` when the
    watcher is off (the default — zero added overhead), a :class:`WatchedLock`
    when it was enabled before construction. Enabling mid-run only affects
    locks created afterwards; stress harnesses enable first, then build the
    server."""
    if watcher.enabled:
        return WatchedLock(name)
    return threading.Lock()
