"""The traffic: seeded request schedules and arrival times from a mix's data
file, and the open loop that sends them through ``QueryServer.submit``."""

from __future__ import annotations

import threading
import time

import numpy as np


def draw(spec: dict, rng) -> object:
    """One parameter from its spec: ``{"int": [lo, hi]}`` (both included),
    ``{"choice": [...]}`` or ``{"fixed": value}``."""
    if "int" in spec:
        lo, hi = spec["int"]
        return int(rng.integers(lo, hi + 1))
    if "choice" in spec:
        options = spec["choice"]
        return options[int(rng.integers(0, len(options)))]
    if "fixed" in spec:
        return spec["fixed"]
    raise ValueError(f"unknown parameter spec {spec!r}")


class Schedule:
    """An endless sequence of (template, params): blocks that each
    hold every template its weight's number of times, in a seeded order, so
    that every seed sends the same mix in another order."""

    def __init__(self, traffic: dict, seed: int, stream: int):
        self.rng = np.random.default_rng([seed, stream])
        self.block = [t for t, w in traffic["block"].items() for _ in range(int(w))]
        self.params = traffic["params"]
        self.pending = []

    def next(self):
        if not self.pending:
            self.pending = [self.block[i] for i in self.rng.permutation(len(self.block))]
        name = self.pending.pop(0)
        return name, {k: draw(spec, self.rng) for k, spec in self.params.get(name, {}).items()}


class Request:
    """One request: its template and parameters, when it was due (``t0``)
    and answered (``t1``), its answer or error, and an event set once it is
    resolved."""

    __slots__ = ("template", "params", "t0", "t1", "result", "error", "done")

    def __init__(self, template, params):
        self.template, self.params = template, params
        self.t0 = self.t1 = self.result = self.error = None
        self.done = threading.Event()


def arrivals(traffic: dict, seconds: float, seed: int, stream: int) -> list:
    """Due times (seconds from the start) of ``round(rate * seconds)``
    requests at the mix's ``rate``, whose gaps add up to ``seconds``, by its
    ``arrivals``: ``"exponential"``, the gaps of a Poisson process, one from
    each of the n quantiles of the exponential, in a seeded order, so that
    every seed offers the same bursts and lulls at other times."""
    if traffic["arrivals"] != "exponential":
        raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
    n = int(round(float(traffic["rate"]) * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / max(n, 1))
    gaps = gaps[np.random.default_rng([seed, stream, 2]).permutation(n)]
    gaps *= seconds / gaps.sum() if n else 0.0
    return (np.cumsum(gaps) - gaps).tolist()


def open_loop(server, make, schedule, due, timeout=60.0):
    """Send one request at each due time (seconds after the start) from one
    sender thread, whether or not earlier ones have returned; each request
    is timed from when it was due, so a late send counts in its latency.
    Returns (requests, sender thread, start, lateness): the caller joins the
    sender, then waits for the requests' ``done`` events."""
    done, late = [], []
    start = time.perf_counter()

    def sender():
        for at in due:
            now = time.perf_counter()
            if now < start + at:
                time.sleep(start + at - now)
            name, params = schedule.next()
            r = Request(name, params)
            r.t0 = start + at
            late.append(time.perf_counter() - r.t0)
            done.append(r)
            try:
                fut = server.submit(make(name, params), timeout=timeout)
            except Exception as e:  # refused at admission: failed at once
                r.error, r.t1 = f"{type(e).__name__}: {e}", time.perf_counter()
                r.done.set()
                continue

            def finish(f, r=r):
                try:
                    r.result = f.result()
                except Exception as e:  # a failed or timed-out request counts in ``failed``
                    r.error = f"{type(e).__name__}: {e}"
                r.t1 = time.perf_counter()
                r.done.set()

            fut.add_done_callback(finish)

    th = threading.Thread(target=sender, name="hsbench-sender", daemon=True)
    th.start()
    return done, th, start, late
