"""Latency SLO tracking: good/bad event counters + multi-window burn rates.

An SLO here is the standard serving formulation: a latency target
(``hyperspace.obs.slo.targetMs``) and an objective fraction
(``hyperspace.obs.slo.objective``, e.g. ``0.999`` = "99.9% of requests
finish under the target"). Every completed request is a *good* event
(finished under target, no error) or a *bad* event (slow, errored, or
rejected at admission).

The registry carries the cumulative truth (``hs_slo_good_total`` /
``hs_slo_bad_total``, labeled per server and tenant) — the shape Prometheus
alerting recomputes burn rates from at any window. For processes scraping
``/statusz`` (or no Prometheus at all), the tracker also maintains its own
multi-window **burn-rate gauges**: burn rate over window W = (bad fraction
in W) / (1 - objective), so 1.0 means "exactly consuming error budget at
the sustainable rate", 14.4 is the classic page-now threshold for a 1h
window on a 30d budget. Windowed state is a bounded per-tenant deque of
(monotonic time, good?) events — memory is O(window events retained), not
O(requests served).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from hyperspace_tpu_torch.check.locks import named_lock

__all__ = ["SloTracker"]

#: per-tenant cap on retained windowed events; beyond it the oldest fall off
#: and long-window burn rates degrade gracefully toward the recent rate
_MAX_EVENTS = 8192


class _TenantState:
    __slots__ = ("good", "bad", "events", "lock", "local_good", "local_bad")

    def __init__(self):
        self.good = None  # registry counters, bound lazily
        self.bad = None
        self.events: "deque[Tuple[float, bool]]" = deque(maxlen=_MAX_EVENTS)
        self.lock = named_lock("obs.slo.tenant")
        # locally-recorded cumulative counts, excluding remote merges — the
        # ledger the fabric sidecar publishes (peers must never re-export
        # each other's events, or counts would snowball around the ring)
        self.local_good = 0
        self.local_bad = 0


class SloTracker:
    """Per-server latency-SLO accounting with per-tenant labels."""

    def __init__(
        self,
        target_ms: float,
        objective: float = 0.999,
        windows_s: Tuple[float, ...] = (300.0, 3600.0),
        registry=None,
        server: str = "",
        clock=time.monotonic,
    ):
        if not (0.0 < objective < 1.0):
            raise ValueError(f"SLO objective must be in (0, 1), got {objective}")
        self.target_s = float(target_ms) / 1000.0
        self.objective = float(objective)
        self.windows_s = tuple(float(w) for w in windows_s)
        self.registry = registry
        self.server = server
        self._clock = clock
        self._lock = named_lock("obs.slo")
        self._tenants: Dict[str, _TenantState] = {}

    def _tenant(self, tenant: str) -> _TenantState:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = _TenantState()
                self._tenants[tenant] = st
                if self.registry is not None:
                    labels = {"tenant": tenant}
                    if self.server:
                        labels["server"] = self.server
                    st.good = self.registry.counter(
                        "hs_slo_good_total", "requests meeting the latency SLO", **labels
                    )
                    st.bad = self.registry.counter(
                        "hs_slo_bad_total",
                        "requests violating the latency SLO (slow, errored, or rejected)",
                        **labels,
                    )
                    for w in self.windows_s:
                        self.registry.gauge(
                            "hs_slo_burn_rate",
                            "error-budget burn rate over the labeled window "
                            "(1.0 = budget consumed exactly at the sustainable rate)",
                            fn=(lambda t=tenant, ws=w: self.burn_rate(ws, tenant=t)),
                            window=f"{int(w)}s",
                            **labels,
                        )
            return st

    def record(self, latency_s: float, error: bool = False, tenant: str = "default") -> bool:
        """Account one completed (or rejected) request; returns whether it
        was a good event."""
        good = (not error) and (latency_s <= self.target_s)
        st = self._tenant(tenant)
        with st.lock:
            st.events.append((self._clock(), good))
            if good:
                st.local_good += 1
            else:
                st.local_bad += 1
        if st.good is not None:
            (st.good if good else st.bad).inc()
        return good

    # -- fabric coherence (hyperspace_tpu_torch/fabric/coherence.py) ---------------
    def counts(self) -> Dict[str, Tuple[int, int]]:
        """Locally-recorded cumulative (good, bad) per tenant — the sidecar's
        publish ledger. Excludes events merged from peers."""
        with self._lock:
            tenants = dict(self._tenants)
        out: Dict[str, Tuple[int, int]] = {}
        for name, st in tenants.items():
            with st.lock:
                out[name] = (st.local_good, st.local_bad)
        return out

    def note_remote(self, tenant: str, good: int = 0, bad: int = 0) -> None:
        """Fold a peer process's good/bad event deltas into this tenant's
        burn-rate windows. Deliberately touches neither the registry
        counters (each process's ``hs_slo_*_total`` series stay its own
        cumulative truth — aggregation is the scrape layer's job) nor the
        local publish ledger (no echo)."""
        st = self._tenant(tenant)
        now = self._clock()
        with st.lock:
            st.events.extend([(now, True)] * max(0, int(good)))
            st.events.extend([(now, False)] * max(0, int(bad)))

    # -- windowed views ------------------------------------------------------
    def _window_counts(self, st: _TenantState, window_s: float) -> Tuple[int, int]:
        cutoff = self._clock() - window_s
        good = bad = 0
        with st.lock:
            for t, g in reversed(st.events):
                if t < cutoff:
                    break
                if g:
                    good += 1
                else:
                    bad += 1
        return good, bad

    def burn_rate(self, window_s: float, tenant: str = "default") -> float:
        """(bad fraction over the window) / (1 - objective); 0.0 when the
        window holds no events."""
        st = self._tenants.get(tenant)
        if st is None:
            return 0.0
        good, bad = self._window_counts(st, window_s)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - self.objective)

    def state(self) -> Dict[str, Any]:
        """JSON-able snapshot for ``/statusz``: cumulative + windowed, per
        tenant."""
        with self._lock:
            tenants = dict(self._tenants)
        out: Dict[str, Any] = {
            "targetMs": self.target_s * 1000.0,
            "objective": self.objective,
            "windowsSeconds": list(self.windows_s),
            "tenants": {},
        }
        for name, st in tenants.items():
            good = int(st.good.value) if st.good is not None else sum(1 for _, g in st.events if g)
            bad = int(st.bad.value) if st.bad is not None else sum(1 for _, g in st.events if not g)
            total = good + bad
            out["tenants"][name] = {
                "good": good,
                "bad": bad,
                "compliance": (good / total) if total else None,
                "burnRates": {
                    f"{int(w)}s": round(self.burn_rate(w, tenant=name), 4)
                    for w in self.windows_s
                },
            }
        return out
