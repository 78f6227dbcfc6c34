"""Lake-persisted lease with fencing tokens: crash-tolerant single writers.

The fabric's refresh single-writer guarantee was an in-process
``threading.Lock`` — two fabric *processes* could still race a refresh,
and a process killed mid-refresh held nothing a peer could observe. This
module puts the mutex on the lake itself, built from the same primitives
as the operation log:

- **claim = create-exclusive**: a lease on ``name`` is a directory of
  numbered token files ``<system.path>/_fabric/leases/<name>/t-NNNNNNNN``;
  the *highest-numbered parseable file is the current lease*. Acquiring
  claims token ``current+1`` with ``write_atomic_exclusive`` — exactly one
  of any number of racing processes wins the claim, with no coordinator.
- **fencing token = the claim number**: monotonically increasing across
  the lease's whole history, including takeovers. A holder presents its
  token at commit time (:func:`fence_scope` wraps the refresh and
  ``IndexLogManager.write_log`` calls :meth:`Lease.verify`); a zombie —
  paused past expiry and taken over — sees a higher token on the lake and
  its late commit raises :class:`LeaseLostError` instead of landing.
- **heartbeat renewal**: the holder periodically rewrites its own token
  file with an extended expiry (atomic temp+rename overwrite;
  ``lease.renew`` is a fault-injection seam). Renewal re-lists the
  directory first, so a fenced holder *learns* it lost rather than
  resurrecting a stolen lease.
- **expiry takeover**: an expired current token makes the lease claimable
  by anyone; the claim race above picks exactly one successor.

Clocks are injected (``clock=time.time``) so expiry and takeover are
deterministic under test; production uses wall time, and a skewed clock
can only make takeover *late* (a peer's unexpired view wins) — fencing,
not time, protects the commit itself.

All crash cases degrade safely: a holder that dies simply stops renewing
and is taken over after TTL; a claimant that dies between claim and use
*is* the holder and expires like any other. Dead token files below the
current one are garbage-collected by :mod:`hyperspace_tpu_torch.fabric.fsck`.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from hyperspace_tpu_torch.fabric.records import FABRIC_DIR, _safe_name
from hyperspace_tpu_torch.utils.file_utils import write_atomic, write_atomic_exclusive

__all__ = [
    "Lease",
    "LeaseLostError",
    "acquire",
    "current_fence",
    "fence_scope",
    "leases_dir",
    "read_state",
]

#: zero-padded token ids keep lexicographic == numeric ordering in listings
_TOKEN_WIDTH = 8
_TOKEN_PREFIX = "t-"


class LeaseLostError(RuntimeError):
    """The holder's fencing token is no longer current: a peer took over
    after expiry. Raised at renewal and — via :func:`fence_scope` — at the
    operation-log commit point, so a zombie's late commit never lands."""

    def __init__(self, name: str, held_token: int, current_token: int):
        super().__init__(
            f"lease {name!r} lost: held token {held_token}, "
            f"lake shows token {current_token}"
        )
        self.name = name
        self.held_token = held_token
        self.current_token = current_token


def _count_acquire(outcome: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_lease_acquires_total",
        "lake lease acquisition attempts (acquired | takeover | busy)",
        outcome=outcome,
    ).inc()


def _count_renewal(outcome: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_lease_renewals_total",
        "lake lease heartbeat renewals (ok | lost | error)",
        outcome=outcome,
    ).inc()


def _count_fenced() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_lease_fenced_total",
        "commits rejected by the lease fencing check (zombie writers)",
    ).inc()


def leases_dir(system_path: str, name: Optional[str] = None) -> str:
    d = os.path.join(str(system_path), FABRIC_DIR, "leases")
    return d if name is None else os.path.join(d, _safe_name(name))


def _token_path(lease_dir: str, token: int) -> str:
    return os.path.join(lease_dir, f"{_TOKEN_PREFIX}{token:0{_TOKEN_WIDTH}d}")


def _list_tokens(lease_dir: str) -> List[int]:
    try:
        names = os.listdir(lease_dir)
    except OSError:
        return []
    out = []
    for n in names:
        if n.startswith(_TOKEN_PREFIX) and n[len(_TOKEN_PREFIX):].isdigit():
            out.append(int(n[len(_TOKEN_PREFIX):]))
    return sorted(out)


def read_state(
    system_path: str, name: str
) -> Tuple[int, Optional[Dict]]:
    """``(current_token, state)`` for a lease — the highest-numbered
    parseable token file, or ``(0, None)`` for a never-claimed lease. A
    torn/corrupt current file still *counts* for the token sequence
    (claimants must number past it) but reads as an expired state, so it
    is immediately claimable rather than wedging the lease forever."""
    d = leases_dir(system_path, name)
    tokens = _list_tokens(d)
    if not tokens:
        return 0, None
    current = tokens[-1]
    try:
        with open(_token_path(d, current), "rb") as f:
            return current, json.loads(f.read().decode("utf-8"))
    except Exception:
        return current, None


class Lease:
    """A held lease: fencing token + renewal/verify/release handles.

    Constructed by :func:`acquire` only. Thread-safe for the intended
    pattern (owner thread works, heartbeat thread renews)."""

    def __init__(
        self,
        system_path: str,
        name: str,
        holder: str,
        token: int,
        ttl_s: float,
        expires_at: float,
        clock: Callable[[], float],
    ):
        self.system_path = str(system_path)
        self.name = str(name)
        self.holder = str(holder)
        self.token = int(token)
        self.ttl_s = float(ttl_s)
        self.expires_at = float(expires_at)
        self._clock = clock
        self._lost = False
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()

    @property
    def path(self) -> str:
        return _token_path(leases_dir(self.system_path, self.name), self.token)

    @property
    def lost(self) -> bool:
        return self._lost

    def _payload(self, expires_at: float) -> bytes:
        return json.dumps(
            {
                "holder": self.holder,
                "token": self.token,
                "expiresAt": expires_at,
                "ttlSeconds": self.ttl_s,
            },
            sort_keys=True,
        ).encode("utf-8")

    # -- heartbeat renewal ---------------------------------------------------
    def renew(self) -> bool:
        """Extend the lease by one TTL from now. Returns False — and marks
        the lease lost — when a peer's takeover token is on the lake; a
        fenced holder must stop, not re-assert itself."""
        from hyperspace_tpu_torch.reliability.faults import FAULTS

        if self._lost:
            return False
        current, _ = read_state(self.system_path, self.name)
        if current != self.token:
            self._lost = True
            _count_renewal("lost")
            return False
        try:
            if FAULTS.active:
                FAULTS.check("lease.renew", self.path)
            now = self._clock()
            write_atomic(self.path, self._payload(now + self.ttl_s))
            self.expires_at = now + self.ttl_s
        except OSError:
            # a failed renewal write is not a loss: the prior expiry still
            # stands and the next beat retries. Only takeover loses a lease.
            _count_renewal("error")
            return True
        _count_renewal("ok")
        return True

    def start_heartbeat(self, interval_s: float) -> "Lease":
        """Renew every ``interval_s`` on a daemon thread until released,
        fenced, or stopped (tests drive :meth:`renew` directly instead)."""
        if self._hb_thread is None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._hb_run,
                args=(float(interval_s),),
                name=f"hs-lease-{_safe_name(self.name)}",
                daemon=True,
            )
            self._hb_thread.start()
        return self

    def _hb_run(self, interval_s: float) -> None:
        while not self._hb_stop.wait(interval_s):
            try:
                if not self.renew():
                    return
            except Exception:
                # an unclassifiable renewal failure (injected corrupt, lake
                # error) ends the heartbeat but not the lease: the holder
                # keeps its current expiry and the fence still governs
                return

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        thread = self._hb_thread
        self._hb_thread = None
        if thread is not None:
            thread.join(timeout=5)

    # -- fencing -------------------------------------------------------------
    def verify(self) -> None:
        """The fencing check: raise :class:`LeaseLostError` unless this
        token is still the lease's current one on the lake. Called at the
        operation-log commit point via :func:`fence_scope`, so a zombie
        writer fails *before* its entry lands."""
        current, _ = read_state(self.system_path, self.name)
        if current != self.token:
            self._lost = True
            _count_fenced()
            raise LeaseLostError(self.name, self.token, current)

    def release(self) -> None:
        """Zero the expiry so the next acquirer takes over immediately.
        The token file stays — the fencing sequence must never restart
        while successors can still race (fsck GCs superseded tokens)."""
        self.stop_heartbeat()
        if self._lost:
            return
        current, _ = read_state(self.system_path, self.name)
        if current != self.token:
            self._lost = True
            return
        try:
            write_atomic(self.path, self._payload(0.0))
        except OSError:
            pass  # unreleased = held until TTL; safe, just slower takeover
        self.expires_at = 0.0

    def __repr__(self) -> str:
        return (
            f"Lease({self.name!r}, holder={self.holder!r}, token={self.token}, "
            f"expires_at={self.expires_at:.3f}, lost={self._lost})"
        )


def acquire(
    system_path: str,
    name: str,
    holder: str,
    ttl_s: float,
    clock: Callable[[], float] = time.time,
) -> Optional[Lease]:
    """Try to acquire the lease once (non-blocking). Returns the held
    :class:`Lease` or None when a live holder exists or a racer won the
    claim. Counted in ``hs_fabric_lease_acquires_total`` by outcome."""
    now = clock()
    current, state = read_state(system_path, name)
    if state is not None and float(state.get("expiresAt", 0.0)) > now:
        _count_acquire("busy")
        return None
    token = current + 1
    lease = Lease(system_path, name, holder, token, ttl_s, now + float(ttl_s), clock)
    if not write_atomic_exclusive(lease.path, lease._payload(lease.expires_at)):
        # a racing claimant took this exact token between our read and claim
        _count_acquire("busy")
        return None
    _count_acquire("takeover" if current > 0 else "acquired")
    return lease


# -- the commit-time fencing hook --------------------------------------------

_FENCE: "contextvars.ContextVar[Optional[Lease]]" = contextvars.ContextVar(
    "hs_fabric_lease_fence", default=None
)


def current_fence() -> Optional[Lease]:
    """The lease guarding the current refresh, or None. Consulted by
    ``IndexLogManager.write_log`` — one contextvar read when no lease is
    in scope, so the default-off path stays free."""
    return _FENCE.get()


class fence_scope:
    """Bind a lease as the commit fence for the ``with`` block. Entering
    with ``None`` is a no-op, so callers don't branch on lease mode."""

    def __init__(self, lease: Optional[Lease]):
        self._lease = lease
        self._token = None

    def __enter__(self) -> Optional[Lease]:
        if self._lease is not None:
            self._token = _FENCE.set(self._lease)
        return self._lease

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _FENCE.reset(self._token)
            self._token = None
