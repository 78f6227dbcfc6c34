"""Deterministic fault injection at the lake IO seams.

A :class:`FaultRule` targets one *site* — a named IO seam the production
code consults via :func:`check` / :func:`mangle_bytes` — and fires either
on the nth matching operation, with a seeded probability, or on every
match. Sites wired through the codebase:

========================  ====================================================
``log.read``              operation-log entry read (models/log_manager.py)
``log.write``             operation-log entry write
``io.footer``             parquet footer/metadata/schema read (exec/io.py)
``io.decode``             parquet decode — fires on the per-file path
                          (exec/io.py read_one) AND before/after the native
                          row-group fast path's C calls (_native_rg_scan)
``pipeline.task``         prefetch-pipeline chunk task (exec/pipeline.py)
``join.task``             streamed-join side decode task (exec/join_stream.py)
``device.transfer``       host→device staging (exec/device.py)
``lease.renew``           fabric lease heartbeat renewal (fabric/lease.py)
``fabric.http``           FrontDoor→worker HTTP dispatch (fabric/frontdoor.py)
``record.compact``        fsck garbage-collection removal (fabric/fsck.py)
========================  ====================================================

Fault kinds: ``transient`` raises :class:`InjectedTransientIOError`,
``corrupt`` raises :class:`InjectedCorruptDataError`, ``latency`` sleeps
``delay_s`` then proceeds, and ``truncate`` / ``magic`` mangle the bytes at
byte-level seams (the log reader) — truncation tears the tail off, magic
flips the leading bytes.

Default-off discipline: the registry holds a single ``active`` flag that is
False unless rules are installed; every production seam checks that one
attribute before anything else, so the disabled path is one attribute read
(the ≤1% hook budget). Tests install rules with :func:`fault_scope` — no
monkeypatching — and sessions can install from conf via
``hyperspace.reliability.faults.spec``:

    "io.decode:transient:p=0.01;log.read:corrupt:glob=*_hyperspace_log*:nth=3"

Everything is deterministic under a fixed seed: one ``random.Random(seed)``
drives probability draws in installation order, and nth-operation counters
are per-rule.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from typing import List, Optional

from hyperspace_tpu_torch.reliability.errors import (
    InjectedCorruptDataError,
    InjectedTransientIOError,
)

KINDS = ("transient", "corrupt", "latency", "truncate", "magic")


class FaultRule:
    """One injection rule; see module docstring for targeting semantics."""

    __slots__ = ("site", "kind", "path_glob", "nth", "probability", "delay_s",
                 "max_fires", "_ops", "_fires")

    def __init__(
        self,
        site: str,
        kind: str,
        *,
        path_glob: Optional[str] = None,
        nth: Optional[int] = None,
        probability: Optional[float] = None,
        delay_s: float = 0.0,
        max_fires: Optional[int] = None,
    ):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        self.site = str(site)
        self.kind = kind
        self.path_glob = path_glob
        self.nth = nth
        self.probability = probability
        self.delay_s = float(delay_s)
        self.max_fires = max_fires
        self._ops = 0    # matching operations observed
        self._fires = 0  # faults actually delivered

    def matches_target(self, site: str, path: Optional[str]) -> bool:
        if self.site != "*" and self.site != site:
            return False
        if self.path_glob is not None:
            if path is None or not fnmatch.fnmatch(str(path), self.path_glob):
                return False
        return True

    def should_fire(self, rng: random.Random) -> bool:
        """Called under the registry lock for a target match; advances the
        per-rule op counter and decides deterministically."""
        if self.max_fires is not None and self._fires >= self.max_fires:
            return False
        self._ops += 1
        if self.nth is not None:
            fire = self._ops == self.nth
        elif self.probability is not None:
            fire = rng.random() < self.probability
        else:
            fire = True
        if fire:
            self._fires += 1
        return fire

    @property
    def fires(self) -> int:
        return self._fires

    def __repr__(self) -> str:
        return (
            f"FaultRule({self.site}:{self.kind}, glob={self.path_glob!r}, "
            f"nth={self.nth}, p={self.probability}, fires={self._fires})"
        )


def _count_injection(site: str, kind: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_faults_injected_total",
        "faults delivered by the reliability fault-injection harness",
        site=site,
        kind=kind,
    ).inc()


class FaultRegistry:
    """Process-global rule set; ``active`` is the one-attribute fast path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        self._rng = random.Random(0)
        self.active = False

    # -- installation --------------------------------------------------------
    def install(self, *rules: FaultRule) -> None:
        with self._lock:
            self._rules.extend(rules)
            self.active = bool(self._rules)

    def clear(self) -> None:
        with self._lock:
            self._rules = []
            self.active = False

    def seed(self, seed: int) -> None:
        with self._lock:
            self._rng = random.Random(int(seed))

    def rules(self) -> List[FaultRule]:
        with self._lock:
            return list(self._rules)

    # -- the seams -----------------------------------------------------------
    def check(self, site: str, path: Optional[str] = None) -> None:
        """Raise/delay per the first matching rule that fires. The inactive
        path is the caller's ``if FAULTS.active`` — this method assumes at
        least the possibility of rules."""
        if not self.active:
            return
        fired: Optional[FaultRule] = None
        with self._lock:
            for r in self._rules:
                if r.matches_target(site, path) and r.should_fire(self._rng):
                    fired = r
                    break
        if fired is None:
            return
        _count_injection(site, fired.kind)
        if fired.kind == "latency":
            time.sleep(fired.delay_s)
            return
        if fired.kind == "transient":
            raise InjectedTransientIOError(
                f"injected transient fault at {site} ({path or '?'})"
            )
        # corrupt / truncate / magic at a non-byte seam all surface as a
        # corrupt-data error: the seam has no bytes to mangle
        raise InjectedCorruptDataError(
            f"injected corrupt-data fault at {site}", path=path or ""
        )

    def mangle_bytes(self, site: str, path: Optional[str], data: bytes) -> bytes:
        """Byte-level seams (the log reader holds raw bytes): ``truncate``
        tears off the tail, ``magic`` flips the head, other kinds delegate
        to :meth:`check` semantics (raise/delay)."""
        if not self.active:
            return data
        fired: Optional[FaultRule] = None
        with self._lock:
            for r in self._rules:
                if r.matches_target(site, path) and r.should_fire(self._rng):
                    fired = r
                    break
        if fired is None:
            return data
        _count_injection(site, fired.kind)
        if fired.kind == "truncate":
            return data[: max(0, len(data) // 2 - 1)]
        if fired.kind == "magic":
            return (b"XXXX" + data[4:]) if len(data) >= 4 else b"X"
        if fired.kind == "latency":
            time.sleep(fired.delay_s)
            return data
        if fired.kind == "transient":
            raise InjectedTransientIOError(
                f"injected transient fault at {site} ({path or '?'})"
            )
        raise InjectedCorruptDataError(
            f"injected corrupt-data fault at {site}", path=path or ""
        )


#: the process-global registry every seam consults (fast path: one attr read);
#: intentionally process-local — fault injection is a per-process chaos harness
FAULTS = FaultRegistry()  # hscheck: disable=process-local-state


class fault_scope:
    """Install rules for a ``with`` block and restore the prior set after —
    the no-monkeypatching test API. Re-seeds on entry for determinism."""

    def __init__(self, *rules: FaultRule, seed: int = 0):
        self._rules = rules
        self._seed = seed

    def __enter__(self):
        self._prior = FAULTS.rules()
        FAULTS.clear()
        FAULTS.seed(self._seed)
        FAULTS.install(*self._rules)
        return FAULTS

    def __exit__(self, *exc) -> None:
        FAULTS.clear()
        FAULTS.install(*self._prior)


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse the conf-string rule syntax (see module docstring):
    ``site:kind[:glob=PAT][:nth=N][:p=F][:delay=S][:max=N]`` joined by ``;``."""
    rules: List[FaultRule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"fault spec {part!r}: need site:kind")
        site, kind = fields[0].strip(), fields[1].strip()
        kw: dict = {}
        for opt in fields[2:]:
            k, _, v = opt.partition("=")
            k = k.strip()
            if k == "glob":
                kw["path_glob"] = v
            elif k == "nth":
                kw["nth"] = int(v)
            elif k == "p":
                kw["probability"] = float(v)
            elif k == "delay":
                kw["delay_s"] = float(v)
            elif k == "max":
                kw["max_fires"] = int(v)
            else:
                raise ValueError(f"fault spec {part!r}: unknown option {k!r}")
        rules.append(FaultRule(site, kind, **kw))
    return rules


_CONF_INSTALLED = False


def configure(conf) -> None:
    """Apply a session's ``hyperspace.reliability.faults.*`` conf (called
    from Session construction; most recent session wins, like the decode
    pool). A disabled conf clears only conf-installed rules — a test's
    ``fault_scope`` rules survive a session constructed inside the scope."""
    global _CONF_INSTALLED
    if not conf.reliability_faults_enabled:
        if _CONF_INSTALLED:
            FAULTS.clear()
            _CONF_INSTALLED = False
        return
    FAULTS.clear()
    FAULTS.seed(conf.reliability_faults_seed)
    FAULTS.install(*parse_spec(conf.reliability_faults_spec))
    _CONF_INSTALLED = True
