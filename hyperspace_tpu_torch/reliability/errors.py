"""Typed error taxonomy for lake IO failures.

Every failure a lake-touching path can observe classifies into exactly one
of two operational families:

- :class:`TransientIOError` — the read *might* succeed if repeated (network
  blip, NFS hiccup, a racing writer's rename window). Subclasses ``OSError``
  so existing ``except OSError`` fallbacks keep catching injected/classified
  transients without a second handler arm. Retryable under the retry policy.
- :class:`CorruptDataError` — the bytes are wrong (torn write, flipped
  parquet magic, truncated footer). Retrying re-reads the same bad bytes;
  the correct responses are skip-to-prior-version (operation log), index
  quarantine (degrade.py), or a typed query failure (source files).

:class:`FaultInjected` is a marker mixin: errors raised by the
fault-injection harness (faults.py) carry it so the chaos soak can assert
"every failure I saw was one I injected" while the production classifiers
never produce it.

:func:`classify` maps raw third-party exceptions into the taxonomy — the
single routing table every swallow site consults, so transient-vs-corrupt
is decided in one place.
"""

from __future__ import annotations

import json


class ReliabilityError(Exception):
    """Base of the typed lake-IO failure taxonomy."""


class TransientIOError(ReliabilityError, OSError):
    """Possibly-recoverable IO failure; retry may succeed."""


class CorruptDataError(ReliabilityError):
    """The bytes read are not the bytes written; retry cannot help."""

    def __init__(self, message: str = "", path: str = ""):
        super().__init__(message or f"corrupt data: {path}")
        self.path = path


class FaultInjected:
    """Marker mixin for errors raised by the fault-injection harness."""


class InjectedTransientIOError(FaultInjected, TransientIOError):
    pass


class InjectedCorruptDataError(FaultInjected, CorruptDataError):
    pass


#: exception types whose meaning is "the stored bytes are wrong" — decode
#: and parse failures, never connectivity (lazy pa import keeps this module
#: importable without pyarrow)
def _corrupt_types() -> tuple:
    out = [json.JSONDecodeError, KeyError, ValueError]
    try:
        import pyarrow as pa

        out += [pa.ArrowInvalid, pa.ArrowTypeError]
    except Exception:  # pragma: no cover - pyarrow is a baked-in dep
        pass
    return tuple(out)


def classify(exc: BaseException, path: str = "") -> ReliabilityError:
    """Wrap a raw exception as its taxonomy type (already-typed errors pass
    through unchanged). ``OSError`` → transient; parse/decode errors →
    corrupt; anything else stays transient-leaning corrupt-free so an
    unknown failure is never mistaken for bad bytes."""
    if isinstance(exc, ReliabilityError):
        return exc
    if isinstance(exc, _corrupt_types()):
        err = CorruptDataError(f"{type(exc).__name__}: {exc}", path=path)
        err.__cause__ = exc
        return err
    if isinstance(exc, OSError):
        err2 = TransientIOError(str(exc) or type(exc).__name__)
        err2.__cause__ = exc
        return err2
    err3 = TransientIOError(f"{type(exc).__name__}: {exc}")
    err3.__cause__ = exc
    return err3


def is_corrupt(exc: BaseException) -> bool:
    return isinstance(exc, CorruptDataError) or isinstance(exc, _corrupt_types())


def count_io_error(op: str, exc: BaseException, *, swallowed: bool = False) -> None:
    """Classification counter every audit point bumps — even sites that go
    on to a fallback (``swallowed=True``) leave a metric trail instead of
    vanishing. Cheap: one counter inc, no conf lookup."""
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    kind = "corrupt" if is_corrupt(exc) else (
        "transient" if isinstance(exc, OSError) else "other"
    )
    REGISTRY.counter(
        "hs_io_errors_total",
        "lake IO errors observed, classified by the reliability taxonomy "
        "(handled=fallback-taken vs raised=surfaced to the caller)",
        op=op,
        kind=kind,
        outcome="handled" if swallowed else "raised",
    ).inc()
