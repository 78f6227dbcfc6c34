"""Kind-string -> Index class registry, reviving the polymorphic
``derivedDataset`` payload of a log entry (the reference uses Jackson
polymorphic deserialization; ref: HS/index/LogEntry.scala:33-46,
com/fasterxml/jackson/.../ScalaObjectMapper.scala)."""

from __future__ import annotations

from typing import Callable, Dict

from hyperspace_tpu_torch.indexes.base import Index
from hyperspace_tpu_torch.models.log_entry import DerivedDataset, IndexLogEntry

_REGISTRY: Dict[str, Callable[[DerivedDataset], Index]] = {}


def register(kind: str, factory: Callable[[DerivedDataset], Index]) -> None:
    _REGISTRY[kind] = factory


def revive(dd: DerivedDataset) -> Index:
    if dd.kind not in _REGISTRY:
        # import built-ins lazily to avoid import cycles
        import hyperspace_tpu_torch.indexes.covering  # noqa: F401
        import hyperspace_tpu_torch.indexes.dataskipping  # noqa: F401
    if dd.kind not in _REGISTRY:
        raise ValueError(f"Unknown index kind {dd.kind!r}")
    return _REGISTRY[dd.kind](dd)


def index_of_entry(entry: IndexLogEntry) -> Index:
    return revive(entry.derived_dataset)
