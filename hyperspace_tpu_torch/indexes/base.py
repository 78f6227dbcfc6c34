"""Index SPI.

``Index`` is the derived-dataset interface every index kind implements
(ref: HS/index/Index.scala:32-168); ``IndexConfig`` is the user-facing config
SPI (ref: HS/index/IndexConfigTrait.scala:31-59); ``CreateContext`` carries
what the reference passes as ``IndexerContext`` (session, data path, file-id
tracker).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from hyperspace_tpu_torch.models.log_entry import DerivedDataset, FileIdTracker


@dataclass
class CreateContext:
    """Context for index build/refresh operations
    (ref: ``IndexerContext`` in HS/index/Index.scala)."""

    session: Any
    index_data_path: str  # versioned data dir (v__=N) to write into
    file_id_tracker: FileIdTracker = field(default_factory=FileIdTracker)
    properties: Dict[str, str] = field(default_factory=dict)


class Index:
    """A derived dataset (ref: HS/index/Index.scala:32-168)."""

    kind: str = ""
    kind_abbr: str = ""

    @property
    def indexed_columns(self) -> List[str]:
        raise NotImplementedError

    @property
    def referenced_columns(self) -> List[str]:
        raise NotImplementedError

    @property
    def properties(self) -> Dict[str, Any]:
        raise NotImplementedError

    def to_derived_dataset(self) -> DerivedDataset:
        return DerivedDataset(self.kind, dict(self.properties))

    def write(self, ctx: CreateContext, df) -> None:
        """Build and persist index data for ``df`` into ``ctx.index_data_path``."""
        raise NotImplementedError


class IndexConfig:
    """User-facing index configuration (ref: HS/index/IndexConfigTrait.scala:31-59)."""

    @property
    def index_name(self) -> str:
        raise NotImplementedError

    @property
    def referenced_columns(self) -> List[str]:
        raise NotImplementedError

    def create_index(self, ctx: CreateContext, df, properties: Dict[str, str]) -> Index:
        """Resolve columns against ``df``, build index data, return the Index."""
        raise NotImplementedError
