"""Source-provider SPI.

Mirrors the reference's pluggable source layer
(ref: HS/index/sources/interfaces.scala:43-272):

  - ``FileBasedRelation``          — wraps one concrete source relation
  - ``FileBasedRelationMetadata``  — operations on the *logged* relation
  - ``FileBasedSourceProvider``    — answers "is this relation supported?"
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import pyarrow as pa

from hyperspace_tpu_torch.models.log_entry import FileInfo, IndexLogEntry, Relation


class FileBasedRelation:
    """One source relation: files + schema + format + options
    (ref: HS/index/sources/interfaces.scala:43-158)."""

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def schema(self) -> pa.Schema:
        raise NotImplementedError

    @property
    def root_paths(self) -> List[str]:
        raise NotImplementedError

    @property
    def file_format(self) -> str:
        raise NotImplementedError

    @property
    def physical_format(self) -> str:
        """Format of the underlying data files (e.g. a Delta relation's files
        are parquet; ref: internalFileFormatName, interfaces.scala:249-272)."""
        return "parquet" if self.has_parquet_as_source_format() else self.file_format

    @property
    def options(self) -> Dict[str, str]:
        return {}

    @property
    def partition_columns(self) -> List[str]:
        return []

    def all_file_infos(self) -> List[FileInfo]:
        raise NotImplementedError

    def signature(self) -> str:
        """Content fingerprint of this relation at this moment
        (ref: DefaultFileBasedRelation signature,
        HS/index/sources/default/DefaultFileBasedSource.scala:37-124)."""
        raise NotImplementedError

    def create_relation_metadata(self, file_id_tracker) -> Relation:
        """Snapshot into log-entry form (ref: interfaces.scala createRelationMetadata)."""
        raise NotImplementedError

    def closest_index(self, entry: IndexLogEntry) -> IndexLogEntry:
        """Hook for source-specific index-version selection, e.g. Delta time
        travel (ref: interfaces.scala:155-158, DeltaLakeRelation.scala:179-251).
        Default: identity."""
        return entry

    def has_parquet_as_source_format(self) -> bool:
        return self.file_format == "parquet"


class FileBasedRelationMetadata:
    """Operations over a relation *as recorded in a log entry*
    (ref: HS/index/sources/interfaces.scala:249-272)."""

    def __init__(self, relation: Relation):
        self.relation = relation

    def refresh(self) -> Relation:
        """Reconstruct a current snapshot of the logged relation (drop any
        recorded update, re-list files)."""
        raise NotImplementedError

    def to_relation_object(self) -> "FileBasedRelation":
        """Revive a live FileBasedRelation over the logged source's current
        state (used by refresh actions)."""
        raise NotImplementedError

    def internal_file_format_name(self) -> str:
        return self.relation.file_format

    def enrich_index_properties(
        self,
        properties: Dict[str, Any],
        log_id: Optional[int] = None,
        previous_properties: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Provider hook run when an action commits its final log entry
        (ref: FileBasedRelationMetadata.enrichIndexProperties,
        HS/index/sources/interfaces.scala:249-272): ``log_id`` is the entry's
        id and ``previous_properties`` the preceding entry's properties, so a
        provider can maintain per-log-version history (Delta's
        ``deltaVersions`` time-travel map)."""
        return properties


class FileBasedSourceProvider:
    """Answers SPI calls for relations it supports; returns None otherwise
    (ref: HS/index/sources/interfaces.scala:196-232)."""

    def create_relation(self, path_or_plan, session) -> Optional[FileBasedRelation]:
        raise NotImplementedError

    def create_relation_metadata(self, relation: Relation, session) -> Optional[FileBasedRelationMetadata]:
        raise NotImplementedError
