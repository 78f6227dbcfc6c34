"""Default file-based source provider: Parquet (and CSV/JSON via pyarrow)
datasets on local/fuse-mounted lake storage
(ref: HS/index/sources/default/DefaultFileBasedSource.scala:37-124,
DefaultFileBasedRelation.scala:38).
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads

from hyperspace_tpu_torch.models.log_entry import Content, FileInfo, Relation, Storage
from hyperspace_tpu_torch.sources import partitions
from hyperspace_tpu_torch.sources import schema as schema_codec
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedRelationMetadata,
    FileBasedSourceProvider,
)
from hyperspace_tpu_torch.sources.signatures import file_based_signature
from hyperspace_tpu_torch.sources import formats
from hyperspace_tpu_torch.sources.formats import (
    MATERIALIZED_FORMATS,
    SUPPORTED_FORMATS,
    read_format_schema,
    read_table,
    tables_to_dataset,
)


def _list_data_files(root: str) -> List[str]:
    from hyperspace_tpu_torch.utils.file_utils import walk_data_files

    return sorted(walk_data_files(root))


class DefaultFileBasedRelation(FileBasedRelation):
    def __init__(self, root_paths: List[str], file_format: str, options: Optional[Dict[str, str]] = None,
                 files: Optional[List[str]] = None):
        self._root_paths = [os.path.abspath(p) for p in root_paths]
        self._file_format = file_format
        self._options = dict(options or {})
        if files is not None:
            self._files = sorted(os.path.abspath(f) for f in files)
        else:
            self._files = []
            for p in self._root_paths:
                if os.path.isdir(p):
                    self._files.extend(_list_data_files(p))
                elif globlib.has_magic(p):
                    for m in sorted(globlib.glob(p)):
                        if os.path.isdir(m):
                            self._files.extend(_list_data_files(m))
                        else:
                            self._files.append(os.path.abspath(m))
                else:
                    self._files.append(p)
        if not self._files:
            raise FileNotFoundError(f"No data files under {root_paths!r}")
        self._schema: Optional[pa.Schema] = None
        # hive-style partition discovery (.../col=value/... segments); single
        # root only, so arrow_dataset() can serve the same partition columns
        # (multi-root layouts are treated as unpartitioned, like Spark
        # without an explicit basePath)
        if len(self._root_paths) == 1 and os.path.isdir(self._root_paths[0]):
            self._part_cols, self._part_raw = partitions.discover(self._files, self._root_paths)
        else:
            self._part_cols, self._part_raw = [], {}
        self._part_dtypes = partitions.infer_dtypes(self._part_cols, self._part_raw)

    @property
    def name(self) -> str:
        return ",".join(self._root_paths)

    def _partition_arrow_fields(self) -> List[pa.Field]:
        out = []
        for c in self._part_cols:
            dt = self._part_dtypes[c]
            if dt == np.dtype(np.int64):
                out.append(pa.field(c, pa.int64()))
            elif dt == np.dtype(np.float64):
                out.append(pa.field(c, pa.float64()))
            else:
                out.append(pa.field(c, pa.string()))
        return out

    @property
    def schema(self) -> pa.Schema:
        # arrow_dataset() carries the hive partitioning, so its schema
        # already includes the partition fields (the path-derived value
        # shadows any same-named column in the file bytes); avro/text resolve
        # from file headers alone — no record data is decoded for the schema
        if self._schema is None:
            if self._file_format in MATERIALIZED_FORMATS:
                s = read_format_schema(self._files, self._file_format)
                for field in self._partition_arrow_fields():
                    if field.name not in s.names:
                        s = s.append(field)
                self._schema = s
            else:
                self._schema = self.arrow_dataset().schema
        return self._schema

    @property
    def partition_columns(self) -> List[str]:
        return list(self._part_cols)

    def partition_values_for(self, file_path: str) -> Dict[str, object]:
        """Typed partition-column values of one file's rows."""
        raw = self._part_raw.get(os.path.abspath(file_path), {})
        return {
            c: partitions.typed_value(raw.get(c), self._part_dtypes[c])
            for c in self._part_cols
        }

    @property
    def partition_dtypes(self) -> Dict[str, "np.dtype"]:
        return dict(self._part_dtypes)

    @property
    def root_paths(self) -> List[str]:
        return list(self._root_paths)

    @property
    def file_format(self) -> str:
        return self._file_format

    @property
    def options(self) -> Dict[str, str]:
        return dict(self._options)

    def arrow_dataset(self, files: Optional[List[str]] = None) -> pads.Dataset:
        target = files if files is not None else self._files
        if self._file_format in MATERIALIZED_FORMATS:
            return self._materialized_dataset(target)
        fmt = formats.arrow_format(self._file_format, self._options)
        if self._part_cols:
            part = pads.partitioning(pa.schema(self._partition_arrow_fields()), flavor="hive")
            return pads.dataset(
                target,
                format=fmt,
                partitioning=part,
                partition_base_dir=self._root_paths[0],
            )
        return pads.dataset(target, format=fmt)

    def _materialized_dataset(self, target: List[str]) -> pads.Dataset:
        """Avro/text: decode to in-memory tables, attaching hive-partition
        columns (constant per file, absent from the file bytes) so the schema
        matches what the native path's hive partitioning would expose."""
        tables = []
        for f in target:
            t = read_table(f, self._file_format)
            if self._part_cols:
                vals = self.partition_values_for(f)
                for field in self._partition_arrow_fields():
                    t = t.append_column(
                        field, pa.array([vals.get(field.name)] * t.num_rows, type=field.type)
                    )
            tables.append(t)
        return tables_to_dataset(tables)

    def all_file_infos(self) -> List[FileInfo]:
        return [FileInfo.from_path(f) for f in self._files]

    def signature(self) -> str:
        return file_based_signature(self.all_file_infos())

    def create_relation_metadata(self, file_id_tracker) -> Relation:
        infos = self.all_file_infos()
        if file_id_tracker is not None:
            file_id_tracker.add_files(infos)
        return Relation(
            root_paths=self.root_paths,
            data=Storage(Content.from_leaf_files(infos)),
            schema_json=schema_codec.schema_to_json(self.schema),
            file_format=self._file_format,
            options=self.options,
        )


class DefaultFileBasedRelationMetadata(FileBasedRelationMetadata):
    """(ref: HS/index/sources/default/DefaultFileBasedRelationMetadata.scala:25)"""

    def refresh(self) -> Relation:
        fresh = DefaultFileBasedRelation(
            self.relation.root_paths, self.relation.file_format, self.relation.options
        )
        return fresh.create_relation_metadata(None)

    def to_relation_object(self) -> DefaultFileBasedRelation:
        return DefaultFileBasedRelation(
            self.relation.root_paths, self.relation.file_format, self.relation.options
        )


class DefaultFileBasedSource(FileBasedSourceProvider):
    def create_relation(self, path_or_plan, session) -> Optional[FileBasedRelation]:
        if isinstance(path_or_plan, DefaultFileBasedRelation):
            return path_or_plan
        if isinstance(path_or_plan, tuple):
            paths, fmt, options = path_or_plan
            if fmt not in SUPPORTED_FORMATS:
                return None
            return DefaultFileBasedRelation(list(paths), fmt, options)
        return None

    def create_relation_metadata(self, relation: Relation, session) -> Optional[FileBasedRelationMetadata]:
        if relation.file_format in SUPPORTED_FORMATS:
            return DefaultFileBasedRelationMetadata(relation)
        return None


class DefaultFileBasedSourceBuilder:
    """Builder loaded from conf ``hyperspace.index.sources.fileBasedBuilders``
    (ref: HS/index/sources/FileBasedSourceProviderManager.scala:38-174)."""

    def build(self, session) -> FileBasedSourceProvider:
        return DefaultFileBasedSource()
