"""Delta Lake source provider.

Reads the Delta transaction log (``_delta_log/NNN...N.json``) natively — no
Spark — replaying add/remove actions to materialize the file list at any
table version, enabling time travel
(ref: HS/index/sources/delta/DeltaLakeFileBasedSource.scala:31,
DeltaLakeRelation.scala:40-44 signature = tableVersion + path;
DeltaLakeRelationMetadata.scala:39-53 deltaVersions history property).

Also ships a minimal writer (``write_delta_table``) so tests and local
pipelines can produce Delta tables without Spark.

Checkpoint parquet files are supported read-only (``_last_checkpoint``).
"""

from __future__ import annotations

import json
import os
import re
import time
import uuid
from typing import Any, Dict, List, Optional

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from hyperspace_tpu_torch.models.log_entry import Content, FileInfo, IndexLogEntry, Relation, Storage
from hyperspace_tpu_torch.sources import schema as schema_codec
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedRelationMetadata,
    FileBasedSourceProvider,
)
from hyperspace_tpu_torch.utils.hashing import md5_hex

DELTA_LOG_DIR = "_delta_log"
_VERSION_FILE_RE = re.compile(r"^(\d{20})\.json$")
DELTA_VERSIONS_PROPERTY = "deltaVersions"


def _log_dir(root: str) -> str:
    return os.path.join(root, DELTA_LOG_DIR)


def list_versions(root: str) -> List[int]:
    try:
        names = os.listdir(_log_dir(root))
    except OSError:
        return []
    out = []
    for n in names:
        m = _VERSION_FILE_RE.match(n)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _replay(root: str, version: int) -> Dict[str, Dict]:
    """Replay the log up to ``version`` inclusive; returns path -> add action."""
    files: Dict[str, Dict] = {}
    checkpoint_version = -1
    cp_path = os.path.join(_log_dir(root), "_last_checkpoint")
    if os.path.exists(cp_path):
        with open(cp_path) as f:
            cp = json.load(f)
        if cp.get("version", -1) <= version:
            checkpoint_version = int(cp["version"])
            cp_file = os.path.join(_log_dir(root), f"{checkpoint_version:020d}.checkpoint.parquet")
            t = pq.read_table(cp_file)
            for row in t.to_pylist():
                add = row.get("add")
                if add and add.get("path"):
                    files[add["path"]] = add
    for v in list_versions(root):
        if v <= checkpoint_version or v > version:
            continue
        with open(os.path.join(_log_dir(root), f"{v:020d}.json")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                action = json.loads(line)
                if "add" in action:
                    files[action["add"]["path"]] = action["add"]
                elif "remove" in action:
                    files.pop(action["remove"]["path"], None)
    return files


class DeltaLakeRelation(FileBasedRelation):
    def __init__(self, root: str, version: Optional[int] = None):
        self._root = os.path.abspath(root)
        versions = list_versions(self._root)
        if not versions:
            raise FileNotFoundError(f"No Delta table found at {root!r} (missing {DELTA_LOG_DIR})")
        self._version = versions[-1] if version is None else int(version)
        if self._version not in versions and version is not None:
            # allow any version <= latest present in the log range
            if self._version > versions[-1] or self._version < 0:
                raise ValueError(f"Version {version} not available; latest is {versions[-1]}")
        self._adds = _replay(self._root, self._version)
        if not self._adds:
            raise FileNotFoundError(f"Delta table at {root!r} has no data files at version {self._version}")
        self._schema: Optional[pa.Schema] = None

    @property
    def name(self) -> str:
        return self._root

    @property
    def version(self) -> int:
        return self._version

    @property
    def schema(self) -> pa.Schema:
        if self._schema is None:
            self._schema = self.arrow_dataset().schema
        return self._schema

    @property
    def root_paths(self) -> List[str]:
        return [self._root]

    @property
    def file_format(self) -> str:
        return "delta"

    @property
    def options(self) -> Dict[str, str]:
        return {"versionAsOf": str(self._version)}

    def _abs_files(self) -> List[str]:
        return sorted(os.path.join(self._root, p) for p in self._adds)

    def arrow_dataset(self, files: Optional[List[str]] = None) -> pads.Dataset:
        return pads.dataset(files if files is not None else self._abs_files(), format="parquet")

    def all_file_infos(self) -> List[FileInfo]:
        out = []
        for rel_path, add in sorted(self._adds.items()):
            out.append(
                FileInfo(
                    os.path.join(self._root, rel_path),
                    int(add.get("size", 0)),
                    int(add.get("modificationTime", 0)),
                )
            )
        return out

    def signature(self) -> str:
        """Delta signature = table version + path
        (ref: DeltaLakeRelation.scala:40-44)."""
        return md5_hex(f"delta:{self._root}:{self._version}")

    def has_parquet_as_source_format(self) -> bool:
        return True

    def create_relation_metadata(self, file_id_tracker) -> Relation:
        infos = self.all_file_infos()
        if file_id_tracker is not None:
            file_id_tracker.add_files(infos)
        return Relation(
            root_paths=self.root_paths,
            data=Storage(Content.from_leaf_files(infos)),
            schema_json=schema_codec.schema_to_json(self.schema),
            file_format="delta",
            options=self.options,
        )

    def closest_index(self, entry: IndexLogEntry) -> IndexLogEntry:
        """Time-travel-aware index-version selection: when querying an older
        table version, use the index log version whose recorded delta version
        is closest to (and at most) the queried version
        (ref: DeltaLakeRelation.scala:179-251)."""
        history = entry.properties.get(DELTA_VERSIONS_PROPERTY)
        if not history:
            return entry
        # history: {index_log_id(str): delta_version(int)}; among versions at
        # most the queried one, prefer the highest version and, on ties, the
        # LATEST log id (earlier ids for the same version are superseded)
        best_log_id, best_delta = None, None
        for log_id_str, delta_v in history.items():
            dv, lid = int(delta_v), int(log_id_str)
            if dv <= self._version and (best_delta is None or (dv, lid) > (best_delta, best_log_id)):
                best_log_id, best_delta = lid, dv
        if best_log_id is None or best_log_id == entry.id:
            return entry
        # the LATEST entry covers the newest recorded snapshot even when its
        # own id isn't in the history (optimize/restore entries supersede the
        # recording refresh without changing source coverage) — only reach
        # back for a strictly older snapshot
        latest_recorded = max(int(v) for v in history.values())
        if best_delta >= latest_recorded:
            return entry
        from hyperspace_tpu_torch.models.log_manager import IndexLogManager
        from hyperspace_tpu_torch.models.path_resolver import PathResolver

        # re-read that log version of the same index
        index_root = os.path.dirname(os.path.dirname(entry.content.files[0])) if entry.content.files else None
        if index_root is None:
            return entry
        older = IndexLogManager(index_root).get_log(best_log_id)
        return older if older is not None and older.state == entry.state else entry


class DeltaLakeRelationMetadata(FileBasedRelationMetadata):
    """(ref: HS/index/sources/delta/DeltaLakeRelationMetadata.scala:39-53)"""

    def refresh(self) -> Relation:
        return self.to_relation_object().create_relation_metadata(None)

    def to_relation_object(self) -> DeltaLakeRelation:
        return DeltaLakeRelation(self.relation.root_paths[0])  # latest version

    def enrich_index_properties(
        self,
        properties: Dict[str, Any],
        log_id: Optional[int] = None,
        previous_properties: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Maintain the index-log-version -> delta-table-version history that
        time-travel queries consult via ``closest_index``
        (ref: DeltaLakeRelationMetadata.scala:39-53 deltaVersions).

        ``log_id=None`` means carry the history forward without recording
        (actions whose entries copy their predecessor)."""
        history = dict((previous_properties or {}).get(DELTA_VERSIONS_PROPERTY) or {})
        if log_id is not None:
            version = self.relation.options.get("versionAsOf")
            if version is not None:
                history[str(log_id)] = int(version)
        if not history:
            return properties
        out = dict(properties)
        out[DELTA_VERSIONS_PROPERTY] = history
        return out


class DeltaLakeFileBasedSource(FileBasedSourceProvider):
    def create_relation(self, path_or_plan, session) -> Optional[FileBasedRelation]:
        if isinstance(path_or_plan, DeltaLakeRelation):
            return path_or_plan
        if isinstance(path_or_plan, tuple):
            paths, fmt, options = path_or_plan
            if fmt == "delta":
                version = options.get("versionAsOf")
                return DeltaLakeRelation(list(paths)[0], None if version is None else int(version))
        return None

    def create_relation_metadata(self, relation: Relation, session) -> Optional[FileBasedRelationMetadata]:
        if relation.file_format == "delta":
            return DeltaLakeRelationMetadata(relation)
        return None


class DeltaLakeSourceBuilder:
    def build(self, session) -> FileBasedSourceProvider:
        return DeltaLakeFileBasedSource()


# --- minimal writer (tests / local pipelines; no Spark needed) --------------

def write_delta_table(table: pa.Table, root: str, mode: str = "append") -> int:
    """Write ``table`` as one parquet part + one Delta commit. Returns the new
    table version. ``mode='overwrite'`` removes all previous files."""
    root = os.path.abspath(root)
    os.makedirs(_log_dir(root), exist_ok=True)
    versions = list_versions(root)
    new_version = (versions[-1] + 1) if versions else 0

    part = f"part-{new_version:05d}-{uuid.uuid4().hex[:12]}.parquet"
    pq.write_table(table, os.path.join(root, part))
    st = os.stat(os.path.join(root, part))

    actions = []
    if new_version == 0:
        actions.append({"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}})
        actions.append(
            {
                "metaData": {
                    "id": uuid.uuid4().hex,
                    "format": {"provider": "parquet", "options": {}},
                    "partitionColumns": [],
                    "configuration": {},
                }
            }
        )
    if mode == "overwrite" and new_version > 0:
        for rel_path in _replay(root, versions[-1]):
            actions.append({"remove": {"path": rel_path, "dataChange": True}})
    actions.append(
        {
            "add": {
                "path": part,
                "size": st.st_size,
                "modificationTime": int(st.st_mtime * 1000),
                "dataChange": True,
                "partitionValues": {},
            }
        }
    )
    actions.append({"commitInfo": {"timestamp": int(time.time() * 1000), "operation": "WRITE"}})
    with open(os.path.join(_log_dir(root), f"{new_version:020d}.json"), "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")
    return new_version


def delete_delta_files(root: str, rel_paths: List[str]) -> int:
    """Commit a remove-only transaction (logical delete of whole files)."""
    root = os.path.abspath(root)
    versions = list_versions(root)
    if not versions:
        raise FileNotFoundError(f"No Delta table at {root!r}")
    new_version = versions[-1] + 1
    with open(os.path.join(_log_dir(root), f"{new_version:020d}.json"), "w") as f:
        for p in rel_paths:
            f.write(json.dumps({"remove": {"path": p, "dataChange": True}}) + "\n")
        f.write(json.dumps({"commitInfo": {"timestamp": int(time.time() * 1000), "operation": "DELETE"}}) + "\n")
    return new_version
