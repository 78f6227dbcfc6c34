"""Index metadata model.

The full schema of an index's on-storage metadata, mirroring the semantics of
the reference's ``IndexLogEntry`` (ref: HS/index/IndexLogEntry.scala:40-685):

  - ``FileInfo``     — one source/index file: name, size, mtime, stable id
  - ``Directory``    — compressed file tree (``from_leaf_files``/``merge``)
  - ``Content``      — a Directory tree rooted at an absolute path
  - ``Signature``    — provider-name + opaque fingerprint value
  - ``LogicalPlanFingerprint`` — the set of signatures of the source plan
  - ``Update``       — appended/deleted file trees (quick refresh / hybrid scan)
  - ``Relation``     — snapshot of the source relation (paths, data, schema,
                       file format, options)
  - ``Source``       — plan node wrapping Relation + fingerprint
  - ``IndexLogEntry``— one operation-log record (id, state, timestamp, the
                       derived-dataset payload, content tree, source snapshot)
  - ``FileIdTracker``— stable (name, size, mtime) → id assignment
                       (ref: HS/index/IndexLogEntry.scala:609-685)

Everything (de)serializes to plain-dict JSON; transient query-time state lives
in a ``tags`` dict that is never persisted (ref: IndexLogEntry tags :519-571).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hyperspace_tpu_torch import config as C

FileKey = Tuple[str, int, int]  # (absolute path, size, modified_time)


class FileInfo:
    """A single file's metadata. Equality/hash ignore ``file_id`` — two
    FileInfos are the same file iff (name, size, mtime) match
    (ref: HS/index/IndexLogEntry.scala:308-333)."""

    __slots__ = ("name", "size", "modified_time", "file_id")

    def __init__(self, name: str, size: int, modified_time: int, file_id: int = C.UNKNOWN_FILE_ID):
        self.name = name
        self.size = int(size)
        self.modified_time = int(modified_time)
        self.file_id = int(file_id)

    @classmethod
    def from_path(cls, path: str, file_id: int = C.UNKNOWN_FILE_ID) -> "FileInfo":
        st = os.stat(path)
        return cls(os.path.abspath(path), st.st_size, st.st_mtime_ns, file_id)

    @property
    def key(self) -> FileKey:
        return (self.name, self.size, self.modified_time)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, FileInfo) and self.key == other.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        return f"FileInfo({self.name!r}, {self.size}, {self.modified_time}, id={self.file_id})"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "size": self.size,
            "modifiedTime": self.modified_time,
            "id": self.file_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FileInfo":
        return cls(d["name"], d["size"], d["modifiedTime"], d.get("id", C.UNKNOWN_FILE_ID))


@dataclass
class Directory:
    """A node of the compressed file tree. ``files`` hold leaf-file metadata
    with *basename* names; absolute paths are reconstructed by joining the
    names on the path from the root (ref: HS/index/IndexLogEntry.scala:123-284).
    """

    name: str
    files: List[FileInfo] = field(default_factory=list)
    subdirs: List["Directory"] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "files": [f.to_dict() for f in self.files],
            "subDirs": [d.to_dict() for d in self.subdirs],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Directory":
        return cls(
            d["name"],
            [FileInfo.from_dict(f) for f in d.get("files", [])],
            [Directory.from_dict(s) for s in d.get("subDirs", [])],
        )

    def merge(self, other: "Directory") -> "Directory":
        """Merge two trees with the same root name
        (ref: HS/index/IndexLogEntry.scala:149-171)."""
        if self.name != other.name:
            raise ValueError(f"Merging directories with names {self.name!r} and {other.name!r} failed.")
        files = list(self.files)
        seen = {f.key for f in files}
        files.extend(f for f in other.files if f.key not in seen)
        by_name = {d.name: d for d in self.subdirs}
        merged_subdirs: List[Directory] = []
        other_names = set()
        for od in other.subdirs:
            other_names.add(od.name)
            if od.name in by_name:
                merged_subdirs.append(by_name[od.name].merge(od))
            else:
                merged_subdirs.append(od)
        merged_subdirs.extend(d for d in self.subdirs if d.name not in other_names)
        return Directory(self.name, files, sorted(merged_subdirs, key=lambda d: d.name))

    @classmethod
    def from_leaf_files(cls, files: Iterable[FileInfo]) -> "Directory":
        """Build the compressed tree from absolute-path leaf files
        (ref: HS/index/IndexLogEntry.scala:230-284). Root node is ``/``."""
        root = cls("/")
        index: Dict[str, Directory] = {"": root}

        def get_dir(path: str) -> Directory:
            if path in index:
                return index[path]
            parent_path, name = os.path.split(path)
            if parent_path == path:  # filesystem root
                return root
            parent = get_dir(parent_path.rstrip("/") if parent_path != "/" else "")
            node = cls(name)
            parent.subdirs.append(node)
            index[path] = node
            return node

        for f in files:
            parent = get_dir(os.path.dirname(os.path.abspath(f.name)).rstrip("/"))
            parent.files.append(FileInfo(os.path.basename(f.name), f.size, f.modified_time, f.file_id))
        _sort_tree(root)
        return root


def _sort_tree(d: Directory) -> None:
    d.files.sort(key=lambda f: f.name)
    d.subdirs.sort(key=lambda s: s.name)
    for s in d.subdirs:
        _sort_tree(s)


@dataclass
class Content:
    """A file tree rooted at the absolute root directory
    (ref: HS/index/IndexLogEntry.scala:40-121)."""

    root: Directory

    @property
    def files(self) -> List[str]:
        return [fi.name for fi in self.file_infos()]

    def file_infos(self) -> List[FileInfo]:
        """Leaf files with absolute-path names.

        The tree is never mutated after construction (merge/refresh build new
        Content objects), so the walk is memoized — the optimizer touches this
        on every candidate index per query, and re-joining every path
        dominated the rewrite pass before caching."""
        cached = self.__dict__.get("_file_infos")
        if cached is None:
            out: List[FileInfo] = []

            def walk(node: Directory, prefix: str) -> None:
                base = os.path.join(prefix, node.name) if prefix else node.name
                for f in node.files:
                    out.append(FileInfo(os.path.join(base, f.name), f.size, f.modified_time, f.file_id))
                for s in node.subdirs:
                    walk(s, base)

            walk(self.root, "")
            cached = self.__dict__["_file_infos"] = out
        return list(cached)

    def file_info_map(self) -> Dict[str, FileInfo]:
        """``file_infos()`` by absolute path, memoized as the walk is: an index
        scan looks its files' committed facts up here instead of stat'ing them
        (exec/executor.py::leaf_file_facts)."""
        cached = self.__dict__.get("_file_info_map")
        if cached is None:
            cached = self.__dict__["_file_info_map"] = {fi.name: fi for fi in self.file_infos()}
        return cached

    @property
    def total_size(self) -> int:
        cached = self.__dict__.get("_total_size")
        if cached is None:
            cached = self.__dict__["_total_size"] = sum(f.size for f in self.file_infos())
        return cached

    def merge(self, other: "Content") -> "Content":
        return Content(self.root.merge(other.root))

    @classmethod
    def from_leaf_files(cls, files: Iterable[FileInfo]) -> "Content":
        return cls(Directory.from_leaf_files(files))

    @classmethod
    def from_directory(cls, path: str, tracker: Optional["FileIdTracker"] = None) -> "Content":
        """Scan ``path`` recursively, assigning ids via ``tracker``."""
        from hyperspace_tpu_torch.utils.file_utils import walk_data_files

        infos: List[FileInfo] = []
        for fpath in walk_data_files(path):
            fi = FileInfo.from_path(fpath)
            if tracker is not None:
                fi.file_id = tracker.add_file(fi)
            infos.append(fi)
        if not infos:
            # Represent an empty content tree rooted at path itself.
            return cls(Directory.from_leaf_files([]))
        return cls.from_leaf_files(infos)

    def to_dict(self) -> Dict[str, Any]:
        return {"root": self.root.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Content":
        return cls(Directory.from_dict(d["root"]))


@dataclass(frozen=True)
class Signature:
    """(provider class name, fingerprint value)
    (ref: HS/index/IndexLogEntry.scala:335-336)."""

    provider: str
    value: str

    def to_dict(self) -> Dict[str, Any]:
        return {"provider": self.provider, "value": self.value}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Signature":
        return cls(d["provider"], d["value"])


@dataclass
class LogicalPlanFingerprint:
    """Signatures of the source logical plan
    (ref: HS/index/IndexLogEntry.scala:338-349)."""

    signatures: List[Signature]
    kind: str = "LogicalPlan"

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "properties": {"signatures": [s.to_dict() for s in self.signatures]}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LogicalPlanFingerprint":
        sigs = [Signature.from_dict(s) for s in d.get("properties", {}).get("signatures", [])]
        return cls(sigs, d.get("kind", "LogicalPlan"))


@dataclass
class Update:
    """Appended/deleted source files recorded by quick refresh
    (ref: HS/index/IndexLogEntry.scala:351-352)."""

    appended_files: Optional[Content] = None
    deleted_files: Optional[Content] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "appendedFiles": self.appended_files.to_dict() if self.appended_files else None,
            "deletedFiles": self.deleted_files.to_dict() if self.deleted_files else None,
        }

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["Update"]:
        if not d:
            return None
        return cls(
            Content.from_dict(d["appendedFiles"]) if d.get("appendedFiles") else None,
            Content.from_dict(d["deletedFiles"]) if d.get("deletedFiles") else None,
        )


@dataclass
class Storage:
    """Source data snapshot: the content tree at index-build time plus any
    recorded update (ref: ``Hdfs`` at HS/index/IndexLogEntry.scala:354-377)."""

    content: Content
    update: Optional[Update] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"content": self.content.to_dict(), "update": self.update.to_dict() if self.update else None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Storage":
        return cls(Content.from_dict(d["content"]), Update.from_dict(d.get("update")))


@dataclass
class Relation:
    """Snapshot of the source relation
    (ref: HS/index/IndexLogEntry.scala:379-385)."""

    root_paths: List[str]
    data: Storage
    schema_json: str  # arrow schema serialized as JSON (see sources/schema.py)
    file_format: str
    options: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rootPaths": self.root_paths,
            "data": self.data.to_dict(),
            "dataSchemaJson": self.schema_json,
            "fileFormat": self.file_format,
            "options": self.options,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Relation":
        return cls(
            list(d["rootPaths"]),
            Storage.from_dict(d["data"]),
            d["dataSchemaJson"],
            d["fileFormat"],
            dict(d.get("options", {})),
        )


@dataclass
class Source:
    """The logged source plan: a single relation plus its fingerprint
    (ref: ``SparkPlan``/``Source`` at HS/index/IndexLogEntry.scala:387-406)."""

    relation: Relation
    fingerprint: LogicalPlanFingerprint

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan": {
                "kind": "Relation",
                "properties": {
                    "relations": [self.relation.to_dict()],
                    "fingerprint": self.fingerprint.to_dict(),
                },
            }
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Source":
        props = d["plan"]["properties"]
        return cls(
            Relation.from_dict(props["relations"][0]),
            LogicalPlanFingerprint.from_dict(props["fingerprint"]),
        )


@dataclass
class DerivedDataset:
    """The index payload: a kind tag (e.g. ``CoveringIndex``) plus its
    kind-specific properties. Revived into a concrete ``Index`` via the
    registry in ``indexes/registry.py``
    (ref: the polymorphic ``derivedDataset`` of HS/index/IndexLogEntry.scala:408-430)."""

    kind: str
    properties: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "properties": self.properties}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DerivedDataset":
        return cls(d["kind"], dict(d.get("properties", {})))


class FileIdTracker:
    """Assigns stable, monotonically increasing ids to (name, size, mtime)
    keys across the lifetime of an index
    (ref: HS/index/IndexLogEntry.scala:609-685)."""

    def __init__(self) -> None:
        self._ids: Dict[FileKey, int] = {}
        self._max_id: int = C.UNKNOWN_FILE_ID

    @property
    def max_id(self) -> int:
        return self._max_id

    def file_to_id_map(self) -> Dict[FileKey, int]:
        return dict(self._ids)

    def add_file(self, fi: FileInfo) -> int:
        """Record ``fi``; returns its id. Existing key keeps its id; a known
        id (>= 0) on a new key is honored; otherwise a fresh id is assigned."""
        key = fi.key
        if key in self._ids:
            existing = self._ids[key]
            if fi.file_id != C.UNKNOWN_FILE_ID and fi.file_id != existing:
                raise ValueError(
                    f"Adding file {fi.name} with id {fi.file_id} conflicts with existing id {existing}."
                )
            return existing
        if fi.file_id == C.UNKNOWN_FILE_ID:
            self._max_id += 1
            self._ids[key] = self._max_id
        else:
            self._ids[key] = fi.file_id
            self._max_id = max(self._max_id, fi.file_id)
        return self._ids[key]

    def add_files(self, files: Iterable[FileInfo]) -> None:
        for f in files:
            f.file_id = self.add_file(f)

    def get_file_id(self, key: FileKey) -> Optional[int]:
        return self._ids.get(key)

    @classmethod
    def from_contents(cls, *contents: Content) -> "FileIdTracker":
        tracker = cls()
        for c in contents:
            for fi in c.file_infos():
                if fi.file_id != C.UNKNOWN_FILE_ID:
                    tracker.add_file(fi)
        return tracker


class LogEntry:
    """Versioned operation-log record base: id, state, timestamp
    (ref: HS/index/LogEntry.scala:23-46)."""

    def __init__(self, state: str, log_id: int = 0, timestamp: int = 0):
        self.state = state
        self.id = log_id
        self.timestamp = timestamp


class IndexLogEntry(LogEntry):
    """One full index-metadata record (ref: HS/index/IndexLogEntry.scala:408-572).

    ``tags`` is transient per-process state keyed by (plan_key, tag_name),
    used only by the whyNot analysis, which wipes it before and after each
    run (ref: IndexLogEntry tags :519-571); it is never serialized.
    """

    def __init__(
        self,
        name: str,
        derived_dataset: DerivedDataset,
        content: Content,
        source: Source,
        properties: Dict[str, Any],
        state: str = "",
        log_id: int = 0,
        timestamp: int = 0,
    ):
        super().__init__(state, log_id, timestamp)
        self.name = name
        self.derived_dataset = derived_dataset
        self.content = content
        self.source = source
        self.properties = dict(properties)
        self.tags: Dict[Tuple[Any, str], Any] = {}

    # --- derived accessors -------------------------------------------------
    @property
    def kind(self) -> str:
        return self.derived_dataset.kind

    @property
    def relation(self) -> Relation:
        return self.source.relation

    @property
    def signature(self) -> LogicalPlanFingerprint:
        return self.source.fingerprint

    def source_files_size(self) -> int:
        return self.relation.data.content.total_size

    def source_file_infos(self) -> List[FileInfo]:
        return self.relation.data.content.file_infos()

    def appended_files(self) -> List[FileInfo]:
        u = self.relation.data.update
        return u.appended_files.file_infos() if u and u.appended_files else []

    def deleted_files(self) -> List[FileInfo]:
        u = self.relation.data.update
        return u.deleted_files.file_infos() if u and u.deleted_files else []

    def file_id_tracker(self) -> FileIdTracker:
        tracker = FileIdTracker.from_contents(self.relation.data.content)
        u = self.relation.data.update
        if u:
            for c in (u.appended_files, u.deleted_files):
                if c:
                    for fi in c.file_infos():
                        if fi.file_id != C.UNKNOWN_FILE_ID:
                            tracker.add_file(fi)
        return tracker

    def has_parquet_as_source_format(self) -> bool:
        return (
            str(self.derived_dataset.properties.get(C.HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY, "false")).lower()
            == "true"
        )

    def has_lineage_column(self) -> bool:
        return str(self.derived_dataset.properties.get(C.LINEAGE_PROPERTY, "false")).lower() == "true"

    def with_next_id(self, next_id: int) -> "IndexLogEntry":
        self.id = next_id
        return self

    def copy_with_update(self, appended: List[FileInfo], deleted: List[FileInfo]) -> "IndexLogEntry":
        """Record appended/deleted files for query-time hybrid scan
        (ref: HS/index/IndexLogEntry.scala:460-475, used by RefreshQuickAction)."""
        new = IndexLogEntry.from_dict(self.to_dict())
        new.relation.data.update = Update(
            Content.from_leaf_files(appended) if appended else None,
            Content.from_leaf_files(deleted) if deleted else None,
        )
        return new

    # --- tags (transient) --------------------------------------------------
    def set_tag(self, plan_key: Any, tag: str, value: Any) -> None:
        self.tags[(plan_key, tag)] = value

    def get_tag(self, plan_key: Any, tag: str) -> Any:
        return self.tags.get((plan_key, tag))

    def unset_tag(self, plan_key: Any, tag: str) -> None:
        self.tags.pop((plan_key, tag), None)

    def unset_tag_for_all_plans(self, tag: str) -> None:
        """Drop a tag for every plan key (ref: IndexLogEntry
        ``unsetTagValueForAllPlan``, HS/index/IndexLogEntry.scala:560-565) —
        entries are shared across queries by the caching manager, so analysis
        tags must be wiped before each whyNot run."""
        for key in [k for k in self.tags if k[1] == tag]:
            self.tags.pop(key, None)

    # --- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "derivedDataset": self.derived_dataset.to_dict(),
            "content": self.content.to_dict(),
            "source": self.source.to_dict(),
            "properties": self.properties,
            "state": self.state,
            "id": self.id,
            "timestamp": self.timestamp,
            "enabled": True,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IndexLogEntry":
        return cls(
            name=d["name"],
            derived_dataset=DerivedDataset.from_dict(d["derivedDataset"]),
            content=Content.from_dict(d["content"]),
            source=Source.from_dict(d["source"]),
            properties=dict(d.get("properties", {})),
            state=d.get("state", ""),
            log_id=d.get("id", 0),
            timestamp=d.get("timestamp", 0),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "IndexLogEntry":
        return cls.from_dict(json.loads(text))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, IndexLogEntry) and self.to_dict() == other.to_dict()

    def __hash__(self) -> int:
        return hash((self.name, self.id, self.state))
