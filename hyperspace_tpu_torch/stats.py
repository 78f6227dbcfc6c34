"""Index statistics (ref: HS/index/IndexStatistics.scala:41-96)."""

from __future__ import annotations

from typing import Any, Dict

from hyperspace_tpu_torch.models.log_entry import IndexLogEntry


def _index_location(entry: IndexLogEntry, infos) -> str:
    """Common directory of the index's data files (after incremental refresh
    the content can span several v__=N version dirs; their parent is the
    index root — ref: IndexStatistics commonPrefix, IndexStatistics.scala:70-96)."""
    import os

    if not infos:
        return entry.content.root.name
    return os.path.commonpath([os.path.dirname(fi.name) for fi in infos])


def index_statistics(session, entry: IndexLogEntry, extended: bool = False) -> Dict[str, Any]:
    infos = entry.content.file_infos()
    row: Dict[str, Any] = {
        "name": entry.name,
        "indexedColumns": entry.derived_dataset.properties.get("indexedColumns", []),
        "includedColumns": entry.derived_dataset.properties.get("includedColumns", []),
        "numBuckets": entry.derived_dataset.properties.get("numBuckets"),
        "schema": entry.derived_dataset.properties.get("schemaJson", ""),
        "indexLocation": _index_location(entry, infos),
        "state": entry.state,
        "kind": entry.kind,
    }
    if extended:
        row.update(
            {
                "numIndexFiles": len(infos),
                "sizeInBytes": entry.content.total_size,
                "logVersion": entry.id,
                "appendedFiles": [f.name for f in entry.appended_files()],
                "deletedFiles": [f.name for f in entry.deleted_files()],
                "indexContentPaths": entry.content.files,
            }
        )
    return row
