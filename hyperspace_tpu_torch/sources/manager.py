"""Source-provider manager.

Dispatches each source call to the default file-based (parquet) provider,
the only source the port has, and raises when it does not answer
(ref: HS/index/sources/FileBasedSourceProviderManager.scala:38-174). The
conf-loaded list of provider builders comes with the first other source.
"""

from __future__ import annotations

from hyperspace_tpu_torch.models.log_entry import Relation
from hyperspace_tpu_torch.sources.default import DefaultFileBasedSource
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedRelationMetadata,
)


class HyperspaceException(Exception):
    pass


class FileBasedSourceProviderManager:
    def __init__(self, session):
        self._session = session
        self._provider = DefaultFileBasedSource()

    def _run(self, fn_name: str, arg):
        result = getattr(self._provider, fn_name)(arg, self._session)
        if result is None:
            raise HyperspaceException(f"No source provider handles {fn_name} for {arg!r}.")
        return result

    def create_relation(self, path_or_plan) -> FileBasedRelation:
        return self._run("create_relation", path_or_plan)

    def create_relation_metadata(self, relation: Relation) -> FileBasedRelationMetadata:
        return self._run("create_relation_metadata", relation)
