"""Source-provider manager.

Builds the providers that the conf's comma-separated builder class names
list and dispatches each source call to them, enforcing that exactly one
provider answers (ref: HS/index/sources/FileBasedSourceProviderManager.scala:38-174).

A class name resolves through a static table of the port's own builders,
never by importing the name: a conf shared with the JAX package names that
package's classes, which load the same builders here under the package
prefix ``hyperspace_tpu`` as under ``hyperspace_tpu_torch``.
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch.models.log_entry import Relation
from hyperspace_tpu_torch.sources.default import DefaultFileBasedSourceBuilder
from hyperspace_tpu_torch.sources.delta import DeltaLakeSourceBuilder
from hyperspace_tpu_torch.sources.iceberg import IcebergSourceBuilder
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedRelationMetadata,
    FileBasedSourceProvider,
)


class HyperspaceException(Exception):
    pass


#: builder class name, below the package name -> the port's builder
_BUILDERS = {
    "sources.default.DefaultFileBasedSourceBuilder": DefaultFileBasedSourceBuilder,
    "sources.delta.DeltaLakeSourceBuilder": DeltaLakeSourceBuilder,
    "sources.iceberg.IcebergSourceBuilder": IcebergSourceBuilder,
}

#: package names whose builder class names the table resolves
_PACKAGES = ("hyperspace_tpu_torch", "hyperspace_tpu")


def builder_class(dotted: str):
    package, _, name = dotted.strip().partition(".")
    builder = _BUILDERS.get(name) if package in _PACKAGES else None
    if builder is None:
        raise HyperspaceException(f"Unknown source builder {dotted!r}; known: {sorted(_BUILDERS)}")
    return builder


class FileBasedSourceProviderManager:
    def __init__(self, session):
        self._session = session
        self._providers: Optional[List[FileBasedSourceProvider]] = None
        self._built_from: Optional[str] = None

    def providers(self) -> List[FileBasedSourceProvider]:
        raw = self._session.conf.source_builders
        if self._providers is None or raw != self._built_from:
            self._providers = [builder_class(name)().build(self._session) for name in raw.split(",") if name.strip()]
            self._built_from = raw
        return self._providers

    def _run_single(self, fn_name: str, *args):
        answers = []
        for p in self.providers():
            result = getattr(p, fn_name)(*args, self._session)
            if result is not None:
                answers.append(result)
        if len(answers) != 1:
            raise HyperspaceException(
                f"Expected exactly one source provider to handle {fn_name}; got {len(answers)}."
            )
        return answers[0]

    def create_relation(self, path_or_plan) -> FileBasedRelation:
        return self._run_single("create_relation", path_or_plan)

    def create_relation_metadata(self, relation: Relation) -> FileBasedRelationMetadata:
        return self._run_single("create_relation_metadata", relation)
