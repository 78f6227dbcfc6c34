"""CreateAction: build a new index (CREATING -> ACTIVE)
(ref: HS/actions/CreateAction.scala:29-100, CreateActionBase.scala:30-103).
"""

from __future__ import annotations

from typing import Dict

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.actions.base import Action, HyperspaceActionException
from hyperspace_tpu_torch.indexes.base import CreateContext, IndexConfig
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.log_entry import (
    Content,
    FileIdTracker,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Signature,
    Source,
)
from hyperspace_tpu_torch.plan.logical import Scan
from hyperspace_tpu_torch.plan.resolver import resolve_columns_against_schema
from hyperspace_tpu_torch.sources.signatures import INDEX_SIGNATURE_PROVIDER, index_signature
from hyperspace_tpu_torch.telemetry.events import CreateActionEvent
from hyperspace_tpu_torch.version import INDEX_LOG_VERSION, __version__


class CreateAction(Action):
    records_source_version = True
    transient_state = states.CREATING
    final_state = states.ACTIVE
    event_class = CreateActionEvent

    def __init__(self, session, df, index_config: IndexConfig, log_manager, data_manager, index_path: str):
        super().__init__(session, log_manager, data_manager)
        self.df = df
        self.index_config = index_config
        self.index_path = index_path
        self._index = None
        self._tracker = FileIdTracker()
        self._data_version = 0

    @property
    def index_name(self) -> str:
        return self.index_config.index_name

    def validate(self) -> None:
        """(ref: CreateAction.scala:50-81 — supported relation, resolvable
        columns, no name collision)."""
        if not isinstance(self.df.plan, Scan):
            raise HyperspaceActionException(
                "Only creating index over a supported source scan is allowed; "
                "apply filters/projections at query time instead."
            )
        # columns resolve?
        resolve_columns_against_schema(self.index_config.referenced_columns, self.df.plan.relation.schema)
        # Stable-state check only: a crashed creator's abandoned CREATING
        # transient must not brick the name (the retry's own transient write
        # races on the next log id, and allocate_version() gives every
        # builder an exclusive data dir, so concurrent creators can neither
        # share a version dir nor double-commit) (ref: CreateAction.scala:50-81).
        existing = self.log_manager.get_latest_stable_log()
        if existing is not None and existing.state != states.DOESNOTEXIST:
            raise HyperspaceActionException(
                f"Another index with name {self.index_name!r} already exists (state {existing.state})."
            )

    def transient_log_entry(self) -> IndexLogEntry:
        return self._build_entry(Content.from_leaf_files([]), self.index_config_stub())

    def index_config_stub(self):
        """A pre-build DerivedDataset payload (filled in by op())."""
        from hyperspace_tpu_torch.models.log_entry import DerivedDataset

        return DerivedDataset(
            "CoveringIndex" if "Covering" in type(self.index_config).__name__ else type(self.index_config).__name__,
            {"indexedColumns": self.index_config.referenced_columns},
        )

    def _enriched_properties(self) -> Dict[str, str]:
        """(ref: CreateActionBase enriched props; IndexConstants:118-127)."""
        relation = self.df.plan.relation
        return {
            C.HYPERSPACE_VERSION_PROPERTY: __version__,
            C.INDEX_LOG_VERSION_PROPERTY: INDEX_LOG_VERSION,
            C.HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY: str(relation.has_parquet_as_source_format()).lower(),
        }

    def op(self) -> None:
        self._data_version = self._allocated_version = self.data_manager.allocate_version()
        data_path = self.data_manager.version_path(self._data_version)
        ctx = CreateContext(
            session=self.session,
            index_data_path=data_path,
            file_id_tracker=self._tracker,
            properties=self._enriched_properties(),
        )
        self._index = self.index_config.create_index(ctx, self.df, self._enriched_properties())

    def _build_entry(self, content: Content, derived_dataset) -> IndexLogEntry:
        relation_meta = self.df.plan.relation.create_relation_metadata(self._tracker)
        sig_value = index_signature(self.df.plan)
        entry = IndexLogEntry(
            name=self.index_name,
            derived_dataset=derived_dataset,
            content=content,
            source=Source(
                relation_meta,
                LogicalPlanFingerprint([Signature(INDEX_SIGNATURE_PROVIDER, sig_value or "")]),
            ),
            properties={},
        )
        return entry

    def log_entry(self) -> IndexLogEntry:
        assert self._index is not None
        data_path = self.data_manager.version_path(self._data_version)
        content = Content.from_directory(data_path, self._tracker)
        return self._build_entry(content, self._index.to_derived_dataset())
