"""Refresh actions: full, incremental, quick
(ref: HS/actions/RefreshActionBase.scala:37-129, RefreshAction.scala:33-64,
RefreshIncrementalAction.scala:45-133, RefreshQuickAction.scala:32-80).

All three share the same preamble: reconstruct the source relation from the
logged metadata, re-list its files, and diff against the files recorded at
index-build time (``FileInfo`` set difference; ref: RefreshActionBase:97-128).
They differ in what they do with the diff:

  - full         — rebuild the entire index from current data
  - incremental  — index only appended files; rows from deleted files are
                   dropped via the lineage column (index data rewritten)
  - quick        — metadata-only: record appended/deleted in the log entry so
                   query-time Hybrid Scan handles them
"""

from __future__ import annotations

from typing import List, Tuple

import pyarrow as pa
import pyarrow.dataset as pads

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.actions.base import Action, HyperspaceActionException, NoChangesException
from hyperspace_tpu_torch.indexes import registry
from hyperspace_tpu_torch.indexes.base import CreateContext
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.log_entry import (
    Content,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Signature,
    Source,
)
from hyperspace_tpu_torch.sources.signatures import INDEX_SIGNATURE_PROVIDER, index_signature
from hyperspace_tpu_torch.telemetry.events import (
    RefreshActionEvent,
    RefreshIncrementalActionEvent,
    RefreshQuickActionEvent,
)


class _RefreshActionBase(Action):
    transient_state = states.REFRESHING
    final_state = states.ACTIVE

    def __init__(self, session, name: str, log_manager, data_manager):
        super().__init__(session, log_manager, data_manager)
        self._name = name
        self._entry: IndexLogEntry = None  # type: ignore[assignment]
        self._appended: List[FileInfo] = []
        self._deleted: List[FileInfo] = []
        self._tracker: FileIdTracker = FileIdTracker()
        self._fresh_relation = None  # FileBasedRelation over current source state

    @property
    def index_name(self) -> str:
        return self._name

    def validate(self) -> None:
        entry = self.log_manager.get_latest_stable_log()
        if entry is None or entry.state != states.ACTIVE:
            state = entry.state if entry else states.DOESNOTEXIST
            raise HyperspaceActionException(
                f"Refresh is only supported on an ACTIVE index; {self._name!r} is {state}."
            )
        self._entry = entry
        self._tracker = entry.file_id_tracker()

        # reconstruct the source relation from logged metadata and diff files
        # (ref: RefreshActionBase refresh() :54-76, diffs :97-128)
        metadata = self.session.provider_manager.create_relation_metadata(entry.relation)
        self._fresh_relation = metadata.to_relation_object()
        current = {fi.key: fi for fi in self._fresh_relation.all_file_infos()}
        indexed = {fi.key: fi for fi in self._entry.source_file_infos()}
        self._appended = [current[k] for k in current.keys() - indexed.keys()]
        self._deleted = [indexed[k] for k in indexed.keys() - current.keys()]
        if not self._appended and not self._deleted:
            raise NoChangesException("Refresh aborted as no source data change found.")

    # --- shared helpers ----------------------------------------------------
    def _revived_index(self):
        return registry.index_of_entry(self._entry)

    def _new_version_ctx(self) -> Tuple[CreateContext, int]:
        version = self._allocated_version = self.data_manager.allocate_version()
        ctx = CreateContext(
            session=self.session,
            index_data_path=self.data_manager.version_path(version),
            file_id_tracker=self._tracker,
        )
        return ctx, version

    def _final_entry(self, content: Content, derived_dataset) -> IndexLogEntry:
        relation_meta = self._fresh_relation.create_relation_metadata(self._tracker)
        from hyperspace_tpu_torch.plan.logical import Scan

        sig = index_signature(Scan(self._fresh_relation)) or ""
        return IndexLogEntry(
            name=self._name,
            derived_dataset=derived_dataset,
            content=content,
            source=Source(relation_meta, LogicalPlanFingerprint([Signature(INDEX_SIGNATURE_PROVIDER, sig)])),
            properties=dict(self._entry.properties),
        )


class RefreshFullAction(_RefreshActionBase):
    records_source_version = True
    """Full rebuild (ref: RefreshAction.scala:33-64)."""

    event_class = RefreshActionEvent

    def __init__(self, *args):
        super().__init__(*args)
        self._new_index = None
        self._version = 0

    def op(self) -> None:
        from hyperspace_tpu_torch.plan.dataframe import DataFrame
        from hyperspace_tpu_torch.plan.logical import Scan

        ctx, self._version = self._new_version_ctx()
        df = DataFrame(Scan(self._fresh_relation), self.session)
        index = self._revived_index()
        index.write(ctx, df)
        self._new_index = index

    def log_entry(self) -> IndexLogEntry:
        content = Content.from_directory(self.data_manager.version_path(self._version), self._tracker)
        return self._final_entry(content, self._new_index.to_derived_dataset())


class RefreshIncrementalAction(_RefreshActionBase):
    records_source_version = True
    """Index only the appended files; drop rows of deleted files via lineage
    (ref: RefreshIncrementalAction.scala:45-133)."""

    event_class = RefreshIncrementalActionEvent

    def __init__(self, *args):
        super().__init__(*args)
        self._new_index = None
        self._version = 0
        self._overwrite = False

    def validate(self) -> None:
        super().validate()
        if self._deleted:
            # kind-polymorphic, matching the query-path candidate gate: a
            # covering index needs lineage to drop deleted files' rows; other
            # kinds (data-skipping) handle deletes by rebuilding over current
            # data in op()
            from hyperspace_tpu_torch.indexes import registry

            if not registry.index_of_entry(self._entry).can_handle_deleted_files():
                raise HyperspaceActionException(
                    "Index refresh (incremental) is only supported for deleted files "
                    "when lineage is enabled; use refresh mode 'full' instead."
                )

    def op(self) -> None:
        import numpy as np
        import pyarrow.parquet as pq

        from hyperspace_tpu_torch.indexes.covering import CoveringIndex, write_bucketed
        from hyperspace_tpu_torch.plan.dataframe import DataFrame
        from hyperspace_tpu_torch.plan.logical import Scan
        from hyperspace_tpu_torch.sources.default import DefaultFileBasedRelation

        ctx, self._version = self._new_version_ctx()
        index = self._revived_index()
        if not isinstance(index, CoveringIndex):
            # other index kinds refresh by full rebuild over current data
            df = DataFrame(Scan(self._fresh_relation), self.session)
            index.write(ctx, df)
            self._new_index = index
            self._overwrite = True
            return

        appended_table = None
        if self._appended:
            appended_rel = DefaultFileBasedRelation(
                self._fresh_relation.root_paths,
                self._fresh_relation.physical_format,
                self._fresh_relation.options,
                files=[fi.name for fi in self._appended],
            )
            appended_df = DataFrame(Scan(appended_rel), self.session)
            appended_table = index._index_data_table(ctx, appended_df)

        if self._deleted:
            # read existing index data, drop rows originating from deleted
            # files (NOT-IN on the lineage column), combine with appended rows,
            # rewrite everything into the new version (Overwrite mode)
            # (ref: CoveringIndex.refreshIncremental :105-125)
            deleted_ids = {fi.file_id for fi in self._deleted if fi.file_id != C.UNKNOWN_FILE_ID}
            old = pads.dataset(self._entry.content.files, format="parquet").to_table()
            ids = old.column(C.DATA_FILE_NAME_ID).to_numpy()
            mask = ~np.isin(ids, np.array(sorted(deleted_ids), dtype=ids.dtype))
            kept = old.filter(pa.array(mask))
            combined = (
                pa.concat_tables([kept, appended_table], promote_options="default")
                if appended_table is not None
                else kept
            )
            write_bucketed(combined, index.indexed_columns, index.num_buckets, ctx.index_data_path, batch_rows=ctx.session.conf.build_batch_rows, session=ctx.session)
            # Overwrite mode re-buckets EVERY row with the current hash:
            # stamp the index consistent (covering.BUCKET_HASH_VERSION)
            from hyperspace_tpu_torch.indexes.covering import (
                _BUCKET_HASH_VERSION_PROP,
                BUCKET_HASH_VERSION,
            )

            index._extra[_BUCKET_HASH_VERSION_PROP] = str(BUCKET_HASH_VERSION)
            self._overwrite = True
        else:
            # appended-only: write just the delta, merge content trees
            # (ref: RefreshIncrementalAction merge :115-128, UpdateMode.Merge)
            assert appended_table is not None
            write_bucketed(appended_table, index.indexed_columns, index.num_buckets, ctx.index_data_path, batch_rows=ctx.session.conf.build_batch_rows, session=ctx.session)
            self._overwrite = False
        self._new_index = index

    def log_entry(self) -> IndexLogEntry:
        new_content = Content.from_directory(self.data_manager.version_path(self._version), self._tracker)
        if not self._overwrite:
            new_content = self._entry.content.merge(new_content)
        return self._final_entry(new_content, self._new_index.to_derived_dataset())


class RefreshQuickAction(_RefreshActionBase):
    """Metadata-only refresh: record appended/deleted for query-time Hybrid
    Scan (ref: RefreshQuickAction.scala:32-80)."""

    event_class = RefreshQuickActionEvent

    def op(self) -> None:
        self._tracker.add_files(self._appended)

    def log_entry(self) -> IndexLogEntry:
        entry = self._entry.copy_with_update(self._appended, self._deleted)
        return entry
