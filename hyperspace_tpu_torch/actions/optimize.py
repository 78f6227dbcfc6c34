"""OptimizeAction: compact small index files per bucket
(ref: HS/actions/OptimizeAction.scala:57-148).

quick mode — only files below ``hyperspace.index.optimize.fileSizeThreshold``;
full mode — all files. Buckets with more than one eligible file get their
files merged (rows re-sorted) into a single file in a new data version; files
left out ("ignored") stay referenced by the merged content tree
(ref: OptimizeAction.scala:96-143).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

import pyarrow as pa
import pyarrow.dataset as pads

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.actions.base import Action, HyperspaceActionException, NoChangesException
from hyperspace_tpu_torch.indexes import registry
from hyperspace_tpu_torch.indexes.covering import CoveringIndex, bucket_of_file, write_bucketed
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.log_entry import Content, FileIdTracker, FileInfo, IndexLogEntry
from hyperspace_tpu_torch.telemetry.events import OptimizeActionEvent


class OptimizeAction(Action):
    transient_state = states.OPTIMIZING
    final_state = states.ACTIVE
    event_class = OptimizeActionEvent

    def __init__(self, session, name: str, log_manager, data_manager, mode: str):
        super().__init__(session, log_manager, data_manager)
        self._name = name
        self._mode = mode
        self._entry: IndexLogEntry = None  # type: ignore[assignment]
        self._to_optimize: Dict[int, List[FileInfo]] = {}
        self._ignored: List[FileInfo] = []
        self._version = 0
        self._tracker = FileIdTracker()

    @property
    def index_name(self) -> str:
        return self._name

    def validate(self) -> None:
        entry = self.log_manager.get_latest_stable_log()
        if entry is None or entry.state != states.ACTIVE:
            state = entry.state if entry else states.DOESNOTEXIST
            raise HyperspaceActionException(
                f"Optimize is only supported on an ACTIVE index; {self._name!r} is {state}."
            )
        if entry.kind != CoveringIndex.kind:
            raise HyperspaceActionException(f"Optimize is not supported for {entry.kind} indexes.")
        self._entry = entry
        self._tracker = entry.file_id_tracker()

        threshold = self.session.conf.optimize_file_size_threshold
        per_bucket: Dict[int, List[FileInfo]] = defaultdict(list)
        ignored: List[FileInfo] = []
        for fi in entry.content.file_infos():
            bucket = bucket_of_file(fi.name)
            eligible = self._mode == C.OPTIMIZE_MODE_FULL or fi.size < threshold
            if bucket is None or not eligible:
                ignored.append(fi)
            else:
                per_bucket[bucket].append(fi)
        # only buckets with >1 file benefit from compaction (ref: :96-114)
        self._to_optimize = {b: fs for b, fs in per_bucket.items() if len(fs) > 1}
        for b, fs in per_bucket.items():
            if len(fs) <= 1:
                ignored.extend(fs)
        self._ignored = ignored
        if not self._to_optimize:
            raise NoChangesException(
                "Optimize aborted as no optimizable index files "
                f"(multiple files per bucket, mode={self._mode}) found."
            )

    def op(self) -> None:
        import pyarrow.parquet as pq

        index = registry.index_of_entry(self._entry)
        assert isinstance(index, CoveringIndex)
        self._version = self._allocated_version = self.data_manager.allocate_version()
        out_dir = self.data_manager.version_path(self._version)

        # Compaction must leave ONE file per optimized bucket, so chunking by
        # row ranges (which splits buckets into multiple runs and would make
        # repeated optimize calls non-convergent) is not an option here.
        # Device memory is bounded instead by processing whole-bucket GROUPS
        # whose total rows fit the batch budget; a single oversized bucket
        # becomes its own group.
        budget = self.session.conf.build_batch_rows

        def bucket_rows(fis) -> int:
            total = 0
            for fi in fis:
                try:
                    total += pq.read_metadata(fi.name).num_rows
                except OSError:
                    return 1 << 62  # unknown -> force its own group
            return total

        groups: List[List[int]] = []
        cur: List[int] = []
        cur_rows = 0
        for b in sorted(self._to_optimize):
            rows = bucket_rows(self._to_optimize[b])
            if cur and budget > 0 and cur_rows + rows > budget:
                groups.append(cur)
                cur, cur_rows = [], 0
            cur.append(b)
            cur_rows += rows
        if cur:
            groups.append(cur)

        for group in groups:
            files = [fi.name for b in group for fi in self._to_optimize[b]]
            table = pads.dataset(files, format="parquet").to_table()
            # one write_bucketed pass per group re-buckets + re-sorts
            write_bucketed(table, index.indexed_columns, index.num_buckets, out_dir, session=self.session)

    def log_entry(self) -> IndexLogEntry:
        new_content = Content.from_directory(self.data_manager.version_path(self._version), self._tracker)
        if self._ignored:
            new_content = new_content.merge(Content.from_leaf_files(self._ignored))
        entry = IndexLogEntry.from_dict(self._entry.to_dict())
        entry.content = new_content
        return entry
