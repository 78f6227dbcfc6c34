"""Live-data lifecycle subsystem: zero-downtime refresh for a serving runtime.

Three cooperating pieces (docs/lifecycle.md has the walkthrough):

- :mod:`hyperspace_tpu_torch.lifecycle.snapshot` — immutable per-request
  ``SnapshotHandle`` pinning the index-log roster observed at admission, so
  a refresh committing version N+1 mid-flight never changes a running
  query's answer;
- :mod:`hyperspace_tpu_torch.lifecycle.refresh_manager` — the background
  controller that watches per-index appended/deleted drift against the
  hybrid-scan thresholds and schedules incremental/quick refreshes
  concurrently with serving;
- :mod:`hyperspace_tpu_torch.lifecycle.invalidation` — the commit bus: every
  index mutation publishes exactly one commit event, and freshness
  propagation (roster cache, bucket/IO/device caches, brand rotation)
  happens in one place instead of per-cache ad-hoc discipline.
"""

from hyperspace_tpu_torch.lifecycle.invalidation import CommitEvent, InvalidationBus
from hyperspace_tpu_torch.lifecycle.refresh_manager import RefreshManager
from hyperspace_tpu_torch.lifecycle.snapshot import (
    SnapshotHandle,
    current_snapshot,
    snapshot_scope,
)

__all__ = [
    "CommitEvent",
    "InvalidationBus",
    "RefreshManager",
    "SnapshotHandle",
    "current_snapshot",
    "snapshot_scope",
]
