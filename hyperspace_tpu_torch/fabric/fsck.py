"""Fabric log recovery and compaction: ``python -m hyperspace_tpu_torch.fsck``.

The fabric's lake state only ever grows: every published commit leaves a
``_commits/`` record, every lease takeover leaves a superseded token
file, and every node that ever joined leaves a ``_fabric/nodes/`` ledger.
:func:`fsck` is the startup/periodic garbage collector that walks one
lake and removes, per kind:

``torn-record``
    ``_commits/`` entries whose bytes don't parse — impossible under the
    rename protocol, possible under lake-level corruption. Readers
    already skip them; fsck removes them so they stop being re-skipped
    every poll.
``old-record``
    parseable commit records older than the retention horizon
    (``hyperspace.fabric.fsck.retentionSeconds``). The **newest record of
    every index is always kept** regardless of age: record numbering
    derives from the directory listing (max+1), so compacting the whole
    directory would restart ids at 0 *behind* live ``CommitWatcher``
    cursors and new commits would replay nowhere. Keeping the high-water
    record keeps every cursor — live or stale — monotonic.
``stale-claim``
    lease token files below the current (highest) token: history of
    settled takeover races, never read again.
``expired-lease``
    a current lease token whose expiry is a full retention horizon in the
    past — nobody is coming back for it, so the whole lease directory
    (token sequence included) resets.
``dead-node``
    sidecar ledgers not rewritten for ``hyperspace.fabric.fsck.deadNodeSeconds``.
    Safe because sidecar merges are delta-based: if the node does return,
    its restarted ledger contributes nothing until it grows again.

Every removal passes the ``record.compact`` fault-injection seam; an
injected (or real) failure skips that file and the pass continues —
fsck must never wedge on the lake state it exists to clean. Removals land
in ``hs_fabric_fsck_removed_total{kind}``, passes in
``hs_fabric_fsck_runs_total``. ``dry_run`` reports without deleting.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.fabric import lease as lease_mod
from hyperspace_tpu_torch.fabric.records import COMMITS_DIR, nodes_dir

__all__ = ["fsck", "main"]

KINDS = ("torn-record", "old-record", "stale-claim", "expired-lease", "dead-node")


def _count_run() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_fsck_runs_total",
        "fabric fsck passes completed",
    ).inc()


def _count_removed(kind: str, n: int = 1) -> None:
    if n <= 0:
        return
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_fsck_removed_total",
        "lake files garbage-collected by fabric fsck, by kind",
        kind=kind,
    ).inc(n)


class _Pass:
    """One fsck pass's bookkeeping + guarded removal."""

    def __init__(self, dry_run: bool):
        self.dry_run = dry_run
        self.removed: Dict[str, int] = {k: 0 for k in KINDS}
        self.scanned = 0
        self.skipped = 0

    def remove(self, path: str, kind: str) -> bool:
        from hyperspace_tpu_torch.reliability.faults import FAULTS

        try:
            if FAULTS.active:
                FAULTS.check("record.compact", path)
            if not self.dry_run:
                os.remove(path)
        except OSError:
            self.skipped += 1
            return False
        self.removed[kind] += 1
        if not self.dry_run:
            _count_removed(kind)
        return True


def fsck(
    system_path: str,
    *,
    retention_s: float = 3600.0,
    dead_node_s: float = 600.0,
    dry_run: bool = False,
    clock: Callable[[], float] = time.time,
) -> dict:
    """One garbage-collection pass over ``system_path`` (module docstring).
    Returns the report dict the CLI prints as JSON."""
    now = clock()
    p = _Pass(dry_run)
    _fsck_commit_records(p, system_path, now - retention_s)
    _fsck_leases(p, system_path, now, retention_s)
    _fsck_nodes(p, system_path, now - dead_node_s)
    _count_run()
    return {
        "systemPath": str(system_path),
        "dryRun": bool(dry_run),
        "scanned": p.scanned,
        "skipped": p.skipped,
        "removed": p.removed,
        "removedTotal": sum(p.removed.values()),
    }


def _fsck_commit_records(p: _Pass, system_path: str, horizon: float) -> None:
    try:
        index_names = sorted(os.listdir(str(system_path)))
    except OSError:
        return
    for name in index_names:
        if name.startswith((".", "_")):
            continue
        d = os.path.join(str(system_path), name, C.HYPERSPACE_LOG_DIR, COMMITS_DIR)
        try:
            rids = sorted(int(n) for n in os.listdir(d) if n.isdigit())
        except OSError:
            continue
        if not rids:
            continue
        # the high-water record anchors id monotonicity for every cursor
        for rid in rids[:-1]:
            path = os.path.join(d, f"{rid:010d}")
            p.scanned += 1
            try:
                with open(path, "rb") as f:
                    rec = json.loads(f.read().decode("utf-8"))
            except OSError:
                p.skipped += 1
                continue
            except Exception:
                p.remove(path, "torn-record")
                continue
            if float(rec.get("ts", 0.0)) < horizon:
                p.remove(path, "old-record")


def _fsck_leases(
    p: _Pass, system_path: str, now: float, retention_s: float
) -> None:
    root = lease_mod.leases_dir(str(system_path))
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return
    for name in names:
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        tokens = lease_mod._list_tokens(d)
        if not tokens:
            continue
        for token in tokens[:-1]:
            p.scanned += 1
            p.remove(lease_mod._token_path(d, token), "stale-claim")
        current = tokens[-1]
        path = lease_mod._token_path(d, current)
        p.scanned += 1
        try:
            with open(path, "rb") as f:
                state = json.loads(f.read().decode("utf-8"))
            expires_at = float(state.get("expiresAt", 0.0))
        except OSError:
            p.skipped += 1
            continue
        except Exception:
            expires_at = 0.0  # torn current token reads as long-expired
        if expires_at < now - retention_s:
            if p.remove(path, "expired-lease") and not p.dry_run:
                try:
                    os.rmdir(d)  # resets the token sequence with no live racers
                except OSError:
                    pass


def _fsck_nodes(p: _Pass, system_path: str, horizon: float) -> None:
    d = nodes_dir(str(system_path))
    try:
        names = sorted(n for n in os.listdir(d) if n.endswith(".json"))
    except OSError:
        return
    for name in names:
        path = os.path.join(d, name)
        p.scanned += 1
        try:
            with open(path, "rb") as f:
                state = json.loads(f.read().decode("utf-8"))
            updated = float(state.get("updatedAt", 0.0))
        except OSError:
            p.skipped += 1
            continue
        except Exception:
            updated = 0.0  # an unparseable ledger is as dead as an old one
        if updated < horizon:
            p.remove(path, "dead-node")


def main(argv: Optional[list] = None) -> int:
    """CLI entry point: ``python -m hyperspace_tpu_torch.fsck <system-path>``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.fsck",
        description="Garbage-collect fabric lake state: torn/old commit "
        "records, superseded lease tokens, expired leases, dead-node ledgers.",
    )
    ap.add_argument("system_path", help="the lake root (hyperspace.system.path)")
    ap.add_argument(
        "--retention-seconds", type=float, default=3600.0,
        help="commit records older than this are compacted (default 3600)",
    )
    ap.add_argument(
        "--dead-node-seconds", type=float, default=600.0,
        help="node ledgers silent longer than this are removed (default 600)",
    )
    ap.add_argument(
        "--dry-run", action="store_true",
        help="report what would be removed without removing anything",
    )
    args = ap.parse_args(argv)
    report = fsck(
        args.system_path,
        retention_s=args.retention_seconds,
        dead_node_s=args.dead_node_seconds,
        dry_run=args.dry_run,
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0
