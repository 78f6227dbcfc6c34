"""Lake-persisted fabric records: commit records + sidecar node files.

Two record families, both plain JSON under paths source listing can never
see (``walk_data_files`` skips dot/underscore-prefixed entries at any
depth):

- **Commit records** — ``<index>/_hyperspace_log/_commits/<NNNNNNNNNN>``,
  one immutable numbered file per published :class:`CommitEvent`, claimed
  with the same create-exclusive protocol the operation log itself uses
  (``write_atomic_exclusive``), so concurrent publishers on one index
  serialize into a total per-index order with no coordinator. Each record
  carries the publisher's post-bump ``commit_seq`` (the Lamport timestamp
  peers merge via ``InvalidationBus.replay``) and its ``origin`` node id
  (self-commit dedupe).
- **Sidecar node files** — ``<system.path>/_fabric/nodes/<node>.json``,
  one mutable per-node file overwritten atomically (temp + rename) each
  publish round, carrying the node's cumulative quarantine strikes and
  per-tenant SLO / token-bucket accounting. Peers merge *deltas* between
  successive reads, so a node file is a cumulative ledger, never a queue.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.utils.file_utils import write_atomic, write_atomic_exclusive

#: commit records live under <index>/_hyperspace_log/<COMMITS_DIR>/
COMMITS_DIR = "_commits"
#: sidecar node files live under <system.path>/<FABRIC_DIR>/nodes/
FABRIC_DIR = "_fabric"

#: zero-padded record ids keep lexicographic == numeric ordering in listings
_RECORD_WIDTH = 10


def local_node_id(conf) -> str:
    """The configured node id, or the per-process default."""
    return conf.fabric_node_id or f"{socket.gethostname()}:{os.getpid()}"


def _count_commit_record() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_commit_records_total",
        "commit records persisted to the lake for peer replay",
    ).inc()


def _count_record_error(op: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_record_errors_total",
        "fabric record reads/writes that failed and were skipped",
        op=op,
    ).inc()


def commits_dir(system_path: str, index_name: str) -> str:
    return os.path.join(
        str(system_path), str(index_name), C.HYPERSPACE_LOG_DIR, COMMITS_DIR
    )


def nodes_dir(system_path: str) -> str:
    return os.path.join(str(system_path), FABRIC_DIR, "nodes")


# -- commit records ----------------------------------------------------------


def append_commit_record(system_path: Optional[str], event, seq: int) -> Optional[int]:
    """Persist one published commit as the next numbered record under its
    index's log directory. Returns the claimed record id, or None when the
    record could not be written (a fabric record failure must never fail
    the commit it describes — peers simply stay TTL-fresh instead)."""
    if not system_path:
        return None
    payload = json.dumps(
        {
            "seq": int(seq),
            "origin": event.origin,
            "index": event.index_name,
            "logId": event.log_id,
            "kind": event.kind,
            "affectedFiles": list(event.affected_files),
            "ts": time.time(),
        },
        sort_keys=True,
    ).encode("utf-8")
    try:
        d = commits_dir(system_path, event.index_name)
        rid = _next_record_id(d)
        while not write_atomic_exclusive(
            os.path.join(d, f"{rid:0{_RECORD_WIDTH}d}"), payload
        ):
            rid += 1  # another publisher claimed this slot; take the next
        _count_commit_record()
        return rid
    except Exception:
        _count_record_error("commit-write")
        return None


def _next_record_id(dirpath: str) -> int:
    try:
        ids = [int(n) for n in os.listdir(dirpath) if n.isdigit()]
    except OSError:
        return 0
    return max(ids) + 1 if ids else 0


def read_commit_records(
    dirpath: str, after_id: int = -1
) -> List[Tuple[int, dict]]:
    """All parseable commit records in ``dirpath`` with id > ``after_id``,
    ordered by id. Unreadable/corrupt records are counted and skipped — a
    half-written record (impossible under the rename protocol, possible
    under lake-level corruption) must not wedge the watcher."""
    try:
        names = sorted(n for n in os.listdir(dirpath) if n.isdigit())
    except OSError:
        return []
    out: List[Tuple[int, dict]] = []
    for name in names:
        rid = int(name)
        if rid <= after_id:
            continue
        try:
            with open(os.path.join(dirpath, name), "rb") as f:
                out.append((rid, json.loads(f.read().decode("utf-8"))))
        except Exception:
            _count_record_error("commit-read")
    return out


# -- sidecar node files ------------------------------------------------------


def write_node_file(system_path: Optional[str], node_id: str, state: dict) -> bool:
    """Atomically overwrite this node's sidecar file with its cumulative
    coherence state. Returns False (and counts) on failure."""
    if not system_path:
        return False
    payload = dict(state)
    payload["origin"] = node_id
    payload["updatedAt"] = time.time()
    try:
        write_atomic(
            os.path.join(nodes_dir(system_path), f"{_safe_name(node_id)}.json"),
            json.dumps(payload, sort_keys=True).encode("utf-8"),
        )
        return True
    except Exception:
        _count_record_error("node-write")
        return False


def read_peer_node_files(system_path: Optional[str], node_id: str) -> Dict[str, dict]:
    """Every peer's sidecar state keyed by origin, excluding our own file
    and anything unparseable."""
    if not system_path:
        return {}
    d = nodes_dir(system_path)
    try:
        names = [n for n in os.listdir(d) if n.endswith(".json")]
    except OSError:
        return {}
    out: Dict[str, dict] = {}
    for name in names:
        try:
            with open(os.path.join(d, name), "rb") as f:
                state = json.loads(f.read().decode("utf-8"))
        except Exception:
            _count_record_error("node-read")
            continue
        origin = state.get("origin")
        if origin and origin != node_id:
            out[str(origin)] = state
    return out


def _safe_name(node_id: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_" for c in node_id)
