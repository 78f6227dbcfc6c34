"""Which side of a join the JAX package would broadcast.

The JAX package's ``hyperspace_tpu/exec/join_stream.py`` builds the smaller
side of a join, when its leaf files hold at most
``hyperspace.exec.join.broadcastMaxBytes``, into one device-resident sorted
hash table and streams the other side through it; its whole-stage fused join
aggregate takes the same decision. This module holds only that decision
(host work, no device): the port's executor asks it where the fused join
aggregate, which is not in the port, would run. The build, probe and
post-join programs and ``dispatch_broadcast_join`` come with the broadcast
hash join (ROADMAP A6).
"""

from __future__ import annotations

import os
from typing import List, Optional

from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import extract_equi_join_keys


class BroadcastSpec:
    __slots__ = ("build_is_left", "lkeys", "rkeys")

    def __init__(self, build_is_left: bool, lkeys: List[str], rkeys: List[str]):
        self.build_is_left = build_is_left
        self.lkeys = lkeys
        self.rkeys = rkeys


def _plan_leaf_bytes(plan: L.LogicalPlan) -> Optional[int]:
    """Estimated input bytes of ``plan`` from its leaf files; None when a
    leaf is not file-backed or a file cannot be stat'ed (no estimate, no
    broadcast decision)."""
    leaves = L.collect(plan, lambda p: isinstance(p, (L.Scan, L.FileScan, L.IndexScan)))
    if not leaves:
        return None
    total = 0
    for leaf in leaves:
        try:
            if isinstance(leaf, L.Scan):
                total += sum(int(fi.size) for fi in leaf.relation.all_file_infos())
            else:
                if not leaf.files:
                    return None
                total += sum(os.stat(f).st_size for f in leaf.files)
        except OSError:
            return None
    return total


def broadcast_spec(session, plan: L.Join) -> Optional[BroadcastSpec]:
    """Which side (if any) broadcasts: the smaller side whose estimated leaf
    bytes fit under ``hyperspace.exec.join.broadcastMaxBytes``."""
    if not isinstance(plan, L.Join) or plan.residual is not None:
        return None
    if plan.how not in ("inner", "left", "right", "outer"):
        return None
    max_bytes = session.conf.join_broadcast_max_bytes
    if max_bytes <= 0:
        return None
    pairs = extract_equi_join_keys(plan.condition)
    if not pairs:
        return None
    lcols = set(plan.left.output_columns)
    rcols = set(plan.right.output_columns)
    lkeys: List[str] = []
    rkeys: List[str] = []
    for a, b in pairs:
        if a in lcols and b in rcols:
            lkeys.append(a)
            rkeys.append(b)
        elif b in lcols and a in rcols:
            lkeys.append(b)
            rkeys.append(a)
        else:
            return None
    lb = _plan_leaf_bytes(plan.left)
    rb = _plan_leaf_bytes(plan.right)
    cands = []
    if lb is not None and lb <= max_bytes:
        cands.append((lb, True))
    if rb is not None and rb <= max_bytes:
        cands.append((rb, False))
    if not cands:
        return None
    # both fit: broadcast the smaller, probe the larger
    _, build_is_left = min(cands, key=lambda t: t[0])
    return BroadcastSpec(build_is_left, lkeys, rkeys)
