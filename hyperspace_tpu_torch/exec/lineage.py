"""The hybrid-scan delete filter on the device: ``lineage-antijoin``.

When an index serves a source that has lost files since its last refresh,
the rewritten plan filters the index side with ``NOT (_data_file_id IN
deleted ids)`` (rules/utils.py ``_hybrid_scan_plan``). This is the port of
the JAX package's program for it (``hyperspace_tpu/exec/lineage.py``): the
deleted ids are sorted and padded, and membership of each row's lineage id
is a ``searchsorted`` lookup, one torch program over the resident column.

The id table pads to a geometric bucket (floor 64) with an int64-max
sentinel, as in the JAX package; correctness does not rely on the sentinel,
because a ``pos < n_ids`` guard with the live id count rides along, and the
gather index is clamped into the table (torch raises on an out-of-range
gather where XLA clamps). The lineage column shares the device column cache
with the predicate path: the same ``(scan_key, column, device)`` keys and
the same encoding.

``lineage_keep_mask_plain`` is the plain numpy version of the same
function; the tests hold the program against it, and nothing on the card's
path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec.device import (
    DeviceUnsupported,
    _cached_column,
    _device_cache,
    _host_tensor,
    _put_encoded,
    count_dispatch,
)

#: sorted-ascending pad value of the id table: above any real lineage id, so
#: padding keeps the table sorted and never reports a false membership
ID_SENTINEL = np.iinfo(np.int64).max

#: id tables are tiny next to columns; a small geometric floor keeps the
#: number of distinct table shapes logarithmic in the delete count
ID_BUCKET_FLOOR = 64

_SQRT2 = 1.4142135623730951

_program_lint.register_contract(
    "lineage-antijoin",
    collectives={},
    description="hybrid-scan delete filter: sorted-lookup anti-semi-join, shuffle-free",
)


def id_table_rows(n: int, floor: int = ID_BUCKET_FLOOR) -> int:
    """Smallest geometric bucket (powers of sqrt(2) over ``floor``) holding
    ``n`` ids."""
    b = floor
    while b < n:
        b = int(b * _SQRT2) + 1
    return b


def padded_id_table(deleted_ids) -> tuple:
    """(sorted unique ids padded with ``ID_SENTINEL`` to their bucket, live
    count)."""
    ids = np.unique(np.asarray(list(deleted_ids), dtype=np.int64))
    table = np.full(id_table_rows(int(ids.size)), ID_SENTINEL, dtype=np.int64)
    table[: ids.size] = ids
    return table, int(ids.size)


def antijoin_program(col: torch.Tensor, ids: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Keep-mask of ``col`` (int64): True where the value is not among the
    first ``n_ids`` entries of the sorted table ``ids``."""
    pos = torch.searchsorted(ids, col)
    pos_c = pos.clamp(0, ids.shape[0] - 1)
    found = (pos < n_ids) & (ids[pos_c] == col)
    return ~found


def lineage_keep_mask_plain(col: np.ndarray, deleted_ids) -> np.ndarray:
    """The plain version: ``NOT (col IN deleted_ids)`` with numpy."""
    return ~np.isin(np.asarray(col, dtype=np.int64), np.asarray(list(deleted_ids), dtype=np.int64))


def lineage_delete_mask(session, batch: B.Batch, column: str, deleted_ids, scan_key=None,
                        parallel=None) -> np.ndarray:
    """Keep-mask for ``NOT (column IN deleted_ids)`` computed on the
    session's device; byte-identical to the plain version. Raises
    :class:`DeviceUnsupported` when the column is absent or not integral —
    the caller falls back to the host and counts the fallback. ``parallel``
    (a ``ShardedExecutor``) runs the program per shard of its mesh, the id
    table replicated to each shard's device."""
    if column not in batch:
        raise DeviceUnsupported(f"lineage column {column!r} missing from batch")
    n = B.num_rows(batch)
    if n == 0:
        return np.zeros(0, dtype=bool)
    col_np = batch[column]
    if col_np.dtype.kind not in ("i", "u"):
        raise DeviceUnsupported(f"lineage column dtype {col_np.dtype} is not integral")
    table, n_ids = padded_id_table(deleted_ids)
    if n_ids == 0:
        return np.ones(n, dtype=bool)

    device = session.device
    # column residency: the same key and encoding as device_filter_mask, so
    # staging, predicate evaluation and lineage filtering share one entry
    ckey = (scan_key, column, str(device)) if scan_key is not None else None
    cached = _cached_column(ckey, n)
    if cached is not None:
        dev_col = cached[0]
    else:
        dev_col, codec, nbytes = _put_encoded(col_np, device)
        if ckey is not None:
            _device_cache.put(ckey, (dev_col, codec, n, None), nbytes)
    dev_ids = _host_tensor(table).to(device)
    key = f"lineage-antijoin/{'sharded' if parallel is not None else 'single'}"
    with _program_lint.maybe_verify(session.conf, "lineage-antijoin", key, (dev_col, dev_ids)):
        if parallel is not None:
            from hyperspace_tpu_torch.parallel import collectives as C

            program = C.sharded_elementwise(
                parallel.mesh, parallel.axis, lambda cols, lits: antijoin_program(cols["c"], lits[0], n_ids))
            mask = program({"c": dev_col}, (dev_ids,))
        else:
            mask = antijoin_program(dev_col, dev_ids, n_ids)
    count_dispatch("lineage-antijoin")
    return mask.cpu().numpy()[:n]
