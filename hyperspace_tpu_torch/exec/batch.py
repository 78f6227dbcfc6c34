"""Columnar batch: a dict ``column name -> numpy array`` (object dtype for
strings), the host-side unit flowing between physical operators. The device
filter dictionary-encodes string columns into int32 codes so everything on
the device is dense numeric (see exec/device.py)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pyarrow as pa

Batch = Dict[str, np.ndarray]


def table_to_batch(table: pa.Table) -> Batch:
    out: Batch = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            out[name] = col.to_numpy(zero_copy_only=False)
        except pa.ArrowInvalid:
            out[name] = np.asarray(col.to_pylist(), dtype=object)
    return out


def num_rows(batch: Batch) -> int:
    for v in batch.values():
        return len(v)
    return 0


def take(batch: Batch, indices: np.ndarray) -> Batch:
    return {k: v[indices] for k, v in batch.items()}


def mask_rows(batch: Batch, mask: np.ndarray) -> Batch:
    mask = np.asarray(mask)
    if mask.ndim == 0:
        # a scalar predicate applies uniformly; 0-d boolean indexing would
        # instead add an axis
        mask = np.broadcast_to(mask, (num_rows(batch),))
    return {k: v[mask] for k, v in batch.items()}


def concat(batches: List[Batch]) -> Batch:
    if not batches:
        return {}
    names = list(batches[0])
    return {n: np.concatenate([b[n] for b in batches]) for n in names}


def select(batch: Batch, columns: List[str]) -> Batch:
    from hyperspace_tpu_torch.plan.expr import get_column

    out: Batch = {}
    for c in columns:
        got = batch[c] if c in batch else get_column(batch, c)
        if got is None:
            raise KeyError(f"Column {c!r} not found in batch with columns {list(batch)}")
        out[c] = got
    return out
