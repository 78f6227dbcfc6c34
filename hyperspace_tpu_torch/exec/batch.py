"""Columnar batch: a dict ``column name -> numpy array`` (object dtype for
strings), the host-side unit flowing between physical operators. The device
filter dictionary-encodes string columns into int32 codes so everything on
the device is dense numeric (see exec/device.py); a string column the native
decoder read from dictionary pages arrives as a ``DictBackedArray`` and
ships its codes instead."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa

Batch = Dict[str, np.ndarray]


class DictBackedArray(np.ndarray):
    """Object array of strings that remembers the dictionary encoding it was
    decoded from (parquet RLE_DICTIONARY via the native row-group reader).

    ``hs_dict_codes`` is an int32 array (-1 = null) indexing into
    ``hs_dict_uniques`` (object array, file order — NOT sorted). Host
    operators see a plain object array of str/None; the device staging path
    (exec/device.py) spots the attributes and ships the narrow codes +
    dictionary instead of bytes×rows, expanding on-device.

    Derived arrays (slices, masks, concat) intentionally do NOT inherit the
    attributes — numpy only propagates them through an __array_finalize__
    that copies, which we omit — so any reshaped view degrades to plain
    value semantics instead of carrying stale codes.
    """

    hs_dict_codes: Optional[np.ndarray] = None
    hs_dict_uniques: Optional[np.ndarray] = None


def dict_backed(values: np.ndarray, codes: np.ndarray, uniques: np.ndarray) -> DictBackedArray:
    arr = values.view(DictBackedArray)
    arr.hs_dict_codes = codes
    arr.hs_dict_uniques = uniques
    return arr


def table_to_batch(table: pa.Table) -> Batch:
    out: Batch = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            out[name] = col.to_numpy(zero_copy_only=False)
        except pa.ArrowInvalid:
            out[name] = np.asarray(col.to_pylist(), dtype=object)
    return out


def batch_to_table(batch: Batch, column_order: Optional[List[str]] = None) -> pa.Table:
    names = column_order if column_order is not None else list(batch)
    arrays = []
    for n in names:
        v = batch[n]
        if v.dtype == object or v.dtype.kind in ("U", "S"):
            arrays.append(pa.array([None if x is None else str(x) for x in v.tolist()], type=pa.string()))
        else:
            arrays.append(pa.array(v))
    return pa.table(dict(zip(names, arrays)))


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


def _struct_leaf(batch: Batch, name: str) -> Optional[np.ndarray]:
    """``plan.expr.get_column`` of a dotted struct path, by plain dict
    lookups, where that gives the same array: the root column is the one
    ``get_column`` would take, every row is None or a dict holding each
    segment's exact field name, and no two field names differ only in
    case. None elsewhere, and ``get_column`` answers."""
    from hyperspace_tpu_torch.plan.expr import NESTED_PREFIX

    root_name, *segs = name.split(".")
    lowered = {name.lower(), (NESTED_PREFIX + name).lower()}
    roots = [k for k in batch if k.lower() == root_name.lower()]
    if not segs or not roots or roots[0] != root_name or any(k.lower() in lowered for k in batch):
        return None
    vals = list(batch[root_name])
    for seg in segs:
        first = next((v for v in vals if v is not None), None)
        if not isinstance(first, dict) or len({k.lower() for k in first}) != len(first):
            return None
        try:
            vals = [None if v is None else v[seg] for v in vals]
        except (KeyError, TypeError, IndexError):
            return None
    arr = np.asarray(vals)
    if arr.dtype == object:
        try:
            arr = np.asarray(vals, dtype=np.float64)
        except (TypeError, ValueError):
            pass
    return arr


def select(batch: Batch, columns: List[str]) -> Batch:
    from hyperspace_tpu_torch.plan.expr import get_column

    out: Batch = {}
    for c in columns:
        got = batch[c] if c in batch else _struct_leaf(batch, c)
        if got is None:
            got = get_column(batch, c)
        if got is None:
            raise KeyError(f"Column {c!r} not found in batch with columns {list(batch)}")
        out[c] = got
    return out
