"""Columnar batch: a dict ``column name -> numpy array`` (object dtype for
strings), the host-side unit the build encodes before anything goes to the
device."""

from __future__ import annotations

from typing import Dict

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
