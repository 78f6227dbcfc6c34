"""Scan-side IO: parquet files -> columnar batches, through pyarrow.

The JAX package's native row-group decoder is not in the port yet; every
file decodes with pyarrow, which yields the same numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from hyperspace_tpu_torch.exec import batch as B


def read_parquet_batch(files: List[str], columns: Optional[List[str]]) -> B.Batch:
    """Read ``columns`` of ``files`` into one batch, as one dataset over the
    files' unified schema (a file missing a requested column null-fills it)."""
    schema = pa.unify_schemas([pq.read_schema(f) for f in files])
    return B.table_to_batch(pads.dataset(files, format="parquet", schema=schema).to_table(columns=columns))
