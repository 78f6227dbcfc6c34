"""Arrow-schema -> JSON encoder.

The reference stores the source relation's Spark ``StructType`` JSON in the
log entry (ref: HS/index/IndexLogEntry.scala:379-385, util/JsonUtils.scala).
Here schemas are ``pyarrow.Schema`` serialized to a small JSON structure, in
the JAX package's format, so either package reads the other's log.
"""

from __future__ import annotations

import json
from typing import Dict, List

import pyarrow as pa


def _type_to_dict(t: pa.DataType) -> Dict:
    if pa.types.is_struct(t):
        return {"type": "struct", "fields": [{"name": t.field(i).name, **_type_to_dict(t.field(i).type)} for i in range(t.num_fields)]}
    if pa.types.is_list(t):
        return {"type": "list", "item": _type_to_dict(t.value_type)}
    if pa.types.is_decimal(t):
        return {"type": "decimal", "precision": t.precision, "scale": t.scale}
    return {"type": str(t)}


def arrow_to_numpy_dtype(t: pa.DataType):
    """Best-effort numpy dtype for an arrow type (object for strings/nested)."""
    import numpy as np

    if pa.types.is_integer(t):
        return np.dtype(np.int64)
    if pa.types.is_floating(t):
        return np.dtype(np.float64)
    if pa.types.is_boolean(t):
        return np.dtype(bool)
    if pa.types.is_timestamp(t):
        return np.dtype(f"datetime64[{t.unit}]")
    if pa.types.is_date(t):
        return np.dtype("datetime64[D]")
    return np.dtype(object)


def schema_to_json(schema: pa.Schema) -> str:
    fields: List[Dict] = [{"name": f.name, **_type_to_dict(f.type)} for f in schema]
    return json.dumps({"fields": fields})
