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


def schema_to_json(schema: pa.Schema) -> str:
    fields: List[Dict] = [{"name": f.name, **_type_to_dict(f.type)} for f in schema]
    return json.dumps({"fields": fields})
