"""Dataset opening for every supported file format.

The reference's default source accepts the formats listed in
``spark.hyperspace.index.sources.fileBasedBuilders``'s default provider —
avro, csv, json, orc, parquet, text (ref: HS/util/HyperspaceConf.scala:94-99).
pyarrow's dataset layer natively covers parquet/csv/json/orc; Avro object
container files are decoded with the framework's own codec
(``utils/avro.py``, shared with the Iceberg manifest reader) and ``text``
reads each line into a single ``value`` string column (Spark text-source
semantics), both materialized as in-memory arrow datasets.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Optional

import pyarrow as pa
import pyarrow.dataset as pads

#: formats pyarrow.dataset handles directly from file bytes
ARROW_NATIVE_FORMATS = ("parquet", "csv", "json", "orc")
#: formats decoded by this module into in-memory tables
MATERIALIZED_FORMATS = ("avro", "text")
SUPPORTED_FORMATS = ARROW_NATIVE_FORMATS + MATERIALIZED_FORMATS

TEXT_COLUMN = "value"


def _avro_primitive_to_arrow(schema: Any) -> Optional[pa.DataType]:
    if isinstance(schema, str):
        return {
            "null": pa.null(),
            "boolean": pa.bool_(),
            "int": pa.int32(),
            "long": pa.int64(),
            "float": pa.float32(),
            "double": pa.float64(),
            "bytes": pa.binary(),
            "string": pa.string(),
        }.get(schema)
    return None


def _avro_to_arrow_type(schema: Any) -> pa.DataType:
    prim = _avro_primitive_to_arrow(schema)
    if prim is not None:
        return prim
    if isinstance(schema, list):  # union: use the first non-null branch
        branches = [b for b in schema if b != "null"]
        return _avro_to_arrow_type(branches[0]) if branches else pa.null()
    if isinstance(schema, dict):
        t = schema.get("type")
        if t == "record":
            return pa.struct(
                [pa.field(f["name"], _avro_to_arrow_type(f["type"])) for f in schema.get("fields", [])]
            )
        if t == "array":
            return pa.list_(_avro_to_arrow_type(schema["items"]))
        if t == "map":
            return pa.map_(pa.string(), _avro_to_arrow_type(schema["values"]))
        if t == "enum":
            return pa.string()
        if t == "fixed":
            return pa.binary(int(schema["size"]))
        prim = _avro_primitive_to_arrow(t)
        if prim is not None:
            return prim
    raise ValueError(f"Unsupported Avro schema for arrow conversion: {schema!r}")


def _avro_arrow_schema(avro_schema: Dict[str, Any]) -> pa.Schema:
    if avro_schema.get("type") != "record":
        raise ValueError("Avro data files must have a record top-level schema")
    return pa.schema(
        [pa.field(f["name"], _avro_to_arrow_type(f["type"])) for f in avro_schema.get("fields", [])]
    )


def read_avro_table(path: str, columns: Optional[List[str]] = None) -> pa.Table:
    from hyperspace_tpu_torch.utils.avro import read_container

    schema, records = read_container(path)
    t = pa.Table.from_pylist(records, schema=_avro_arrow_schema(schema))
    if columns is not None:
        # a requested column absent from this file (schema evolution) is
        # null-filled, matching the native formats' dataset-level behavior
        arrays, fields = [], []
        for c in columns:
            if c in t.schema.names:
                arrays.append(t.column(c))
                fields.append(t.schema.field(c))
            else:
                arrays.append(pa.nulls(t.num_rows))
                fields.append(pa.field(c, pa.null()))
        t = pa.Table.from_arrays(arrays, schema=pa.schema(fields))
    return t


def read_text_table(path: str, columns: Optional[List[str]] = None) -> pa.Table:
    with io.open(path, "r", encoding="utf-8", newline="") as f:
        data = f.read()
    lines = data.split("\n")
    if lines and lines[-1] == "":  # trailing newline does not create a row
        lines.pop()
    lines = [ln[:-1] if ln.endswith("\r") else ln for ln in lines]
    t = pa.table({TEXT_COLUMN: pa.array(lines, type=pa.string())})
    if columns is not None:
        t = t.select(columns)
    return t


def write_text(path: str, lines: List[str]) -> None:
    with io.open(path, "w", encoding="utf-8", newline="") as f:
        for ln in lines:
            f.write(ln)
            f.write("\n")


def arrow_format(file_format: str, options: Optional[Dict[str, Any]] = None):
    """The pyarrow dataset ``format`` argument honoring reader options.

    CSV supports ``delimiter``/``sep`` and ``header`` (default true; false
    autogenerates ``f0..fN`` column names). Unknown options are ignored, as
    are options on formats that take none here."""
    if file_format == "csv" and options:
        from pyarrow import csv as pacsv

        parse = pacsv.ParseOptions(delimiter=str(options.get("delimiter", options.get("sep", ","))))
        header = options.get("header", True)
        if isinstance(header, str):
            header = header.strip().lower() in ("true", "1", "yes")
        read = pacsv.ReadOptions(autogenerate_column_names=not header)
        return pads.CsvFileFormat(parse_options=parse, read_options=read)
    return file_format


def read_table(
    path: str,
    file_format: str,
    columns: Optional[List[str]] = None,
    options: Optional[Dict[str, Any]] = None,
) -> pa.Table:
    """One file -> arrow table (column-pruned at decode when the format allows)."""
    if file_format == "avro":
        return read_avro_table(path, columns)
    if file_format == "text":
        return read_text_table(path, columns)
    return pads.dataset([path], format=arrow_format(file_format, options)).to_table(columns=columns)


def _align_to_schema(t: pa.Table, schema: pa.Schema) -> pa.Table:
    """Project ``t`` onto ``schema``: cast common columns, null-fill absent
    ones (schema evolution across files)."""
    arrays = []
    for field in schema:
        if field.name in t.schema.names:
            arrays.append(t.column(field.name).cast(field.type))
        else:
            arrays.append(pa.nulls(t.num_rows, type=field.type))
    return pa.Table.from_arrays(arrays, schema=schema)


def tables_to_dataset(tables: List[pa.Table]) -> pads.Dataset:
    """In-memory dataset over per-file tables with one unified schema."""
    if not tables:
        empty = pa.schema([])
        return pads.dataset([pa.Table.from_arrays([], schema=empty)], schema=empty)
    schema = pa.unify_schemas([t.schema for t in tables])
    return pads.dataset([_align_to_schema(t, schema) for t in tables], schema=schema)


def open_dataset(
    files: List[str], file_format: str, options: Optional[Dict[str, Any]] = None
) -> pads.Dataset:
    """``files`` -> a pyarrow Dataset regardless of format.

    Native formats stream from file bytes; materialized formats (avro/text)
    are decoded up front into an in-memory dataset with a unified schema.
    """
    if file_format in ARROW_NATIVE_FORMATS:
        return pads.dataset(files, format=arrow_format(file_format, options))
    if file_format not in MATERIALIZED_FORMATS:
        raise ValueError(f"Unsupported file format: {file_format!r}")
    return tables_to_dataset([read_table(f, file_format) for f in files])


def count_rows(path: str, file_format: str, options: Optional[Dict[str, Any]] = None) -> int:
    if file_format in ARROW_NATIVE_FORMATS:
        return pads.dataset([path], format=arrow_format(file_format, options)).count_rows()
    if file_format == "avro":
        # block headers carry record counts; no payload is decompressed
        from hyperspace_tpu_torch.utils.avro import count_records

        return count_records(path)
    if file_format == "text":
        n = 0
        last = b""
        with open(path, "rb") as f:
            while True:  # stream: bounded memory on arbitrarily large files
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                n += chunk.count(b"\n")
                last = chunk[-1:]
        if last and last != b"\n":
            n += 1  # last line without trailing newline is still a row
        return n
    raise ValueError(f"Unsupported file format: {file_format!r}")


def read_format_schema(files: List[str], file_format: str) -> pa.Schema:
    """Unified schema of a materialized-format dataset WITHOUT decoding any
    record data: avro from container headers, text is constant."""
    if file_format == "text":
        return pa.schema([pa.field(TEXT_COLUMN, pa.string())])
    if file_format == "avro":
        from hyperspace_tpu_torch.utils.avro import read_schema

        return pa.unify_schemas([_avro_arrow_schema(read_schema(f)) for f in files])
    raise ValueError(f"read_format_schema only covers {MATERIALIZED_FORMATS}, got {file_format!r}")
