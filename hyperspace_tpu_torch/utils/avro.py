"""Minimal Avro Object Container File codec (read + write).

Iceberg stores its manifest lists and manifests as Avro container files; no
Avro library is available in this environment, so the framework carries its
own schema-driven binary codec. The reader is generic (decodes any record
schema found in the file header, so real Iceberg tables written by other
engines parse); the writer is sufficient for the manifests this framework
emits (null codec).

Format: magic "Obj\\x01", file-metadata map (avro.schema JSON + avro.codec),
16-byte sync marker, then blocks of <count><byte-size><payload><sync>.
Codecs: null, deflate, and snappy (raw block + big-endian CRC32 framing;
decompression via the native library's decoder, pure-Python fallback).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"Obj\x01"


def _snappy_decompress(blob: bytes) -> bytes:
    """Raw-snappy decompression: native (libhs_native) when available, else
    pyarrow's bundled snappy (an unconditional dependency of this package) —
    the uncompressed size comes from the raw-format varint preamble."""
    try:
        from hyperspace_tpu_torch.native import NativeUnsupported
        from hyperspace_tpu_torch.native import snappy_decompress as native_snappy

        try:
            return native_snappy(blob)
        except NativeUnsupported:
            pass
    except ImportError:
        pass
    import pyarrow as pa

    n, shift, i = 0, 0, 0
    while True:
        if i >= len(blob) or i >= 5:
            raise ValueError("snappy: bad length header")
        b = blob[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if n > max(len(blob) * 256, 1 << 30):  # untrusted varint: cap allocation
        raise ValueError(f"snappy: implausible uncompressed length {n}")
    try:
        return pa.decompress(blob, decompressed_size=n, codec="snappy", asbytes=True)
    except (pa.lib.ArrowException, OSError) as e:  # ArrowIOError == OSError
        raise ValueError(f"snappy: malformed block ({e})")


# --------------------------------------------------------------------------
# binary primitives
# --------------------------------------------------------------------------


def _read_long(buf: io.BytesIO) -> int:
    """zigzag varint"""
    shift = 0
    accum = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("unexpected end of avro data")
        byte = b[0]
        accum |= (byte & 0x7F) << shift
        if not (byte & 0x80):
            break
        shift += 7
    return (accum >> 1) ^ -(accum & 1)


def _write_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    while True:
        to_write = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([to_write | 0x80]))
        else:
            out.write(bytes([to_write]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    return buf.read(n)


def _write_bytes(out: io.BytesIO, b: bytes) -> None:
    _write_long(out, len(b))
    out.write(b)


# --------------------------------------------------------------------------
# schema-driven value codec
# --------------------------------------------------------------------------


def _decode(schema: Any, buf: io.BytesIO, names: Dict[str, Any]) -> Any:
    if isinstance(schema, str):
        t = schema
        if t in names:
            return _decode(names[t], buf, names)
        if t == "null":
            return None
        if t == "boolean":
            return buf.read(1)[0] != 0
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if t == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if t == "bytes":
            return _read_bytes(buf)
        if t == "string":
            return _read_bytes(buf).decode("utf-8")
        raise ValueError(f"Unknown avro type {t!r}")
    if isinstance(schema, list):  # union
        idx = _read_long(buf)
        return _decode(schema[idx], buf, names)
    t = schema["type"]
    if t == "record":
        full = schema.get("name", "")
        if full:
            names[full] = schema
        out = {}
        for f in schema["fields"]:
            out[f["name"]] = _decode(f["type"], buf, names)
        return out
    if t == "array":
        out_list: List[Any] = []
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                _read_long(buf)  # block byte size, unused
                count = -count
            for _ in range(count):
                out_list.append(_decode(schema["items"], buf, names))
        return out_list
    if t == "map":
        out_map: Dict[str, Any] = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                _read_long(buf)
                count = -count
            for _ in range(count):
                k = _read_bytes(buf).decode("utf-8")
                out_map[k] = _decode(schema["values"], buf, names)
        return out_map
    if t == "fixed":
        if schema.get("name"):
            names[schema["name"]] = schema
        return buf.read(schema["size"])
    if t == "enum":
        if schema.get("name"):
            names[schema["name"]] = schema
        return schema["symbols"][_read_long(buf)]
    # logical types wrap a primitive in {"type": prim, "logicalType": ...}
    return _decode(t, buf, names)


def _encode(schema: Any, value: Any, out: io.BytesIO, names: Dict[str, Any]) -> None:
    if isinstance(schema, str):
        t = schema
        if t in names:
            return _encode(names[t], value, out, names)
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if value else b"\x00")
            return
        if t in ("int", "long"):
            _write_long(out, int(value))
            return
        if t == "float":
            out.write(struct.pack("<f", float(value)))
            return
        if t == "double":
            out.write(struct.pack("<d", float(value)))
            return
        if t == "bytes":
            _write_bytes(out, bytes(value))
            return
        if t == "string":
            _write_bytes(out, str(value).encode("utf-8"))
            return
        raise ValueError(f"Unknown avro type {t!r}")
    if isinstance(schema, list):  # union: pick first matching branch
        for i, branch in enumerate(schema):
            if _matches(branch, value, names):
                _write_long(out, i)
                _encode(branch, value, out, names)
                return
        raise ValueError(f"No union branch of {schema} matches {value!r}")
    t = schema["type"]
    if t == "record":
        if schema.get("name"):
            names[schema["name"]] = schema
        for f in schema["fields"]:
            _encode(f["type"], value.get(f["name"]), out, names)
        return
    if t == "array":
        items = list(value or [])
        if items:
            _write_long(out, len(items))
            for it in items:
                _encode(schema["items"], it, out, names)
        _write_long(out, 0)
        return
    if t == "map":
        entries = dict(value or {})
        if entries:
            _write_long(out, len(entries))
            for k, v in entries.items():
                _write_bytes(out, str(k).encode("utf-8"))
                _encode(schema["values"], v, out, names)
        _write_long(out, 0)
        return
    if t == "fixed":
        out.write(bytes(value))
        return
    if t == "enum":
        _write_long(out, schema["symbols"].index(value))
        return
    _encode(t, value, out, names)


def _matches(schema: Any, value: Any, names: Dict[str, Any]) -> bool:
    if isinstance(schema, str):
        if schema in names:
            return _matches(names[schema], value, names)
        if schema == "null":
            return value is None
        if schema == "boolean":
            return isinstance(value, bool)
        if schema in ("int", "long"):
            return isinstance(value, int) and not isinstance(value, bool)
        if schema in ("float", "double"):
            return isinstance(value, (int, float)) and not isinstance(value, bool)
        if schema == "bytes":
            return isinstance(value, (bytes, bytearray))
        if schema == "string":
            return isinstance(value, str)
        return False
    if isinstance(schema, list):
        return any(_matches(b, value, names) for b in schema)
    t = schema["type"]
    if t == "record":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "map":
        return isinstance(value, dict)
    if t in ("fixed",):
        return isinstance(value, (bytes, bytearray))
    if t == "enum":
        return isinstance(value, str)
    return _matches(t, value, names)


# --------------------------------------------------------------------------
# container file API
# --------------------------------------------------------------------------


def read_schema(path: str) -> Dict[str, Any]:
    """Parse only the container header (magic + metadata map) — no record
    blocks are read, so this is O(header) regardless of file size."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path!r} is not an Avro container file")
        meta: Dict[str, bytes] = {}
        while True:
            count = _read_long(f)
            if count == 0:
                break
            if count < 0:
                _read_long(f)
                count = -count
            for _ in range(count):
                k = _read_bytes(f).decode("utf-8")
                meta[k] = _read_bytes(f)
        return json.loads(meta["avro.schema"].decode("utf-8"))


def count_records(path: str) -> int:
    """Total record count from block headers only: each block starts with
    (count, byte-size); payloads are seeked past, never decompressed."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path!r} is not an Avro container file")
        while True:  # skip metadata map
            count = _read_long(f)
            if count == 0:
                break
            if count < 0:
                _read_long(f)
                count = -count
            for _ in range(count):
                _read_bytes(f)
                _read_bytes(f)
        f.read(16)  # sync marker
        total = 0
        while True:
            try:
                n = _read_long(f)
            except EOFError:
                break
            size = _read_long(f)
            f.seek(size + 16, 1)  # payload + sync marker
            total += n
        return total


def read_container(path: str) -> Tuple[Dict[str, Any], List[Any]]:
    """Read an Avro container file; returns (schema, records)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path!r} is not an Avro container file")
    meta: Dict[str, bytes] = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:
            _read_long(buf)
            count = -count
        for _ in range(count):
            k = _read_bytes(buf).decode("utf-8")
            meta[k] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = buf.read(16)

    records: List[Any] = []
    while buf.tell() < len(data):
        try:
            count = _read_long(buf)
        except EOFError:
            break
        size = _read_long(buf)
        payload = buf.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec == "snappy":
            # a raw snappy block followed by the 4-byte big-endian CRC32 of
            # the uncompressed data (Avro spec's snappy codec framing)
            crc = int.from_bytes(payload[-4:], "big")
            payload = _snappy_decompress(payload[:-4])
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError(f"Avro snappy block CRC mismatch in {path!r}")
        elif codec != "null":
            raise ValueError(f"Unsupported avro codec {codec!r}")
        block = io.BytesIO(payload)
        names: Dict[str, Any] = {}
        for _ in range(count):
            records.append(_decode(schema, block, names))
        if buf.read(16) != sync:
            raise ValueError(f"Avro sync marker mismatch in {path!r}")
    return schema, records


def write_container(path: str, schema: Dict[str, Any], records: List[Any]) -> None:
    """Write records as a null-codec Avro container file."""
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"), "avro.codec": b"null"}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode("utf-8"))
        _write_bytes(out, v)
    _write_long(out, 0)
    sync = os.urandom(16)
    out.write(sync)

    payload = io.BytesIO()
    names: Dict[str, Any] = {}
    for r in records:
        _encode(schema, r, payload, names)
    body = payload.getvalue()
    _write_long(out, len(records))
    _write_long(out, len(body))
    out.write(body)
    out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())
