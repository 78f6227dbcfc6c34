"""ctypes binding for libhs_native, the native Parquet decoder: one open
file per ``NativeParquetFile``, column chunks decoded from the mmap'd file
straight into numpy buffers (``read_fixed_rg_into`` writes into a slice the
caller owns, so exec/io.py's decode lands in pinned staging buffers), plus
the host join's span walk (``merge_spans``) and pair expansion
(``expand_pairs``) and raw-snappy decompression for Avro manifests.

The port builds its own copy of the library from
``hyperspace_tpu_torch/csrc/hs_native.cc`` and ``thrift_compact.h``
(byte-identical to the JAX package's ``native/`` sources) with ``g++`` at
first use, into ``hyperspace_tpu_torch/_build/libhs_native-<digest>.so``: the
digest covers both sources, the compiler and the flags, so an edited source
is never served by a stale build, and the build writes a temporary file and
renames it, so processes that build at once never load a half-written
library. A host without the zlib or zstd development files still builds,
without that codec (``build_info()`` says which). The library loads with
ctypes' default ``RTLD_LOCAL``, so a process that also holds the JAX
package's copy resolves each binding's calls in its own library.

Files outside the decoder's dialect (other codecs, nested columns) raise
``NativeUnsupported``, and callers fall back to pyarrow.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("hs_native.cc", "thrift_compact.h")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
#: codec -> (link flag, header, define that builds without it)
_CODEC_LIBS = (("gzip", "z", "zlib.h", "-DHS_NO_ZLIB"), ("zstd", "zstd", "zstd.h", "-DHS_NO_ZSTD"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed: Optional[str] = None
_build_info: Dict[str, object] = {}


class NativeUnsupported(Exception):
    """The native decoder cannot handle this file; fall back to pyarrow."""


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> str:
    """Where this checkout's library lives: ``_build/libhs_native-<digest>.so``."""
    h = hashlib.sha256()
    for s in SOURCES:
        with open(os.path.join(CSRC_DIR, s), "rb") as f:
            h.update(f.read())
    h.update(" ".join((_cxx(),) + CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhs_native-{h.hexdigest()[:16]}.so")


def _missing(stderr: str, lib: str, header: str) -> bool:
    """Whether a failed build failed only for want of ``lib`` (GNU ld, lld
    and ld64 word it differently; the name must match as a whole word, since
    '-lz' is a prefix of '-lzstd')."""
    pats = (
        rf"cannot find -l{lib}\b",
        rf"unable to find library -l{lib}\b",
        rf"library '{lib}' not found",
        rf"library not found for -l{lib}\b",
        rf"-l{lib}\b: not found",
    )
    if any(re.search(p, stderr) for p in pats):
        return True
    return header in stderr and ("No such file" in stderr or "not found" in stderr)


def _build(out: str) -> Dict[str, object]:
    """Compile the library into ``out``; returns what was built. Drops the
    gzip or zstd codec only when its library is missing, first trying
    zstd's runtime library without its header (``-DHS_ZSTD_COMPAT``); any
    other failure raises ``NativeUnsupported`` with the compiler output."""
    if not os.path.exists(os.path.join(CSRC_DIR, SOURCES[0])):
        raise NativeUnsupported("native sources not present")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    base = [_cxx(), *CXX_FLAGS, os.path.join(CSRC_DIR, SOURCES[0])]

    def run(flags):
        return subprocess.run(base + flags + ["-o", tmp], capture_output=True, text=True, cwd=CSRC_DIR)

    flags: List[str] = ["-lz", "-lzstd"]
    dropped: List[str] = []
    compat = False
    res = run(flags)
    if res.returncode != 0 and _missing(res.stderr, "zstd", "zstd.h"):
        alt = ["-DHS_ZSTD_COMPAT"] + [f if f != "-lzstd" else "-l:libzstd.so.1" for f in flags]
        res2 = run(alt)
        if res2.returncode == 0:
            res, flags, compat = res2, alt, True
    for codec, lib, header, define in _CODEC_LIBS:
        if res.returncode == 0:
            break
        if not _missing(res.stderr, lib, header):
            continue
        flags = [f for f in flags if f != f"-l{lib}"] + [define]
        dropped.append(codec)
        res = run(flags)
    if res.returncode != 0:
        raise NativeUnsupported(f"native build failed: {res.stderr[-2000:]}")
    if dropped:
        logging.getLogger(__name__).warning("hs_native built without %s (missing on this host)", "/".join(dropped))
    with open(tmp + ".codecs", "w") as f:
        f.write(" ".join(dropped) + ("\ncompat" if compat else "") + "\n")
    os.replace(tmp + ".codecs", out + ".codecs")
    os.replace(tmp, out)
    return {"dropped": dropped, "zstd_compat": compat, "built": True}


def _compiler_version() -> str:
    try:
        res = subprocess.run([_cxx(), "--version"], capture_output=True, text=True)
        return res.stdout.splitlines()[0] if res.stdout else "unknown"
    except OSError:
        return "unknown"


def build_info() -> Dict[str, object]:
    """The loaded library's path, compiler, codecs dropped at build, and
    whether this process built it (raises ``NativeUnsupported`` when the
    library cannot be had)."""
    _load()
    return dict(_build_info)


def _load() -> ctypes.CDLL:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed is not None:
            raise NativeUnsupported(_load_failed)
        try:
            path = library_path()
            info: Dict[str, object] = {"built": False}
            if not os.path.exists(path):
                info = _build(path)
            else:
                try:
                    with open(path + ".codecs") as f:
                        lines = f.read().split("\n")
                    info.update(dropped=lines[0].split(), zstd_compat="compat" in lines[1:])
                except OSError:
                    info.update(dropped=None, zstd_compat=None)
            lib = ctypes.CDLL(path)
            _wire_symbols(lib)
        except NativeUnsupported as e:
            _load_failed = str(e)
            raise
        except (OSError, AttributeError) as e:
            _load_failed = f"cannot load libhs_native: {e}"
            raise NativeUnsupported(_load_failed)
        _build_info.update(info, path=path, compiler=_compiler_version(),
                           codecs=["uncompressed", "snappy"]
                           + [c for c, *_ in _CODEC_LIBS if c not in (info.get("dropped") or [])])
        _lib = lib
        return lib


def _wire_symbols(lib: ctypes.CDLL) -> None:
    lib.hsn_open.restype = ctypes.c_void_p
    lib.hsn_open.argtypes = [ctypes.c_char_p]
    lib.hsn_close.argtypes = [ctypes.c_void_p]
    lib.hsn_error.restype = ctypes.c_char_p
    lib.hsn_error.argtypes = [ctypes.c_void_p]
    lib.hsn_num_rows.restype = ctypes.c_int64
    lib.hsn_num_rows.argtypes = [ctypes.c_void_p]
    lib.hsn_num_columns.restype = ctypes.c_int32
    lib.hsn_num_columns.argtypes = [ctypes.c_void_p]
    lib.hsn_column_name.restype = ctypes.c_char_p
    lib.hsn_column_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hsn_column_type.restype = ctypes.c_int32
    lib.hsn_column_type.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hsn_column_optional.restype = ctypes.c_int32
    lib.hsn_column_optional.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hsn_read_fixed.restype = ctypes.c_int64
    lib.hsn_read_fixed.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hsn_read_binary.restype = ctypes.c_int64
    lib.hsn_read_binary.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    # row-group-granular ABI (parallel decode; errors via per-call buffer)
    lib.hsn_num_row_groups.restype = ctypes.c_int32
    lib.hsn_num_row_groups.argtypes = [ctypes.c_void_p]
    lib.hsn_rg_num_rows.restype = ctypes.c_int64
    lib.hsn_rg_num_rows.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hsn_rg_codec.restype = ctypes.c_int32
    lib.hsn_rg_codec.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.hsn_read_fixed_rg.restype = ctypes.c_int64
    lib.hsn_read_fixed_rg.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.hsn_read_binary_rg.restype = ctypes.c_int64
    lib.hsn_read_binary_rg.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.hsn_read_codes_rg.restype = ctypes.c_int64
    lib.hsn_read_codes_rg.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.hsn_rg_dict_count.restype = ctypes.c_int64
    lib.hsn_rg_dict_count.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.hsn_read_dict_binary_rg.restype = ctypes.c_int64
    lib.hsn_read_dict_binary_rg.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.hsn_merge_spans.restype = None
    lib.hsn_merge_spans.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hsn_expand_pairs.restype = ctypes.c_int64
    lib.hsn_expand_pairs.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hsn_snappy_decompress.restype = ctypes.c_int32
    lib.hsn_snappy_decompress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.hsn_snappy_uncompressed_length.restype = ctypes.c_int64
    lib.hsn_snappy_uncompressed_length.argtypes = [ctypes.c_char_p, ctypes.c_int64]


def snappy_decompress(blob: bytes) -> bytes:
    """Raw-snappy decompression via the native library; raises
    NativeUnsupported when the library is unavailable (callers fall back to
    the pure-Python decoder in utils/avro.py)."""
    lib = _load()
    n = lib.hsn_snappy_uncompressed_length(blob, len(blob))
    if n < 0:
        raise ValueError("snappy: bad length header")
    # the varint comes from untrusted input: a corrupt header must not drive
    # a multi-GB allocation (snappy can expand at most ~255x per the format's
    # max copy/literal ratios; 1 GiB also caps any legitimate Avro block)
    if n > max(len(blob) * 256, 1 << 30):
        raise ValueError(f"snappy: implausible uncompressed length {n}")
    out = ctypes.create_string_buffer(n)
    if lib.hsn_snappy_decompress(blob, len(blob), out, n) != 0:
        raise ValueError("snappy: malformed input")
    return out.raw


# parquet physical types
_T_BOOLEAN, _T_INT32, _T_INT64 = 0, 1, 2
_T_FLOAT, _T_DOUBLE, _T_BYTE_ARRAY = 4, 5, 6

_FIXED_DTYPES = {
    _T_BOOLEAN: np.dtype(np.bool_),
    _T_INT32: np.dtype(np.int32),
    _T_INT64: np.dtype(np.int64),
    _T_FLOAT: np.dtype(np.float32),
    _T_DOUBLE: np.dtype(np.float64),
}

#: per-call error buffer size for the row-group ABI (the C side truncates)
_ERR_CAP = 256

#: parquet CompressionCodec ids the dialect decodes, as metric-label names
CODEC_NAMES = {0: "uncompressed", 1: "snappy", 2: "gzip", 6: "zstd"}


class NativeParquetFile:
    """One open parquet file. Use as a context manager."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.hsn_open(path.encode())
        if not self._h:
            raise NativeUnsupported(f"cannot open {path!r} natively")
        err = lib.hsn_error(self._h)
        if err:
            msg = err.decode()
            lib.hsn_close(self._h)
            self._h = None
            raise NativeUnsupported(msg)
        self.num_rows = lib.hsn_num_rows(self._h)
        self.columns: List[str] = []
        self._types: List[int] = []
        for i in range(lib.hsn_num_columns(self._h)):
            self.columns.append(lib.hsn_column_name(self._h, i).decode())
            self._types.append(lib.hsn_column_type(self._h, i))
        self.num_row_groups = int(lib.hsn_num_row_groups(self._h))
        #: rows per row group, in file order (row-group g starts at
        #: sum(rg_rows[:g]) within the file)
        self.rg_rows: List[int] = [
            int(lib.hsn_rg_num_rows(self._h, g)) for g in range(self.num_row_groups)
        ]

    def __enter__(self) -> "NativeParquetFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._h:
            self._lib.hsn_close(self._h)
            self._h = None

    def _err(self) -> str:
        e = self._lib.hsn_error(self._h)
        return e.decode() if e else "unknown native error"

    def read_column(self, name: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Decode one column. Returns (values, validity-or-None). Fixed-width
        columns come back as their numpy dtype; BYTE_ARRAY as an object array
        of ``str``. Rows that were null have zero/empty values and validity 0."""
        if name not in self.columns:
            raise NativeUnsupported(f"column {name!r} not in file")
        col = self.columns.index(name)
        t = self._types[col]
        n = self.num_rows
        optional = self._lib.hsn_column_optional(self._h, col) == 1
        validity = np.ones(n, dtype=np.uint8) if optional else None
        vptr = validity.ctypes.data_as(ctypes.c_void_p) if validity is not None else None

        if t in _FIXED_DTYPES:
            out = np.empty(n, dtype=_FIXED_DTYPES[t])
            rc = self._lib.hsn_read_fixed(self._h, col, out.ctypes.data_as(ctypes.c_void_p), vptr)
            if rc != n:
                raise NativeUnsupported(self._err())
            return out, validity
        if t == _T_BYTE_ARRAY:
            offsets = np.empty(n + 1, dtype=np.int64)
            rc = self._lib.hsn_read_binary(
                self._h, col, offsets.ctypes.data_as(ctypes.c_void_p), None, vptr
            )
            if rc != n:
                raise NativeUnsupported(self._err())
            data = np.empty(int(offsets[n]), dtype=np.uint8)
            rc = self._lib.hsn_read_binary(
                self._h,
                col,
                offsets.ctypes.data_as(ctypes.c_void_p),
                data.ctypes.data_as(ctypes.c_void_p),
                vptr,
            )
            if rc != n:
                raise NativeUnsupported(self._err())
            # zero-copy arrow view over (offsets, data); arrow's C++ loop then
            # materializes the python strings — ~5x faster than a python loop
            import pyarrow as pa

            arr = pa.Array.from_buffers(
                pa.large_utf8(), n, [None, pa.py_buffer(offsets), pa.py_buffer(data)]
            )
            out = arr.to_numpy(zero_copy_only=False)
            return out, validity
        raise NativeUnsupported(f"unsupported physical type {t}")

    # -- row-group-granular decode (parallel fan-out) -------------------------

    def _col_index(self, name: str) -> int:
        if name not in self.columns:
            raise NativeUnsupported(f"column {name!r} not in file")
        return self.columns.index(name)

    def column_optional(self, name: str) -> bool:
        return self._lib.hsn_column_optional(self._h, self._col_index(name)) == 1

    def column_numpy_dtype(self, name: str) -> Optional[np.dtype]:
        """Decoded numpy dtype for a column, or None for BYTE_ARRAY (strings
        materialize as object arrays, which have no flat buffer to decode
        into). Raises NativeUnsupported for physical types outside the dialect."""
        t = self._types[self._col_index(name)]
        if t in _FIXED_DTYPES:
            return _FIXED_DTYPES[t]
        if t == _T_BYTE_ARRAY:
            return None
        raise NativeUnsupported(f"unsupported physical type {t}")

    def rg_codec(self, rg: int, name: str) -> str:
        """Codec name of one chunk ("uncompressed"/"snappy"/"gzip"/"zstd"),
        or "other" for ids outside the dialect."""
        c = self._lib.hsn_rg_codec(self._h, rg, self._col_index(name))
        return CODEC_NAMES.get(int(c), "other")

    def read_fixed_rg_into(
        self, rg: int, name: str, out: np.ndarray, validity: Optional[np.ndarray] = None
    ) -> None:
        """Decode one (row group × column) chunk into ``out`` — typically a
        slice of a larger per-column buffer; the C side writes through the
        slice's data pointer, so the caller controls the row offset and
        parallel workers fill disjoint slots of one shared array."""
        col = self._col_index(name)
        t = self._types[col]
        if t not in _FIXED_DTYPES:
            raise NativeUnsupported(f"not a fixed-width column: {name!r}")
        n = self.rg_rows[rg]
        if out.shape[0] != n or out.dtype.itemsize != _FIXED_DTYPES[t].itemsize:
            raise ValueError(
                f"read_fixed_rg_into: buffer shape {out.shape}/{out.dtype} does "
                f"not match row group ({n} rows of {_FIXED_DTYPES[t]})"
            )
        if not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
            raise ValueError("read_fixed_rg_into: need a contiguous writable buffer")
        vptr = validity.ctypes.data_as(ctypes.c_void_p) if validity is not None else None
        err = ctypes.create_string_buffer(_ERR_CAP)
        rc = self._lib.hsn_read_fixed_rg(
            self._h, rg, col, out.ctypes.data_as(ctypes.c_void_p), vptr, err, _ERR_CAP
        )
        if rc != n:
            raise NativeUnsupported(err.value.decode() or "native row-group decode failed")

    def read_binary_rg(
        self, rg: int, name: str
    ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """Decode one BYTE_ARRAY chunk to (object array of str, validity,
        utf8 payload bytes)."""
        col = self._col_index(name)
        if self._types[col] != _T_BYTE_ARRAY:
            raise NativeUnsupported(f"not a BYTE_ARRAY column: {name!r}")
        n = self.rg_rows[rg]
        optional = self._lib.hsn_column_optional(self._h, col) == 1
        validity = np.ones(n, dtype=np.uint8) if optional else None
        vptr = validity.ctypes.data_as(ctypes.c_void_p) if validity is not None else None
        offsets = np.empty(n + 1, dtype=np.int64)
        err = ctypes.create_string_buffer(_ERR_CAP)
        rc = self._lib.hsn_read_binary_rg(
            self._h, rg, col, offsets.ctypes.data_as(ctypes.c_void_p), None, vptr,
            err, _ERR_CAP,
        )
        if rc != n:
            raise NativeUnsupported(err.value.decode() or "native row-group decode failed")
        data = np.empty(int(offsets[n]), dtype=np.uint8)
        rc = self._lib.hsn_read_binary_rg(
            self._h,
            rg,
            col,
            offsets.ctypes.data_as(ctypes.c_void_p),
            data.ctypes.data_as(ctypes.c_void_p),
            vptr,
            err,
            _ERR_CAP,
        )
        if rc != n:
            raise NativeUnsupported(err.value.decode() or "native row-group decode failed")
        import pyarrow as pa

        arr = pa.Array.from_buffers(
            pa.large_utf8(), n, [None, pa.py_buffer(offsets), pa.py_buffer(data)]
        )
        return arr.to_numpy(zero_copy_only=False), validity, int(offsets[n])

    def read_codes_rg(self, rg: int, name: str) -> np.ndarray:
        """Dictionary codes (int32; -1 = null) for a fully dictionary-encoded
        chunk. Raises NativeUnsupported when any page fell back to PLAIN —
        callers retry with value decode."""
        col = self._col_index(name)
        n = self.rg_rows[rg]
        codes = np.empty(n, dtype=np.int32)
        err = ctypes.create_string_buffer(_ERR_CAP)
        rc = self._lib.hsn_read_codes_rg(
            self._h, rg, col, codes.ctypes.data_as(ctypes.c_void_p), err, _ERR_CAP
        )
        if rc != n:
            raise NativeUnsupported(err.value.decode() or "native codes decode failed")
        return codes

    def rg_dict_count(self, rg: int, name: str) -> int:
        """Dictionary entry count for a chunk (0 = no dictionary page)."""
        col = self._col_index(name)
        err = ctypes.create_string_buffer(_ERR_CAP)
        rc = self._lib.hsn_rg_dict_count(self._h, rg, col, err, _ERR_CAP)
        if rc < 0:
            raise NativeUnsupported(err.value.decode() or "native dict probe failed")
        return int(rc)

    def read_dict_rg(self, rg: int, name: str) -> np.ndarray:
        """The BYTE_ARRAY dictionary payload of one chunk as an object array
        of str (entry i is the value behind code i)."""
        return self.read_dict_rg_arrow(rg, name).to_numpy(zero_copy_only=False)

    def read_dict_rg_arrow(self, rg: int, name: str):
        """The BYTE_ARRAY dictionary payload of one chunk as an arrow
        large_utf8 Array over the decoder's buffers — no per-entry Python
        string is materialized, so dictionary merges across many chunks stay
        in C (callers concat + dictionary_encode arrow-side)."""
        col = self._col_index(name)
        if self._types[col] != _T_BYTE_ARRAY:
            raise NativeUnsupported(f"not a BYTE_ARRAY column: {name!r}")
        err = ctypes.create_string_buffer(_ERR_CAP)
        count = self._lib.hsn_rg_dict_count(self._h, rg, col, err, _ERR_CAP)
        if count < 0:
            raise NativeUnsupported(err.value.decode() or "native dict probe failed")
        offsets = np.empty(int(count) + 1, dtype=np.int64)
        rc = self._lib.hsn_read_dict_binary_rg(
            self._h, rg, col, offsets.ctypes.data_as(ctypes.c_void_p), None, err, _ERR_CAP
        )
        if rc != count:
            raise NativeUnsupported(err.value.decode() or "native dict decode failed")
        data = np.empty(int(offsets[count]), dtype=np.uint8)
        rc = self._lib.hsn_read_dict_binary_rg(
            self._h,
            rg,
            col,
            offsets.ctypes.data_as(ctypes.c_void_p),
            data.ctypes.data_as(ctypes.c_void_p),
            err,
            _ERR_CAP,
        )
        if rc != count:
            raise NativeUnsupported(err.value.decode() or "native dict decode failed")
        import pyarrow as pa

        return pa.Array.from_buffers(
            pa.large_utf8(), int(count), [None, pa.py_buffer(offsets), pa.py_buffer(data)]
        )


def read_columns(path: str, columns: List[str], dtype_hints: Optional[Dict[str, np.dtype]] = None) -> Dict[str, np.ndarray]:
    """Decode ``columns`` of ``path`` into a host batch (dict of numpy arrays).

    ``dtype_hints`` maps column name -> desired numpy dtype (e.g. datetime64
    views of INT64 timestamps); the raw decoded int64 array is reinterpreted
    via ``.view`` when widths match.
    """
    hints = dtype_hints or {}
    out: Dict[str, np.ndarray] = {}
    with NativeParquetFile(path) as f:
        for c in columns:
            values, validity = f.read_column(c)
            hint = hints.get(c)
            if hint is not None and values.dtype.kind in ("i", "u"):
                if hint.itemsize == values.dtype.itemsize:
                    values = values.view(hint)
                elif hint.kind == "M":
                    # int32-backed date32 widens to datetime64[D] (astype
                    # treats ints as counts of the target unit since epoch)
                    values = values.astype(hint)
            if validity is not None and not validity.all():
                if values.dtype.kind == "f":
                    values = values.copy()
                    values[validity == 0] = np.nan
                elif values.dtype == object:
                    values[validity == 0] = None
                elif values.dtype.kind == "M":
                    values = values.copy()
                    values[validity == 0] = np.datetime64("NaT")
                elif values.dtype.kind == "b":
                    # match pyarrow's to_numpy: nullable bools surface as
                    # object arrays of True/False/None
                    values = values.astype(object)
                    values[validity == 0] = None
                elif values.dtype.kind in ("i", "u"):
                    # match pyarrow's to_numpy: nullable ints surface as
                    # float64 with NaN holes
                    values = values.astype(np.float64)
                    values[validity == 0] = np.nan
            out[c] = values
    return out


def is_available() -> bool:
    try:
        _load()
        return True
    except NativeUnsupported:
        return False


def merge_spans(left_keys: np.ndarray, right_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per left row, the [lo, hi) span of equal keys in ``right_keys``.

    Both arrays must be ascending int64 (the index dialect's per-bucket
    sortedness). One O(n+m) merge walk in C, replacing two binary-search
    passes. Raises NativeUnsupported when the library is unavailable or a
    side exceeds int32 indexing."""
    lib = _load()
    lk = np.ascontiguousarray(left_keys, dtype=np.int64)
    rk = np.ascontiguousarray(right_keys, dtype=np.int64)
    if rk.shape[0] >= 2**31 or lk.shape[0] >= 2**31:
        raise NativeUnsupported("bucket exceeds int32 indexing")
    lo = np.empty(lk.shape[0], dtype=np.int32)
    hi = np.empty(lk.shape[0], dtype=np.int32)
    lib.hsn_merge_spans(
        lk.ctypes.data_as(ctypes.c_void_p),
        lk.shape[0],
        rk.ctypes.data_as(ctypes.c_void_p),
        rk.shape[0],
        lo.ctypes.data_as(ctypes.c_void_p),
        hi.ctypes.data_as(ctypes.c_void_p),
    )
    return lo, hi


def expand_pairs(lo: np.ndarray, hi: np.ndarray, total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Expand per-left-row spans into (left, right) gather index arrays of
    length ``total`` (= sum(hi - lo)). Raises NativeUnsupported past int32
    range (callers fall back to the int64 numpy expansion)."""
    lib = _load()
    n = int(np.shape(lo)[0])
    if (
        n >= 2**31
        or total >= 2**31
        or (n and int(np.max(hi)) >= 2**31)
    ):
        raise NativeUnsupported("join bucket exceeds int32 indexing")
    lo32 = np.ascontiguousarray(lo, dtype=np.int32)
    hi32 = np.ascontiguousarray(hi, dtype=np.int32)
    lidx = np.empty(total, dtype=np.int32)
    ridx = np.empty(total, dtype=np.int32)
    written = lib.hsn_expand_pairs(
        lo32.ctypes.data_as(ctypes.c_void_p),
        hi32.ctypes.data_as(ctypes.c_void_p),
        lo32.shape[0],
        lidx.ctypes.data_as(ctypes.c_void_p),
        ridx.ctypes.data_as(ctypes.c_void_p),
    )
    if written != total:
        raise NativeUnsupported(f"expand_pairs wrote {written} of {total} pairs")
    return lidx, ridx
