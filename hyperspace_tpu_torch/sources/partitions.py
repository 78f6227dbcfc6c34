"""Hive-style partition discovery (``.../col=value/...`` path segments).

Plays the role of Spark's ``PartitioningAwareFileIndex`` partition inference
for the default source (ref: HS/index/sources/default/DefaultFileBasedRelation.scala:38
exposes partition schema/basePaths; the reference's E2E suites index and
hybrid-scan partitioned data). Inference follows Spark's default: int64 →
float64 → string (date inference is opt-in in Spark and omitted here).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote

import numpy as np

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _segments_between(file_path: str, roots: List[str]) -> Optional[List[str]]:
    """Directory segments of ``file_path`` below its root, or None if the
    file is under no root."""
    fdir = os.path.dirname(os.path.abspath(file_path))
    for root in roots:
        root = os.path.abspath(root)
        if fdir == root:
            return []
        if fdir.startswith(root + os.sep):
            rel = fdir[len(root) + 1 :]
            return rel.split(os.sep)
    return None


def _parse_kv(segment: str) -> Optional[Tuple[str, str]]:
    if "=" not in segment:
        return None
    k, _, v = segment.partition("=")
    if not k:
        return None
    return unquote(k), unquote(v)


def discover(files: List[str], roots: List[str]) -> Tuple[List[str], Dict[str, Dict[str, Optional[str]]]]:
    """Infer partition columns from file paths.

    Returns (ordered partition column names, {file -> {col -> raw value or
    None for the hive null partition}}). An inconsistent layout (files with
    differing partition columns, or any non-``k=v`` directory segment)
    yields ([], {}) — the dataset is treated as unpartitioned, like Spark
    when basePath inference fails.
    """
    cols: Optional[List[str]] = None
    raw: Dict[str, Dict[str, Optional[str]]] = {}
    for f in files:
        segs = _segments_between(f, roots)
        if segs is None:
            return [], {}
        kvs = []
        for s in segs:
            kv = _parse_kv(s)
            if kv is None:
                return [], {}
            kvs.append(kv)
        names = [k for k, _ in kvs]
        if cols is None:
            cols = names
        elif names != cols:
            return [], {}
        raw[f] = {k: (None if v == HIVE_NULL else v) for k, v in kvs}
    if not cols:
        return [], {}
    return cols, raw


def _all_parse(values, caster) -> bool:
    for v in values:
        if v is None:
            continue
        try:
            caster(v)
        except (TypeError, ValueError):
            return False
    return True


def infer_dtypes(cols: List[str], raw: Dict[str, Dict[str, Optional[str]]]) -> Dict[str, np.dtype]:
    """Per-column numpy dtype: int64 if every value parses as int, else
    float64 if every value parses as float, else object (string)."""
    out: Dict[str, np.dtype] = {}
    for c in cols:
        values = [per_file.get(c) for per_file in raw.values()]
        has_null = any(v is None for v in values)
        if _all_parse(values, int) and not has_null:
            out[c] = np.dtype(np.int64)
        elif _all_parse(values, float):
            # int columns containing a hive-null partition also land here:
            # NaN needs a float column
            out[c] = np.dtype(np.float64)
        else:
            out[c] = np.dtype(object)
    return out


def typed_value(value: Optional[str], dtype: np.dtype):
    """Raw partition string -> typed scalar (None stays None for strings,
    NaN for floats; int columns with nulls are promoted to float by
    ``infer_dtypes`` callers only when parsing fails, so null here means the
    hive null partition)."""
    if value is None:
        if dtype == np.dtype(np.float64):
            return float("nan")
        return None
    if dtype == np.dtype(np.int64):
        return int(value)
    if dtype == np.dtype(np.float64):
        return float(value)
    return value


def column_array(value, dtype: np.dtype, n: int) -> np.ndarray:
    """Constant partition column for one file's rows."""
    if dtype == np.dtype(object):
        arr = np.empty(n, dtype=object)
        arr[:] = value
        return arr
    if value is None:
        # int64 with a hive-null partition: no integer NaN — promote to float
        return np.full(n, np.nan, dtype=np.float64)
    return np.full(n, value, dtype=dtype)
