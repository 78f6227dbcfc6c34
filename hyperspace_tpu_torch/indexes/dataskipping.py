"""DataSkippingIndex: per-source-file sketch table.

One row per source data file (keyed by ``_data_file_id``) holding sketch
aggregates (min/max, bloom filter, distinct value list) of chosen columns;
query-time file pruning translates predicates against the sketch table
(ref: HS/index/dataskipping/DataSkippingIndex.scala:35-179,
DataSkippingIndexConfig.scala:40-76, sketch/MinMaxSketch.scala:33-43).

The pruning rule that reads the sketch table is
``rules/dataskipping_rule.py``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.indexes import registry
from hyperspace_tpu_torch.indexes.base import CreateContext, Index, IndexConfig
from hyperspace_tpu_torch.models.log_entry import DerivedDataset
from hyperspace_tpu_torch.plan.resolver import resolve_columns_against_schema


class Sketch:
    """Sketch SPI (ref: HS/index/dataskipping/sketch/Sketch.scala:33-78)."""

    kind = ""

    def __init__(self, expr: str):
        self.expr = expr  # column name (expression strings kept simple)

    @property
    def referenced_columns(self) -> List[str]:
        return [self.expr]

    def output_names(self) -> List[str]:
        raise NotImplementedError

    def aggregate(self, values: np.ndarray) -> List[Any]:
        """Compute this sketch's aggregates over one file's column values."""
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "expr": self.expr}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Sketch":
        kind = d["kind"]
        for sk in (MinMaxSketch, BloomFilterSketch, ValueListSketch, PartitionSketch):
            if sk.kind == kind:
                if kind == "BloomFilter":
                    return BloomFilterSketch(
                        d["expr"], d.get("fpp", 0.01), d.get("expectedItems", 10000), d.get("valueDtype")
                    )
                return sk(d["expr"])
        raise ValueError(f"Unknown sketch kind {kind!r}")

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash((self.kind, self.expr))

    def __repr__(self):
        return f"{self.kind}({self.expr})"


class MinMaxSketch(Sketch):
    """(ref: sketch/MinMaxSketch.scala:33-43)"""

    kind = "MinMax"

    def output_names(self) -> List[str]:
        return [f"MinMax_{self.expr}__min", f"MinMax_{self.expr}__max"]

    def aggregate(self, values: np.ndarray) -> List[Any]:
        if len(values) == 0:
            return [None, None]
        return [values.min(), values.max()]


class ValueListSketch(Sketch):
    """Distinct values per file — exact membership pruning
    (ref: dataskipping sketches; ValueListSketch exists in later reference versions)."""

    kind = "ValueList"
    MAX_VALUES = 1024

    def output_names(self) -> List[str]:
        return [f"ValueList_{self.expr}__values"]

    def aggregate(self, values: np.ndarray) -> List[Any]:
        uniq = np.unique(values)
        if len(uniq) > self.MAX_VALUES:
            return [None]  # too many distincts: no pruning signal
        return [uniq.tolist()]


class BloomFilterSketch(Sketch):
    """Bloom-filter membership per file. The filter is a fixed-size bit array
    stored as a list of uint64 words; membership tests run vectorized."""

    kind = "BloomFilter"

    def __init__(self, expr: str, fpp: float = 0.01, expected_items: int = 10000, value_dtype: Optional[str] = None):
        super().__init__(expr)
        self.fpp = float(fpp)
        self.expected_items = int(expected_items)
        # hashing is dtype-sensitive (float64 5.0 and int64 5 have different
        # bit patterns); the build-time column dtype is recorded so query
        # literals can be coerced before membership tests
        self.value_dtype = value_dtype
        m = max(64, int(-expected_items * math.log(fpp) / (math.log(2) ** 2)))
        self.num_bits = 1 << max(6, (m - 1).bit_length())  # power of two
        self.num_hashes = max(1, int(round(self.num_bits / expected_items * math.log(2))))

    def output_names(self) -> List[str]:
        return [f"BloomFilter_{self.expr}__bits"]

    @staticmethod
    def _canonicalize(values: np.ndarray) -> tuple:
        """Hashing is dtype-sensitive, and the same column can surface with
        different numpy dtypes per file (int64 vs float64 when one file holds
        a null, varying '<U{n}' widths). Canonicalize before hashing so every
        file — and every query literal — hashes identically:
        numerics → float64 (precision loss maps build and query the same way,
        so it can only add false *positives*, which are safe), datetimes →
        datetime64[ns], strings → object."""
        kind = values.dtype.kind
        if kind in ("i", "u", "b", "f"):
            return values.astype(np.float64), "float64"
        if kind == "M":
            return values.astype("datetime64[ns]"), "datetime64[ns]"
        return values.astype(object), "object"

    def _positions(self, values: np.ndarray) -> np.ndarray:
        from hyperspace_tpu_torch.ops.encode import hash_input_uint32

        h1 = hash_input_uint32(values).astype(np.uint64)
        h2 = (h1 * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(32) | np.uint64(1)
        ks = np.arange(self.num_hashes, dtype=np.uint64)
        return ((h1[:, None] + ks[None, :] * h2[:, None]) % np.uint64(self.num_bits)).astype(np.int64)

    def aggregate(self, values: np.ndarray) -> List[Any]:
        values, dtype = self._canonicalize(values)
        self.value_dtype = dtype
        bits = np.zeros(self.num_bits // 64, dtype=np.uint64)
        pos = self._positions(values).reshape(-1)
        np.bitwise_or.at(bits, pos // 64, np.uint64(1) << (pos % np.uint64(64)).astype(np.uint64))
        return [bits.view(np.int64).tolist()]

    def might_contain(self, bits_words: List[int], value) -> bool:
        """Raises on a literal that cannot be coerced to the build dtype —
        callers treat that as unprunable."""
        if self.value_dtype == "object":
            arr = np.asarray([str(value)], dtype=object)
        elif self.value_dtype == "datetime64[ns]":
            arr = np.asarray([np.datetime64(value)]).astype("datetime64[ns]")
        else:
            arr = np.asarray([value]).astype(np.float64)
        bits = np.asarray(bits_words, dtype=np.int64).view(np.uint64)
        pos = self._positions(arr).reshape(-1)
        return bool(np.all((bits[pos // 64] >> (pos % np.uint64(64)).astype(np.uint64)) & np.uint64(1)))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "expr": self.expr,
            "fpp": self.fpp,
            "expectedItems": self.expected_items,
            "valueDtype": self.value_dtype,
        }


class PartitionSketch(Sketch):
    """Single partition value per file (for hive-partitioned sources)."""

    kind = "Partition"

    def output_names(self) -> List[str]:
        return [f"Partition_{self.expr}__value"]

    def aggregate(self, values: np.ndarray) -> List[Any]:
        uniq = np.unique(values)
        return [uniq[0] if len(uniq) == 1 else None]


def _restore_bound(value: float, dtype: np.dtype, lower: bool):
    """Map a float64 device-reduce result back to the column dtype.

    int64 values beyond 2**53 are not exactly representable in float64; a
    misrounded bound could wrongly *tighten* the sketch and prune a matching
    file. Bounds are therefore widened outward (min down, max up) whenever the
    round trip is inexact — widening only ever costs false positives, which
    data skipping tolerates by design.
    """
    if dtype.kind not in ("i", "u"):
        return dtype.type(value)
    iv = int(value)
    # strict: at exactly +-2**53 the float may itself be a rounded bound
    if float(iv) == value and abs(value) < 2**53:
        return iv
    # beyond 2**53 the f64 rounding error is up to ulp/2, which grows with
    # magnitude (512 at 2**62) — widen by a full ulp, clamped to the dtype
    slack = max(1, int(math.ulp(abs(value))))
    info = np.iinfo(dtype)
    return max(iv - slack, info.min) if lower else min(iv + slack, info.max)


class DataSkippingIndex(Index):
    kind = "DataSkippingIndex"
    kind_abbr = "DS"

    def __init__(self, sketches: List[Sketch], extra_properties: Optional[Dict[str, Any]] = None):
        self.sketches = list(sketches)
        self._extra = dict(extra_properties or {})

    @property
    def indexed_columns(self) -> List[str]:
        out: List[str] = []
        for s in self.sketches:
            for c in s.referenced_columns:
                if c not in out:
                    out.append(c)
        return out

    @property
    def referenced_columns(self) -> List[str]:
        return self.indexed_columns

    @property
    def properties(self) -> Dict[str, Any]:
        props = {"sketches": [s.to_dict() for s in self.sketches]}
        props.update(self._extra)
        return props

    def with_new_properties(self, properties: Dict[str, Any]) -> "DataSkippingIndex":
        extra = {k: v for k, v in properties.items() if k != "sketches"}
        return DataSkippingIndex(self.sketches, extra)

    @classmethod
    def from_derived_dataset(cls, dd: DerivedDataset) -> "DataSkippingIndex":
        extra = {k: v for k, v in dd.properties.items() if k != "sketches"}
        return cls([Sketch.from_dict(s) for s in dd.properties["sketches"]], extra)

    def can_handle_deleted_files(self) -> bool:
        return True  # rows are keyed by file id; deleted files' rows are dropped

    def stats(self) -> Dict[str, Any]:
        return {"sketches": [repr(s) for s in self.sketches]}

    # --- build (ref: DataSkippingIndex.index() :116-138) -------------------
    def write(self, ctx: CreateContext, df) -> None:
        from hyperspace_tpu_torch.plan.logical import Scan

        assert isinstance(df.plan, Scan)
        relation = df.plan.relation
        cols = resolve_columns_against_schema(self.indexed_columns, relation.schema)
        rows = self._sketch_rows(relation, relation.all_file_infos(), cols, ctx)
        self._write_rows(rows, ctx.index_data_path)

    def _sketch_rows(self, relation, file_infos, cols: List[str], ctx: CreateContext) -> List[Dict[str, Any]]:
        from hyperspace_tpu_torch.exec.io import read_parquet_batch

        part_cols = set(getattr(relation, "partition_columns", []) or []) & set(cols)
        file_cols = [c for c in cols if c not in part_cols]
        part_dtypes = dict(getattr(relation, "partition_dtypes", {}) or {})

        batches: List[Dict[str, np.ndarray]] = []
        rows: List[Dict[str, Any]] = []
        for fi in file_infos:
            fid = ctx.file_id_tracker.add_file(fi)
            if not file_cols:
                b = {}
                n = relation.arrow_dataset([fi.name]).count_rows()
            elif relation.physical_format == "parquet":
                b = read_parquet_batch([fi.name], file_cols)
                n = len(next(iter(b.values()))) if b else 0
            else:
                from hyperspace_tpu_torch.sources import formats as F

                t = F.read_table(fi.name, relation.physical_format, file_cols, getattr(relation, "options", None))
                b = {c: t.column(c).to_numpy(zero_copy_only=False) for c in file_cols}
                n = len(next(iter(b.values()))) if b else 0
            if part_cols:
                from hyperspace_tpu_torch.sources import partitions as P

                values = relation.partition_values_for(fi.name)
                for c in part_cols:
                    b[c] = P.column_array(values.get(c), part_dtypes.get(c, np.dtype(object)), n)
            batches.append(b)
            rows.append({C.DATA_FILE_NAME_ID: fid})

        # numeric MinMax sketches aggregate on device: all files' segments in
        # one segmented min+max kernel launch per call group
        # (ops/kernels.segmented_min_max)
        device_minmax = [
            s
            for s in self.sketches
            if isinstance(s, MinMaxSketch)
            and batches
            and all(b[s.expr].dtype.kind in ("i", "u", "f") for b in batches)
        ]
        for s in device_minmax:
            from hyperspace_tpu_torch.ops.kernels import segmented_min_max

            mins, maxs = segmented_min_max([b[s.expr] for b in batches], ctx.session.device)
            names = s.output_names()
            for i, row in enumerate(rows):
                dt = batches[i][s.expr].dtype
                row[names[0]] = None if np.isnan(mins[i]) else _restore_bound(mins[i], dt, lower=True)
                row[names[1]] = None if np.isnan(maxs[i]) else _restore_bound(maxs[i], dt, lower=False)

        host_sketches = [s for s in self.sketches if s not in device_minmax]
        for i, row in enumerate(rows):
            for s in host_sketches:
                col = batches[i][s.expr]
                for name, value in zip(s.output_names(), s.aggregate(col)):
                    row[name] = value
        return rows

    def _write_rows(self, rows: List[Dict[str, Any]], out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        if not rows:
            return
        names = list(rows[0])
        table = pa.table({n: [r[n] for r in rows] for n in names})
        pq.write_table(table, os.path.join(out_dir, "sketches-00000.parquet"))

    def read_sketch_table(self, entry) -> pa.Table:
        """The sketch table of a log entry: one row per source file."""
        return pads.dataset(entry.content.files, format="parquet").to_table()


class DataSkippingIndexConfig(IndexConfig):
    """(ref: HS/index/dataskipping/DataSkippingIndexConfig.scala:40-76)"""

    def __init__(self, index_name: str, first_sketch: Sketch, *more_sketches: Sketch):
        if not index_name:
            raise ValueError("Index name must not be empty")
        sketches = [first_sketch, *more_sketches]
        if len(set(sketches)) != len(sketches):
            raise ValueError("Duplicate sketches are not allowed")
        self._name = index_name
        self._sketches = sketches

    @property
    def index_name(self) -> str:
        return self._name

    @property
    def referenced_columns(self) -> List[str]:
        out: List[str] = []
        for s in self._sketches:
            for c in s.referenced_columns:
                if c not in out:
                    out.append(c)
        return out

    def create_index(self, ctx: CreateContext, df, properties: Dict[str, str]) -> DataSkippingIndex:
        index = DataSkippingIndex(self._sketches, dict(properties))
        index.write(ctx, df)
        return index


registry.register(DataSkippingIndex.kind, DataSkippingIndex.from_derived_dataset)
