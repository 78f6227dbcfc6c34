"""TPC-H-shaped ``lineitem`` and ``orders`` from a seed: the columns and
value ranges of ``chip_smoke.py``'s ``gen_lineitem`` / ``gen_orders``
(copied, so that the yardstick does not move when the smoke does).

``l_returnflag`` and ``l_linestatus`` follow TPC-H's rule from the ship date
and a receipt 1-30 days later, drawn from a second generator. Every
``l_orderkey`` matches exactly one ``o_orderkey``. The smoke writes only the
columns its queries read; the rest of TPC-H's columns, so that each row has
TPC-H's width, come from a third generator (``tpch_full``'s vocabularies),
which leaves the smoke's columns as they are.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hsbench.datagen import tpch_full as F

LINEITEM_ROWS_SF1 = 6_000_000
ORDERS_ROWS_SF1 = 1_500_000
#: TPC-H's "current date" (spec 4.2.3): a line shipped after it is open
CURRENT_DATE = "1995-06-17"


def lineitem_columns(rng, flags_rng, rest_rng, rows: int, sf: float) -> dict:
    """One ``lineitem`` file's columns at scale factor ``sf``."""
    base = np.datetime64("1992-01-01")
    current = np.datetime64(CURRENT_DATE)
    n_orders = max(1, int(ORDERS_ROWS_SF1 * sf))
    cols = {
        "l_orderkey": rng.integers(0, n_orders, rows).astype(np.int64),
        "l_partkey": rng.integers(0, int(200_000 * max(sf, 0.01)), rows).astype(np.int64),
        "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105000.0, rows), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, rows), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, rows), 2),
        "l_shipdate": base + rng.integers(0, 2526, rows).astype("timedelta64[D]"),
    }
    receipt = cols["l_shipdate"] + flags_rng.integers(1, 31, rows).astype("timedelta64[D]")
    returned = flags_rng.choice(np.array(["R", "A"]), rows)
    cols["l_returnflag"] = np.where(receipt <= current, returned, "N")
    cols["l_linestatus"] = np.where(cols["l_shipdate"] > current, "O", "F")
    cols["l_suppkey"] = rest_rng.integers(0, int(10_000 * max(sf, 0.01)), rows).astype(np.int64)
    cols["l_linenumber"] = rest_rng.integers(1, 8, rows).astype(np.int64)
    cols["l_commitdate"] = cols["l_shipdate"] + rest_rng.integers(7, 30, rows).astype("timedelta64[D]")
    cols["l_receiptdate"] = receipt
    cols["l_shipinstruct"] = np.array(F._INSTRUCT, dtype=object)[rest_rng.integers(0, 4, rows)]
    cols["l_shipmode"] = np.array(F._SHIPMODES, dtype=object)[rest_rng.integers(0, 8, rows)]
    cols["l_comment"] = F._comments(rest_rng, rows)
    return cols


def orders_columns(rng, rest_rng, first_key: int, rows: int, sf: float) -> dict:
    """One ``orders`` file's columns: order keys ``first_key`` on."""
    base = np.datetime64("1992-01-01")
    keys = np.arange(first_key, first_key + rows, dtype=np.int64)
    return {
        "o_orderkey": keys,
        "o_custkey": rng.integers(0, int(150_000 * max(sf, 0.01)), rows).astype(np.int64),
        "o_totalprice": np.round(rng.uniform(800.0, 600000.0, rows), 2),
        "o_orderdate": base + rng.integers(0, 2406, rows).astype("timedelta64[D]"),
        "o_shippriority": rng.integers(0, 2, rows).astype(np.int64),
        "o_orderstatus": np.array(["F", "O", "P"], dtype=object)[rest_rng.integers(0, 3, rows)],
        "o_orderpriority": np.array(F._PRIORITIES, dtype=object)[rest_rng.integers(0, 5, rows)],
        "o_clerk": np.array([f"Clerk#{v % 1000:09d}" for v in keys], dtype=object),
        "o_comment": F._comments(rest_rng, rows),
    }


def _write(d: str, rows_total: int, num_files: int, make) -> dict:
    os.makedirs(d, exist_ok=True)
    per = max(1, rows_total // num_files)
    parts = []
    for i in range(num_files):
        rows = per if i < num_files - 1 else rows_total - per * (num_files - 1)
        cols = make(i, i * per, rows)
        pq.write_table(pa.table(cols), os.path.join(d, f"part-{i:05d}.parquet"))
        parts.append(cols)
    return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}


def generate(root: str, tables: dict, seed: int) -> dict:
    """Write the tables named in ``tables`` ({name: {"rows", "files"}}) under
    ``root``; returns {name: {"dir": path, "columns": {column: array}}}."""
    out = {}
    if "lineitem" in tables:
        spec = tables["lineitem"]
        sf = spec["rows"] / LINEITEM_ROWS_SF1
        rng, flags_rng = np.random.default_rng(seed), np.random.default_rng(seed + 1)
        rest_rng = np.random.default_rng([seed, 3])
        d = os.path.join(root, "lineitem")
        cols = _write(d, spec["rows"], spec["files"],
                      lambda i, off, rows: lineitem_columns(rng, flags_rng, rest_rng, rows, sf))
        out["lineitem"] = {"dir": d, "columns": cols}
    if "orders" in tables:
        spec = tables["orders"]
        sf = spec["rows"] / ORDERS_ROWS_SF1
        rng, rest_rng = np.random.default_rng(seed + 2), np.random.default_rng([seed, 4])
        d = os.path.join(root, "orders")
        cols = _write(d, spec["rows"], spec["files"], lambda i, off, rows: orders_columns(rng, rest_rng, off, rows, sf))
        out["orders"] = {"dir": d, "columns": cols}
    unknown = set(tables) - {"lineitem", "orders"}
    if unknown:
        raise ValueError(f"tpch_lineitem_orders makes no table {sorted(unknown)}")
    return out
