"""TPC-H's eight tables from a seed, sized by scale factor (SF1 is 6M
``lineitem`` rows, the official row-count scaling). Not dbgen: the value
distributions follow what the 22 query texts predicate on. Copied from
``benchmarks/tpch_full.py::gen_all`` so that the yardstick stays put, with
two changes: only the tables asked for are written, and each table draws
from a generator of its own (``(seed, table)``), so a table's rows do not
depend on which others are made.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

ROWS_SF1 = {
    "region": 5,
    "nation": 25,
    "supplier": 10_000,
    "customer": 150_000,
    "part": 200_000,
    "partsupp": 800_000,
    "orders": 1_500_000,
    "lineitem": 6_000_000,
}
#: files per table, as ``gen_all`` writes them
FILES = {"region": 1, "nation": 1, "supplier": 2, "customer": 4, "part": 4, "partsupp": 4, "orders": 8, "lineitem": 16}

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["AIR", "AIR REG", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
_TYPES = [
    f"{a} {b} {c}"
    for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
    for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
    for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")
]
_CONTAINERS = [f"{a} {b}" for a in ("SM", "MED", "LG", "JUMBO", "WRAP")
               for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")]
_BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
_P_NAME_WORDS = np.array(
    ["almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
     "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
     "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
     "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
     "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
     "hot", "hotpink", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
     "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
     "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange"]
)
_BASE = np.datetime64("1992-01-01")


def rows_of(name: str, sf: float) -> int:
    if name in ("region", "nation"):
        return ROWS_SF1[name]
    return max(20, int(ROWS_SF1[name] * sf))


def _comments(rng, rows, special_frac=0.1):
    base = np.array([f"notes {i}" for i in range(97)], dtype=object)
    out = base[rng.integers(0, len(base), rows)]
    hits = rng.random(rows) < special_frac
    specials = np.array(["special requests handle", "pending deposits accounts",
                         "unusual packages wake", "express Customer Complaints"], dtype=object)
    out[hits] = specials[rng.integers(0, len(specials), int(hits.sum()))]
    return out


def _chunk(name: str, rng, off: int, rows: int, n: dict) -> dict:
    """``rows`` rows of table ``name`` from row ``off``; ``n`` holds every
    table's row count (the foreign keys' domains)."""
    k = np.arange(off, off + rows, dtype=np.int64)
    if name == "region":
        return {"r_regionkey": k, "r_name": np.array(_REGIONS, dtype=object),
                "r_comment": np.array([f"region {i}" for i in range(5)], dtype=object)}
    if name == "nation":
        return {"n_nationkey": k, "n_name": np.array([a for a, _ in _NATIONS], dtype=object),
                "n_regionkey": np.array([r for _, r in _NATIONS], dtype=np.int64),
                "n_comment": np.array([f"nation {i}" for i in range(25)], dtype=object)}
    if name == "supplier":
        return {"s_suppkey": k,
                "s_name": np.array([f"Supplier#{v:09d}" for v in k], dtype=object),
                "s_address": np.array([f"{v % 9999} Dock Rd" for v in k], dtype=object),
                "s_nationkey": rng.integers(0, 25, rows).astype(np.int64),
                "s_phone": np.array([f"{13 + (v % 20)}-{v % 997:03d}-55" for v in k], dtype=object),
                "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, rows), 2),
                "s_comment": _comments(rng, rows)}
    if name == "customer":
        return {"c_custkey": k,
                "c_name": np.array([f"Customer#{v:09d}" for v in k], dtype=object),
                "c_address": np.array([f"{v % 9999} Market St" for v in k], dtype=object),
                "c_nationkey": rng.integers(0, 25, rows).astype(np.int64),
                "c_phone": np.array([f"{13 + (v % 20)}-{v % 997:03d}-55" for v in k], dtype=object),
                "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, rows), 2),
                "c_mktsegment": np.array(SEGMENTS, dtype=object)[rng.integers(0, 5, rows)],
                "c_comment": _comments(rng, rows)}
    if name == "part":
        w1 = _P_NAME_WORDS[rng.integers(0, len(_P_NAME_WORDS), rows)]
        w2 = _P_NAME_WORDS[rng.integers(0, len(_P_NAME_WORDS), rows)]
        return {"p_partkey": k,
                "p_name": np.array([f"{a} {b}" for a, b in zip(w1, w2)], dtype=object),
                "p_mfgr": np.array([f"Manufacturer#{1 + (v % 5)}" for v in k], dtype=object),
                "p_brand": np.array(_BRANDS, dtype=object)[rng.integers(0, len(_BRANDS), rows)],
                "p_type": np.array(_TYPES, dtype=object)[rng.integers(0, len(_TYPES), rows)],
                "p_size": rng.integers(1, 51, rows).astype(np.int64),
                "p_container": np.array(_CONTAINERS, dtype=object)[rng.integers(0, len(_CONTAINERS), rows)],
                "p_retailprice": np.round(rng.uniform(900.0, 2000.0, rows), 2),
                "p_comment": _comments(rng, rows)}
    if name == "partsupp":
        return {"ps_partkey": rng.integers(0, n["part"], rows).astype(np.int64),
                "ps_suppkey": rng.integers(0, n["supplier"], rows).astype(np.int64),
                "ps_availqty": rng.integers(1, 10_000, rows).astype(np.int64),
                "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, rows), 2),
                "ps_comment": _comments(rng, rows)}
    if name == "orders":
        return {"o_orderkey": k,
                "o_custkey": rng.integers(0, max(1, int(n["customer"] * 0.85)), rows).astype(np.int64),
                "o_orderstatus": np.array(["F", "O", "P"], dtype=object)[rng.integers(0, 3, rows)],
                "o_totalprice": np.round(rng.uniform(800.0, 600000.0, rows), 2),
                "o_orderdate": _BASE + rng.integers(0, 2406, rows).astype("timedelta64[D]"),
                "o_orderpriority": np.array(_PRIORITIES, dtype=object)[rng.integers(0, 5, rows)],
                "o_clerk": np.array([f"Clerk#{v % 1000:09d}" for v in k], dtype=object),
                "o_shippriority": np.zeros(rows, dtype=np.int64),
                "o_comment": _comments(rng, rows)}
    if name == "lineitem":
        ship = _BASE + rng.integers(366, 2526, rows).astype("timedelta64[D]")
        commit = ship + rng.integers(7, 30, rows).astype("timedelta64[D]")
        late = rng.random(rows) < 0.2
        receipt = commit + np.where(late, rng.integers(1, 6, rows), rng.integers(-5, 1, rows)).astype("timedelta64[D]")
        okeys = rng.integers(0, n["orders"], rows).astype(np.int64)
        heavy = rng.random(rows) < 0.02  # q18's heavy orders
        okeys[heavy] = rng.integers(0, max(1, n["orders"] // 1000), int(heavy.sum()))
        return {"l_orderkey": okeys,
                "l_partkey": rng.integers(0, n["part"], rows).astype(np.int64),
                "l_suppkey": rng.integers(0, n["supplier"], rows).astype(np.int64),
                "l_linenumber": rng.integers(1, 8, rows).astype(np.int64),
                "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
                "l_extendedprice": np.round(rng.uniform(900.0, 105000.0, rows), 2),
                "l_discount": np.round(rng.integers(0, 11, rows) / 100.0, 2),
                "l_tax": np.round(rng.integers(0, 9, rows) / 100.0, 2),
                "l_returnflag": np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, rows)],
                "l_linestatus": np.array(["F", "O"], dtype=object)[rng.integers(0, 2, rows)],
                "l_shipdate": ship,
                "l_commitdate": commit,
                "l_receiptdate": receipt,
                "l_shipinstruct": np.array(_INSTRUCT, dtype=object)[rng.integers(0, 4, rows)],
                "l_shipmode": np.array(_SHIPMODES, dtype=object)[rng.integers(0, 8, rows)],
                "l_comment": _comments(rng, rows)}
    raise ValueError(f"tpch_full makes no table {name!r}")


def generate(root: str, tables: dict, seed: int) -> dict:
    """Write the tables named in ``tables`` ({name: {"scale_factor"}}, one
    scale factor for all) under ``root``; returns {name: {"dir": path,
    "columns": {column: array}}}."""
    sfs = {spec["scale_factor"] for spec in tables.values()}
    if len(sfs) != 1:
        raise ValueError(f"tpch_full takes one scale factor for every table, not {sorted(sfs)}")
    sf = sfs.pop()
    n = {name: rows_of(name, sf) for name in ROWS_SF1}
    out = {}
    for t, name in enumerate(ROWS_SF1):
        if name not in tables:
            continue
        rng = np.random.default_rng([seed, t])
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        total, files = n[name], FILES[name]
        per = max(1, total // files)
        parts = []
        for i in range(files):
            rows = per if i < files - 1 else total - per * (files - 1)
            cols = _chunk(name, rng, i * per, rows, n)
            pq.write_table(pa.table(cols), os.path.join(d, f"part-{i:05d}.parquet"))
            parts.append(cols)
        out[name] = {"dir": d, "columns": {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}}
    unknown = set(tables) - set(ROWS_SF1)
    if unknown:
        raise ValueError(f"tpch_full makes no table {sorted(unknown)}")
    return out
