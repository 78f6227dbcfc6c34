"""TPC-H Q3 (shipping priority) as SQL text, with its substitution
parameters (TPC-H 2.4.3.3): SEGMENT one of the five market segments, DATE a
day of March 1995."""

import numpy as np

TABLES = ("customer", "orders", "lineitem")
INDEXES = ("c_ck", "o_ck", "li_sd")
KEYS = ("l_orderkey", "o_orderdate", "o_shippriority")
ORDERED = True
READ = {"customer": {"c_custkey": 8, "c_mktsegment": 4},
        "orders": {"o_custkey": 8, "o_orderkey": 8, "o_orderdate": 4, "o_shippriority": 8},
        "lineitem": {"l_shipdate": 4, "l_orderkey": 8, "l_extendedprice": 8, "l_discount": 8}}
OUT_ROW_BYTES = 8 + 8 + 4 + 8

TEXT = """select
  l_orderkey,
  sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{segment}'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '{date}'
  and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10"""


def date(p):
    return np.datetime64("1995-03-01") + np.timedelta64(int(p["day"]) - 1, "D")


def request(ctx, p):
    return TEXT.format(segment=p["segment"], date=str(date(p)))


def prepare(tables):
    return {"n_customer": len(tables["customer"]["c_custkey"]), "n_orders": len(tables["orders"]["o_orderkey"]),
            "ship": np.sort(tables["lineitem"]["l_shipdate"].astype("datetime64[D]"))}


def bytes_once(state, p):
    # the keys of c_ck and o_ck carry no predicate: every row is read
    li_rows = len(state["ship"]) - int(np.searchsorted(state["ship"], date(p), side="right"))
    return (state["n_customer"] * sum(READ["customer"].values()) + state["n_orders"] * sum(READ["orders"].values())
            + li_rows * sum(READ["lineitem"].values()) + 10 * OUT_ROW_BYTES)
