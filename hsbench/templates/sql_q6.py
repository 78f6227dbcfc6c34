"""TPC-H Q6 as SQL text, with its substitution parameters (TPC-H 2.4.6.3):
DATE the first of January of a year in 1993-1997, DISCOUNT 0.02-0.09 (the
band written out as two literals), QUANTITY 24 or 25."""

import numpy as np

TABLES = ("lineitem",)
INDEXES = ("li_sd",)
KEYS = ()
ORDERED = True
READ = {"l_shipdate": 4, "l_discount": 8, "l_quantity": 8, "l_extendedprice": 8}
OUT_ROW_BYTES = 8

TEXT = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{year}-01-01'
  and l_shipdate < date '{year}-01-01' + interval '1' year
  and l_discount between {lo} and {hi}
  and l_quantity < {quantity}"""


def literals(p):
    d = int(p["discount"])
    return {"year": int(p["year"]), "lo": f"{(d - 1) / 100:.2f}", "hi": f"{(d + 1) / 100:.2f}",
            "quantity": int(p["quantity"])}


def request(ctx, p):
    return TEXT.format(**literals(p))


def prepare(tables):
    return np.sort(tables["lineitem"]["l_shipdate"].astype("datetime64[D]"))


def bytes_once(days, p):
    y = int(p["year"])
    rows = int(np.searchsorted(days, np.datetime64(f"{y + 1}-01-01")) - np.searchsorted(days, np.datetime64(f"{y}-01-01")))
    return rows * sum(READ.values()) + OUT_ROW_BYTES
