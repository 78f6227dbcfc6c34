"""TPC-H Q6's global aggregate as a DataFrame, with Q6's substitution
parameters (TPC-H 2.4.6.3): DATE the first of January of a year in
1993-1997, DISCOUNT 0.02-0.09 with a band of 0.01 either side, QUANTITY 24
or 25. Aggregates as ``chip_smoke.py``'s A2 (no computed column)."""

import numpy as np

TABLES = ("lineitem",)
INDEXES = ("li_shipdate",)
KEYS = ()
ORDERED = True
READ = {"l_shipdate": 4, "l_discount": 8, "l_quantity": 8, "l_extendedprice": 8}
OUT_ROW_BYTES = 5 * 8


def bounds(p):
    """(first day, day after the year, lowest discount, highest, quantity)"""
    start = np.datetime64(f"{int(p['year'])}-01-01")
    end = np.datetime64(f"{int(p['year']) + 1}-01-01")
    d = int(p["discount"])
    return start, end, float(f"{(d - 1) / 100:.2f}"), float(f"{(d + 1) / 100:.2f}"), int(p["quantity"])


def request(ctx, p):
    c = ctx.ht.col
    start, end, lo, hi, qty = bounds(p)
    return (ctx.frames["lineitem"]
            .filter((c("l_shipdate") >= start) & (c("l_shipdate") < end) & (c("l_discount") >= lo)
                    & (c("l_discount") <= hi) & (c("l_quantity") < qty))
            .agg(revenue=("l_extendedprice", "sum"), n=("*", "count"), avg_disc=("l_discount", "avg"),
                 min_qty=("l_quantity", "min"), max_qty=("l_quantity", "max")))


def prepare(tables):
    return np.sort(tables["lineitem"]["l_shipdate"].astype("datetime64[D]"))


def bytes_once(days, p):
    start, end, *_ = bounds(p)
    rows = int(np.searchsorted(days, end, side="left") - np.searchsorted(days, start, side="left"))
    return rows * sum(READ.values()) + OUT_ROW_BYTES
