"""TPC-H Q6: sum(l_extendedprice * l_discount) over a year's lines in a
discount band below a quantity."""

import numpy as np


def prepare(tables):
    li = tables["lineitem"]
    days = li["l_shipdate"].astype("datetime64[D]")
    order = np.argsort(days, kind="stable")
    return days[order], li["l_discount"][order], li["l_quantity"][order], li["l_extendedprice"][order]


def answer(state, p, dtype=np.float64):
    days, disc, qty, price = state
    year, d = int(p["year"]), int(p["discount"])
    lo, hi = float(f"{(d - 1) / 100:.2f}"), float(f"{(d + 1) / 100:.2f}")
    a = int(np.searchsorted(days, np.datetime64(f"{year}-01-01")))
    b = int(np.searchsorted(days, np.datetime64(f"{year + 1}-01-01")))
    m = (disc[a:b] >= lo) & (disc[a:b] <= hi) & (qty[a:b] < int(p["quantity"]))
    x = price[a:b][m].astype(dtype) * disc[a:b][m].astype(dtype)
    # SQL's sum over no rows is NULL
    return {"revenue": np.array([np.sum(x, dtype=dtype) if len(x) else np.nan])}
