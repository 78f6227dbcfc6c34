"""TPC-H Q6's filter, aggregated as ``chip_smoke.py``'s A2: the revenue
sum, the count, the mean discount and the quantity's range."""

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
    x, dd, q = price[a:b][m].astype(dtype), disc[a:b][m].astype(dtype), qty[a:b][m]
    n = len(x)
    if n == 0:  # every aggregate but the count is NULL over no rows
        return {"revenue": np.array([np.nan]), "n": np.array([0]), "avg_disc": np.array([np.nan]),
                "min_qty": np.array([np.nan]), "max_qty": np.array([np.nan])}
    return {"revenue": np.array([np.sum(x, dtype=dtype)]), "n": np.array([n]),
            "avg_disc": np.array([np.sum(dd, dtype=dtype) / dtype(n)]),
            "min_qty": np.array([q.min()]), "max_qty": np.array([q.max()])}
