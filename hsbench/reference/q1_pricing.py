"""TPC-H Q1 over plain columns: lines shipped by 1998-12-01 less DELTA days,
grouped by (l_returnflag, l_linestatus)."""

import numpy as np


def prepare(tables):
    """Per group, its rows sorted by ship day: a cut-off then selects a prefix."""
    li = tables["lineitem"]
    flag = np.asarray(li["l_returnflag"]).astype(str)
    status = np.asarray(li["l_linestatus"]).astype(str)
    pairs, inverse = np.unique(np.char.add(np.char.add(flag, "|"), status), return_inverse=True)
    groups = []
    for g, pair in enumerate(pairs):
        rows = np.flatnonzero(inverse == g)
        days = li["l_shipdate"][rows].astype("datetime64[D]")
        order = np.argsort(days, kind="stable")
        rows = rows[order]
        groups.append((tuple(str(pair).split("|")), days[order], li["l_quantity"][rows],
                       li["l_extendedprice"][rows], li["l_discount"][rows]))
    return groups


def answer(state, p, dtype=np.float64):
    cutoff = np.datetime64("1998-12-01") - np.timedelta64(int(p["delta"]), "D")
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty", "sum_base_price", "avg_qty", "avg_price",
                           "avg_disc", "count_order", "sd_price")}
    for (flag, status), days, qty, price, disc in state:
        n = int(np.searchsorted(days, cutoff, side="right"))
        if n == 0:
            continue
        q = qty[:n]
        x = price[:n].astype(dtype)
        d = disc[:n].astype(dtype)
        nd = dtype(n)
        sum_x = np.sum(x, dtype=dtype)
        mean_x = sum_x / nd
        sum_q = int(np.sum(q, dtype=np.int64))
        out["l_returnflag"].append(flag)
        out["l_linestatus"].append(status)
        out["sum_qty"].append(sum_q)
        out["sum_base_price"].append(sum_x)
        out["avg_qty"].append(dtype(sum_q) / nd)
        out["avg_price"].append(mean_x)
        out["avg_disc"].append(np.sum(d, dtype=dtype) / nd)
        out["count_order"].append(n)
        out["sd_price"].append(np.sqrt(np.sum((x - mean_x) ** 2, dtype=dtype) / dtype(n - 1)) if n > 1 else np.nan)
    return {k: np.array(v, dtype=object if k in ("l_returnflag", "l_linestatus") else None) for k, v in out.items()}
