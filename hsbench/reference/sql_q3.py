"""TPC-H Q3: the ten unshipped orders of a market segment with the highest
revenue, ordered by revenue (descending) and order date."""

import numpy as np


def prepare(tables):
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    return {"c_custkey": c["c_custkey"], "c_mktsegment": np.asarray(c["c_mktsegment"]).astype(str),
            "o_orderkey": o["o_orderkey"], "o_custkey": o["o_custkey"],
            "o_orderdate": o["o_orderdate"].astype("datetime64[D]"), "o_shippriority": o["o_shippriority"],
            "l_orderkey": li["l_orderkey"], "l_shipdate": li["l_shipdate"].astype("datetime64[D]"),
            "l_extendedprice": li["l_extendedprice"], "l_discount": li["l_discount"]}


def answer(s, p, dtype=np.float64):
    date = np.datetime64("1995-03-01") + np.timedelta64(int(p["day"]) - 1, "D")
    custs = s["c_custkey"][s["c_mktsegment"] == p["segment"]]
    om = (s["o_orderdate"] < date) & np.isin(s["o_custkey"], custs)
    okeys = s["o_orderkey"][om]
    lm = (s["l_shipdate"] > date) & np.isin(s["l_orderkey"], okeys)
    keys = s["l_orderkey"][lm]
    rev = s["l_extendedprice"][lm].astype(dtype) * (dtype(1) - s["l_discount"][lm].astype(dtype))
    order = np.argsort(keys, kind="stable")
    keys, rev = keys[order], rev[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) if len(keys) else np.zeros(0, dtype=np.int64)
    gkeys = keys[starts]
    grev = np.add.reduceat(rev, starts, dtype=dtype) if len(keys) else np.zeros(0, dtype=dtype)
    # each group's order: o_orderkey is unique, so a search finds its row
    pos = np.searchsorted(s["o_orderkey"], gkeys) if np.all(np.diff(s["o_orderkey"]) > 0) else \
        np.array([np.flatnonzero(s["o_orderkey"] == k)[0] for k in gkeys], dtype=np.int64)
    odate, oprio = s["o_orderdate"][pos], s["o_shippriority"][pos]
    top = np.lexsort((odate, -grev.astype(np.float64)))[:10]
    return {"l_orderkey": gkeys[top], "revenue": grev[top], "o_orderdate": odate[top], "o_shippriority": oprio[top]}
