"""TPC-H Q1's pricing summary over plain columns, as a DataFrame: the lines
shipped by 1998-12-01 less DELTA days, grouped by return flag and line
status (Q1's two computed sums need computed columns, which a DataFrame
request cannot carry; ``sd_price`` stands in for them as a float aggregate
that does not telescope)."""

import numpy as np

TABLES = ("lineitem",)
#: the covering index the rewrite has to read
INDEXES = ("li_q1",)
KEYS = ("l_returnflag", "l_linestatus")
ORDERED = False
#: stored widths in bytes (a date 4, an int64 or a float64 8, a dictionary string 4)
READ = {"l_shipdate": 4, "l_returnflag": 4, "l_linestatus": 4, "l_quantity": 8, "l_extendedprice": 8,
        "l_discount": 8}
OUT_ROW_BYTES = 2 * 4 + 7 * 8


def cutoff(p):
    return np.datetime64("1998-12-01") - np.timedelta64(int(p["delta"]), "D")


def request(ctx, p):
    c = ctx.ht.col
    return (ctx.frames["lineitem"].filter(c("l_shipdate") <= cutoff(p))
            .group_by("l_returnflag", "l_linestatus")
            .agg(sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
                 avg_qty=("l_quantity", "avg"), avg_price=("l_extendedprice", "avg"),
                 avg_disc=("l_discount", "avg"), count_order=("*", "count"),
                 sd_price=("l_extendedprice", "stddev_samp")))


def prepare(tables):
    """The ship days sorted, and each (flag, status) group's first ship day."""
    li = tables["lineitem"]
    days = li["l_shipdate"].astype("datetime64[D]")
    # one-letter flags: their code points name the group
    pair = li["l_returnflag"].astype("U1").view(np.uint32) * 128 + li["l_linestatus"].astype("U1").view(np.uint32)
    first = {}
    for g in np.unique(pair):
        first[int(g)] = days[pair == g].min()
    return np.sort(days), np.array(sorted(first.values()))


def bytes_once(state, p):
    days, firsts = state
    rows = int(np.searchsorted(days, cutoff(p), side="right"))
    groups = int(np.searchsorted(firsts, cutoff(p), side="right"))
    return rows * sum(READ.values()) + groups * OUT_ROW_BYTES
