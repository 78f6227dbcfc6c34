"""TPC-H Q19: revenue of the lines of three (brand, container, quantity,
size) classes shipped by air and delivered in person."""

import numpy as np

BRANCHES = ((("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 5),
            (("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10),
            (("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 15))


def prepare(tables):
    """The lines shipped by air and delivered in person (no parameter
    touches that part of the predicate), each with its part's attributes."""
    li, part = tables["lineitem"], tables["part"]
    keep = (np.isin(np.asarray(li["l_shipmode"]).astype(str), ["AIR", "AIR REG"])
            & (np.asarray(li["l_shipinstruct"]).astype(str) == "DELIVER IN PERSON"))
    pk = li["l_partkey"][keep]
    order = np.argsort(part["p_partkey"], kind="stable")
    pos = order[np.searchsorted(part["p_partkey"], pk, sorter=order)]
    found = part["p_partkey"][pos] == pk
    return {"quantity": li["l_quantity"][keep][found], "price": li["l_extendedprice"][keep][found],
            "discount": li["l_discount"][keep][found],
            "brand": np.asarray(part["p_brand"]).astype(str)[pos[found]],
            "container": np.asarray(part["p_container"]).astype(str)[pos[found]],
            "size": part["p_size"][pos[found]]}


def answer(s, p, dtype=np.float64):
    m = np.zeros(len(s["quantity"]), dtype=bool)
    for i, (containers, size) in enumerate(BRANCHES, start=1):
        q = int(p[f"quantity{i}"])
        m |= ((s["brand"] == p[f"brand{i}"]) & np.isin(s["container"], containers)
              & (s["quantity"] >= q) & (s["quantity"] <= q + 10) & (s["size"] >= 1) & (s["size"] <= size))
    x = s["price"][m].astype(dtype) * (dtype(1) - s["discount"][m].astype(dtype))
    # SQL's sum over no rows is NULL
    return {"revenue": np.array([np.sum(x, dtype=dtype) if len(x) else np.nan])}
