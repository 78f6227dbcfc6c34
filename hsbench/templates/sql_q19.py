"""TPC-H Q19 (discounted revenue) as SQL text, with its substitution
parameters (TPC-H 2.4.19.3): QUANTITY1 1-10, QUANTITY2 10-20, QUANTITY3
20-30, BRAND1-3 ``Brand#MN`` with M and N in 1-5."""

TABLES = ("lineitem", "part")
INDEXES = ("li_pk", "p_pk")
KEYS = ()
ORDERED = True
READ = {"lineitem": {"l_partkey": 8, "l_quantity": 8, "l_extendedprice": 8, "l_discount": 8, "l_shipmode": 4,
                     "l_shipinstruct": 4},
        "part": {"p_partkey": 8, "p_brand": 4, "p_container": 4, "p_size": 8}}
OUT_ROW_BYTES = 8
#: (containers, largest size) of the three branches, as the specification fixes them
BRANCHES = ((("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 5),
            (("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10),
            (("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 15))

_BRANCH = """(p_partkey = l_partkey
    and p_brand = '{brand}'
    and p_container in ({containers})
    and l_quantity >= {quantity} and l_quantity <= {quantity} + 10
    and p_size between 1 and {size}
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON')"""


def request(ctx, p):
    branches = [_BRANCH.format(brand=p[f"brand{i}"], containers=", ".join(f"'{c}'" for c in cont),
                               quantity=int(p[f"quantity{i}"]), size=size)
                for i, (cont, size) in enumerate(BRANCHES, start=1)]
    return ("select sum(l_extendedprice * (1 - l_discount)) as revenue\nfrom lineitem, part\nwhere "
            + "\n  or ".join(branches))


def prepare(tables):
    return len(tables["lineitem"]["l_partkey"]), len(tables["part"]["p_partkey"])


def bytes_once(state, p):
    # the keys of li_pk and p_pk carry no predicate: every row is read
    n_li, n_part = state
    return n_li * sum(READ["lineitem"].values()) + n_part * sum(READ["part"].values()) + OUT_ROW_BYTES
