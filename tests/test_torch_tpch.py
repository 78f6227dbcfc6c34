"""TPC-H q1-q22 through the port's SQL front end, against the JAX package.

One shaped 8-table lake (the fixture of tests/test_tpch_queries.py: its
schemas, row counts, generator, shaping and index roster at 4 buckets) is
indexed by each package in a system path of its own. Every one of the 22
texts of tests/tpch_queries.py then runs through both packages'
``Session.sql``:

- the port's optimized plan equals the approved plan
  (tests/approved_plans/tpch_sql/qN.txt) and the JAX package's plan;
- the port's rows equal the JAX package's: in order where the query ends
  in an ORDER BY, else as a multiset; float aggregates at rtol 1e-9;
- hyperspace on equals off in the port;
- with ``deviceMinRows=0`` (the device programs run as torch programs on
  the CPU) the rows are the same again, and the dispatch trace, recorded
  from cleared IO and device caches as the approved one was, equals the
  approved one (qN.dispatch.txt) line for line, ``decode:`` lines included;
- ten queries match the pandas oracles of tests/test_tpch_oracles.py.

Only helper names are imported from the JAX test modules, so pytest does
not collect their tests a second time.
"""

import math
import os
import re
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import pandas as pd  # noqa: E402

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import io as IO  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from test_tpch_oracles import test_q1 as _oracle_q1  # noqa: E402
from test_tpch_oracles import test_q3 as _oracle_q3  # noqa: E402
from test_tpch_oracles import test_q4 as _oracle_q4  # noqa: E402
from test_tpch_oracles import test_q5 as _oracle_q5  # noqa: E402
from test_tpch_oracles import test_q6 as _oracle_q6  # noqa: E402
from test_tpch_oracles import test_q10 as _oracle_q10  # noqa: E402
from test_tpch_oracles import test_q12 as _oracle_q12  # noqa: E402
from test_tpch_oracles import test_q14 as _oracle_q14  # noqa: E402
from test_tpch_oracles import test_q17 as _oracle_q17  # noqa: E402
from test_tpch_oracles import test_q19 as _oracle_q19  # noqa: E402
from test_tpch_queries import _ROWS, INDEXES, TPCH_SCHEMAS, _gen, _shape_table  # noqa: E402
from tpch_queries import TPCH_QUERIES  # noqa: E402

pytestmark = pytest.mark.torch_port

APPROVED_DIR = os.path.join(os.path.dirname(__file__), "approved_plans", "tpch_sql")
QUERIES = sorted(TPCH_QUERIES, key=lambda s: int(s[1:]))
FLOAT_RTOL = 1e-9
MODES = {"default": {}, "device": {"hyperspace.tpu.query.deviceMinRows": 0}}
ORACLES = {
    "q1": _oracle_q1, "q3": _oracle_q3, "q4": _oracle_q4, "q5": _oracle_q5, "q6": _oracle_q6,
    "q10": _oracle_q10, "q12": _oracle_q12, "q14": _oracle_q14, "q17": _oracle_q17, "q19": _oracle_q19,
}


def write_lake(root: str) -> dict:
    """The shaped tables as one parquet file each; returns {table: pandas}."""
    frames = {}
    for name, schema in TPCH_SCHEMAS.items():
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        n = _ROWS[name]
        cols = {c: _gen(c, k, n, rng) for c, k in schema.items()}
        if name in ("region", "nation", "supplier", "customer", "part", "orders"):
            cols[list(schema)[0]] = np.arange(n, dtype=np.int64)  # unique primary keys
        _shape_table(name, cols, n, rng)
        d = os.path.join(root, name)
        os.makedirs(d)
        pq.write_table(pa.table(cols), os.path.join(d, "part-00000.parquet"))
        frames[name] = pd.DataFrame(cols)
    return frames


def open_package(pkg, root: str, system: str, **kwargs):
    """A session of ``pkg`` over the lake with the roster built and every
    table registered as a view; hyperspace on."""
    sess = pkg.Session(conf={pkg.keys.SYSTEM_PATH: system, pkg.keys.NUM_BUCKETS: 4}, **kwargs)
    hs = pkg.Hyperspace(sess)
    for name in TPCH_SCHEMAS:
        sess.read_parquet(os.path.join(root, name)).create_or_replace_temp_view(name)
    for table, idx_name, indexed, included in INDEXES:
        hs.create_index(sess._temp_views[table], pkg.CoveringIndexConfig(idx_name, indexed, included))
    return sess.enable_hyperspace()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_torch"))
    frames = write_lake(root)
    ref = open_package(hst, root, os.path.join(root, "_jax"))
    port = open_package(ht, root, os.path.join(root, "_torch"), device="cpu")
    yield {"root": root, "frames": frames, "ref": ref, "port": port, "ref_rows": {}}
    hst.set_session(None)


def ordered_by_sort(text: str) -> bool:
    """Compare in order where the query ends in an ORDER BY (no TPC-H text
    orders a subquery)."""
    return bool(re.search(r"\border\s+by\b", text, re.I))


def assert_same_rows(got, want, ordered: bool, what: str):
    assert list(got) == list(want), (what, list(got), list(want))
    n = {len(v) for v in want.values()}
    assert {len(v) for v in got.values()} == n, what

    def rows(batch):
        cols = [batch[k].tolist() for k in batch]
        return list(zip(*cols)) if cols else []

    g, w = rows(got), rows(want)
    if not ordered:
        key = lambda r: tuple((x is None, x != x if isinstance(x, float) else False, repr(x)) for x in r)  # noqa: E731
        g, w = sorted(g, key=key), sorted(w, key=key)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert (x != x and y != y) or math.isclose(x, y, rel_tol=FLOAT_RTOL), (what, a, b)
            else:
                assert x == y or (x is None and y is None), (what, a, b)


def approved_dispatch(qname: str) -> str:
    with open(os.path.join(APPROVED_DIR, f"{qname}.dispatch.txt")) as f:
        return f.read()


def ref_rows(env, qname):
    got = env["ref_rows"].get(qname)
    if got is None:
        got = env["ref_rows"][qname] = env["ref"].sql(TPCH_QUERIES[qname]).collect()
    return got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("qname", QUERIES)
def test_query_matches_jax(env, qname, mode):
    sess, root = env["port"], env["root"]
    text = TPCH_QUERIES[qname]
    for k, v in MODES[mode].items():
        sess.conf.set(k, v)
    try:
        q = sess.sql(text)
        plan = q.optimized_plan().pretty()
        with open(os.path.join(APPROVED_DIR, f"{qname}.txt")) as f:
            assert plan.replace(root, "<TPCH>") == f.read(), qname
        if mode == "device":
            # the approved traces were recorded from cold caches
            IO.clear_io_cache()
            D.clear_device_cache()
        with trace.recording() as events:
            on = q.collect()
    finally:
        sess.conf.set("hyperspace.tpu.query.deviceMinRows", 1 << 25)
    if mode == "default":
        ref_q = env["ref"].sql(text)
        assert ref_q.optimized_plan().pretty() == plan, qname
        sess.disable_hyperspace()
        try:
            off = q.collect()
        finally:
            sess.enable_hyperspace()
        assert_same_rows(on, off, ordered_by_sort(text), f"{qname} on vs off")
    else:
        assert trace.summarize(events) == approved_dispatch(qname), qname
    assert len(next(iter(on.values()))) > 0, qname
    assert_same_rows(on, ref_rows(env, qname), ordered_by_sort(text), f"{qname} port vs jax")


@pytest.mark.parametrize("qname", sorted(ORACLES, key=lambda s: int(s[1:])))
def test_query_matches_pandas_oracle(env, qname):
    ORACLES[qname]((env["port"], env["frames"]))


def test_all_22_run():
    assert len(QUERIES) == 22


COMPUTED_OVER_JOIN = {
    # a computed input on the left side, grouped by the join key and a
    # right-side key (TPC-H q3's revenue)
    "grouped_left_input": (
        "select l_orderkey, o_orderdate, sum(l_extendedprice * (1 - l_discount)) as revenue, count(*) as n "
        "from lineitem join orders on l_orderkey = o_orderkey group by l_orderkey, o_orderdate "
        "order by l_orderkey"),
    # computed inputs on both sides, each from one side only, globally
    "global_both_sides": (
        "select sum(l_extendedprice * (1 - l_discount)) as revenue, avg(o_totalprice / 2) as half, "
        "count(*) as n from lineitem join orders on l_orderkey = o_orderkey"),
    # a computed group key on the right side
    "grouped_computed_key": (
        "select o_shippriority + 1 as sp, sum(l_quantity * 2) as q2 "
        "from lineitem join orders on l_orderkey = o_orderkey group by o_shippriority + 1 order by sp"),
    # an input computed from both sides: the join materializes
    "cross_side_input": (
        "select sum(l_extendedprice * o_totalprice) as x from lineitem join orders on l_orderkey = o_orderkey"),
}


@pytest.mark.parametrize("name", sorted(COMPUTED_OVER_JOIN))
def test_computed_aggregate_over_bucketed_join_matches_jax(env, name):
    """SQL's computed aggregate inputs and keys over the bucketed inner join
    of ``li_ok`` and ``o_ok``: the same plan, the same ``agg:`` and
    ``join:`` trace lines (``agg: fused-bucketed-join`` where each
    expression reads one side, the materialized join where one reads both)
    and the same rows as the JAX package."""
    from hyperspace_tpu.exec import trace as ref_trace

    text = COMPUTED_OVER_JOIN[name]
    out = {}
    for key, rec in (("ref", ref_trace), ("port", trace)):
        q = env[key].sql(text)
        with rec.recording() as events:
            got = q.collect()
        lines = [ln for ln in rec.summarize(events).splitlines() if ln.startswith(("agg:", "join:"))]
        out[key] = (q.optimized_plan().pretty(), lines, got)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1], (out["port"][1], out["ref"][1])
    fused = "agg: fused-bucketed-join x1" in out["port"][1]
    assert fused == (name != "cross_side_input"), out["port"][1]
    assert_same_rows(out["port"][2], out["ref"][2], True, name)
    assert len(next(iter(out["port"][2].values()))) > 0
