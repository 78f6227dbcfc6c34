"""The port's bucketed join (slice 4) against the JAX package, end to end.

One TPC-H-shaped lake, made from a seed with numpy, is indexed by both
packages (``hyperspace_tpu`` on the JAX CPU backend, ``hyperspace_tpu_torch``
with ``device="cpu"``). Every join then runs in both packages over each
package's indexes, on each path of the join:

- ``device``: ``deviceMinRows=0``, the span program and the inner join's
  expand-gather program (``join: device-smj``);
- ``nomat``: the same with ``deviceMaterialize`` off, so the pairs expand on
  the host from the device's spans;
- ``host``: the default ``deviceMinRows``, spans on the host
  (``join: host-span-smj``);
- ``off``: hyperspace off, the generic merge (``join: generic-merge``).

The comparisons are exact: the optimized plans' text, the dispatch trace's
``join:``, ``scan:`` and ``spans:`` lines, and the collected columns byte for
byte and in order.

Both packages' sessions set ``hyperspace.exec.join.broadcastMaxBytes`` to 0.
The JAX package takes a broadcast hash join for a side under that many bytes
(64 MiB by default) when the bucketed join does not apply, and that tier's
row order may differ from the generic merge's; the port has no such tier and
runs the generic merge there. The JAX package's native span walk and pair
expansion are switched off, as they are where its native library is absent:
its host path then takes the numpy branch the port copies (the same spans,
the same pairs, and the ``spans: searchsorted`` trace line).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu import native as ref_native  # noqa: E402
from hyperspace_tpu.exec import device as RD  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import join as J  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 8
BASE = np.datetime64("1995-01-01")


def _table(rng, n, cols):
    return pa.table({name: make(rng, n) for name, make in cols.items()})


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """{table: directory}. ``lineitem`` (3 files) and ``orders`` hold
    duplicate keys on both sides and keys the other side lacks, a nullable
    int payload (``l_n``), nullable strings and dates; ``shipmodes`` joins on
    a string key, ``events``/``dims`` share the key name ``k`` (USING)."""
    root = tmp_path_factory.mktemp("join_lake")
    rng = np.random.default_rng(41)

    def ints(lo, hi):
        return lambda r, n: r.integers(lo, hi, n).astype(np.int64)

    def floats(r, n):
        return np.round(r.uniform(0, 1000, n), 3)

    def dates(r, n):
        return BASE + r.integers(0, 400, n).astype("timedelta64[D]")

    def strings(prefix, k, null=0.0):
        return lambda r, n: pa.array([f"{prefix}{x}" for x in r.integers(0, k, n)], mask=r.random(n) < null)

    tables = {
        "lineitem": (3, 900, {
            "l_orderkey": ints(0, 600), "l_partkey": ints(0, 40), "l_suppkey": ints(0, 4),
            "l_quantity": ints(1, 51), "l_extendedprice": floats, "l_discount": floats, "l_shipdate": dates,
            "l_comment": strings("c", 30, 0.1), "l_shipmode": strings("m", 7),
            "l_n": lambda r, n: pa.array(r.integers(-(2**40), 2**40, n), mask=r.random(n) < 0.15),
        }),
        "orders": (2, 400, {
            "o_orderkey": ints(100, 700), "o_custkey": ints(0, 90), "o_totalprice": floats,
            "o_orderdate": dates, "o_status": strings("s", 3, 0.1),
        }),
        "customer": (1, 80, {"c_custkey": ints(0, 100), "c_nationkey": ints(0, 25), "c_acctbal": floats}),
        "part": (1, 60, {"p_partkey": ints(0, 50), "p_size": ints(1, 50)}),
        "partsupp": (1, 160, {"ps_partkey": ints(0, 50), "ps_suppkey": ints(0, 4), "ps_supplycost": floats}),
        "supplier": (1, 30, {"s_suppkey": ints(0, 30), "s_nationkey": ints(0, 25), "s_acctbal": floats}),
        "nation": (1, 25, {"n_nationkey": ints(0, 25), "n_regionkey": ints(0, 5)}),
        "shipmodes": (1, 10, {"sm_mode": strings("m", 9), "sm_cost": floats}),
        "events": (2, 300, {"k": ints(0, 120), "ev": floats}),
        "dims": (1, 100, {"k": ints(40, 160), "dv": floats}),
    }
    out = {}
    for name, (files, rows, cols) in tables.items():
        d = root / name
        d.mkdir()
        for i in range(files):
            pq.write_table(_table(rng, rows, cols), d / f"part-{i:05d}.parquet")
        out[name] = str(d)
    return out


COVERING = [
    ("lineitem", "li_orderkey", ["l_orderkey"],
     ["l_extendedprice", "l_discount", "l_quantity", "l_shipdate", "l_comment", "l_n"]),
    ("lineitem", "li_pk_sk", ["l_partkey", "l_suppkey"], ["l_quantity"]),
    ("lineitem", "li_shipmode", ["l_shipmode"], ["l_extendedprice"]),
    ("lineitem", "li_shipdate", ["l_shipdate"], ["l_extendedprice"]),
    ("orders", "o_orderkey", ["o_orderkey"], ["o_custkey", "o_totalprice", "o_orderdate", "o_status"]),
    ("orders", "o_custkey", ["o_custkey"], ["o_orderkey"]),
    ("orders", "o_orderdate", ["o_orderdate"], ["o_totalprice"]),
    ("customer", "c_custkey", ["c_custkey"], ["c_nationkey", "c_acctbal"]),
    ("part", "p_partkey", ["p_partkey"], ["p_size"]),
    ("partsupp", "ps_partkey", ["ps_partkey"], ["ps_supplycost"]),
    ("partsupp", "ps_pk_sk", ["ps_partkey", "ps_suppkey"], ["ps_supplycost"]),
    ("shipmodes", "sm_mode", ["sm_mode"], ["sm_cost"]),
    ("events", "ev_k", ["k"], ["ev"]),
    ("dims", "dm_k", ["k"], ["dv"]),
]


def _conf(keys, system_path, **extra):
    return {keys.SYSTEM_PATH: system_path, keys.NUM_BUCKETS: NUM_BUCKETS, "hyperspace.tpu.build.batchRows": 700,
            "hyperspace.exec.join.broadcastMaxBytes": 0, **extra}


@pytest.fixture(scope="module")
def systems(lake, tmp_path_factory):
    """{owner: system path} with every covering index built by that package."""
    out = {}
    for owner, pkg in (("jax", hst), ("torch", ht)):
        path = str(tmp_path_factory.mktemp(f"{owner}_join_indexes"))
        kwargs = {} if pkg is hst else {"device": "cpu"}
        sess = pkg.Session(conf=_conf(pkg.keys, path), **kwargs)
        for table, name, indexed, included in COVERING:
            pkg.Hyperspace(sess).create_index(sess.read_parquet(lake[table]),
                                              pkg.CoveringIndexConfig(name, indexed, included))
        out[owner] = path
    return out


@pytest.fixture(autouse=True)
def _no_native_join(monkeypatch):
    """The JAX package's span walk and pair expansion without its native
    library (module docstring)."""

    def unsupported(*args, **kwargs):
        raise ref_native.NativeUnsupported("native join kernels off for the comparison")

    monkeypatch.setattr(ref_native, "merge_spans", unsupported)
    monkeypatch.setattr(ref_native, "expand_pairs", unsupported)


WIDE = ("l_orderkey", "l_extendedprice", "l_comment", "l_n", "l_shipdate",
        "o_orderkey", "o_totalprice", "o_status", "o_orderdate")

#: name -> (query over the frames ``t`` with ``col`` c, the index names its
#: optimized plan scans). q04-q10 are tests/test_plan_stability.py's join
#: shapes.
JOINS = {
    "q04_join_li_orders": (lambda t, c: t["lineitem"].join(t["orders"], c("l_orderkey") == c("o_orderkey"))
                           .select("l_extendedprice", "o_totalprice"), ["li_orderkey", "o_orderkey"]),
    "q05_join_orders_customer": (lambda t, c: t["orders"].join(t["customer"], c("o_custkey") == c("c_custkey"))
                                 .select("o_totalprice", "c_acctbal"), []),
    "q06_join_filter": (lambda t, c: t["lineitem"].filter(c("l_quantity") > 10)
                        .join(t["orders"], c("l_orderkey") == c("o_orderkey")).select("l_quantity", "o_totalprice"),
                        ["li_orderkey", "o_orderkey"]),
    "q07_join_part_partsupp": (lambda t, c: t["part"].join(t["partsupp"], c("p_partkey") == c("ps_partkey"))
                               .select("p_size", "ps_supplycost"), ["p_partkey", "ps_partkey"]),
    "q08_three_way": (lambda t, c: t["lineitem"].join(t["orders"], c("l_orderkey") == c("o_orderkey"))
                      .join(t["customer"], c("o_custkey") == c("c_custkey")).select("l_extendedprice", "c_acctbal"),
                      ["li_orderkey", "o_orderkey"]),
    "q09_self_join": (lambda t, c: t["lineitem"].join(t["lineitem"], on=["l_orderkey"]).select("l_extendedprice"),
                      ["li_orderkey", "li_orderkey"]),
    "self_join_renamed": (lambda t, c: t["lineitem"].join(t["lineitem"], on=["l_orderkey"], how="outer")
                          .select("l_orderkey", "l_extendedprice", "l_extendedprice#r", "l_n#r"),
                          ["li_orderkey", "li_orderkey"]),
    "q10_no_index_join": (lambda t, c: t["supplier"].join(t["nation"], c("s_nationkey") == c("n_nationkey"))
                          .select("s_acctbal"), []),
    "inner_wide": (lambda t, c: t["lineitem"].join(t["orders"], c("l_orderkey") == c("o_orderkey")).select(*WIDE),
                   ["li_orderkey", "o_orderkey"]),
    "left": (lambda t, c: t["lineitem"].join(t["orders"], c("l_orderkey") == c("o_orderkey"), how="left")
             .select(*WIDE), ["li_orderkey", "o_orderkey"]),
    "right": (lambda t, c: t["lineitem"].join(t["orders"], c("o_orderkey") == c("l_orderkey"), how="right")
              .select(*WIDE), ["li_orderkey", "o_orderkey"]),
    "outer": (lambda t, c: t["lineitem"].join(t["orders"], c("l_orderkey") == c("o_orderkey"), how="outer")
              .select(*WIDE), ["li_orderkey", "o_orderkey"]),
    "using_right": (lambda t, c: t["events"].join(t["dims"], on="k", how="right").select("k", "ev", "dv"),
                    ["dm_k", "ev_k"]),
    "using_outer": (lambda t, c: t["events"].join(t["dims"], on="k", how="outer"), ["dm_k", "ev_k"]),
    "composite": (lambda t, c: t["lineitem"].join(
        t["partsupp"], (c("l_partkey") == c("ps_partkey")) & (c("l_suppkey") == c("ps_suppkey")))
        .select("l_partkey", "l_quantity", "ps_supplycost"), ["li_pk_sk", "ps_pk_sk"]),
    "string_key": (lambda t, c: t["lineitem"].join(t["shipmodes"], c("l_shipmode") == c("sm_mode"))
                   .select("l_shipmode", "l_extendedprice", "sm_cost"), ["li_shipmode", "sm_mode"]),
    "date_key": (lambda t, c: t["lineitem"].join(t["orders"], c("l_shipdate") == c("o_orderdate"))
                 .select("l_shipdate", "l_extendedprice", "o_totalprice"), ["li_shipdate", "o_orderdate"]),
    "empty": (lambda t, c: t["lineitem"].filter(c("l_orderkey") < 50)
              .join(t["orders"].filter(c("o_orderkey") >= 50), c("l_orderkey") == c("o_orderkey"))
              .select("l_orderkey", "l_n", "l_comment", "o_totalprice", "o_orderdate"), ["li_orderkey", "o_orderkey"]),
}

MODES = {
    "device": {"hyperspace.tpu.query.deviceMinRows": 0},
    "nomat": {"hyperspace.tpu.query.deviceMinRows": 0, "hyperspace.tpu.join.deviceMaterialize": "false"},
    "host": {},
    "off": {},
}

#: the ``join:`` trace line of a rewritten two-index join on each path
JOIN_LINE = {"device": "join: device-smj x1", "nomat": "join: device-smj x1",
             "host": "join: host-span-smj x1", "off": "join: generic-merge x1"}


def _frames(pkg, sess, lake):
    return {name: sess.read_parquet(path) for name, path in lake.items()}


def _run(pkg, path, query, mode, lake):
    """(optimized plan, collected batch, join:/scan:/spans: trace lines)."""
    kwargs = {} if pkg is hst else {"device": "cpu"}
    sess = pkg.Session(conf=_conf(pkg.keys, path, **MODES[mode]), **kwargs)
    if mode != "off":
        sess.enable_hyperspace()
    df = query(_frames(pkg, sess, lake), pkg.col)
    plan = df.optimized_plan()
    rec = ref_trace if pkg is hst else trace
    with rec.recording() as events:
        got = df.collect()
    lines = [ln for ln in rec.summarize(events).splitlines() if ln.startswith(("join:", "scan:", "spans:"))]
    return plan, got, lines


def _same_objects(g, w) -> bool:
    """Element by element; a NaN equals a NaN (the generic merge
    null-extends each string row with its own NaN object)."""
    return all(x is y or x == y or (x != x and y != y) for x, y in zip(g.tolist(), w.tolist()))


def _assert_same_batch(got, ref):
    assert list(got) == list(ref)
    for name in ref:
        g, r = got[name], ref[name]
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        assert g.shape == r.shape, name
        if r.dtype == object:
            assert _same_objects(g, r), name
        else:
            assert g.tobytes() == r.tobytes(), name


def _index_names(plan, logical):
    return sorted(s.entry.name for s in logical.collect(plan, lambda p: isinstance(p, logical.IndexScan)))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("owner", ["jax", "torch"])
@pytest.mark.parametrize("name", sorted(JOINS))
def test_join_matches_jax(systems, lake, name, owner, mode):
    query, indexes = JOINS[name]
    from hyperspace_tpu.plan import logical as RL

    ref_plan, ref, ref_lines = _run(hst, systems[owner], query, mode, lake)
    plan, got, lines = _run(ht, systems[owner], query, mode, lake)

    assert plan.pretty() == ref_plan.pretty()
    assert _index_names(plan, L) == _index_names(ref_plan, RL) == (indexes if mode != "off" else [])
    _assert_same_batch(got, ref)
    assert lines == ref_lines
    if indexes and mode != "off":
        assert JOIN_LINE[mode] in lines, lines
        assert "scan: index-bucketed x2" in lines, lines
    else:
        assert any(ln.startswith("join: generic-merge") for ln in lines), lines
    if name == "empty":
        assert len(next(iter(got.values()))) == 0
        assert got["l_n"].dtype == np.float64 and got["o_orderdate"].dtype.kind == "M"
    else:
        assert len(next(iter(got.values()))) > 0


def test_paths_agree_and_count_dispatches(systems, lake):
    """The device, no-materialize and host paths of the port give the same
    rows in the same order; the device path runs one span program per join
    and one expand-gather per inner join, and a repeated join finds its
    rectangles resident on the device."""
    query = JOINS["inner_wide"][0]
    D.clear_device_cache()
    D.reset_dispatches()
    _, device, _ = _run(ht, systems["torch"], query, "device", lake)
    assert D.dispatches["bucketed-smj-span"] == 1 and D.dispatches["join-expand-gather"] == 1
    resident = len(D._device_cache)
    assert resident == 2  # the key rectangles and the payload rectangles
    _, nomat, _ = _run(ht, systems["torch"], query, "nomat", lake)
    _, host, _ = _run(ht, systems["torch"], query, "host", lake)
    assert D.dispatches["bucketed-smj-span"] == 2 and D.dispatches["join-expand-gather"] == 1
    _assert_same_batch(nomat, device)
    _assert_same_batch(host, device)
    _run(ht, systems["torch"], query, "device", lake)
    assert len(D._device_cache) == resident and D.dispatches["join-expand-gather"] == 2


def test_self_join_reads_its_side_once(systems, lake):
    """Both sides of a self-join over one DataFrame are one plan object:
    with hyperspace off the executor's memo decodes the source once."""
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"]), device="cpu")
    df = JOINS["self_join_renamed"][0](_frames(ht, sess, lake), ht.col)
    from hyperspace_tpu_torch.exec import io as IO

    IO.clear_io_cache()
    with trace.recording() as events:
        df.collect()
    assert [e for e in events if e[0] == "decode"] == [("decode", "pyarrow")] * 3  # lineitem's 3 files


def test_join_stage_seconds(systems, lake):
    """A join's collect() adds its host time per layer to the session's
    ``query_stage_seconds``; a repeated device join uploads nothing."""
    D.clear_device_cache()
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"], **MODES["device"]), device="cpu")
    sess.enable_hyperspace()
    df = JOINS["inner_wide"][0](_frames(ht, sess, lake), ht.col)
    device = {"rewrite", "join_plan", "join_decode", "join_keys", "join_upload", "join_span", "join_materialize"}
    df.collect()
    assert set(sess.query_stage_seconds) == device
    sess.query_stage_seconds.clear()
    df.collect()
    assert set(sess.query_stage_seconds) == device - {"join_upload"}
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 1 << 25)
    sess.query_stage_seconds.clear()
    df.collect()
    assert set(sess.query_stage_seconds) == {"rewrite", "join_plan", "join_decode", "join_keys", "join_host_expand"}
    sess.disable_hyperspace()
    sess.query_stage_seconds.clear()
    df.collect()
    assert set(sess.query_stage_seconds) == {"rewrite", "decode", "join_merge"}


@pytest.fixture(scope="module")
def two_sides(tmp_path_factory):
    """tests/test_join_rule_matrix.py's two tables."""
    rng = np.random.default_rng(12)
    root = tmp_path_factory.mktemp("join_matrix")
    out = []
    for t in ("t1", "t2"):
        d = root / t
        d.mkdir()
        pq.write_table(pa.table({
            f"{t}c1": rng.integers(0, 40, 600).astype(np.int64),
            f"{t}c2": np.array([f"s{v}" for v in rng.integers(0, 10, 600)]),
            f"{t}c3": rng.integers(0, 20, 600).astype(np.int64),
            f"{t}c4": rng.standard_normal(600),
        }), d / "p.parquet")
        out.append(str(d))
    return out


MATRIX_INDEXES = {
    "l1": ("t1", ["t1c1"], ["t1c4"]),
    "r1": ("t2", ["t2c1"], ["t2c4"]),
    "l2": ("t1", ["t1c1", "t1c3"], ["t1c4"]),
    "r2": ("t2", ["t2c1", "t2c3"], ["t2c4"]),
}

#: test_join_rule_matrix.py's no-rewrite cases: (condition over ``col`` and
#: ``lit``, selected columns or None, indexes present, raises)
NO_REWRITE = {
    "non_equi": (lambda c, lit: c("t1c1") > c("t2c1"), None, ["l1", "r1"], True),
    "or": (lambda c, lit: (c("t1c1") == c("t2c1")) | (c("t1c3") == c("t2c3")), None, ["l1", "r1"], True),
    "literal": (lambda c, lit: c("t1c1") == lit(5), None, ["l1", "r1"], True),
    "one_side_unindexed": (lambda c, lit: c("t1c1") == c("t2c1"), ["t1c4", "t2c4"], ["l1"], False),
    "missing_required_column": (lambda c, lit: c("t1c1") == c("t2c1"), ["t1c4", "t2c3"], ["l1", "r1"], False),
    "subset_key_vs_composite": (lambda c, lit: c("t1c1") == c("t2c1"), ["t1c4", "t2c4"], ["l2", "r2"], False),
}


@pytest.mark.parametrize("case", sorted(NO_REWRITE))
def test_no_rewrite_matches_jax(two_sides, tmp_path, case):
    """Shapes JoinIndexRule leaves alone: no IndexScan in either package's
    plan, the same plan text, and the generic merge's rows (or the same
    error for a condition that is not a conjunction of equalities)."""
    cond, select, names, raises = NO_REWRITE[case]
    results = {}
    for pkg in (hst, ht):
        kwargs = {} if pkg is hst else {"device": "cpu"}
        sess = pkg.Session(conf=_conf(pkg.keys, str(tmp_path / pkg.__name__), **MODES["device"]), **kwargs)
        ldf, rdf = (sess.read_parquet(p) for p in two_sides)
        for n in names:
            side, indexed, included = MATRIX_INDEXES[n]
            pkg.Hyperspace(sess).create_index(ldf if side == "t1" else rdf,
                                              pkg.CoveringIndexConfig(n, indexed, included))
        sess.enable_hyperspace()
        q = ldf.join(rdf, on=cond(pkg.col, pkg.lit))
        if select:
            q = q.select(*select)
        plan = q.optimized_plan()
        assert "IndexScan" not in plan.pretty()
        if raises:
            with pytest.raises(NotImplementedError, match="equi-join"):
                q.collect()
            results[pkg] = (plan.pretty(), None)
        else:
            results[pkg] = (plan.pretty(), q.collect())
    (ref_plan, ref), (got_plan, got) = results[hst], results[ht]
    assert got_plan == ref_plan
    if ref is not None:
        _assert_same_batch(got, ref)


def test_residual_and_streamed_joins_raise(systems, lake):
    """A residual ON predicate is not in the port yet: asking for it
    raises. A join above the streaming threshold, which raised before the
    streamed join was ported, now gives the JAX package's rows and trace."""
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"], **{"hyperspace.exec.stream.joinMinBytes": 1}),
                      device="cpu")
    t = _frames(ht, sess, lake)
    with pytest.raises(NotImplementedError, match="residual"):
        t["lineitem"].join(t["orders"], ht.col("l_orderkey") == ht.col("o_orderkey"),
                           residual=ht.col("l_quantity") > 3)
    out = {}
    for pkg in (hst, ht):
        kwargs = {} if pkg is hst else {"device": "cpu"}
        sess = pkg.Session(conf=_conf(pkg.keys, systems["torch"], **{"hyperspace.exec.stream.joinMinBytes": 1}),
                           **kwargs).enable_hyperspace()
        rec = ref_trace if pkg is hst else trace
        with rec.recording() as events:
            out[pkg] = JOINS["q04_join_li_orders"][0](_frames(pkg, sess, lake), pkg.col).collect()
        out[pkg, "lines"] = [ln for ln in rec.summarize(events).splitlines() if ln.startswith("join:")]
    _assert_same_batch(out[ht], out[hst])
    assert out[ht, "lines"] == out[hst, "lines"] == ["join: host-span-smj-stream x1"]


def _rectangles(rng, nb, wl, wr):
    """Sorted per-bucket key runs padded with SENTINEL into (nb, wl) and
    (nb, wr) rectangles, with a left-only, a right-only and an empty bucket,
    and a payload rectangle of each width."""
    llens = rng.integers(1, wl + 1, nb)
    rlens = rng.integers(1, wr + 1, nb)
    llens[1] = rlens[2] = 0  # right-only bucket 1... and left-only bucket 2
    llens[3] = rlens[3] = 0  # empty bucket 3
    lmat = np.full((nb, wl), J.SENTINEL, dtype=np.int64)
    rmat = np.full((nb, wr), J.SENTINEL, dtype=np.int64)
    for b in range(nb):
        lmat[b, : llens[b]] = np.sort(rng.integers(0, 30, llens[b]))
        rmat[b, : rlens[b]] = np.sort(rng.integers(0, 30, rlens[b]))
    return lmat, rmat, llens.astype(np.int64), rlens.astype(np.int64)


def test_programs_match_jax():
    """The span, pair-totals and expand-gather programs equal the JAX
    package's on random rectangles with SENTINEL padding, a left-only, a
    right-only and an empty bucket: the same spans, totals, pairs and
    gathered values, exactly."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    rng = np.random.default_rng(5)
    nb, wl, wr = 8, 57, 23
    lmat, rmat, llens, rlens = _rectangles(rng, nb, wl, wr)
    mesh = Mesh(np.array(jax.devices()), ("d",))
    ref_lo, ref_hi = (np.asarray(x) for x in RD._bucketed_span_program(mesh, "d")(lmat, rmat))
    lo, hi = J.bucketed_span(torch.from_numpy(lmat), torch.from_numpy(rmat))
    assert np.array_equal(lo.numpy(), ref_lo) and np.array_equal(hi.numpy(), ref_hi)

    t_llens, t_rlens = torch.from_numpy(llens), torch.from_numpy(rlens)
    ref_totals = np.asarray(RD._bucket_pair_totals(jnp.asarray(ref_lo), jnp.asarray(ref_hi),
                                                   jnp.asarray(llens), jnp.asarray(rlens)))
    totals = J.bucket_pair_totals(lo, hi, t_llens, t_rlens).numpy()
    assert np.array_equal(totals, ref_totals) and totals[1] == totals[2] == totals[3] == 0
    total = int(totals.sum())
    assert total > 0

    lpay = (rng.standard_normal((nb, wl)), rng.integers(-(2**62), 2**62, (nb, wl)))
    rpay = (rng.standard_normal((nb, wr)), rng.integers(-(2**62), 2**62, (nb, wr)))
    from hyperspace_tpu.ops.sort import padded_size

    ref_l, ref_r, ref_b, ref_i, ref_j, valid = RD._expand_gather_program(padded_size(total))(
        jnp.asarray(ref_lo), jnp.asarray(ref_hi), jnp.asarray(llens), jnp.asarray(rlens),
        tuple(jnp.asarray(m) for m in lpay), tuple(jnp.asarray(m) for m in rpay), np.int64(total))
    assert int(np.asarray(valid).sum()) == total
    louts, routs, b, i, j = J.expand_gather(lo, hi, t_llens, t_rlens, [torch.from_numpy(m) for m in lpay],
                                            [torch.from_numpy(m) for m in rpay], total)
    for got, ref in ((b, ref_b), (i, ref_i), (j, ref_j), *zip(louts, ref_l), *zip(routs, ref_r)):
        assert np.asarray(ref)[:total].tobytes() == got.numpy().astype(np.asarray(ref).dtype).tobytes()
    # every pair joins equal keys of one bucket, and each bucket emits its total
    assert np.array_equal(lmat[b.numpy(), i.numpy()], rmat[b.numpy(), j.numpy()])
    assert np.array_equal(np.bincount(b.numpy(), minlength=nb), totals)
