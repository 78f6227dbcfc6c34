"""The port's data-skipping rule against the JAX package.

One lake of four files with disjoint ranges (an int key, a float column
with NaN, a date column, strings with nulls), made from a seed with numpy,
is indexed by both packages with MinMax, ValueList and BloomFilter sketches
(``hyperspace_tpu`` on the JAX CPU backend, ``hyperspace_tpu_torch`` with
``device="cpu"``). For every predicate shape (``=``, ranges with the literal
on either side, ``AND``, ``OR``, ``IN``, ``NOT``, ``!=``) the surviving
files of ``prune_files``, the optimized plan and the collected rows must be
the JAX package's, and the rows hyperspace off's; each package also serves
the other's data-skipping indexes. The sketch evaluator's matrix
(``tests/test_sketch_evaluator.py``) runs through both evaluators. The
partition-sketch and hybrid-scan cases wait for their slices. Every
comparison is exact.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
from hyperspace_tpu.rules import dataskipping_rule as ref_rule  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402
from hyperspace_tpu_torch.rules import dataskipping_rule as rule  # noqa: E402
from hyperspace_tpu_torch.rules import score  # noqa: E402

pytestmark = pytest.mark.torch_port

D0 = np.datetime64("1997-01-01")


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """Four files: ``k`` in [100 i, 100 i + 100), ``v`` in [10 i, 10 i + 10)
    with NaN, ``d`` in the i-th 90 days from 1997-01-01, ``tag`` from the
    file's own five values, ``s`` (nulls) from a pool of 40 that file 2
    does not draw from."""
    root = tmp_path_factory.mktemp("ds_lake")
    rng = np.random.default_rng(5)
    for i in range(4):
        n = 300 + 50 * i
        v = i * 10 + rng.uniform(0, 10, n)
        v[rng.random(n) < 0.05] = np.nan
        table = pa.table({
            "k": (i * 100 + rng.integers(0, 100, n)).astype(np.int64),
            "v": v,
            "d": D0 + (i * 90 + rng.integers(0, 90, n)).astype("timedelta64[D]"),
            # no nulls in the value-list column: the JAX package's ValueList
            # build sorts the values and cannot order None against a string
            "tag": np.array([f"t{i}_{x}" for x in rng.integers(0, 5, n)]),
            "s": pa.array([f"s{x}" for x in (rng.integers(0, 40, n) if i != 2 else rng.integers(40, 50, n))],
                          mask=rng.random(n) < 0.05),
            "p": rng.integers(-(10**6), 10**6, n),
        })
        pq.write_table(table, root / f"part-{i:05d}.parquet")
    return str(root)


SKETCHES = {
    # no MinMax on the date column: the JAX package's build cannot write a
    # date bound (datetime.date into an int64 column), and neither can the port
    "mm": [("MinMax", "k"), ("MinMax", "v")],
    "vl": [("ValueList", "tag")],
    "bf": [("BloomFilter", "s"), ("BloomFilter", "p")],
}


def _ds_config(pkg, name):
    kinds = {"MinMax": pkg.MinMaxSketch, "ValueList": pkg.ValueListSketch, "BloomFilter": pkg.BloomFilterSketch}
    return pkg.DataSkippingIndexConfig(name, *[kinds[k](c) for k, c in SKETCHES[name]])


def _session(pkg, path, **extra):
    conf = {pkg.keys.SYSTEM_PATH: path, pkg.keys.NUM_BUCKETS: 8, **extra}
    return pkg.Session(conf=conf) if pkg is hst else pkg.Session(conf=conf, device="cpu")


@pytest.fixture(scope="module")
def systems(lake, tmp_path_factory):
    """{owner: system path} holding that package's three data-skipping indexes."""
    out = {}
    for owner, pkg in (("jax", hst), ("torch", ht)):
        path = str(tmp_path_factory.mktemp(f"ds_{owner}"))
        sess = _session(pkg, path)
        df = sess.read_parquet(lake)
        for name in SKETCHES:
            pkg.Hyperspace(sess).create_index(df, _ds_config(pkg, name))
        out[owner] = path
    return out


# name -> (predicate over a col/lit pair, projected columns, the index expected to prune or None)
PREDICATES = {
    "eq": (lambda c, lit: c("k") == 150, ["v", "tag"], "mm"),
    "eq_lit_left": (lambda c, lit: lit(250) == c("k"), ["k"], "mm"),
    "lt": (lambda c, lit: c("k") < 150, ["k", "p"], "mm"),
    "ge_lit_left": (lambda c, lit: lit(250) <= c("k"), ["k", "s"], "mm"),
    "range_and": (lambda c, lit: (c("k") >= 120) & (c("k") < 180), ["k", "v"], "mm"),
    "or": (lambda c, lit: (c("k") < 50) | (c("k") > 350), ["k"], "mm"),
    "in": (lambda c, lit: c("k").isin(5, 305), ["k", "d"], "mm"),
    "not_lt": (lambda c, lit: ~(c("k") < 200), ["k"], "mm"),
    "ne": (lambda c, lit: c("k") != 5, ["k"], None),
    "float_range": (lambda c, lit: c("v") < 9.5, ["v", "k"], "mm"),
    "float_gt": (lambda c, lit: c("v") > 31.0, ["v"], "mm"),
    "date_ge": (lambda c, lit: c("d") >= np.datetime64("1997-07-01"), ["d", "k"], None),
    "date_eq": (lambda c, lit: c("d") == np.datetime64("1997-02-01"), ["d"], None),
    "vl_eq": (lambda c, lit: c("tag") == "t1_2", ["tag", "k"], "vl"),
    "vl_in": (lambda c, lit: c("tag").isin("t0_1", "t3_4"), ["tag"], "vl"),
    "vl_absent": (lambda c, lit: c("tag") == "t9_9", ["tag"], "vl"),
    "bf_eq": (lambda c, lit: c("s") == "s45", ["s", "k"], "bf"),
    "bf_or": (lambda c, lit: (c("s") == "s41") | (c("s") == "s47"), ["s"], "bf"),
    "bf_in": (lambda c, lit: c("s").isin("s42", "s44"), ["s", "p"], "bf"),
    "mixed_and": (lambda c, lit: (c("k") < 100) & (c("tag") == "t0_1"), ["k", "tag"], "mm"),
    "unprunable_or": (lambda c, lit: (c("k") < 50) | (c("tag") == "t3_1"), ["k"], None),
    "no_filter_column": (lambda c, lit: c("p") > 0, ["p"], None),
}


def _query(pkg, sess, lake, name):
    pred, cols, _ = PREDICATES[name]
    return sess.read_parquet(lake).filter(pred(pkg.col, pkg.lit)).select(*cols)


def _sorted(batch):
    order = np.lexsort([np.asarray(v).astype("U64") if v.dtype == object else v for v in reversed(list(batch.values()))])
    return {k: v[order] for k, v in batch.items()}


def _assert_same(got, want, what):
    got, want = _sorted(got), _sorted(want)
    assert list(got) == list(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


def _file_scans(plan, mod):
    return [p for p in mod.collect(plan, lambda p: True) if isinstance(p, mod.FileScan)]


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_prune_files_matches_jax(systems, lake, name):
    """Each index's surviving files, surviving bytes and total bytes are the
    JAX package's, or both packages say the predicate is unprunable."""
    pred = PREDICATES[name][0]
    jsess, tsess = _session(hst, systems["jax"]), _session(ht, systems["torch"])
    current = tsess.read_parquet(lake).plan.relation.all_file_infos()
    ref_current = jsess.read_parquet(lake).plan.relation.all_file_infos()
    for idx in SKETCHES:
        ref = ref_rule.prune_files(jsess.index_manager.get_index(idx), pred(hst.col, hst.lit), ref_current)
        got = rule.prune_files(tsess.index_manager.get_index(idx), pred(ht.col, ht.lit), current)
        assert got == ref, f"{idx}: {got} != {ref}"


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_plans_and_rows_match_jax(systems, lake, name):
    """The optimized plan is the JAX package's (a Filter over a FileScan via
    the pruning index, or the source scan when nothing prunes); the rows are
    the JAX package's and hyperspace off's."""
    expected_index = PREDICATES[name][2]
    results = {}
    for owner, pkg in (("jax", hst), ("torch", ht)):
        sess = _session(pkg, systems[owner])
        q = _query(pkg, sess, lake, name)
        sess.enable_hyperspace()
        plan = q.optimized_plan()
        results[owner] = (plan.pretty().replace(systems[owner], "<sys>"), q.collect())
        sess.disable_hyperspace()
        _assert_same(results[owner][1], q.collect(), f"{owner}: hyperspace on vs off")
        scans = _file_scans(plan, RL if pkg is hst else L)
        if expected_index is None:
            assert not scans, plan.pretty()
        else:
            assert [s.via_index for s in scans] == [expected_index], plan.pretty()
            assert len(scans[0].files) < 4
    assert results["torch"][0] == results["jax"][0]
    _assert_same(results["torch"][1], results["jax"][1], "port vs JAX")
    # the port's device filter over the pruned files gives the same rows
    sess = _session(ht, systems["torch"], **{ht.keys.DEVICE_MIN_ROWS: 0})
    sess.enable_hyperspace()
    _assert_same(_query(ht, sess, lake, name).collect(), results["jax"][1], "port device filter vs JAX")


@pytest.mark.parametrize("name", ["eq", "range_and", "vl_in", "bf_eq", "float_gt"])
@pytest.mark.parametrize("server", ["jax", "torch"])
def test_each_package_serves_the_others_sketches(systems, lake, name, server):
    """A package prunes with the sketches the other package built, to the
    same files and rows as with its own."""
    owner = "torch" if server == "jax" else "jax"
    pkg = hst if server == "jax" else ht
    plans, rows = [], []
    for path in (systems[owner], systems[server]):
        sess = _session(pkg, path)
        sess.enable_hyperspace()
        q = _query(pkg, sess, lake, name)
        plans.append(sorted(f for s in _file_scans(q.optimized_plan(), RL if pkg is hst else L) for f in s.files))
        rows.append(q.collect())
    assert plans[0] == plans[1] and plans[0]
    _assert_same(rows[0], rows[1], f"{server} over {owner}'s indexes")


@pytest.mark.parametrize("covering_included,expect_covering", [(["v", "tag"], True), (["v"], False)])
def test_covering_vs_skipping_ranking_matches_jax(lake, tmp_path, covering_included, expect_covering):
    """A covering index on ``k`` outranks the data-skipping index when it
    covers the query; when it cannot, the data-skipping rewrite applies. Both
    packages choose alike."""
    plans = {}
    for owner, pkg in (("jax", hst), ("torch", ht)):
        path = str(tmp_path / owner)
        sess = _session(pkg, path)
        df = sess.read_parquet(lake)
        hs = pkg.Hyperspace(sess)
        hs.create_index(df, _ds_config(pkg, "mm"))
        hs.create_index(df, pkg.CoveringIndexConfig("ci", ["k"], covering_included))
        sess.enable_hyperspace()
        q = sess.read_parquet(lake).filter(pkg.col("k") == 150).select("v", "tag")
        plan = q.optimized_plan()
        mod = RL if pkg is hst else L
        index_scans = [p for p in mod.collect(plan, lambda p: True) if isinstance(p, mod.IndexScan)]
        assert bool(index_scans) == expect_covering, plan.pretty()
        assert bool(_file_scans(plan, mod)) != expect_covering, plan.pretty()
        plans[owner] = plan.pretty().replace(path, "<sys>")
        on = q.collect()
        sess.disable_hyperspace()
        _assert_same(on, q.collect(), f"{owner}: hyperspace on vs off")
    assert plans["torch"] == plans["jax"]


def test_rule_ranks_below_filter_rule():
    """The data-skipping rule is tried third, after the join and filter
    rules, with the JAX package's maximum score."""
    from hyperspace_tpu.rules import score as ref_score

    assert [r.__name__ for r, _ in score.RULES] == [r.__name__ for r, _ in ref_score.RULES]
    assert [m for _, m in score.RULES] == [m for _, m in ref_score.RULES]
    assert rule.MAX_SCORE == ref_rule.MAX_SCORE == 41
    from hyperspace_tpu_torch.rules import filter_rule

    assert rule.MAX_SCORE < filter_rule.MAX_SCORE


def test_corrupt_sketch_data_keeps_the_source_plan(lake, tmp_path):
    """Missing sketch data means the index cannot prune; the query runs
    over the source and answers as with hyperspace off."""
    import os

    sess = _session(ht, str(tmp_path / "sys"))
    hs = ht.Hyperspace(sess)
    entry = hs.create_index(sess.read_parquet(lake), _ds_config(ht, "mm"))
    for f in entry.content.files:
        os.remove(f)
    sess.enable_hyperspace()
    q = sess.read_parquet(lake).filter(ht.col("k") == 150).select("k")
    assert not _file_scans(q.optimized_plan(), L)
    on = q.collect()
    sess.disable_hyperspace()
    _assert_same(on, q.collect(), "on vs off")


# --- the sketch evaluator (tests/test_sketch_evaluator.py's matrix) -----------


def _minmax_cols(pkg, mins, maxs):
    s = pkg.MinMaxSketch("k")
    mn, mx = s.output_names()
    return [s], {mn: np.array(mins), mx: np.array(maxs)}


def _value_list_cols(pkg, lists, mins=None, maxs=None):
    sketches, cols = [], {}
    if mins is not None:
        sketches, cols = _minmax_cols(pkg, mins, maxs)
    v = pkg.ValueListSketch("k")
    (vname,) = v.output_names()
    cols[vname] = np.array([None if x is None else np.array(x) for x in lists] + [None], dtype=object)[:-1]
    return sketches + [v], cols


RANGES = ([0, 20, 40], [10, 30, 50])
EVALUATOR_CASES = {
    "eq": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k") == 25),
    "eq_lit_left": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: lit(25) == c("k")),
    "lt": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k") < 15),
    "gt_lit_left": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: lit(15) > c("k")),
    "ge_boundary": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k") >= 30),
    "gt_boundary": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k") > 30),
    "ne_constant_file": (lambda p: _minmax_cols(p, [0, 25, 40], [10, 25, 50]), lambda c, lit: c("k") != 25),
    "not_lt": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: ~(c("k") < 15)),
    "not_eq": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: ~(c("k") == 25)),
    "col_vs_col": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k") == c("k")),
    "unknown_column": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("z") == 1),
    "arithmetic": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: (c("k") + 1) == 25),
    "and": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: (c("k") >= 15) & (c("k") <= 35)),
    "and_unprunable_side": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: (c("k") >= 15) & (c("z") == 1)),
    "or": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: (c("k") < 5) | (c("k") > 45)),
    "or_unprunable_side": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: (c("k") < 5) | (c("z") == 1)),
    "in": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k").isin(5, 45)),
    "between": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: (c("k") >= 22) & (c("k") <= 28)),
    "null_aggregate_eq": (lambda p: _minmax_cols(p, [0.0, np.nan, 40.0], [10.0, np.nan, 50.0]),
                          lambda c, lit: c("k") == 5),
    "null_aggregate_gt": (lambda p: _minmax_cols(p, [0.0, np.nan, 40.0], [10.0, np.nan, 50.0]),
                          lambda c, lit: c("k") > 100),
    "two_sketches_refute": (lambda p: _value_list_cols(p, [[2, 4], [25]], [0, 20], [10, 30]),
                            lambda c, lit: c("k") == 5),
    "two_sketches_keep": (lambda p: _value_list_cols(p, [[2, 4], [25]], [0, 20], [10, 30]),
                          lambda c, lit: c("k") == 2),
    "overflowed_list_kept": (lambda p: _value_list_cols(p, [None, [7]]), lambda c, lit: c("k") == 7),
    "overflowed_list_pruned": (lambda p: _value_list_cols(p, [None, [7]]), lambda c, lit: c("k") == 8),
    "incomparable_literal": (lambda p: _minmax_cols(p, *RANGES), lambda c, lit: c("k") == "not-a-number"),
}


@pytest.mark.parametrize("case", sorted(EVALUATOR_CASES))
def test_sketch_evaluator_matches_jax(case):
    make, pred = EVALUATOR_CASES[case]
    ref_sketches, ref_cols = make(hst)
    sketches, cols = make(ht)
    n = len(next(iter(cols.values())))
    want = ref_rule._SketchEvaluator(ref_sketches, ref_cols, n).eval(pred(hst.col, hst.lit))
    got = rule._SketchEvaluator(sketches, cols, n).eval(pred(ht.col, ht.lit))
    if want is None:
        assert got is None
    else:
        assert got is not None and got.tolist() == want.tolist()


@pytest.mark.parametrize("value,expected", [("s45", True), ("s1", False), (7, False)])
def test_bloom_might_contain_matches_jax(value, expected):
    """A bloom sketch built over strings answers membership like the JAX
    package's, and a literal of another type never raises past the
    evaluator."""
    values = np.array([f"s{x}" for x in range(40, 50)], dtype=object)
    ref, got = hst.BloomFilterSketch("s"), ht.BloomFilterSketch("s")
    (ref_words,), (words,) = ref.aggregate(values), got.aggregate(values)
    assert words == ref_words
    assert got.might_contain(words, value) == ref.might_contain(ref_words, value) == expected
