"""The port's hybrid scan against the JAX package.

Two small tables made from a seed with numpy — ``l`` (six files: an int
key, floats with NaN, strings and dates with nulls, a nullable int) and
``r`` (three files) — are indexed at 8 buckets by the port: ``l_k`` and
``r_rk`` with lineage, ``l_kf`` (a narrower index on ``l``) without. Each
scenario then changes its own copy of the lake: files appended to both
tables, one ``l`` file deleted, or both. With
``hyperspace.index.hybridscan.enabled`` both packages (``hyperspace_tpu``
on the JAX CPU backend, ``hyperspace_tpu_torch`` with ``device="cpu"``)
open the same lake and system path, and for each query the optimized plan
text (``BucketUnion``, ``Repartition``, the lineage ``NOT IN``), the
dispatch trace and the rows must be the JAX package's, and the rows
hyperspace off's (as a multiset where the off plan joins in another
order). Filters, the bucketed join (inner and outer), the fused join
aggregate, a grouped aggregate and the streamed join are covered; the
re-bucketed appended rows equal the JAX package's ``_side_buckets`` bucket
by bucket; the thresholds reject at the same ratios; a stale bucket-hash
version plans the plain ``Union``; an index quick-refreshed by either
package serves in the other. The ``lineage-antijoin`` program (on the
CPU) is bit-equal to the plain version and to the JAX package's
``lineage_delete_mask`` over its edge cases. Every comparison is exact.
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.exec import device as RD  # noqa: E402
from hyperspace_tpu.exec import lineage as ref_lineage  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import join as J  # noqa: E402
from hyperspace_tpu_torch.exec import lineage  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 8
D0 = np.datetime64("1996-01-01")
SCENARIOS = ("append", "delete", "both")


def _write_l(path, idx, n=500):
    rng = np.random.default_rng([11, idx])
    f = np.round(rng.standard_normal(n) * 3, 2)
    f[rng.random(n) < 0.05] = np.nan
    pq.write_table(pa.table({
        "k": rng.integers(0, 160, n).astype(np.int64),
        "f": f,
        "s": pa.array([f"s{x}" for x in rng.integers(0, 12, n)], mask=rng.random(n) < 0.05),
        "d": pa.array(D0 + rng.integers(0, 700, n).astype("timedelta64[D]"), mask=rng.random(n) < 0.05),
        "n": pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.1),
    }), os.path.join(path, f"part-{idx:05d}.parquet"))


def _write_r(path, idx, n=250):
    rng = np.random.default_rng([12, idx])
    pq.write_table(pa.table({
        "rk": rng.integers(20, 200, n).astype(np.int64),
        "rv": np.round(rng.uniform(0, 100, n), 2),
        "rs": pa.array([f"r{x}" for x in rng.integers(0, 6, n)], mask=rng.random(n) < 0.1),
    }), os.path.join(path, f"part-{idx:05d}.parquet"))


def _conf(pkg, system, **extra):
    return {pkg.keys.SYSTEM_PATH: system, pkg.keys.NUM_BUCKETS: NUM_BUCKETS,
            "hyperspace.tpu.build.batchRows": 1000, "hyperspace.exec.join.broadcastMaxBytes": 0,
            "hyperspace.index.hybridscan.enabled": True, "hyperspace.tpu.query.deviceMinRows": 0, **extra}


def _session(pkg, system, **extra):
    if pkg is hst:
        return hst.Session(conf=_conf(pkg, system, **extra))
    return ht.Session(conf=_conf(pkg, system, **extra), device="cpu")


def _build(root):
    """The original lake under ``root`` and its three port-built indexes."""
    lroot, rroot, system = os.path.join(root, "l"), os.path.join(root, "r"), os.path.join(root, "sys")
    os.makedirs(lroot)
    os.makedirs(rroot)
    for i in range(6):
        _write_l(lroot, i)
    for i in range(3):
        _write_r(rroot, i)
    sess = _session(ht, system, **{"hyperspace.index.lineage.enabled": True})
    hs = ht.Hyperspace(sess)
    hs.create_index(sess.read_parquet(lroot), ht.CoveringIndexConfig("l_k", ["k"], ["f", "s", "d", "n"]))
    hs.create_index(sess.read_parquet(rroot), ht.CoveringIndexConfig("r_rk", ["rk"], ["rv", "rs"]))
    plain = _session(ht, system)
    ht.Hyperspace(plain).create_index(plain.read_parquet(lroot), ht.CoveringIndexConfig("l_kf", ["k"], ["f"]))
    return lroot, rroot, system


def _change(lroot, rroot, scenario):
    if scenario in ("append", "both"):
        _write_l(lroot, 6, n=400)
        _write_r(rroot, 3, n=100)
    if scenario in ("delete", "both"):
        os.remove(os.path.join(lroot, "part-00002.parquet"))


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    """{scenario: (l dir, r dir, system path)}: each scenario's own lake,
    indexed before its change."""
    out = {}
    for scenario in SCENARIOS:
        root = str(tmp_path_factory.mktemp(f"hybrid_{scenario}"))
        lroot, rroot, system = _build(root)
        _change(lroot, rroot, scenario)
        out[scenario] = (lroot, rroot, system)
    return out


QUERIES = {
    "filter": lambda l, r, c: l.filter((c("k") >= 40) & (c("k") < 90)).select("k", "f", "s", "d"),
    "filter_kf": lambda l, r, c: l.filter(c("k") == 17).select("k", "f"),
    "join": lambda l, r, c: l.join(r, c("k") == c("rk")).select("k", "f", "n", "rv", "rs"),
    "join_outer": lambda l, r, c: l.join(r, c("k") == c("rk"), how="outer").select("k", "s", "rk", "rv"),
    "join_filtered": lambda l, r, c: l.filter(c("f") > 0).join(r.filter(c("rv") < 60), c("k") == c("rk"))
    .select("k", "f", "rv"),
    "join_agg": lambda l, r, c: l.join(r, c("k") == c("rk")).agg(n=("*", "count"), s=("rv", "sum"),
                                                                  m=("f", "max")),
    "group_agg": lambda l, r, c: l.filter(c("k") < 100).group_by("s").agg(n=("*", "count"), m=("f", "max")),
}


def _same_objects(g, r):
    if len(g) != len(r):
        return False
    for a, b in zip(g.tolist(), r.tolist()):
        if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
            continue
        if a != b or type(a) is not type(b):
            return False
    return True


def _assert_same_batch(got, ref, tolerant=()):
    assert list(got) == list(ref)
    for name in ref:
        g, r = got[name], ref[name]
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        if r.dtype == object:
            assert _same_objects(g, r), name
        elif name in tolerant:
            np.testing.assert_allclose(g, r, rtol=1e-9, equal_nan=True, err_msg=name)
        else:
            assert g.tobytes() == r.tobytes(), name


def _multiset(batch):
    return sorted(zip(*(np.asarray(v).astype(str).tolist() for v in batch.values())))


def _lines(pkg, events, prefixes=("agg:", "filter:", "join:", "scan:", "rebucket:")):
    rec = ref_trace if pkg is hst else trace
    return [ln for ln in rec.summarize(events).splitlines() if ln.startswith(prefixes)]


def _run(pkg, lake, query, enabled=True, **conf):
    """(plan text, rows, trace lines) of ``query`` in one package."""
    lroot, rroot, system = lake
    sess = _session(pkg, system, **conf)
    if enabled:
        sess.enable_hyperspace()
    (RD if pkg is hst else D).clear_device_cache()
    (RD if pkg is hst else J).__dict__["_REBUCKET_CACHE"].clear()
    q = QUERIES[query](sess.read_parquet(lroot), sess.read_parquet(rroot), pkg.col)
    rec = ref_trace if pkg is hst else trace
    with rec.recording() as events:
        rows = q.collect()
    return q.optimized_plan().pretty(), rows, _lines(pkg, events)


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plans_and_rows_match_jax(lakes, scenario, query):
    """The plan text, the trace and the rows are the JAX package's, and the
    rows hyperspace off's."""
    ref_plan, ref_rows, ref_lines = _run(hst, lakes[scenario], query)
    plan, rows, lines = _run(ht, lakes[scenario], query)
    assert plan == ref_plan
    assert "BucketUnion" in plan or "NOT" in plan, plan
    _assert_same_batch(rows, ref_rows, tolerant=("s",) if query == "join_agg" else ())
    assert lines == ref_lines
    _, off, _ = _run(ht, lakes[scenario], query, enabled=False)
    if query == "join_agg":
        _assert_same_batch(rows, off, tolerant=("s",))
    else:
        assert _multiset(rows) == _multiset(off)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_hybrid_plan_shapes(lakes, scenario):
    """Appends plan a BucketUnion of the index side and a Repartition of the
    appended files; deletes a NOT IN over the lineage column; the narrower
    index without lineage serves only where no file was deleted."""
    plan = _run(ht, lakes[scenario], "join")[0]
    assert ("BucketUnion(n=8)" in plan) == (scenario != "delete")
    assert ("Repartition(n=8, cols=['k'])" in plan) == (scenario != "delete")
    assert ("_data_file_id" in plan) == (scenario != "append")
    kf = _run(ht, lakes[scenario], "filter_kf")[0]
    assert ("Name: l_kf" in kf) == (scenario == "append")
    assert ("Name: l_k," in kf) == (scenario != "append")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_streamed_join_matches_jax(lakes, scenario):
    """Above ``joinMinBytes`` the hybrid join streams bucket by bucket."""
    for query in ("join", "join_outer"):
        ref_plan, ref_rows, ref_lines = _run(hst, lakes[scenario], query, **{"hyperspace.exec.stream.joinMinBytes": 1})
        plan, rows, lines = _run(ht, lakes[scenario], query, **{"hyperspace.exec.stream.joinMinBytes": 1})
        assert "join: host-span-smj-stream x1" in lines
        # the JAX package's concurrent bucket reads may each re-bucket the
        # appended side, so its count of those lines varies from run to run
        assert [ln for ln in lines if not ln.startswith("rebucket:")] == [
            ln for ln in ref_lines if not ln.startswith("rebucket:")]
        if scenario != "delete":
            assert lines[-1] == "rebucket: computed x2"
        _assert_same_batch(rows, ref_rows)


@pytest.mark.parametrize("scenario", ("append", "both"))
def test_rebucketed_appends_match_jax(lakes, scenario):
    """Each side's buckets, the appended rows re-bucketed by the build's
    hash, equal the JAX package's ``_side_buckets`` bucket by bucket; the
    second read is the cached one."""
    lroot, rroot, system = lakes[scenario]
    out = {}
    for pkg in (hst, ht):
        sess = _session(pkg, system)
        sess.enable_hyperspace()
        (RD if pkg is hst else J).__dict__["_REBUCKET_CACHE"].clear()
        q = QUERIES["join"](sess.read_parquet(lroot), sess.read_parquet(rroot), pkg.col)
        (join,) = (RL if pkg is hst else L).collect(q.optimized_plan(), lambda p: type(p).__name__ == "Join")
        fn = RD._side_buckets if pkg is hst else J._side_buckets
        rec = ref_trace if pkg is hst else trace
        with rec.recording() as events:
            left = fn(sess, join.left, ["k", "f", "n"], ["k"])
            again = fn(sess, join.left, ["k", "f", "n"], ["k"])
        out[pkg] = (left, again, _lines(pkg, events, ("rebucket:",)))
    (ref, ref_again, ref_lines), (got, got_again, lines) = out[hst], out[ht]
    assert sorted(got) == sorted(ref)
    for b in ref:
        _assert_same_batch(got[b], ref[b])
        _assert_same_batch(got_again[b], got[b])
    assert lines == ref_lines == ["rebucket: cached x1", "rebucket: computed x1"]


@pytest.mark.parametrize("scenario", ("delete", "both"))
def test_device_lineage_matches_jax(lakes, scenario):
    """At ``deviceLineage.minRows`` 0 the index side's NOT IN runs as the
    lineage-antijoin program in both packages; at the default 4096 these
    small indexes fall back to the host alike."""
    for min_rows in (0, 4096):
        conf = {"hyperspace.lifecycle.deviceLineage.minRows": min_rows}
        ref_plan, ref_rows, ref_lines = _run(hst, lakes[scenario], "filter", **conf)
        before = D.dispatches["lineage-antijoin"]
        plan, rows, lines = _run(ht, lakes[scenario], "filter", **conf)
        assert lines == ref_lines
        assert ("filter: device-lineage x1" in lines) == (min_rows == 0)
        assert D.dispatches["lineage-antijoin"] - before == (1 if min_rows == 0 else 0)
        _assert_same_batch(rows, ref_rows)


@pytest.mark.parametrize(
    "scenario,key,value",
    [("append", "hyperspace.index.hybridscan.maxAppendedRatio", 0.05),
     ("delete", "hyperspace.index.hybridscan.maxDeletedRatio", 0.05),
     ("both", "hyperspace.index.hybridscan.maxAppendedRatio", 0.05),
     ("both", "hyperspace.index.hybridscan.maxDeletedRatio", 0.05),
     ("append", "hyperspace.index.hybridscan.enabled", False)],
)
def test_thresholds_reject_like_jax(lakes, scenario, key, value):
    """Past a threshold (or with hybrid scan off) the changed source's
    index is no candidate: both packages plan the same source scan."""
    for query in ("filter", "join"):
        ref_plan, ref_rows, _ = _run(hst, lakes[scenario], query, **{key: value})
        plan, rows, _ = _run(ht, lakes[scenario], query, **{key: value})
        assert plan == ref_plan
        assert "l_k," not in plan
        assert _multiset(rows) == _multiset(ref_rows)


def test_stale_hash_version_plans_a_plain_union(tmp_path):
    """An index whose log claims an older bucket-hash version serves its
    rows through a plain Union with the appended files, in both packages."""
    lroot, rroot, system = _build(str(tmp_path))
    _change(lroot, rroot, "append")
    for p in glob.glob(os.path.join(system, "l_k", "_hyperspace_log", "*")):
        if os.path.isfile(p):
            with open(p) as f:
                text = f.read()
            with open(p, "w") as f:
                f.write(text.replace('"bucketHashVersion": "2"', '"bucketHashVersion": "1"'))
    lake = (lroot, rroot, system)
    ref_plan, ref_rows, _ = _run(hst, lake, "filter")
    plan, rows, _ = _run(ht, lake, "filter")
    assert plan == ref_plan
    assert "  Union" in plan and "BucketUnion" not in plan, plan
    _assert_same_batch(rows, ref_rows)


@pytest.mark.parametrize("refresher", ["jax", "torch"])
def test_quick_refreshed_index_serves_in_both(tmp_path, refresher):
    """After a quick refresh by either package (appended and deleted files
    recorded, the old signature kept), both packages serve the index
    through hybrid scan with the same plan and rows."""
    lroot, rroot, system = _build(str(tmp_path))
    _change(lroot, rroot, "both")
    pkg = hst if refresher == "jax" else ht
    sess = _session(pkg, system)
    pkg.Hyperspace(sess).refresh_index("l_k", "quick")
    lake = (lroot, rroot, system)
    for query in ("filter", "join"):
        ref_plan, ref_rows, ref_lines = _run(hst, lake, query)
        plan, rows, lines = _run(ht, lake, query)
        assert plan == ref_plan and "LogVersion: 3" in plan, plan
        assert lines == ref_lines
        _assert_same_batch(rows, ref_rows)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_data_skipping_under_hybrid_scan(tmp_path, scenario):
    """A data-skipping index over a changed source prunes the files its
    sketches know and keeps the appended files it does not, in both
    packages alike; a deleted file is simply absent."""
    lroot, rroot, system = _build(str(tmp_path))
    sess = _session(ht, system)
    ht.Hyperspace(sess).create_index(sess.read_parquet(lroot),
                                     ht.DataSkippingIndexConfig("l_ds", ht.MinMaxSketch("n")))
    _change(lroot, rroot, scenario)
    out = {}
    for pkg in (hst, ht):
        s = _session(pkg, system)
        s.enable_hyperspace()
        q = s.read_parquet(lroot).filter(pkg.col("n") > 2**40 - 2**34)
        out[pkg] = (q.optimized_plan().pretty(), q.collect())
        s.disable_hyperspace()
        off = q.collect()
    assert out[ht][0] == out[hst][0]
    assert "Hyperspace(Type: DS, Name: l_ds)" in out[ht][0], out[ht][0]
    _assert_same_batch(out[ht][1], out[hst][1])
    assert _multiset(out[ht][1]) == _multiset(off)


# --------------------------------------------------------------------------
# the lineage-antijoin program
# --------------------------------------------------------------------------

ANTIJOIN_CASES = {
    "duplicates": (np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int64), [1, 1, 9, 9, 9]),
    "no_ids": (np.arange(10, dtype=np.int64), []),
    "every_id": (np.array([0, 1, 2, 2, 1, 0], dtype=np.int64), [0, 1, 2]),
    "beyond_range": (np.arange(5, dtype=np.int64), [-(2**40), 7, 2**62, 100]),
    "int32": (np.array([5, 6, 7, 8, 9], dtype=np.int32), [6, 8]),
    "bucket_64": (np.arange(200, dtype=np.int64), list(range(0, 128, 2))),
    "bucket_65": (np.arange(200, dtype=np.int64), list(range(0, 130, 2))),
    "negative": (np.array([-3, -2, -1, 0, 1], dtype=np.int64), [-2, 1]),
    "empty_column": (np.zeros(0, dtype=np.int64), [1, 2]),
}


@pytest.mark.parametrize("case", sorted(ANTIJOIN_CASES))
def test_antijoin_matches_plain_and_jax(tmp_path, case):
    """The program on the CPU, the plain version and the JAX package's
    ``lineage_delete_mask`` give the same keep-mask, bit for bit; the id
    table pads to its geometric bucket with the int64-max sentinel."""
    col, ids = ANTIJOIN_CASES[case]
    plain = lineage.lineage_keep_mask_plain(col, ids)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path)}, device="cpu")
    got = lineage.lineage_delete_mask(sess, {"_data_file_id": col}, "_data_file_id", ids)
    ref_sess = hst.Session(conf={hst.keys.SYSTEM_PATH: str(tmp_path)})
    ref = ref_lineage.lineage_delete_mask(ref_sess, {"_data_file_id": col}, "_data_file_id", ids)
    assert got.dtype == ref.dtype == plain.dtype == np.bool_
    assert got.tobytes() == ref.tobytes() == plain.tobytes()
    table, live = lineage.padded_id_table(ids)
    assert live == len(set(ids))
    assert len(table) == (lineage.id_table_rows(max(live, 1)))
    assert (table[live:] == lineage.ID_SENTINEL).all()
    if live:
        dev = lineage.antijoin_program(torch.from_numpy(col.astype(np.int64)), torch.from_numpy(table), live)
        assert dev.numpy().tobytes() == plain.tobytes()


def test_antijoin_table_buckets():
    """The id table's bucket: 64 ids fit the floor, 65 take the next
    sqrt(2) step, as in the JAX package."""
    assert lineage.id_table_rows(1) == lineage.id_table_rows(64) == 64
    assert lineage.id_table_rows(65) == RD.bucket_rows(65, floor=64) == 91


@pytest.mark.parametrize("batch", [{"other": np.arange(4)}, {"_data_file_id": np.array([1.0, 2.0])},
                                   {"_data_file_id": np.array(["a", "b"], dtype=object)}],
                         ids=["missing", "float", "string"])
def test_antijoin_refuses_like_jax(tmp_path, batch):
    """A missing or non-integral lineage column raises DeviceUnsupported in
    both packages (the executor then filters on the host)."""
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path)}, device="cpu")
    with pytest.raises(D.DeviceUnsupported):
        lineage.lineage_delete_mask(sess, batch, "_data_file_id", [1])
    with pytest.raises(RD.DeviceUnsupported):
        ref_lineage.lineage_delete_mask(hst.Session(conf={hst.keys.SYSTEM_PATH: str(tmp_path)}), batch,
                                        "_data_file_id", [1])
