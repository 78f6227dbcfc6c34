"""The port's aggregates (slice 5) against the JAX package, end to end.

One seeded lake is indexed by the port (``device="cpu"``); every aggregate
then runs in both packages over that index (the JAX package on its CPU
backend), on each path of the aggregate:

- ``device``: ``deviceMinRows=0``: the ``fused-agg`` program for a global
  aggregate, the ``grouped-agg-chunk`` program for a grouped one, over a
  (filtered) index scan; the fused aggregate over a bucketed join;
- ``default``: the default ``deviceMinRows``, where the scan's aggregate
  falls back to the host (``min-rows``);
- ``off``: hyperspace off, the host pandas aggregate over the source.

What must equal the JAX package's: the optimized plan's text, the dispatch
trace's ``agg:``, ``filter:``, ``join:``, ``scan:`` and ``spans:`` lines,
the fallback reasons, the device programs run, and the results' column
names, dtypes, row order and values — exact, except float sums, avg and
stddev at rtol 1e-9 (the two programs add floats in different orders).

Both packages' sessions set ``hyperspace.exec.join.broadcastMaxBytes`` to 0
and the JAX package's native span walk and pair expansion are off, as in
tests/test_torch_join.py: a join the fused aggregate cannot take then runs
the bucketed join in both, in the same row order.
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
from hyperspace_tpu.obs.metrics import REGISTRY  # noqa: E402
from hyperspace_tpu_torch.exec import aggregate as A  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 4
FLOAT_RTOL = 1e-9
BASE = np.datetime64("1996-01-01")
PROGRAMS = ("fused-agg", "grouped-agg-chunk")


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """{table: directory}. ``t`` (3 files): an int key ``ik``, a float key
    ``fk`` with NaN, -0.0 and +0.0, a string key ``sk`` with nulls, a date
    key ``dk``, int, float (with NaN) and bool inputs, ``big`` int64 values
    above 2^53 of both signs, and ``gnan``, NaN in every row of group
    ``ik == 3``. ``l`` and ``o`` join on ``l_ok = o_ok``: ``o_ok`` is unique
    and some keys of each side are absent from the other."""
    root = tmp_path_factory.mktemp("agg_lake")
    rng = np.random.default_rng(57)
    out = {}
    d = root / "t"
    d.mkdir()
    for i, n in enumerate((700, 900, 400)):
        ik = rng.integers(0, 7, n)
        v = np.round(rng.standard_normal(n) * 10, 3)
        v[rng.random(n) < 0.1] = np.nan
        gnan = np.round(rng.uniform(-5, 5, n), 2)
        gnan[ik == 3] = np.nan
        big = (2**53 + rng.integers(0, 1000, n)) * rng.choice([-1, 1], n)
        pq.write_table(pa.table({
            "ik": ik,
            "fk": rng.choice(np.array([1.5, -0.0, 0.0, np.nan, 2.5]), n),
            "sk": pa.array([f"s{x}" for x in rng.integers(0, 5, n)], mask=rng.random(n) < 0.1),
            "dk": BASE + rng.integers(0, 6, n).astype("timedelta64[D]"),
            "q": rng.integers(1, 51, n),
            "v": v,
            "b": rng.random(n) < 0.3,
            "big": big,
            "gnan": gnan,
        }), d / f"part-{i:05d}.parquet")
    out["t"] = str(d)
    for name, files, rows, make in (
        ("l", 2, 600, lambda n: {
            "l_ok": rng.integers(0, 300, n), "l_price": np.round(rng.uniform(1, 100, n), 2),
            "l_q": rng.integers(1, 51, n),
            "l_flag": pa.array([f"f{x}" for x in rng.integers(0, 3, n)], mask=rng.random(n) < 0.05)}),
        ("o", 1, 250, lambda n: {
            "o_ok": rng.permutation(np.arange(40, 340))[:n], "o_total": np.round(rng.uniform(1, 900, n), 2),
            "o_date": BASE + rng.integers(0, 9, n).astype("timedelta64[D]")}),
    ):
        d = root / name
        d.mkdir()
        for i in range(files):
            pq.write_table(pa.table(make(rows)), d / f"part-{i:05d}.parquet")
        out[name] = str(d)
    return out


COVERING = [
    ("t", "t_ik", ["ik"], ["fk", "sk", "dk", "q", "v", "b", "big", "gnan"]),
    ("l", "l_ok", ["l_ok"], ["l_price", "l_q", "l_flag"]),
    ("o", "o_ok", ["o_ok"], ["o_total", "o_date"]),
]


def _conf(keys, system_path, **extra):
    return {keys.SYSTEM_PATH: system_path, keys.NUM_BUCKETS: NUM_BUCKETS, "hyperspace.tpu.build.batchRows": 900,
            "hyperspace.exec.join.broadcastMaxBytes": 0, **extra}


def _build(pkg, path, lake):
    kwargs = {} if pkg is hst else {"device": "cpu"}
    sess = pkg.Session(conf=_conf(pkg.keys, path), **kwargs)
    for table, name, indexed, included in COVERING:
        pkg.Hyperspace(sess).create_index(sess.read_parquet(lake[table]),
                                          pkg.CoveringIndexConfig(name, indexed, included))
    return path


@pytest.fixture(scope="module")
def system(lake, tmp_path_factory):
    """The system path of every covering index, built by the port."""
    return _build(ht, str(tmp_path_factory.mktemp("torch_agg_indexes")), lake)


@pytest.fixture(autouse=True)
def _no_native_join(monkeypatch):
    """The JAX package's span walk and pair expansion without its native
    library (module docstring)."""

    def unsupported(*args, **kwargs):
        raise ref_native.NativeUnsupported("native join kernels off for the comparison")

    monkeypatch.setattr(ref_native, "merge_spans", unsupported)
    monkeypatch.setattr(ref_native, "expand_pairs", unsupported)


GLOBAL_ALL = dict(
    n=("*", "count"), nv=("v", "count"), sq=("q", "sum"), sv=("v", "sum"), mnq=("q", "min"), mxv=("v", "max"),
    aq=("q", "avg"), av=("v", "avg"), sb=("b", "sum"), mnbig=("big", "min"), mxbig=("big", "max"),
    sbig=("big", "sum"),
)
GROUPED_ALL = dict(
    n=("*", "count"), nv=("v", "count"), sq=("q", "sum"), sv=("v", "sum"), mnv=("v", "min"), mxv=("v", "max"),
    av=("v", "avg"), aq=("q", "avg"), sd=("v", "stddev_samp"), mnq=("q", "min"), mxbig=("big", "max"),
    sbig=("big", "sum"), sg=("gnan", "sum"), mng=("gnan", "min"), ag=("gnan", "avg"), sdq=("q", "stddev_samp"),
    mxb=("b", "max"),
)


def _t(f, c):
    return f["t"].filter(c("ik") >= 1)


#: name -> query over the frames ``f`` with ``col`` c
QUERIES = {
    "global_filtered": lambda f, c: _t(f, c).agg(**GLOBAL_ALL),
    "global_no_filter": lambda f, c: f["t"].agg(n=("*", "count"), sv=("v", "sum"), mxq=("q", "max")),
    "global_no_match": lambda f, c: f["t"].filter(c("ik") > 100).agg(
        n=("*", "count"), nv=("v", "count"), sv=("v", "sum"), sq=("q", "sum"), mnq=("q", "min"), av=("v", "avg")),
    "global_string_predicate": lambda f, c: f["t"].filter((c("ik") >= 2) & (c("sk") == "s1")).agg(
        n=("*", "count"), sv=("v", "sum")),
    "global_count_star": lambda f, c: _t(f, c).agg(n=("*", "count")),
    "by_int": lambda f, c: _t(f, c).group_by("ik").agg(**GROUPED_ALL),
    "by_float": lambda f, c: _t(f, c).group_by("fk").agg(**GROUPED_ALL),
    "by_string": lambda f, c: _t(f, c).group_by("sk").agg(**GROUPED_ALL),
    "by_date": lambda f, c: f["t"].filter(c("ik") != 2).group_by("dk").agg(**GROUPED_ALL),
    "by_two_keys": lambda f, c: _t(f, c).group_by("sk", "ik").agg(n=("*", "count"), sv=("v", "sum"),
                                                                  sd=("v", "stddev_samp"), mnq=("q", "min")),
    "by_int_no_match": lambda f, c: f["t"].filter(c("ik") > 100).group_by("ik").agg(n=("*", "count")),
    "grouped_helpers": lambda f, c: _t(f, c).group_by("sk").max("q"),
    "distinct": lambda f, c: _t(f, c).select("sk", "fk").distinct(),
    "count_distinct": lambda f, c: _t(f, c).group_by("ik").agg(nd=("sk", "count_distinct"), n=("*", "count")),
    "join_global": lambda f, c: f["l"].join(f["o"], c("l_ok") == c("o_ok")).agg(
        n=("*", "count"), sp=("l_price", "sum"), st=("o_total", "sum"), ap=("l_price", "avg"),
        mnp=("l_price", "min"), mxq=("l_q", "max"), nt=("o_total", "count"), sq=("l_q", "sum")),
    "join_by_join_key": lambda f, c: f["l"].join(f["o"], c("l_ok") == c("o_ok")).group_by("o_ok").agg(
        n=("*", "count"), sp=("l_price", "sum"), st=("o_total", "sum")),
    "join_by_left_key": lambda f, c: f["l"].join(f["o"], c("l_ok") == c("o_ok")).group_by("l_flag").agg(
        sq=("l_q", "sum"), ap=("l_price", "avg"), n=("*", "count")),
    "join_by_right_key": lambda f, c: f["l"].join(f["o"], c("l_ok") == c("o_ok")).group_by("l_ok", "o_date").agg(
        sp=("l_price", "sum"), n=("*", "count")),
    "join_materialize": lambda f, c: f["l"].join(f["o"], c("l_ok") == c("o_ok")).agg(
        mnt=("o_total", "min"), n=("*", "count")),
}

MODES = {"device": {"hyperspace.tpu.query.deviceMinRows": 0}, "default": {}, "off": {}}

#: the ``agg:`` trace line each query's device mode must show
DEVICE_LINE = {
    "global_filtered": "agg: device-fused-scan x1", "global_no_match": "agg: device-fused-scan x1",
    "by_int": "agg: device-grouped-scan x1", "by_float": "agg: device-grouped-scan x1",
    "by_string": "agg: device-grouped-scan x1", "by_date": "agg: device-grouped-scan x1",
    "by_two_keys": "agg: device-grouped-scan x1", "grouped_helpers": "agg: device-grouped-scan x1",
    "join_global": "agg: fused-bucketed-join x1", "join_by_join_key": "agg: fused-bucketed-join x1",
    "join_by_left_key": "agg: fused-bucketed-join x1", "join_by_right_key": "agg: fused-bucketed-join x1",
}


def _jax_dispatches():
    return {p: REGISTRY.counter("hs_device_dispatches_total", "", program=p).value for p in PROGRAMS}


def _run(pkg, path, name, mode, lake, monkeypatch, **conf):
    """(optimized plan, collected batch, trace lines, fallbacks, device
    programs run) of one query in one package."""
    kwargs = {} if pkg is hst else {"device": "cpu"}
    sess = pkg.Session(conf=_conf(pkg.keys, path, **MODES[mode], **conf), **kwargs)
    if mode != "off":
        sess.enable_hyperspace()
    (RD if pkg is hst else D).clear_device_cache()
    df = QUERIES[name]({t: sess.read_parquet(p) for t, p in lake.items()}, pkg.col)
    plan = df.optimized_plan()
    rec = ref_trace if pkg is hst else trace
    falls = []
    monkeypatch.setattr(rec, "fallback", lambda op, reason: falls.append((op, reason)))
    before = _jax_dispatches() if pkg is hst else {p: D.dispatches[p] for p in PROGRAMS}
    with rec.recording() as events:
        got = df.collect()
    after = _jax_dispatches() if pkg is hst else {p: D.dispatches[p] for p in PROGRAMS}
    lines = [ln for ln in rec.summarize(events).splitlines()
             if ln.startswith(("agg:", "filter:", "join:", "scan:", "spans:"))]
    ran = {p: int(after[p] - before[p]) for p in PROGRAMS}
    return plan, got, lines, falls, ran


def _float_tolerant(name, plan) -> bool:
    """Float sums, avg and stddev compare at FLOAT_RTOL."""
    from hyperspace_tpu_torch.plan import logical as L

    (agg,) = L.collect(plan, lambda p: isinstance(p, L.Aggregate))
    return {n: fn for n, fn, _ in agg.aggs}.get(name) in ("sum", "avg", "stddev_samp")


def _assert_same_result(got, ref, plan):
    assert list(got) == list(ref)
    for name in ref:
        g, r = got[name], ref[name]
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        assert g.shape == r.shape, name
        if r.dtype == object:
            assert all(x == y or (x != x and y != y) or (x is None and y is None)
                       for x, y in zip(g.tolist(), r.tolist())), name
        elif r.dtype.kind == "f" and _float_tolerant(name, plan):
            np.testing.assert_allclose(g, r, rtol=FLOAT_RTOL, equal_nan=True, err_msg=name)
        else:
            assert g.tobytes() == r.tobytes(), name


def _by_keys(batch, keys):
    """``batch``'s rows ordered by its key columns (a multiset's form)."""
    from hyperspace_tpu_torch.ops.encode import sort_key_int64

    order = np.lexsort([sort_key_int64(batch[k]) for k in keys][::-1])
    # pandas hands date keys back at second resolution: compare at one unit
    return {name: (v.astype("datetime64[us]") if v.dtype.kind == "M" else v)[order] for name, v in batch.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_aggregate_matches_jax(system, lake, monkeypatch, name, mode):
    ref_plan, ref, ref_lines, ref_falls, ref_ran = _run(hst, system, name, mode, lake, monkeypatch)
    plan, got, lines, falls, ran = _run(ht, system, name, mode, lake, monkeypatch)
    if name == "by_float" and mode == "device":
        # XLA folds the JAX program's ``k + 0.0`` away on the CPU, so its
        # -0.0 keys form a group apart from +0.0, unlike its own host
        # aggregate (pandas); the port groups them as the host does, so its
        # result is held against JAX's host aggregate over the same scan
        ref = _run(hst, system, name, "default", lake, monkeypatch)[1]

    assert plan.pretty() == ref_plan.pretty()
    assert ("IndexScan" in plan.pretty()) == (mode != "off" and name != "global_no_filter")
    _assert_same_result(got, ref, plan)
    assert lines == ref_lines
    assert falls == ref_falls
    assert ran == ref_ran
    if mode == "device" and name in DEVICE_LINE:
        assert DEVICE_LINE[name] in lines, lines
    if mode == "default" and name.startswith(("global_f", "by_")):
        assert falls == [("agg", "min-rows"), ("filter", "min-rows")], falls
    if mode == "off":
        assert not any(ln.startswith(("agg:", "join: device")) for ln in lines), lines


def test_paths_agree(system, lake, monkeypatch):
    """The port's device, host and hyperspace-off results hold the same
    groups (exact keys and counts, float sums at FLOAT_RTOL); device and
    host over one index scan also in the same order."""
    for name, keys in (("by_string", ["sk"]), ("by_float", ["fk"]), ("by_two_keys", ["sk", "ik"]),
                       ("distinct", ["sk", "fk"]), ("join_by_right_key", ["l_ok", "o_date"])):
        plan, device, *_ = _run(ht, system, name, "device", lake, monkeypatch)
        _, host, *_ = _run(ht, system, name, "default", lake, monkeypatch)
        _, off, *_ = _run(ht, system, name, "off", lake, monkeypatch)
        _assert_same_result(device, host, plan)
        if "fk" not in keys:  # the zero group's key is its first row's -0.0 or +0.0
            _assert_same_result(_by_keys(device, keys), _by_keys(off, keys), plan)


#: (query, conf) whose device aggregate falls back, with the reason
FALLBACKS = {
    "count_distinct": ("count_distinct", {}, ("agg", "unsupported")),
    "spill": ("by_string", {"hyperspace.exec.agg.maxGroups": 2}, ("agg", "spill")),
    "disabled": ("by_int", {"hyperspace.exec.agg.enabled": "false"}, None),
    "join_materialize": ("join_materialize", {}, ("agg", "join-unsupported")),
    "string_predicate": ("global_string_predicate", {}, ("agg", "unsupported")),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_match_jax(system, lake, monkeypatch, case):
    """Each route from the device to the host aggregate: the same reason
    and the same result as the JAX package's."""
    name, conf, reason = FALLBACKS[case]
    ref_plan, ref, ref_lines, ref_falls, ref_ran = _run(hst, system, name, "device", lake, monkeypatch, **conf)
    plan, got, lines, falls, ran = _run(ht, system, name, "device", lake, monkeypatch, **conf)
    _assert_same_result(got, ref, plan)
    assert (lines, falls, ran) == (ref_lines, ref_falls, ref_ran)
    if reason is None:
        assert not falls and not any(ln.startswith("agg:") for ln in lines), (falls, lines)
    else:
        assert reason in falls, falls
    assert not any(ln.startswith("agg: device") for ln in lines), lines


def test_jax_built_index_serves_port(lake, tmp_path, monkeypatch):
    """An index the JAX package built serves the port's grouped aggregate
    with the JAX package's result (the other direction is every test
    above: both packages query the port's index)."""
    path = _build(hst, str(tmp_path / "jax_indexes"), lake)
    ref_plan, ref, ref_lines, *_ = _run(hst, path, "by_two_keys", "device", lake, monkeypatch)
    plan, got, lines, *_ = _run(ht, path, "by_two_keys", "device", lake, monkeypatch)
    assert plan.pretty() == ref_plan.pretty() and lines == ref_lines
    assert "agg: device-grouped-scan x1" in lines
    _assert_same_result(got, ref, plan)


def test_capacity_rerun_and_hint(system, lake, monkeypatch):
    """Above the capacity floor the grouped program re-runs once at the
    right capacity; the next run of the same query starts there. Dispatch
    counts equal the JAX package's."""
    QUERIES["by_big"] = lambda f, c: _t(f, c).group_by("big").agg(n=("*", "count"), sv=("v", "sum"))
    try:
        counts = {}
        for pkg in (hst, ht):
            kwargs = {} if pkg is hst else {"device": "cpu"}
            sess = pkg.Session(conf=_conf(pkg.keys, system, **MODES["device"]), **kwargs).enable_hyperspace()
            (RD if pkg is hst else D).clear_device_cache()
            df = QUERIES["by_big"]({t: sess.read_parquet(p) for t, p in lake.items()}, pkg.col)
            runs = []
            for _ in range(2):
                before = _jax_dispatches() if pkg is hst else dict(D.dispatches)
                out = df.collect()
                after = _jax_dispatches() if pkg is hst else dict(D.dispatches)
                runs.append(int(after["grouped-agg-chunk"] - before.get("grouped-agg-chunk", 0)))
            counts[pkg.__name__] = (runs, len(out["big"]))
        assert counts["hyperspace_tpu"] == counts["hyperspace_tpu_torch"]
        (runs, groups) = counts["hyperspace_tpu_torch"]
        assert runs == [2, 1] and groups > 256
    finally:
        del QUERIES["by_big"]


FUSION = {"hyperspace.exec.fusion.enabled": "true"}
#: a grouped aggregate over a join the span path cannot take (min of a
#: left column over ... grouped by a left key falls to the materialized join)
JOIN_MIN = lambda f, c: f["l"].join(f["o"], c("l_ok") == c("o_ok")).group_by("l_flag").agg(  # noqa: E731
    mn=("l_price", "min"))

#: what the port once raised for and now answers as the JAX package does:
#: the streamed aggregate, and a fused-join shape the JAX package does not
#: fuse because no side is broadcastable (``broadcastMaxBytes`` 0, ``_conf``)
ANSWERED = {
    "streamed_aggregate": ({"hyperspace.exec.stream.aggMinBytes": 1, "hyperspace.exec.stream.chunkBytes": 1},
                           QUERIES["by_int"]),
    "join_min": (FUSION, JOIN_MIN),
}


@pytest.mark.parametrize("case", sorted(ANSWERED))
def test_answered_like_jax(system, lake, monkeypatch, case):
    conf, query = ANSWERED[case]
    QUERIES["__case"] = query
    try:
        _, ref, ref_lines, ref_falls, ref_ran = _run(hst, system, "__case", "device", lake, monkeypatch, **conf)
        plan, got, lines, falls, ran = _run(ht, system, "__case", "device", lake, monkeypatch, **conf)
    finally:
        del QUERIES["__case"]
    _assert_same_result(got, ref, plan)
    assert (lines, falls, ran) == (ref_lines, ref_falls, ref_ran)
    if case == "streamed_aggregate":
        assert "agg: streamed-partial x1" in lines, lines


def test_not_ported_features_raise(system, lake):
    """Whole-stage fusion (of a grouped scan aggregate, and of a grouped
    join aggregate with a side the JAX package would broadcast) and the
    sharded aggregate are not in the port yet: asking for them raises."""
    for conf, query, match in (
        (FUSION, QUERIES["by_int"], "fused grouped aggregate"),
        ({**FUSION, "hyperspace.exec.join.broadcastMaxBytes": 64 << 20}, JOIN_MIN, "fused join aggregate"),
        ({"hyperspace.parallel.enabled": "true"}, QUERIES["by_int"], "sharded"),
    ):
        sess = ht.Session(conf=_conf(ht.keys, system, **MODES["device"], **conf), device="cpu").enable_hyperspace()
        frames = {t: sess.read_parquet(p) for t, p in lake.items()}
        with pytest.raises(NotImplementedError, match=match):
            query(frames, ht.col).collect()


def test_agg_stage_seconds(system, lake):
    """An aggregate's collect() adds its host time per layer to the
    session's ``query_stage_seconds``; a repeated device aggregate uploads
    nothing."""
    D.clear_device_cache()
    sess = ht.Session(conf=_conf(ht.keys, system, **MODES["device"]), device="cpu").enable_hyperspace()
    frames = {t: sess.read_parquet(p) for t, p in lake.items()}
    for name, first, layers in (
        ("by_int", {"agg_upload"}, {"rewrite", "decode", "scan_identity", "agg_program", "agg_finalize"}),
        ("global_filtered", {"agg_upload"}, {"rewrite", "decode", "scan_identity", "agg_program", "agg_finalize"}),
        ("join_by_left_key", set(), {"rewrite", "join_plan", "join_decode", "join_keys", "agg_join"}),
    ):
        df = QUERIES[name](frames, ht.col)
        D.clear_device_cache()
        sess.query_stage_seconds.clear()
        df.collect()
        assert set(sess.query_stage_seconds) == layers | first, (name, set(sess.query_stage_seconds))
        sess.query_stage_seconds.clear()
        df.collect()
        assert set(sess.query_stage_seconds) == layers, (name, set(sess.query_stage_seconds))
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 1 << 25)
    sess.query_stage_seconds.clear()
    QUERIES["by_int"](frames, ht.col).collect()
    assert set(sess.query_stage_seconds) == {"rewrite", "decode", "host_predicate", "mask_rows", "agg_host"}


# --------------------------------------------------------------------------
# program level: the port's programs against the JAX package's
# --------------------------------------------------------------------------


def _program_inputs(rng, n):
    """Encoded device columns as both packages hold them: an int key, a
    float key with NaN and signed zeros, string codes with -1 nulls, an int
    and a float (NaN) input, and a predicate column."""
    f = rng.choice(np.array([0.5, -0.0, 0.0, np.nan, -3.0]), n)
    v = np.round(rng.standard_normal(n), 3)
    v[rng.random(n) < 0.2] = np.nan
    return {
        "ik": rng.integers(-3, 4, n).astype(np.int64),
        "fk": f,
        "sk": rng.integers(-1, 5, n).astype(np.int32),
        "q": rng.integers(-(2**60), 2**60, n).astype(np.int64),
        "v": v,
        "p": rng.integers(0, 10, n).astype(np.int64),
    }


def _jax_grouped(cols, key_specs, slot_specs, cap, keep):
    """JAX's grouped program, jitted on the CPU. XLA folds its ``k + 0.0``
    away there, so -0.0 keys would form a group of their own, against the
    host aggregate (pandas) and the port; the reference is given +0.0 in
    their place, and float keys compare by value."""
    import jax
    import jax.numpy as jnp

    cols = dict(cols, fk=cols["fk"] + 0.0)
    pred = (lambda c, lits: c["p"] < keep) if keep is not None else None
    prog = jax.jit(RD._grouped_chunk_program(pred, key_specs, slot_specs, cap))
    n = next(iter(cols.values())).shape[0]
    n_g, fs, keys, slots = prog({k: jnp.asarray(v) for k, v in cols.items()}, (), np.int64(n), np.int64(11))
    return int(n_g), np.asarray(fs), [np.asarray(k) for k in keys], [np.asarray(s) for s in slots]


def _torch_grouped(cols, key_specs, slot_specs, cap, keep):
    pred = (lambda c, lits: c["p"] < keep) if keep is not None else None
    n = next(iter(cols.values())).shape[0]
    n_g, fs, keys, slots = A.grouped_chunk_program(pred, key_specs, slot_specs, cap)(
        {k: torch.from_numpy(v) for k, v in cols.items()}, (), n, 11)
    return n_g, fs.numpy(), [k.numpy() for k in keys], [s.numpy() for s in slots]


SLOTS = [("cntm", None, True), ("cnt", "v", False), ("sum", "v", False), ("sumsq", "v", False),
         ("min", "v", False), ("max", "v", False), ("sum", "q", True), ("min", "q", True), ("max", "q", True),
         ("cnt", "q", True), ("sum", "q", False)]


def _assert_grouped_equal(got, ref, slot_specs):
    n_g, fs, keys, slots = got
    rn, rfs, rkeys, rslots = ref
    assert n_g == rn
    assert np.array_equal(fs[:n_g], rfs[:n_g])
    for k, rk in zip(keys, rkeys):
        if rk.dtype.kind == "f":
            assert np.array_equal(k[:n_g], rk[:n_g], equal_nan=True)
        else:
            assert k[:n_g].astype(rk.dtype).tobytes() == rk[:n_g].tobytes()
    for (kind, _, isint), s, rs in zip(slot_specs, slots, rslots):
        assert s.dtype == rs.dtype, kind
        if s.dtype.kind == "f" and kind in ("sum", "sumsq"):
            np.testing.assert_allclose(s[:n_g], rs[:n_g], rtol=FLOAT_RTOL, equal_nan=True, err_msg=kind)
        else:
            assert s[:n_g].tobytes() == rs[:n_g].tobytes(), kind


@pytest.mark.parametrize("keys", [("ik",), ("fk",), ("sk",), ("sk", "fk", "ik")])
@pytest.mark.parametrize("keep", [None, 4, -1])
def test_grouped_program_matches_jax(keys, keep):
    """``grouped-agg-chunk`` equals JAX's ``_grouped_chunk_program`` on
    ``[:n_groups]``: the group count, the first rows, the keys and the
    counts, int sums, min and max exactly; float sums at FLOAT_RTOL. A
    predicate that keeps no row gives no group."""
    cols = _program_inputs(np.random.default_rng(3), 1500)
    key_specs = tuple((k, "f" if k == "fk" else "i") for k in keys)
    got = _torch_grouped(cols, key_specs, SLOTS, 256, keep)
    ref = _jax_grouped(cols, key_specs, SLOTS, 256, keep)
    _assert_grouped_equal(got, ref, SLOTS)
    assert (got[0] == 0) == (keep == -1)


def test_grouped_program_above_capacity_reports_count():
    """Above its capacity the program reports the group count, as JAX's
    does, and the caller re-runs it at a capacity that holds them."""
    cols = _program_inputs(np.random.default_rng(4), 800)
    key_specs = (("q", "i"),)
    program = A.grouped_chunk_program(None, key_specs, SLOTS[:3], 16)
    n_g, fs, keys, slots = program({k: torch.from_numpy(v) for k, v in cols.items()}, (), 800, 0)
    assert n_g == _jax_grouped(cols, key_specs, SLOTS[:3], 16, None)[0] == 800 and fs is None
    cap = A.group_capacity(n_g, 16)
    assert cap == RD.group_capacity(n_g, 16) >= n_g
    _assert_grouped_equal(_torch_grouped(cols, key_specs, SLOTS[:3], cap, None),
                          _jax_grouped(cols, key_specs, SLOTS[:3], cap, None), SLOTS[:3])


def _jax_fused_agg(batch, condition, aggs, monkeypatch):
    """(outs, valids) of the JAX package's ``fused-agg`` program on
    ``batch``: the program closure is captured where it is jitted."""
    import jax
    import jax.numpy as jnp

    seen = {}
    real = RD._cached_predicate_jit

    def capture(key, program):
        seen["program"] = program
        return real(key, program)

    monkeypatch.setattr(RD, "_cached_predicate_jit", capture)
    sess = hst.Session(conf={})
    RD.device_filtered_aggregate(sess, batch, condition, aggs)
    monkeypatch.setattr(RD, "_cached_predicate_jit", real)
    cols = {}
    for r in sorted({c for _, _, c in aggs if c} | (condition.references() if condition is not None else set())):
        cols[r] = jnp.asarray(RD.encode_column(batch[r])[0])
    lits = RD.compile_predicate(condition, {r: RD.encode_column(batch[r])[1] for r in cols})[1] if condition \
        is not None else ()
    outs, valids = jax.jit(seen["program"])(cols, lits, np.int64(len(next(iter(batch.values())))))
    return [np.asarray(o) for o in outs], [int(v) for v in valids]


@pytest.mark.parametrize("keep", [5, -1])
def test_fused_agg_program_matches_jax(monkeypatch, keep):
    """``fused-agg`` equals the JAX package's program on the same columns:
    counts, int sums, min and max exactly (int64 above 2^53 included),
    float sums and avg at FLOAT_RTOL; and the finished results (NULL sums
    of no row, int and float output types) equal JAX's."""
    batch = _program_inputs(np.random.default_rng(6), 2000)
    batch["b"] = batch["p"] % 3 == 0
    aggs = [("n", "count", None), ("nv", "count", "v"), ("sq", "sum", "q"), ("sv", "sum", "v"),
            ("mnq", "min", "q"), ("mxq", "max", "q"), ("mnv", "min", "v"), ("mxv", "max", "v"),
            ("aq", "avg", "q"), ("av", "avg", "v"), ("sb", "sum", "b"), ("mxb", "max", "b")]
    cond = ht.col("p") < keep
    ref_outs, ref_valids = _jax_fused_agg(batch, hst.col("p") < keep, aggs, monkeypatch)
    cols = {k: torch.from_numpy(D.encode_column(v)[0]) for k, v in batch.items()}
    fn, lits = D.compile_predicate(cond, {k: D.encode_column(v)[1] for k, v in batch.items()})
    outs, valids = A.fused_agg_program(fn, tuple((f, c) for _, f, c in aggs))(cols, D.upload_literals(lits, "cpu"),
                                                                            2000)
    assert [int(v) for v in valids] == ref_valids
    for (_, fn_, _), o, r in zip(aggs, outs, ref_outs):
        if fn_ in ("sum", "avg") and r.dtype.kind == "f":
            np.testing.assert_allclose(o.numpy(), r, rtol=FLOAT_RTOL)
        else:
            assert o.numpy().astype(r.dtype).tobytes() == r.tobytes(), fn_
    sess = ht.Session(conf={}, device="cpu")
    got = A.device_filtered_aggregate(sess, batch, cond, aggs)
    ref = RD.device_filtered_aggregate(hst.Session(conf={}), batch, hst.col("p") < keep, aggs)
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_allclose(got[name], ref[name], rtol=FLOAT_RTOL, equal_nan=True, err_msg=name)
    assert (keep == -1) == bool(np.isnan(got["sv"][0]))


from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=8, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), keep=st.integers(-1, 10), nan_share=st.sampled_from([0.0, 0.3, 1.0]))
def test_grouped_program_random(seed, keep, nan_share):
    """Random keys, masks and NaN shares at one fixed shape (JAX compiles
    once): the port's grouped program equals JAX's."""
    rng = np.random.default_rng(seed)
    cols = _program_inputs(rng, 512)
    cols["fk"][rng.random(512) < nan_share] = np.nan
    cols["v"][rng.random(512) < nan_share] = np.nan
    key_specs = (("fk", "f"), ("sk", "i"))
    _assert_grouped_equal(_torch_grouped(cols, key_specs, SLOTS, 64, keep),
                          _jax_grouped(cols, key_specs, SLOTS, 64, keep), SLOTS)
