"""The port's out-of-core execution (ROADMAP A4b, A4c) against the JAX package.

One seeded lake (numpy) is indexed by the port (``device="cpu"``); both
packages then run over it with the streaming gates lowered in the conf, as
tests/test_streaming.py does (the JAX package on its CPU backend):

- the streamed bucketed join (``joinMinBytes=1``): its per-bucket chunks,
  serial and pipelined, the folded result and the typed empty result;
- ``DataFrame.to_local_iterator`` over scan chains, filter chains and the
  bucketed join, and one abandoned after its first chunk;
- the partitioned generic merge (``spillMinRows``);
- the streamed aggregate (``aggMinBytes=1, chunkBytes=1``): every
  streamable function, grouped on the device and on the host, global,
  distinct forms, a mid-stream spill;
- ``ScanPipeline`` (tests/test_scan_pipeline.py is the spec) and the
  ``grouped-merge`` program.

Results compare byte for byte and in order, except float sums, averages and
standard deviations, at rtol 1e-9 where the two packages add in another
order (the device programs); the dispatch trace's ``agg:``, ``filter:``,
``join:`` and ``scan:`` lines, the fallback reasons and the device programs
run must be equal too.

Both packages' sessions set ``hyperspace.exec.join.broadcastMaxBytes`` to 0
(the JAX package's broadcast tier is not in the port) and turn row-group
pruning off, so every chunk decodes whole and a query matching no row
still streams (with pruning on, both packages prune its every chunk to
zero rows and fall back alike; tests/test_torch_pruning.py compares the
pruned streams). Both packages walk the spans natively. The float key
``fk`` holds no
-0.0: the JAX package's device path splits -0.0 from +0.0 on its CPU
backend, unlike its host path and the port (ROADMAP C, tests/test_torch_agg.py).
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.exec import device as RD  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu.exec.executor import Executor as RefExecutor  # noqa: E402
from hyperspace_tpu.obs.metrics import REGISTRY  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
from hyperspace_tpu_torch.exec import aggregate as A  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import io as IO  # noqa: E402
from hyperspace_tpu_torch.exec import join as J  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.exec.executor import Executor  # noqa: E402
from hyperspace_tpu_torch.exec.pipeline import ScanPipeline  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 4
FLOAT_RTOL = 1e-9
BASE = np.datetime64("1996-01-01")
PROGRAMS = ("grouped-agg-chunk", "grouped-merge", "fused-filter")
JOIN_STREAM = {"hyperspace.exec.stream.joinMinBytes": 1}
AGG_STREAM = {"hyperspace.exec.stream.aggMinBytes": 1, "hyperspace.exec.stream.chunkBytes": 1}
DEVICE = {"hyperspace.tpu.query.deviceMinRows": 0}


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """{table: directory}. ``t`` (5 files of 240 rows): an int key ``ik``, a
    float key ``fk`` with NaN, a string key ``sk`` with nulls, a date key
    ``dk``, int and float (NaN) inputs, ``big`` int64 above 2^53, ``gnan``
    all NaN in group ``ik == 3``, and ``m`` around 1e9 with a spread of
    about 1 (a standard deviation that cancels). ``l`` (3 files) and ``r``
    (2) join on ``lk = rk``: duplicate keys on both sides, keys either side
    lacks, a nullable int payload and strings."""
    root = tmp_path_factory.mktemp("stream_lake")
    rng = np.random.default_rng(66)
    out = {}
    d = root / "t"
    d.mkdir()
    for i in range(5):
        n = 240
        ik = rng.integers(0, 7, n)
        v = np.round(rng.standard_normal(n) * 10, 3)
        v[rng.random(n) < 0.1] = np.nan
        gnan = np.round(rng.uniform(-5, 5, n), 2)
        gnan[ik == 3] = np.nan
        pq.write_table(pa.table({
            "ik": ik,
            "fk": rng.choice(np.array([1.5, 0.0, np.nan, 2.5]), n),
            "sk": pa.array([f"s{x}" for x in rng.integers(0, 5, n)], mask=rng.random(n) < 0.1),
            "dk": BASE + rng.integers(0, 6, n).astype("timedelta64[D]"),
            "q": rng.integers(1, 51, n),
            "v": v,
            "big": (2**53 + rng.integers(0, 1000, n)) * rng.choice([-1, 1], n),
            "gnan": gnan,
            "m": 1e9 + np.round(rng.standard_normal(n), 6),
        }), d / f"part-{i:05d}.parquet")
    out["t"] = str(d)
    for name, files, rows, make in (
        ("l", 3, 300, lambda n: {
            "lk": rng.integers(0, 150, n), "lv": np.round(rng.standard_normal(n), 4),
            "ln": pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.15),
            "ls": pa.array([f"c{x}" for x in rng.integers(0, 9, n)], mask=rng.random(n) < 0.1)}),
        ("r", 2, 200, lambda n: {
            "rk": rng.integers(40, 200, n), "rv": np.round(rng.uniform(0, 100, n), 2),
            "rd": BASE + rng.integers(0, 90, n).astype("timedelta64[D]")}),
    ):
        d = root / name
        d.mkdir()
        for i in range(files):
            pq.write_table(pa.table(make(rows)), d / f"part-{i:05d}.parquet")
        out[name] = str(d)
    return out


COVERING = [
    ("t", "t_ik", ["ik"], ["fk", "sk", "dk", "q", "v", "big", "gnan", "m"]),
    ("l", "l_lk", ["lk"], ["lv", "ln", "ls"]),
    ("r", "r_rk", ["rk"], ["rv", "rd"]),
]


def _conf(pkg, system_path, **extra):
    base = {pkg.keys.SYSTEM_PATH: system_path, pkg.keys.NUM_BUCKETS: NUM_BUCKETS,
            "hyperspace.tpu.build.batchRows": 400, "hyperspace.exec.join.broadcastMaxBytes": 0,
            "hyperspace.exec.io.rowGroupPruning": False}
    return {**base, **extra}


@pytest.fixture(scope="module")
def system(lake, tmp_path_factory):
    """The system path of every covering index, built by the port."""
    path = str(tmp_path_factory.mktemp("torch_stream_indexes"))
    sess = ht.Session(conf=_conf(ht, path), device="cpu")
    for table, name, indexed, included in COVERING:
        ht.Hyperspace(sess).create_index(sess.read_parquet(lake[table]), ht.CoveringIndexConfig(name, indexed, included))
    return path



def _session(pkg, system, lake, enabled=True, **conf):
    kwargs = {} if pkg is hst else {"device": "cpu"}
    sess = pkg.Session(conf=_conf(pkg, system, **conf), **kwargs)
    if enabled:
        sess.enable_hyperspace()
    (RD if pkg is hst else D).clear_device_cache()
    return sess, {t: sess.read_parquet(p) for t, p in lake.items()}


def _same_objects(g, w) -> bool:
    return all(x is y or x == y or (x != x and y != y) for x, y in zip(g.tolist(), w.tolist()))


def _assert_same_batch(got, ref, tolerant=()):
    """Equal columns, dtypes and rows in order: bytes, object values, or
    (names in ``tolerant``) floats at FLOAT_RTOL."""
    assert list(got) == list(ref)
    for name in ref:
        g, r = got[name], ref[name]
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        assert g.shape == r.shape, name
        if r.dtype == object:
            assert _same_objects(g, r), name
        elif name in tolerant and r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=FLOAT_RTOL, equal_nan=True, err_msg=name)
        else:
            assert g.tobytes() == r.tobytes(), name


def _lines(pkg, events, prefixes=("agg:", "filter:", "join:", "scan:")):
    rec = ref_trace if pkg is hst else trace
    return [ln for ln in rec.summarize(events).splitlines() if ln.startswith(prefixes)]


# --------------------------------------------------------------------------
# the streamed bucketed join
# --------------------------------------------------------------------------

JOINS = {
    "inner": lambda f, c: f["l"].join(f["r"], c("lk") == c("rk")).select("lk", "lv", "ln", "ls", "rv", "rd"),
    "left": lambda f, c: f["l"].join(f["r"], c("lk") == c("rk"), how="left").select("lk", "lv", "ln", "ls", "rv",
                                                                                    "rd"),
    "right": lambda f, c: f["l"].join(f["r"], c("rk") == c("lk"), how="right").select("lk", "ln", "rk", "rv"),
    "outer": lambda f, c: f["l"].join(f["r"], c("lk") == c("rk"), how="outer").select("lk", "lv", "ls", "rk", "rd"),
    "filtered": lambda f, c: f["l"].filter(c("lv") > 0).join(f["r"].filter(c("rv") < 60), c("lk") == c("rk"))
    .select("lk", "lv", "rv"),
    "empty": lambda f, c: f["l"].filter(c("lk") < 20).join(f["r"], c("lk") == c("rk")).select("lk", "ln", "ls", "rd"),
}


def _join_node(plan, logical):
    (node,) = logical.collect(plan, lambda p: isinstance(p, logical.Join))
    return node


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
@pytest.mark.parametrize("name", sorted(set(JOINS) - {"empty"}))
def test_stream_chunks_match_jax(system, lake, name, pipeline):
    """``stream_bucketed_join`` yields the JAX package's chunks: one per
    bucket that gives rows, byte for byte and in order, with the join
    pipeline on and off."""
    chunks = {}
    for pkg in (hst, ht):
        sess, f = _session(pkg, system, lake, **{"hyperspace.exec.join.pipeline.enabled": pipeline})
        node = _join_node(JOINS[name](f, pkg.col).optimized_plan(), RL if pkg is hst else L)
        chunks[pkg] = list((RD if pkg is hst else J).stream_bucketed_join(sess, node))
    assert len(chunks[ht]) == len(chunks[hst]) > 1
    for got, ref in zip(chunks[ht], chunks[hst]):
        _assert_same_batch(got, ref)


@pytest.mark.parametrize("name", sorted(JOINS))
def test_streamed_join_matches_jax(system, lake, name):
    """Above ``joinMinBytes`` the join folds the stream: the JAX package's
    rows, byte for byte, and its trace; the same multiset as the
    unstreamed join. The empty stream is typed from the index footers,
    with the JAX package's dtypes, and does not fall back to the generic
    merge."""
    got = {}
    for pkg in (hst, ht):
        sess, f = _session(pkg, system, lake, **JOIN_STREAM)
        q = JOINS[name](f, pkg.col)
        rec = ref_trace if pkg is hst else trace
        with rec.recording() as events:
            got[pkg] = q.collect()
        assert "join: host-span-smj-stream x1" in _lines(pkg, events), _lines(pkg, events)
        got[pkg, "lines"] = _lines(pkg, events)
    _assert_same_batch(got[ht], got[hst])
    assert got[ht, "lines"] == got[hst, "lines"]
    sess, f = _session(ht, system, lake)
    unstreamed = JOINS[name](f, ht.col).collect()
    n = len(next(iter(unstreamed.values())))
    assert len(next(iter(got[ht].values()))) == n
    if name == "empty":
        # typed from the footers, where the unstreamed empty result takes the
        # decoded buckets' dtypes: the nullable int column ``ln`` is int64
        # here and float64 there, in both packages (ROADMAP C)
        streamed = {k: v.dtype for k, v in got[ht].items()}
        assert n == 0 and streamed == {**{k: v.dtype for k, v in unstreamed.items()}, "ln": np.dtype(np.int64)}
        assert unstreamed["ln"].dtype == np.float64


# --------------------------------------------------------------------------
# to_local_iterator
# --------------------------------------------------------------------------

ITERATED = {
    "scan_chain": (lambda f, c: f["t"].filter(c("q") > 10).select("ik", "v", "sk"), False),
    "index_filter": (lambda f, c: f["t"].filter(c("ik") >= 2).select("ik", "q", "sk"), True),
    "bucketed_join": (JOINS["left"], True),
    "join_post_filter": (lambda f, c: f["l"].join(f["r"], c("lk") == c("rk")).filter(c("rv") > 30)
                         .select("lk", "rv"), True),
}


def _iterate(pkg, system, lake, name, **conf):
    query, enabled = ITERATED[name]
    sess, f = _session(pkg, system, lake, enabled=enabled, **{"hyperspace.exec.stream.chunkBytes": 1}, **conf)
    return list(query(f, pkg.col).to_local_iterator())


@pytest.mark.parametrize("name", sorted(ITERATED))
def test_local_iterator_matches_jax(system, lake, name):
    """``to_local_iterator`` yields the JAX package's chunks: the same
    boundaries (a file group of a scan chain, a bucket of a join), the same
    rows in order."""
    ref = _iterate(hst, system, lake, name, **DEVICE)
    got = _iterate(ht, system, lake, name, **DEVICE)
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        _assert_same_batch(g, r)


def test_local_iterator_of_a_broadcast_join_is_one_batch(system, lake):
    """The JAX package streams a join with a side under
    ``broadcastMaxBytes`` through its broadcast probe, chunk by chunk; that
    tier is not in the port, which yields the one batch ``collect()``
    gives: the same rows."""
    out = {}
    for pkg in (hst, ht):
        sess, f = _session(pkg, system, lake, enabled=False, **{"hyperspace.exec.join.broadcastMaxBytes": 1 << 30})
        q = f["l"].join(f["r"], pkg.col("lk") == pkg.col("rk")).select("lk", "lv", "rv")
        out[pkg] = list(q.to_local_iterator())
    assert len(out[ht]) == 1
    from hyperspace_tpu_torch.exec import batch as B

    def rows(chunks):
        b = B.concat(chunks)
        return sorted(zip(b["lk"].tolist(), b["lv"].tolist(), b["rv"].tolist()))

    assert rows(out[ht]) == rows(out[hst])


@pytest.mark.parametrize("name", ["scan_chain", "bucketed_join"])
def test_abandoned_iterator_leaves_no_decode(system, lake, monkeypatch, name):
    """A ``to_local_iterator`` closed after its first chunk cancels the
    queued decodes and waits for the ones in flight: nothing decodes after
    the close."""
    real = IO.read_parquet_batch
    started, finished = [], []

    def spy(files, columns, predicate=None):
        started.append(files)
        time.sleep(0.01)
        out = real(files, columns, predicate=predicate)
        finished.append(files)
        return out

    monkeypatch.setattr(IO, "read_parquet_batch", spy)
    IO.clear_io_cache()
    query, enabled = ITERATED[name]
    sess, f = _session(ht, system, lake, enabled=enabled, **{"hyperspace.exec.stream.chunkBytes": 1})
    it = query(f, ht.col).to_local_iterator()
    assert next(it)
    it.close()
    assert len(started) == len(finished)
    n = len(started)
    time.sleep(0.1)
    assert len(started) == n
    total = len(list(query(f, ht.col).to_local_iterator()))
    assert total > 1 and n < len(started)


# --------------------------------------------------------------------------
# the partitioned generic merge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_partitioned_merge_matches_jax(system, lake, how):
    """Above ``spillMinRows`` the generic merge runs in hash partitions:
    the JAX package's rows in its order (partition by partition, which is
    not the unpartitioned merge's), and the unpartitioned merge's rows as a
    multiset."""
    got = {}
    for pkg in (hst, ht):
        sess, f = _session(pkg, system, lake, enabled=False, **{"hyperspace.exec.join.spillMinRows": 64})
        q = f["l"].join(f["r"], pkg.col("lk") == pkg.col("rk"), how=how).select("lk", "lv", "ls", "rk", "rv", "rd")
        rec = ref_trace if pkg is hst else trace
        with rec.recording() as events:
            got[pkg] = q.collect()
        got[pkg, "lines"] = _lines(pkg, events, ("join:",))
    _assert_same_batch(got[ht], got[hst])
    assert got[ht, "lines"] == got[hst, "lines"] == ["join: generic-merge x1",
                                                     "join: generic-merge-partitioned(15) x1"]
    sess, f = _session(ht, system, lake, enabled=False)
    whole = f["l"].join(f["r"], ht.col("lk") == ht.col("rk"), how=how).select("lk", "lv", "ls", "rk", "rv",
                                                                            "rd").collect()

    def rows(b):
        return sorted(repr(tuple("null" if x is None or x != x else x for x in row))
                      for row in zip(*(b[c].astype(object).tolist() for c in b)))

    assert rows(got[ht]) == rows(whole)


def test_partitioned_merge_frames_match_jax():
    """``_partitioned_merge`` itself, on frames with NaN keys, -0.0 against
    +0.0 and an int side against a float side: the JAX package's rows in
    its order."""
    import pandas as pd

    rng = np.random.default_rng(8)
    lk = rng.choice(np.array([0.0, -0.0, 1.0, 2.5, np.nan, 7.0]), 300)
    ldf = pd.DataFrame({"a": lk, "__lrow": np.arange(300)})
    rdf = pd.DataFrame({"b": rng.integers(0, 8, 90), "__rrow": np.arange(90)})
    for how in ("inner", "left", "right", "outer"):
        ref = RefExecutor._partitioned_merge(ldf, rdf, ["a"], ["b"], how, 40)
        got = Executor._partitioned_merge(ldf, rdf, ["a"], ["b"], how, 40)
        pd.testing.assert_frame_equal(got, ref)


# --------------------------------------------------------------------------
# ScanPipeline (tests/test_scan_pipeline.py's cases)
# --------------------------------------------------------------------------


def test_pipeline_yields_in_order():
    def mk(i):
        def task():
            time.sleep(0.002 * (5 - i))  # later tasks finish first
            return i

        return task

    assert list(ScanPipeline([mk(i) for i in range(5)], depth=2)) == [0, 1, 2, 3, 4]


def test_pipeline_depth_bounds_lookahead():
    """At most ``depth`` chunks beyond the one consumed are submitted."""
    submitted = []

    def mk(i):
        def task():
            submitted.append(i)
            return i

        return task

    it = iter(ScanPipeline([mk(i) for i in range(8)], depth=2))
    assert next(it) == 0
    time.sleep(0.05)
    assert max(submitted) <= 2
    assert list(it) == list(range(1, 8))


def test_pipeline_close_midstream_leaks_nothing():
    started, finished = [], []
    release = threading.Event()

    def mk(i):
        def task():
            started.append(i)
            release.wait(5)
            finished.append(i)
            return i

        return task

    pipe = ScanPipeline([mk(i) for i in range(8)], depth=1)
    it = iter(pipe)
    t = threading.Thread(target=lambda: next(it))
    t.start()
    time.sleep(0.05)
    release.set()
    t.join(5)
    pipe.close()
    # close() waits for the tasks in flight, and queued ones never start
    assert sorted(finished) == sorted(started)
    assert len(started) < 8


def test_pipeline_byte_budget_limits_lookahead():
    order = []

    def mk(i):
        def task():
            order.append(i)
            return np.zeros(1 << 16)

        return task

    # depth allows chunk 5 at k=1 (1+4), but the byte budget, exceeded by
    # the completed but unconsumed chunks 2-4, vetoes it until it is the
    # always-allowed chunk one ahead
    pipe = ScanPipeline([mk(i) for i in range(6)], depth=4, max_buffered_bytes=1, weigh=lambda a: int(a.nbytes))
    it = iter(pipe)
    next(it)
    deadline = time.monotonic() + 5
    while pipe._buffered <= 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pipe._buffered > 1
    next(it)
    assert 5 not in order
    assert len(list(it)) == 4
    assert sorted(order) == list(range(6))


def test_pipeline_stage_runs_on_the_producer_thread():
    from hyperspace_tpu_torch.exec.pipeline import on_producer_thread

    seen = []
    pipe = ScanPipeline([lambda i=i: i for i in range(3)], depth=1,
                        stage=lambda i, out: seen.append((i, out, on_producer_thread(),
                                                          threading.current_thread() is threading.main_thread())))
    assert list(pipe) == [0, 1, 2]
    assert sorted(seen) == [(i, i, True, False) for i in range(3)] and not on_producer_thread()


# --------------------------------------------------------------------------
# the streamed aggregate
# --------------------------------------------------------------------------

PLAIN = dict(n=("*", "count"), nv=("v", "count"), sq=("q", "sum"), sv=("v", "sum"), mnv=("v", "min"),
             mxv=("v", "max"), av=("v", "avg"), aq=("q", "avg"), sd=("v", "stddev_samp"), mnq=("q", "min"),
             mxbig=("big", "max"), sbig=("big", "sum"), sg=("gnan", "sum"), mng=("gnan", "min"),
             ag=("gnan", "avg"), sdq=("q", "stddev_samp"))
DISTINCT = dict(cd=("sk", "count_distinct"), sdv=("q", "sum_distinct"), adv=("v", "avg_distinct"))


def _t(f, c):
    return f["t"].filter(c("ik") >= 1)


AGGS = {
    "global": lambda f, c: _t(f, c).agg(**PLAIN, **DISTINCT),
    "global_no_filter": lambda f, c: f["t"].agg(n=("*", "count"), sv=("v", "sum"), mxq=("q", "max"),
                                                sd=("m", "stddev_samp")),
    "by_int": lambda f, c: _t(f, c).group_by("ik").agg(**PLAIN),
    "by_float": lambda f, c: _t(f, c).group_by("fk").agg(**PLAIN),
    "by_string": lambda f, c: _t(f, c).group_by("sk").agg(**PLAIN),
    "by_date": lambda f, c: f["t"].filter(c("ik") != 2).group_by("dk").agg(**PLAIN),
    "by_two_keys": lambda f, c: _t(f, c).group_by("sk", "ik").agg(n=("*", "count"), sv=("v", "sum"),
                                                                  mnq=("q", "min")),
    "by_string_distinct": lambda f, c: _t(f, c).group_by("sk").agg(n=("*", "count"), **DISTINCT),
    "cancelling_stddev": lambda f, c: f["t"].group_by("ik").agg(sd=("m", "stddev_samp"), n=("*", "count")),
    "no_match": lambda f, c: f["t"].filter(c("ik") > 100).group_by("ik").agg(n=("*", "count")),
}

MODES = {"device": DEVICE, "host": {}, "off": DEVICE}

#: the streamed aggregate's ``agg:`` lines on the device path
DEVICE_STREAM = ["agg: device-grouped-stream x1", "agg: streamed-partial x1"]


def _programs():
    return {p: REGISTRY.counter("hs_device_dispatches_total", "", program=p).value for p in PROGRAMS}


def _run_agg(pkg, system, lake, name, mode, monkeypatch, query=None, **conf):
    """(result, trace lines, fallbacks, device programs run) of a streamed
    aggregate in one package."""
    sess, f = _session(pkg, system, lake, enabled=mode != "off", **AGG_STREAM, **MODES[mode], **conf)
    q = (query or AGGS[name])(f, pkg.col)
    rec = ref_trace if pkg is hst else trace
    falls = []
    monkeypatch.setattr(rec, "fallback", lambda op, reason: falls.append((op, reason)))
    before = _programs() if pkg is hst else {p: D.dispatches[p] for p in PROGRAMS}
    with rec.recording() as events:
        got = q.collect()
    after = _programs() if pkg is hst else {p: D.dispatches[p] for p in PROGRAMS}
    return got, _lines(pkg, events), falls, {p: int(after[p] - before[p]) for p in PROGRAMS}, q


def _float_names(q):
    (agg,) = L.collect(q.plan, lambda p: isinstance(p, L.Aggregate))
    return {n for n, fn, _ in agg.aggs if fn in ("sum", "avg", "stddev_samp", "avg_distinct", "sum_distinct")}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(AGGS))
def test_streamed_aggregate_matches_jax(system, lake, monkeypatch, name, mode):
    """Above ``aggMinBytes`` the aggregate folds file chunks (one index file
    each at ``chunkBytes=1``): the JAX package's result, trace, fallbacks
    and device programs, on the device stream, the host fold and with
    hyperspace off (source files chunked through FileScan leaves)."""
    ref, ref_lines, ref_falls, ref_ran, _ = _run_agg(hst, system, lake, name, mode, monkeypatch)
    got, lines, falls, ran, q = _run_agg(ht, system, lake, name, mode, monkeypatch)
    device = mode != "host" and name.startswith(("by_", "cancelling", "no_")) and "distinct" not in name
    _assert_same_batch(got, ref, _float_names(q) if device else set())
    assert lines == ref_lines
    assert falls == ref_falls
    assert ran == ref_ran
    assert "agg: streamed-partial x1" in lines
    if device and name != "no_match":
        assert [ln for ln in lines if ln.startswith("agg:")] == DEVICE_STREAM, lines
        assert ran["grouped-agg-chunk"] >= 4 and ran["grouped-merge"] >= 3, ran


def test_cancelling_stddev_is_inherited(system, lake, monkeypatch):
    """The streamed ``stddev_samp`` merges raw (n, sum, sum of squares)
    partials as the JAX package does, and cancels like it when the mean is
    far above the spread: on the host fold both packages give the same
    (wrong) values, bit for bit, far from pandas' one-pass answer."""
    ref = _run_agg(hst, system, lake, "cancelling_stddev", "host", monkeypatch)[0]
    got = _run_agg(ht, system, lake, "cancelling_stddev", "host", monkeypatch)[0]
    _assert_same_batch(got, ref)
    sess, f = _session(ht, system, lake)
    exact = AGGS["cancelling_stddev"](f, ht.col).collect()
    assert np.allclose(exact["sd"], 1.0, rtol=0.2)
    assert not np.allclose(got["sd"], exact["sd"], rtol=1e-3)


def test_infinite_partials_are_inherited(tmp_path, monkeypatch):
    """The streamed host fold adds the chunks' partial sums skipping NaN, as
    the JAX package does: a chunk holding +inf and -inf has a NaN partial
    sum and drops out, and the stddev's NaN variance clips to 0, where the
    one-pass aggregate gives NaN (ROADMAP C). The port equals the JAX
    package."""
    d = tmp_path / "inf"
    d.mkdir()
    for i, vals in enumerate(([1.0, np.inf, -np.inf], [2.0, 3.0, np.inf], [4.0, 5.0, 6.0])):
        pq.write_table(pa.table({"g": np.array([0, 1, 1]), "x": np.array(vals)}), d / f"part-{i:05d}.parquet")
    out = {}
    for pkg in (hst, ht):
        for streamed in (True, False):
            kwargs = {} if pkg is hst else {"device": "cpu"}
            conf = {pkg.keys.SYSTEM_PATH: str(tmp_path / "sys"), **(AGG_STREAM if streamed else {}),
                    "hyperspace.exec.io.rowGroupPruning": False}
            sess = pkg.Session(conf=conf, **kwargs)
            out[pkg, streamed] = sess.read_parquet(str(d)).agg(s=("x", "sum"), sd=("x", "stddev_samp")).collect()
    _assert_same_batch(out[ht, True], out[hst, True])
    _assert_same_batch(out[ht, False], out[hst, False])
    assert out[ht, True]["s"][0] == np.inf and out[ht, True]["sd"][0] == 0.0
    assert np.isnan(out[ht, False]["s"][0]) and np.isnan(out[ht, False]["sd"][0])


#: maxGroups -> the spill. The index files come bucket by bucket: ``ik`` 1,
#: then 6, then 2-5 in one file each; so at 3 a chunk holds more groups than
#: that (it is not folded into the partial), at 1 a merge does (the chunk is
#: in the partial handed to the host)
SPILLS = {"chunk": 3, "merge": 1}


@pytest.mark.parametrize("case", sorted(SPILLS))
def test_mid_stream_spill_matches_jax(system, lake, monkeypatch, case):
    """A cardinality spill mid-stream hands the device partial to the host
    fold (``to_partial_frame``) and goes on there: the JAX package's result,
    fallbacks and programs; each chunk counted once."""
    query = lambda f, c: _t(f, c).group_by("ik").agg(**PLAIN)  # noqa: E731
    conf = {"hyperspace.exec.agg.maxGroups": SPILLS[case]}
    ref, ref_lines, ref_falls, ref_ran, _ = _run_agg(hst, system, lake, None, "device", monkeypatch, query, **conf)
    got, lines, falls, ran, q = _run_agg(ht, system, lake, None, "device", monkeypatch, query, **conf)
    _assert_same_batch(got, ref, _float_names(q))
    assert (lines, falls, ran) == (ref_lines, ref_falls, ref_ran)
    assert ("agg", "spill") in falls and ran["grouped-merge"] > 0, (falls, ran)
    full = _run_agg(ht, system, lake, None, "host", monkeypatch, query)[0]
    _assert_same_batch(got, full, _float_names(q))


def test_stream_update_merges_chunks_like_one_pass(system, lake):
    """Two ``GroupedAggStream.update`` calls give the one-pass result over
    the concatenated rows: the groups in first-appearance order across the
    chunks (string keys with different chunk dictionaries included)."""
    from hyperspace_tpu_torch.exec import batch as B

    import pathlib

    sess = ht.Session(conf={}, device="cpu")
    files = sorted(str(p) for p in pathlib.Path(lake["t"]).glob("*.parquet"))
    chunks = [IO.read_parquet_batch([f], None) for f in files[:3]]
    aggs = [(n, fn, c) for n, (c, fn) in PLAIN.items()]
    aggs = [(n, fn, None if c == "*" else c) for n, fn, c in aggs]
    for keys in (["sk"], ["fk", "ik"]):
        stream = A.GroupedAggStream(sess, keys, aggs, max_groups=1 << 20, cap_floor=4)
        for c in chunks:
            stream.update(c)
        one = A.GroupedAggStream(sess, keys, aggs, max_groups=1 << 20, cap_floor=4)
        one.update(B.concat(chunks))
        _assert_same_batch(stream.finalize(), one.finalize(), {n for n, fn, _ in aggs if fn in ("sum", "avg",
                                                                                             "stddev_samp")})


# --------------------------------------------------------------------------
# the grouped-merge program against JAX's
# --------------------------------------------------------------------------

MERGE_SLOTS = [("cntm", None, True), ("cnt", "v", False), ("sum", "v", False), ("sumsq", "v", False),
               ("min", "v", False), ("max", "v", False), ("sum", "q", True), ("min", "q", True),
               ("max", "q", True)]
CAP_IN, CAP_OUT = 64, 128


def _partial_table(rng, n, base, keyspace):
    """One partial table of ``n`` groups padded to CAP_IN: unique keys (an
    int key and a float key with NaN), first-seen rows from ``base`` up,
    and slots holding -0.0, +0.0, NaN and int64 values above 2^53."""
    pairs = rng.choice(len(keyspace), n, replace=False)
    ik = np.array([keyspace[p][0] for p in pairs], dtype=np.int64)
    fk = np.array([keyspace[p][1] for p in pairs], dtype=np.float64)
    fs = np.sort(rng.choice(1000, n, replace=False)).astype(np.int64) + base
    fs = rng.permutation(fs)

    def fl():
        x = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, np.nan]), n)
        return np.where(rng.random(n) < 0.5, np.round(rng.standard_normal(n), 3), x)

    slots = [rng.integers(0, 50, n), rng.integers(0, 50, n), fl(), np.abs(fl()), fl(), fl(),
             rng.integers(-(2**60), 2**60, n), rng.integers(-(2**60), 2**60, n), rng.integers(-(2**60), 2**60, n)]

    def pad(a, fill):
        return np.concatenate([a, np.full(CAP_IN - n, fill, dtype=a.dtype)])

    return ([pad(ik, 0), pad(fk, np.nan)], [pad(s.astype(s.dtype), 0) for s in slots], pad(fs, 2**63 - 1))


def _jax_merge(a, b, n_a, n_b, key_specs):
    import jax
    import jax.numpy as jnp
    from hyperspace_tpu.utils.x64 import ensure_x64

    ensure_x64()
    prog = jax.jit(RD._grouped_merge_program(key_specs, MERGE_SLOTS, CAP_IN, CAP_OUT))
    n_g, fs, keys, slots = prog(tuple(jnp.asarray(k) for k in a[0]), tuple(jnp.asarray(k) for k in b[0]),
                                tuple(jnp.asarray(s) for s in a[1]), tuple(jnp.asarray(s) for s in b[1]),
                                jnp.asarray(a[2]), jnp.asarray(b[2]), np.int64(n_a), np.int64(n_b))
    return int(n_g), np.asarray(fs), [np.asarray(k) for k in keys], [np.asarray(s) for s in slots]


def _torch_merge(a, b, n_a, n_b, key_specs):
    prog = A.grouped_merge_program(key_specs, MERGE_SLOTS, CAP_IN, CAP_OUT)
    t = torch.from_numpy
    n_g, fs, keys, slots = prog(tuple(t(k) for k in a[0]), tuple(t(k) for k in b[0]),
                                tuple(t(s) for s in a[1]), tuple(t(s) for s in b[1]), t(a[2]), t(b[2]), n_a, n_b)
    return n_g, fs.numpy(), [k.numpy() for k in keys], [s.numpy() for s in slots]


def _assert_merge_equal(got, ref):
    n_g, fs, keys, slots = got
    rn, rfs, rkeys, rslots = ref
    assert n_g == rn
    assert fs[:n_g].tobytes() == rfs[:n_g].tobytes()
    for k, rk in zip(keys, rkeys):
        assert k[:n_g].tobytes() == rk[:n_g].tobytes() or np.array_equal(k[:n_g], rk[:n_g], equal_nan=True)
    for (kind, _, _), s, rs in zip(MERGE_SLOTS, slots, rslots):
        assert s.dtype == rs.dtype, kind
        if s.dtype.kind == "f" and kind in ("sum", "sumsq"):
            np.testing.assert_allclose(s[:n_g], rs[:n_g], rtol=FLOAT_RTOL, equal_nan=True, err_msg=kind)
        else:  # exact, -0.0 against +0.0 and NaN included
            assert s[:n_g].tobytes() == rs[:n_g].tobytes(), (kind, s[:n_g], rs[:n_g])


from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), n_a=st.integers(0, CAP_IN), n_b=st.integers(0, CAP_IN))
def test_grouped_merge_program_random(seed, n_a, n_b):
    """``grouped-merge`` equals JAX's ``_grouped_merge_program`` on random
    partial tables (two keys, overlapping groups, empty tables): the group
    count, first-seen rows, keys, counts, int sums, min and max exactly
    (min/max of -0.0 against +0.0 and NaN as XLA gives them), float sums at
    FLOAT_RTOL."""
    rng = np.random.default_rng(seed)
    keyspace = [(i, f) for i in range(-4, 6) for f in (0.5, 1.5, np.nan, -3.0, 2.0, 9.0, 11.0, 13.5)]
    a = _partial_table(rng, n_a, 0, keyspace)
    b = _partial_table(rng, n_b, 1000, keyspace)
    key_specs = (("ik", "i"), ("fk", "f"))
    _assert_merge_equal(_torch_merge(a, b, n_a, n_b, key_specs), _jax_merge(a, b, n_a, n_b, key_specs))


def test_float_segment_fold_matches_xla():
    """Float segment min and max fold as XLA's: -0.0 below +0.0 in either
    order of arrival, a NaN propagates, an empty segment holds +-inf."""
    import jax.numpy as jnp
    from jax import ops as jops

    from hyperspace_tpu.utils.x64 import ensure_x64

    ensure_x64()
    vals = np.array([0.0, -0.0, -0.0, 0.0, np.nan, 1.0, 2.0, -1.0, -0.0, 5.0])
    seg = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4])
    for how, ref_fn in (("amin", jops.segment_min), ("amax", jops.segment_max)):
        ref = np.asarray(ref_fn(jnp.asarray(vals), jnp.asarray(seg), num_segments=6))
        got = A._seg_fold_float(torch.from_numpy(vals), torch.from_numpy(seg), 6, how).numpy()
        assert got.tobytes() == ref.tobytes(), (how, got, ref)


def test_closing_the_iterator_closes_the_executor_stream_at_once(tmp_path, monkeypatch):
    """``to_local_iterator`` closed after one chunk closes the executor's
    stream before ``close()`` returns, so the stream's prefetched decodes
    stop with it. CPython 3.12.3 closes a generator suspended outside a
    try block without releasing its loop's iterator (later 3.12 releases
    do): the stream is closed explicitly, whatever the interpreter."""
    pq.write_table(pa.table({"a": np.arange(10, dtype=np.int64)}), tmp_path / "p.parquet")
    closed = []

    def execute_stream(self, plan):
        try:
            for _ in range(3):
                yield {"a": np.arange(3, dtype=np.int64)}
        finally:
            closed.append(True)

    monkeypatch.setattr(Executor, "execute_stream", execute_stream)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "idx")}, device="cpu")
    it = sess.read_parquet(str(tmp_path)).to_local_iterator()
    assert next(it)["a"].tolist() == [0, 1, 2] and closed == []
    it.close()
    assert closed == [True]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_staged_stream_matches_serial_and_cpu(system, lake):
    """On the card: the pipelined stream, whose columns are staged from the
    pipeline's threads on side streams, gives the serial stream's result
    bit for bit (deterministic algorithms: the float sums add in a fixed
    order) and the CPU port's at FLOAT_RTOL; float min and max of signed
    zeros fold as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's stream phase runs this check on the card")
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for device, pipeline in (("cuda", True), ("cuda", False), ("cpu", True)):
            sess = ht.Session(conf=_conf(ht, system, **AGG_STREAM, **DEVICE,
                                         **{"hyperspace.exec.pipeline.enabled": pipeline}), device=device)
            sess.enable_hyperspace()
            D.clear_device_cache()
            q = AGGS["by_string"]({t: sess.read_parquet(p) for t, p in lake.items()}, ht.col)
            out[device, pipeline] = q.collect()
    finally:
        torch.use_deterministic_algorithms(False)
    _assert_same_batch(out["cuda", True], out["cuda", False])
    _assert_same_batch(out["cuda", True], out["cpu", True], _float_names(q))
    vals = torch.tensor([0.0, -0.0, -0.0, 0.0, float("nan"), 1.0], dtype=torch.float64)
    seg = torch.tensor([0, 0, 1, 1, 2, 2])
    for how in ("amin", "amax"):
        got = A._seg_fold_float(vals.cuda(), seg.cuda(), 4, how).cpu().numpy()
        assert got.tobytes() == A._seg_fold_float(vals, seg, 4, how).numpy().tobytes(), how
