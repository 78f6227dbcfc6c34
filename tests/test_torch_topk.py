"""ORDER BY ... LIMIT through the port, against the JAX package.

The shapes of tests/test_topk.py (its lake: NaN floats, None strings,
low-cardinality tie keys; its key sets, limits and gates), each run through
both packages over the same files from one numpy seed:

- the streaming device top-k (``topk: device-topk-stream``; the
  ``topk-chunk`` and ``topk-merge`` programs as torch programs on the CPU)
  gives the JAX package's rows, byte for byte and in order, and the host
  sort and slice's (``hyperspace.exec.topk.enabled=false``);
- the sorted-run merge over a covering index (``sort: index-order-merge``
  and ``-limit``) and its refusal reason (``sort: merge-why-not: ...``);
- the running threshold prunes row groups of later chunks without
  changing a row, and ``thresholdPushdown=false`` gives the same rows;
- a bare Limit streamed through ``to_local_iterator`` stops decoding and
  cancels the queued decodes;
- ``topk_chunk_fn`` and ``topk_merge_fn`` equal ``np.lexsort`` exactly.

Where the JAX package's own test fails (ROADMAP C: its pandas oracle turns
None into NaN in string columns, ``test_limit_above_max_k_falls_back`` and
the host-order cases), the rows are held to the JAX package's and to that
oracle with None and NaN taken as one missing value.

The serving batcher's top-k cap (``TestServingBatcherTopk``'s shape) runs
in both packages' ``execute_shared_scan`` and equals each request's own
``collect()``. Left out, each with the ROADMAP item that ports what it
needs: ``TestShardedTopk`` (A10, the sharded select) and
``TestCompileFlatness`` (XLA compiles; torch compiles nothing). The two why-not report cases run here: ``Hyperspace.why_not``
gives the JAX package's report, with its ``Sort elimination:`` section.
"""

import datetime
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.ops import sort as S  # noqa: E402
from hyperspace_tpu_torch.ops.encode import ORDER_PLANE_SENTINEL, order_plane  # noqa: E402
from test_topk import CASES, _oracle, _write_files  # noqa: E402

pytestmark = pytest.mark.torch_port

SENT = np.int64(ORDER_PLANE_SENTINEL)


def _conf(pkg, tmp_path, **conf):
    base = {
        pkg.keys.SYSTEM_PATH: str(tmp_path / "indexes"),
        pkg.keys.NUM_BUCKETS: 8,
        "hyperspace.exec.stream.chunkBytes": 1,  # one file per chunk
    }
    base.update(conf)
    return base


def sessions(tmp_path, **conf):
    """(port session on the CPU, JAX package session) with one conf."""
    return (ht.Session(conf=_conf(ht, tmp_path, **conf), device="cpu"),
            hst.Session(conf=_conf(hst, tmp_path, **conf)))


def run_both(tmp_path, data, build, **conf):
    """``build(session, df)`` -> DataFrame in each package; returns (port rows,
    port trace events, JAX rows, JAX trace events, port session)."""
    port, ref = sessions(tmp_path, **conf)
    with trace.recording() as pev:
        got = build(port, port.read_parquet(data)).collect()
    with ref_trace.recording() as rev:
        want = build(ref, ref.read_parquet(data)).collect()
    return got, pev, want, rev, port


def assert_identical(got, want, what=""):
    assert list(got) == list(want), (what, list(got), list(want))
    for c in want:
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]), err_msg=f"{what}:{c}")
        assert np.asarray(got[c]).dtype == np.asarray(want[c]).dtype, (what, c)


def _missing(x) -> bool:
    return x is None or (isinstance(x, float) and x != x)


def assert_matches_oracle(got, frame):
    """The pandas oracle's rows, None and NaN one missing value (the
    oracle's own string columns come back with NaN for None)."""
    assert set(got) == set(frame.columns)
    for c in frame.columns:
        g, w = np.asarray(got[c]).tolist(), frame[c].to_numpy().tolist()
        assert len(g) == len(w), c
        for x, y in zip(g, w):
            assert x == y or (_missing(x) and _missing(y)), (c, x, y)


def topk_events(events):
    return [d for k, d in events if k == "topk"]


# --------------------------------------------------------------------------
# the streamed top-k against the JAX package, the host sort and the oracle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("keys,asc", CASES, ids=["-".join(k) + str(a) for k, a in CASES])
def test_streamed_topk_matches_jax_and_host(tmp_path, keys, asc):
    data = _write_files(str(tmp_path / "data"))
    D.reset_dispatches()
    got, pev, want, rev, port = run_both(
        tmp_path, data, lambda s, df: df.order_by(*keys, ascending=list(asc)).limit(25))
    assert topk_events(pev) == topk_events(rev) == ["device-topk-stream"]
    assert D.dispatches["topk-chunk"] == 6 and D.dispatches["topk-merge"] == 5, dict(D.dispatches)
    assert_identical(got, want, "port vs jax")
    port.conf.set(ht.keys.EXEC_TOPK_ENABLED, False)
    with trace.recording() as hev:
        host = port.read_parquet(data).order_by(*keys, ascending=list(asc)).limit(25).collect()
    assert not topk_events(hev)
    assert_identical(got, host, "device vs host sort")
    assert_matches_oracle(got, _oracle(port.read_parquet(data).collect(), keys, asc, 25))


def test_stable_ties_match_input_order(tmp_path):
    """grp has 5 values over 4800 rows: the limit spans whole tie groups,
    and the row-id plane must give the stable host order."""
    data = _write_files(str(tmp_path / "data"))
    got, pev, want, _, port = run_both(tmp_path, data, lambda s, df: df.order_by("grp").limit(1200))
    assert topk_events(pev) == ["device-topk-stream"]
    assert_identical(got, want)
    assert_matches_oracle(got, _oracle(port.read_parquet(data).collect(), ("grp",), (True,), 1200))


def test_limit_larger_than_rows(tmp_path):
    data = _write_files(str(tmp_path / "data"), num_files=2, rows_per=100)
    got, _, want, _, port = run_both(tmp_path, data, lambda s, df: df.order_by("k").limit(3000))
    assert len(got["k"]) == 200
    assert_identical(got, want)
    assert_matches_oracle(got, _oracle(port.read_parquet(data).collect(), ("k",), (True,), 3000))


def _typed_lake(d):
    """Date keys with NaT, floats with NaN, -0.0 and +-inf, strings with
    None, over four files."""
    os.makedirs(d)
    rng = np.random.default_rng(31)
    for i in range(4):
        n = 300
        f = np.round(rng.uniform(-5, 5, n), 1)
        f[rng.choice(n, 30, replace=False)] = rng.choice([np.nan, -0.0, 0.0, np.inf, -np.inf], 30)
        day = rng.integers(0, 400, n)
        dt = np.array([datetime.date(1995, 1, 1) + datetime.timedelta(days=int(x)) for x in day], dtype=object)
        dt[rng.choice(n, 10, replace=False)] = None
        s = np.array([f"s{x:03d}" for x in rng.integers(0, 50, n)], dtype=object)
        s[rng.choice(n, 12, replace=False)] = None
        pq.write_table(pa.table({"f": f, "d": pa.array(list(dt), type=pa.date32()), "s": s,
                                 "i": rng.integers(-3, 3, n)}), os.path.join(d, f"part-{i}.parquet"))
    return d


TYPED_CASES = [
    (("d",), (True,)), (("d",), (False,)), (("f",), (True,)), (("f", "i"), (False, True)),
    (("s", "d"), (False, True)), (("i", "f"), (True, False)),
]


@pytest.mark.parametrize("keys,asc", TYPED_CASES, ids=["-".join(k) + str(a) for k, a in TYPED_CASES])
def test_typed_keys_match_jax_and_host(tmp_path, keys, asc):
    data = _typed_lake(str(tmp_path / "typed"))
    got, pev, want, rev, port = run_both(
        tmp_path, data, lambda s, df: df.order_by(*keys, ascending=list(asc)).limit(70))
    assert topk_events(pev) == topk_events(rev) == ["device-topk-stream"]
    assert_identical(got, want)
    port.conf.set(ht.keys.EXEC_TOPK_ENABLED, False)
    assert_identical(got, port.read_parquet(data).order_by(*keys, ascending=list(asc)).limit(70).collect())


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("key", ["v", "name"])
def test_host_sort_nulls_last_stable(tmp_path, key, asc):
    """The host Sort the device path must reproduce: NULLS LAST in both
    directions, ties stable in input order."""
    data = _write_files(str(tmp_path / "data"), num_files=2, rows_per=400)
    got, _, want, _, port = run_both(tmp_path, data, lambda s, df: df.order_by(key, ascending=[asc]),
                                     **{"hyperspace.exec.topk.enabled": False})
    assert_identical(got, want)
    raw = port.read_parquet(data).collect()
    assert_matches_oracle(got, _oracle(raw, (key,), (asc,), len(raw[key])))
    n_missing = sum(_missing(x) for x in raw[key].tolist())
    assert n_missing > 0 and all(_missing(x) for x in got[key].tolist()[-n_missing:])


# --------------------------------------------------------------------------
# sort elimination over a covering index
# --------------------------------------------------------------------------


def _indexed(tmp_path):
    data = _write_files(str(tmp_path / "data"))
    port, ref = sessions(tmp_path)
    ht.Hyperspace(port).create_index(port.read_parquet(data), ht.CoveringIndexConfig("ordIdx", ["k"], ["v", "grp"]))
    port.enable_hyperspace()
    ref.enable_hyperspace()
    return data, port, ref


@pytest.mark.parametrize("limit", [None, 17])
def test_covered_order_merges_sorted_runs(tmp_path, limit):
    data, port, ref = _indexed(tmp_path)

    def build(pkg, s):
        q = s.read_parquet(data).filter(pkg.col("k") > 50).select("k", "v").order_by("k")
        return q if limit is None else q.limit(limit)

    with trace.recording() as pev:
        got = build(ht, port).collect()
    with ref_trace.recording() as rev:
        want = build(hst, ref).collect()
    sort_lines = [d for k, d in pev if k == "sort"]
    assert sort_lines == [d for k, d in rev if k == "sort"]
    assert sort_lines == (["index-order-merge"] if limit is None else ["index-order-merge-limit"])
    assert_identical(got, want)
    port.disable_hyperspace()
    assert_identical(got, build(ht, port).collect(), "index vs off")


def test_descending_order_records_why_not(tmp_path):
    data, port, ref = _indexed(tmp_path)
    with trace.recording() as pev:
        got = port.read_parquet(data).filter(ht.col("k") > 50).select("k", "v").order_by(
            "k", ascending=[False]).collect()
    with ref_trace.recording() as rev:
        want = ref.read_parquet(data).filter(hst.col("k") > 50).select("k", "v").order_by(
            "k", ascending=[False]).collect()
    reasons = [d for k, d in pev if k == "sort" and d.startswith("merge-why-not")]
    assert reasons == [d for k, d in rev if k == "sort" and d.startswith("merge-why-not")]
    assert reasons and "cannot ride the ascending index order" in reasons[0]
    assert_identical(got, want)


@pytest.mark.parametrize("ascending, verdict", [
    (False, "cannot ride the ascending index order"),
    (True, "eliminated — streamed merge of sorted index runs"),
])
def test_why_not_reports_sort_elimination(tmp_path, ascending, verdict):
    """tests/test_topk.py::TestSortElimination's two why-not cases
    (``test_descending_refusal_reason_and_why_not``,
    ``test_eliminated_sort_reported_in_why_not``): the port's report equals
    the JAX package's and names the Sort's verdict."""
    data, port, ref = _indexed(tmp_path)
    text = {}
    for pkg, s in ((ht, port), (hst, ref)):
        q = s.read_parquet(data).filter(pkg.col("k") > 50).select("k", "v").order_by("k", ascending=[ascending])
        text[pkg] = pkg.Hyperspace(s).why_not(q, "ordIdx")
    assert text[ht] == text[hst]
    assert "Sort elimination:" in text[ht] and verdict in text[ht], text[ht]


# --------------------------------------------------------------------------
# the running threshold in row-group pruning
# --------------------------------------------------------------------------


def _sorted_lake(d):
    """Six files with disjoint ascending k ranges in 250-row groups."""
    os.makedirs(d)
    for i in range(6):
        k = np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64)
        pq.write_table(pa.table({"k": k, "v": k.astype(np.float64) / 3}), os.path.join(d, f"part-{i:05d}.parquet"),
                       row_group_size=250)
    return d


@pytest.mark.parametrize("pushdown", [True, False])
def test_threshold_prunes_row_groups_without_changing_rows(tmp_path, monkeypatch, pushdown):
    """After file 0 the threshold is k <= 9, so every row group of the other
    five files (four each) is provably above it (serial decode: prefetch
    would decode a few chunks before the first threshold)."""
    from hyperspace_tpu_torch.exec import io as IO

    data = _sorted_lake(str(tmp_path / "data"))
    kept = []
    real = IO.prune_row_groups

    def spy(path, predicate):
        got = real(path, predicate)
        kept.append(4 if got is None else len(got))
        return got

    monkeypatch.setattr(IO, "prune_row_groups", spy)
    conf = {"hyperspace.exec.pipeline.enabled": False, "hyperspace.exec.topk.thresholdPushdown": pushdown}
    got, pev, want, _, _ = run_both(tmp_path, data, lambda s, df: df.order_by("k").limit(10), **conf)
    assert topk_events(pev) == ["device-topk-stream"]
    skipped = 4 * len(kept) - sum(kept)
    assert (skipped >= 20) if pushdown else (skipped == 0), kept
    np.testing.assert_array_equal(got["k"], np.arange(10, dtype=np.int64))
    assert_identical(got, want)


def test_threshold_condition_keeps_ties(tmp_path):
    """The pushed threshold is ``<=`` ascending and ``>=`` descending on the
    primary key only, so a row that ties the k-th candidate survives."""
    from hyperspace_tpu_torch.exec.topk import TopKStream

    port, _ = sessions(tmp_path)
    for asc, op in ((True, "<="), (False, ">=")):
        st = TopKStream(port, [("k", asc), ("v", True)], 3)
        st.update({"k": np.array([5, 5, 5, 1, 9], dtype=np.int64), "v": np.arange(5.0)})
        cond = st.threshold_condition()
        assert (cond.op, cond.left.name, cond.right.value) == (op, "k", 5)


# --------------------------------------------------------------------------
# the bare Limit, streamed
# --------------------------------------------------------------------------


def test_bare_limit_stops_decoding_and_cancels_queued(tmp_path, monkeypatch):
    """A bare LIMIT met by the first chunks decodes no more than the
    pipeline had started, and closing the pipeline cancels the queued
    decodes."""
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.exec.pipeline import ScanPipeline

    data = _write_files(str(tmp_path / "data"), num_files=10, rows_per=500)
    port, _ = sessions(tmp_path, **{"hyperspace.exec.pipeline.depth": 10})
    calls, lock = [], threading.Lock()
    real = IO.read_parquet_batch

    def slow(files, columns, predicate=None):
        with lock:
            calls.append(list(files))
        time.sleep(0.15)  # keep later futures queued behind the pool
        return real(files, columns, predicate=predicate)

    cancelled = []
    real_close = ScanPipeline.close

    def close(self):
        real_close(self)
        cancelled.append(sum(f.cancelled() for f in self._futures if f is not None))

    monkeypatch.setattr(IO, "read_parquet_batch", slow)
    monkeypatch.setattr(ScanPipeline, "close", close)
    with trace.recording() as events:
        chunks = list(port.read_parquet(data).limit(700).to_local_iterator())
    assert ("limit", "early-stop-stream") in events
    assert sum(len(b["k"]) for b in chunks) == 700
    assert len(calls) < 10
    assert sum(cancelled) > 0


def test_streamed_limit_rows_match_jax_and_materialized(tmp_path):
    from hyperspace_tpu.exec.executor import Executor as RefExecutor
    from hyperspace_tpu_torch.exec.executor import Executor

    data = _write_files(str(tmp_path / "data"))
    port, ref = sessions(tmp_path)
    chunks = list(Executor(port).execute_stream(port.read_parquet(data).limit(1500).optimized_plan()))
    rchunks = list(RefExecutor(ref).execute_stream(ref.read_parquet(data).limit(1500).optimized_plan()))
    assert [len(c["k"]) for c in chunks] == [len(c["k"]) for c in rchunks]
    got = {c: np.concatenate([np.asarray(b[c]) for b in chunks]) for c in chunks[0]}
    assert_identical(got, {c: np.concatenate([np.asarray(b[c]) for b in rchunks]) for c in rchunks[0]})
    raw = port.read_parquet(data).collect()
    assert_identical(got, {c: np.asarray(v)[:1500] for c, v in raw.items()})
    assert_identical(port.read_parquet(data).limit(1500).collect(), got)


def test_order_by_limit_streams_one_batch(tmp_path):
    from hyperspace_tpu_torch.exec.executor import Executor

    data = _write_files(str(tmp_path / "data"))
    port, _ = sessions(tmp_path)
    q = port.read_parquet(data).order_by("v", "k", ascending=[False, True]).limit(40)
    with trace.recording() as events:
        chunks = list(Executor(port).execute_stream(q.optimized_plan()))
    assert len(chunks) == 1 and topk_events(events) == ["device-topk-stream"]
    assert_identical(chunks[0], q.collect())


# --------------------------------------------------------------------------
# gates and fallbacks
# --------------------------------------------------------------------------


def test_disabled_falls_back_to_host_sort(tmp_path):
    data = _write_files(str(tmp_path / "data"))
    got, pev, want, rev, port = run_both(tmp_path, data, lambda s, df: df.order_by("k").limit(9),
                                         **{"hyperspace.exec.topk.enabled": False})
    assert not topk_events(pev) and not topk_events(rev)
    assert_identical(got, want)
    assert_matches_oracle(got, _oracle(port.read_parquet(data).collect(), ("k",), (True,), 9))


def test_limit_above_max_k_falls_back(tmp_path):
    data = _write_files(str(tmp_path / "data"))
    got, pev, want, _, port = run_both(tmp_path, data, lambda s, df: df.order_by("k").limit(50),
                                       **{"hyperspace.exec.topk.maxK": 8})
    assert "device-topk-stream" not in topk_events(pev)
    assert_identical(got, want)
    assert_matches_oracle(got, _oracle(port.read_parquet(data).collect(), ("k",), (True,), 50))


def test_midstream_refusal_takes_the_host_candidates(tmp_path, monkeypatch):
    """A chunk the fold refuses hands the candidate pool and the rest of the
    stream to the host sort: ``topk: host-candidate-fallback``, the same
    rows."""
    from hyperspace_tpu_torch.exec.topk import TopKStream

    data = _write_files(str(tmp_path / "data"))
    port, _ = sessions(tmp_path)
    real = TopKStream.update

    def update(self, batch):
        if self.chunks == 3:
            raise D.DeviceUnsupported("refused")
        return real(self, batch)

    monkeypatch.setattr(TopKStream, "update", update)
    q = port.read_parquet(data).order_by("name", "v", ascending=[False, True]).limit(33)
    with trace.recording() as events:
        got = q.collect()
    assert topk_events(events) == ["host-candidate-fallback"]
    port.conf.set(ht.keys.EXEC_TOPK_ENABLED, False)
    assert_identical(got, q.collect())


@pytest.mark.parametrize("key", ["parallel", "fusion"])
def test_sharded_and_fused_folds(tmp_path, key, monkeypatch):
    """The sharded select (``parallel``, an 8-shard CPU mesh): the port's
    rows equal the JAX package's and the port's single-device run, through
    ``sharded-topk`` programs. The JAX package's own sharded select fails
    on this JAX (its ``shard_map`` takes no ``check_rep``, ROADMAP §C) and
    falls back to its host sort, so only the rows are compared with it. The
    fused fold: the port's rows equal the JAX package's fused run and the
    port's fusion-off run, with as many ``fused-stage-topk`` dispatches as
    the JAX package's.

    Both packages run the fused case with the scan pipeline off. With it
    on, the chunks that reach the fold depend on whether a prefetched
    chunk's decode starts before or after the fold has tightened the
    running k-th-value threshold that prunes its row groups (4 chunks on
    an idle host, 3 when the prefetch pool starts the fourth chunk late),
    and each package runs its own race. Serial, each chunk is pruned by
    the threshold of every chunk before it, in both packages alike."""
    data = _write_files(str(tmp_path / "data"))
    if key == "parallel":
        from hyperspace_tpu_torch.parallel import mesh as PM

        monkeypatch.setattr(PM, "SHARD_COUNT", 8)
        build = lambda s, df: df.order_by("v", "k", ascending=[False, True]).limit(30)  # noqa: E731
        before = D.dispatches["sharded-topk"]
        got, pev, want, rev, port = run_both(tmp_path, data, build, **{"hyperspace.parallel.enabled": True})
        assert D.dispatches["sharded-topk"] > before
        assert topk_events(pev) == ["device-topk-stream-sharded"], topk_events(pev)
        assert_identical(got, want)
        port.conf.set("hyperspace.parallel.enabled", False)
        assert_identical(got, build(port, port.read_parquet(data)).collect())
        return
    from hyperspace_tpu.obs.metrics import REGISTRY

    fused = REGISTRY.counter("hs_device_dispatches_total", "", program="fused-stage-topk")
    build = lambda s, df: df.order_by("k").limit(5)  # noqa: E731
    before, ref_before = D.dispatches["fused-stage-topk"], fused.value
    got, pev, want, rev, port = run_both(tmp_path, data, build, **{"hyperspace.exec.fusion.enabled": True,
                                                                     "hyperspace.exec.pipeline.enabled": False})
    assert D.dispatches["fused-stage-topk"] - before == fused.value - ref_before > 0
    assert topk_events(pev) == topk_events(rev) == ["device-topk-stream"]
    assert_identical(got, want)
    port.conf.set(ht.keys.EXEC_FUSION_ENABLED, False)
    assert_identical(got, build(port, port.read_parquet(data)).collect())


# --------------------------------------------------------------------------
# the programs against np.lexsort
# --------------------------------------------------------------------------


def _plain_topk(mat: np.ndarray, cap: int) -> np.ndarray:
    """np.lexsort over the planes (the first plane most significant), then
    the first ``cap`` columns, sentinel-extended."""
    order = np.lexsort(mat[::-1])
    out = mat[:, order][:, :cap]
    if out.shape[1] < cap:
        out = np.concatenate([out, np.full((mat.shape[0], cap - out.shape[1]), SENT)], axis=1)
    return out


def _planes(rng, n_keys, n, pad):
    keys = [rng.integers(-4, 4, n).astype(np.int64) for _ in range(n_keys)]
    keys[0][rng.random(n) < 0.1] = SENT  # missing values
    mat = np.stack(keys + [np.arange(n, dtype=np.int64) + 1000])
    return np.concatenate([mat, np.full((n_keys + 1, pad), SENT)], axis=1)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
@pytest.mark.parametrize("cap", [1, 64, 300, 1000])
def test_topk_programs_equal_lexsort(n_keys, cap):
    rng = np.random.default_rng(n_keys * 100 + cap)
    a = _planes(rng, n_keys, 500, 20)
    b = _planes(rng, n_keys, 380, 0)
    b[-1] += 5000  # row ids of a later chunk
    chunk = S.topk_chunk_fn(n_keys, cap)
    got_a = chunk(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got_a, _plain_topk(a, cap))
    got_b = chunk(torch.from_numpy(b)).numpy()
    merged = S.topk_merge_fn(n_keys, cap)(torch.from_numpy(got_a), torch.from_numpy(got_b)).numpy()
    np.testing.assert_array_equal(merged, _plain_topk(np.concatenate([got_a, got_b], axis=1), cap))
    np.testing.assert_array_equal(merged, _plain_topk(np.concatenate([a, b], axis=1), cap))


def test_order_plane_matches_reference():
    from hyperspace_tpu.ops.encode import order_plane as ref_order_plane

    rng = np.random.default_rng(5)
    f = rng.standard_normal(200)
    f[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
    cols = [rng.integers(-9, 9, 200), f, np.array([None, "b", "a"] * 66 + ["c", None], dtype=object),
            np.arange(200).astype("datetime64[D]"), rng.integers(0, 9, 200).astype(np.uint64)]
    for c in cols:
        for asc in (True, False):
            np.testing.assert_array_equal(order_plane(c, asc), ref_order_plane(c, asc))


def test_serving_batcher_applies_the_topk_cap(tmp_path):
    """``tests/test_topk.py::TestServingBatcherTopk`` in both packages: an
    ``ORDER BY ... LIMIT`` template decomposes with a ``topk`` cap, and one
    shared scan serves three literal variants, each equal to its own
    ``collect()`` and to the JAX package's shared scan, row for row."""
    from hyperspace_tpu.serving.batcher import execute_shared_scan as ref_shared
    from hyperspace_tpu.serving.batcher import shared_scan_ops as ref_ops
    from hyperspace_tpu_torch.serving.batcher import execute_shared_scan, shared_scan_ops

    rng = np.random.default_rng(5)
    n = 2000
    pq.write_table(pa.table({"k": rng.integers(0, 500, n).astype(np.int64), "v": rng.standard_normal(n)}),
                   str(tmp_path / "t.parquet"))
    port, ref = sessions(tmp_path)
    for sess in (port, ref):
        sess.read_parquet(str(tmp_path / "t.parquet")).create_or_replace_temp_view("t")
    sql = "SELECT k, v FROM t WHERE k > {lo} ORDER BY k, v LIMIT 20"
    los = (100, 5, 400)
    outs = []
    for sess, ops_of, shared in ((port, shared_scan_ops, execute_shared_scan), (ref, ref_ops, ref_shared)):
        ops, leaf = ops_of(sess.sql(sql.format(lo=100)).plan)
        assert ops[0][0] == "topk"
        outs.append(shared(sess, ops, leaf, [sess.sql(sql.format(lo=lo)).plan for lo in los]))
    for lo, got, want in zip(los, *outs):
        own = port.sql(sql.format(lo=lo)).collect()
        for c in own:
            np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(own[c]), err_msg=f"{lo}:{c}")
            np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]), err_msg=f"{lo}:{c}")
