"""Scan file facts from the index log entry (``exec/executor.py::leaf_file_facts``).

An index scan's (path, mtime, size) per file, the device column cache's key
(``_scan_identity``) and the streamed and broadcast size gates' input, come
from the ``FileInfo``s its log entry committed: index data is written once,
under fresh paths, and every commit stats the files it adds. Source files,
and any file the entry does not record, are still stat'ed: each test counts
the ``os.stat`` calls. On the CPU.
"""

import contextlib
import os
import shutil

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import executor as E  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

GROUPED = "SELECT g, count(*) AS n, sum(v) AS s FROM t WHERE k < 30 GROUP BY g"
COLUMNS = ["k", "v", "g"]
_REAL_STAT = os.stat


def _write_part(data, i: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    n = 1200
    pq.write_table(pa.table({
        "k": rng.integers(0, 40, n).astype(np.int64),
        "v": np.round(rng.uniform(0, 100, n), 3),
        "g": np.array([f"g{j % 5}" for j in range(n)]),
    }), str(data / f"part-{i:05d}.parquet"))


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)


@pytest.fixture()
def lake(tmp_path):
    """A two-file lake, a CPU session with device programs at any row count
    and a covering index ``t_k`` over it; ``view()`` re-reads the lake."""
    data = tmp_path / "lake"
    data.mkdir()
    for i in range(2):
        _write_part(data, i, 100 + i)
    sess = ht.Session(conf={"hyperspace.system.path": str(tmp_path / "idx"), "hyperspace.index.numBuckets": 4,
                            ht.keys.DEVICE_MIN_ROWS: 0}, device="cpu")

    def view():
        sess.read_parquet(str(data)).create_or_replace_temp_view("t")

    view()
    hs = ht.Hyperspace(sess)
    hs.create_index(sess.sql("SELECT * FROM t"), ht.CoveringIndexConfig("t_k", ["k"], ["v", "g"]))
    sess.enable_hyperspace()
    D.clear_device_cache()
    return {"sess": sess, "hs": hs, "data": data, "index_root": str(tmp_path / "idx"), "view": view}


def _entry(env):
    return env["sess"].index_manager.get_index("t_k")


def _index_scan(entry, files=None) -> L.IndexScan:
    return L.IndexScan(entry, COLUMNS, None, files=files)


def _stat_facts(files):
    """The stat sweep the facts replace, as ``_scan_identity`` made it."""
    out = []
    for f in files:
        st = _REAL_STAT(f)
        out.append((f, st.st_mtime_ns, st.st_size))
    return out


@contextlib.contextmanager
def stats_under(monkeypatch, root: str):
    """The paths under ``root`` that ``os.stat`` is called on inside the
    block, in call order."""
    seen = []

    def recording_stat(path, *args, **kwargs):
        name = str(path if isinstance(path, int) else os.fspath(path))
        if name.startswith(root):
            seen.append(name)
        return _REAL_STAT(path, *args, **kwargs)

    monkeypatch.setattr(os, "stat", recording_stat)
    try:
        yield seen
    finally:
        monkeypatch.setattr(os, "stat", _REAL_STAT)


def _rows(batch):
    frame = pd.DataFrame({c: np.asarray(v) for c, v in batch.items()})
    return frame.sort_values("g").reset_index(drop=True)


def _host_reference(data):
    frame = pd.concat([pq.read_table(str(data / f)).to_pandas() for f in sorted(os.listdir(data))])
    frame = frame[frame["k"] < 30]
    out = frame.groupby("g").agg(n=("v", "size"), s=("v", "sum")).reset_index()
    out["n"] = out["n"].astype(np.int64)
    return out.sort_values("g").reset_index(drop=True)


def _same_answer(got, data):
    want = _host_reference(data)
    got = _rows(got)
    assert list(got["g"]) == list(want["g"])
    assert list(got["n"]) == list(want["n"])
    np.testing.assert_allclose(got["s"].to_numpy(float), want["s"].to_numpy(float), rtol=1e-12)


def _append_part(env, i: int) -> None:
    _write_part(env["data"], i, 100 + i)
    env["view"]()


@pytest.mark.parametrize("state", ["built", "refreshed", "optimized"])
def test_entry_facts_equal_the_stat_facts(lake, monkeypatch, state):
    """For an index just built, just refreshed incrementally and just
    optimized, every file's facts from the entry equal its ``os.stat``
    facts, none of its files is stat'ed, and ``_scan_identity`` gives the
    key the stat sweep gave."""
    if state in ("refreshed", "optimized"):
        _append_part(lake, 2)
        lake["hs"].refresh_index("t_k", "incremental")
    if state == "optimized":
        before_files = len(_entry(lake).content.files)
        lake["hs"].optimize_index("t_k")
        assert len(_entry(lake).content.files) < before_files  # the buckets' runs were compacted
    entry = _entry(lake)
    scan = _index_scan(entry)
    assert scan.files and all(f.startswith(lake["index_root"]) for f in scan.files)
    with stats_under(monkeypatch, lake["index_root"]) as stated:
        facts = E.leaf_file_facts(scan)
        key = E._scan_identity(scan)
    assert stated == []
    assert facts == _stat_facts(scan.files)
    assert key == tuple(_stat_facts(scan.files))


def test_warm_served_aggregate_stats_no_index_file(lake, monkeypatch):
    """A warm device aggregate over an index scan, served, stats no
    index file, and its ``stream_gate`` and ``scan_identity`` stages still
    run."""
    sess = lake["sess"]
    with ht.QueryServer(sess, workers=1) as srv:
        srv.query(GROUPED)  # cold: decodes and uploads
        sess.query_stage_seconds.clear()
        with stats_under(monkeypatch, lake["index_root"]) as stated:
            got = srv.submit(GROUPED).result(timeout=60)
    assert stated == []
    assert {"stream_gate", "scan_identity", "agg_program"} <= set(sess.query_stage_seconds)
    _same_answer(got, lake["data"])


@pytest.mark.parametrize("present", [True, False])
def test_a_file_the_entry_does_not_record_is_stated(lake, monkeypatch, tmp_path, present):
    """A scan whose file list holds a file the entry does not record
    stats that file, and only that one; where it cannot be stat'ed, the
    sweep raises, the key is None, and a partial sweep gives that file no
    facts."""
    entry = _entry(lake)
    extra = str(tmp_path / "outside" / "part-extra.parquet")
    if present:
        os.makedirs(os.path.dirname(extra))
        shutil.copy(entry.content.files[0], extra)
    scan = _index_scan(entry, files=list(entry.content.files) + [extra])
    with stats_under(monkeypatch, str(tmp_path)) as stated:
        if present:
            facts = E.leaf_file_facts(scan)
        else:
            with pytest.raises(FileNotFoundError):
                E.leaf_file_facts(scan)
    assert stated == [extra]
    if present:
        assert facts == _stat_facts(scan.files)
        assert E._scan_identity(scan) == tuple(facts)
        return
    assert E._scan_identity(scan) is None
    partial = E.leaf_file_facts(scan, partial=True)
    assert partial[:-1] == _stat_facts(entry.content.files)
    assert partial[-1] == (extra, None, None)


def test_a_refresh_that_rewrites_buckets_changes_the_key(lake):
    """After a full refresh rewrites every bucket, the scan's key
    changes, the device column cache misses (the aggregate uploads again),
    and the answer equals the host reference over the new lake."""
    sess = lake["sess"]
    key = E._scan_identity(_index_scan(_entry(lake)))
    sess.sql(GROUPED).collect()
    sess.query_stage_seconds.clear()
    sess.sql(GROUPED).collect()
    assert "agg_upload" not in sess.query_stage_seconds  # warm: a hit
    _append_part(lake, 2)
    lake["hs"].refresh_index("t_k", "full")
    new_key = E._scan_identity(_index_scan(_entry(lake)))
    assert new_key != key
    assert not {f for f, _, _ in new_key} & {f for f, _, _ in key}  # new version, new paths
    sess.query_stage_seconds.clear()
    got = sess.sql(GROUPED).collect()
    assert "agg_upload" in sess.query_stage_seconds  # a miss: the new files' columns
    _same_answer(got, lake["data"])


def test_streaming_groups_from_the_facts_equal_the_stat_sweeps(lake, monkeypatch):
    """With an ``aggMinBytes`` this index passes, the streamed
    aggregate's gate groups the files from the entry's facts exactly as the
    stat sweeps grouped them, stat'ing none, and the streamed aggregate
    answers as the host does."""
    sess = lake["sess"]
    scan = _index_scan(_entry(lake))
    sizes = [_REAL_STAT(f).st_size for f in scan.files]
    min_bytes, chunk = sum(sizes) // 2, max(sizes) + 1

    def stat_groups():  # the sweeps the facts replace
        groups, cur, cur_bytes = [], [], 0
        for f in scan.files:
            sz = _REAL_STAT(f).st_size
            if cur and cur_bytes + sz > chunk:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(f)
            cur_bytes += sz
        return groups + [cur] if cur else groups

    want = stat_groups()
    assert len(want) >= 2
    with stats_under(monkeypatch, lake["index_root"]) as stated:
        assert E._streaming_groups(scan, min_bytes, chunk) == want
        assert E._streaming_groups(scan, sum(sizes) + 1, chunk) is None  # under the gate
    assert stated == []
    sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, min_bytes)
    sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, chunk)
    with trace.recording() as events:
        got = sess.sql(GROUPED).collect()
    assert ("agg", "streamed-partial") in events, trace.summarize(events)
    _same_answer(got, lake["data"])


@pytest.mark.parametrize("kind", ["FileScan", "Scan"])
def test_source_leaves_still_stat(lake, monkeypatch, kind):
    """A ``FileScan`` and a relation ``Scan`` read source files, which
    can change in place: each of their files is stat'ed, and the facts are
    the stat's."""
    data = lake["data"]
    files = sorted(str(data / f) for f in os.listdir(data))
    if kind == "FileScan":
        leaf = L.FileScan(files, "parquet", COLUMNS)
    else:
        leaf = lake["sess"].read_parquet(str(data)).plan
        assert isinstance(leaf, L.Scan)
    with stats_under(monkeypatch, str(data)) as stated:
        facts = E.leaf_file_facts(leaf)
    assert sorted(set(stated)) == files  # a relation's listing stats them too
    assert sorted(facts) == _stat_facts(files)
