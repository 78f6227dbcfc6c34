"""The reference API surface of the port, and its repairs of the port's open
faults, each held against the JAX package.

- tests/test_reference_api_compat.py (the camelCase facade and
  ``CoveringIndexConfig.builder()``) and tests/test_log_manager.py (with
  ``IndexLogManager.get_index_versions``) run with the package renamed to
  the port (tests/torch_mirror.py): every query's plan and rows equal the
  JAX package's.
- The index-log cache reads ``hyperspace.index.cache.expiryDurationInSeconds``
  on every lookup: 0 re-reads the roster.
- Every ``hyperspace_tpu.config.keys`` name whose string the port has
  resolves to the same string, and ``HyperspaceConf.unset`` drops a key.
- Under ``hyperspace.parallel.enabled``, below ``hyperspace.parallel.minRows``
  rows, the filter, the aggregate and the build run on one device with the
  JAX package's rows and trace; at ``minRows=0`` they run sharded over an
  8-shard CPU mesh (the build over a 4-shard one), with the same rows.
- Every lifecycle action runs with hyperspace disabled: over a DataFrame that
  another index covers, it reads the source, not that index.
"""

import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.indexes import covering  # noqa: E402
from hyperspace_tpu_torch.parallel import mesh as PM  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
LEFT_OUT: dict = {}

_entry_cases = M.load_cases(os.path.join(HERE, "test_log_entry.py"), "_torch_test_log_entry_cases")
_modules = [
    M.load_cases(os.path.join(HERE, "test_reference_api_compat.py"), "_torch_test_reference_api_compat_cases"),
    M.load_cases(
        os.path.join(HERE, "test_log_manager.py"),
        "_torch_test_log_manager_cases",
        rewrites={"from tests.test_log_entry import make_entry": "from _torch_test_log_entry_cases import make_entry"},
    ),
]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    sess = M.MirroredSession(tmp_system_path, compare_traces=True)
    ht.set_session(sess)
    with M.mirroring():
        yield sess
    ht.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


# --- the lake the repairs are held on ---------------------------------------


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """Three files, 1500 rows: an int key ``k``, a float ``v``, a string ``s``."""
    root = tmp_path_factory.mktemp("api_lake")
    rng = np.random.default_rng(31)
    for i in range(3):
        pq.write_table(pa.table({
            "k": rng.integers(0, 40, 500).astype(np.int64),
            "v": np.round(rng.standard_normal(500), 3),
            "s": np.array([f"s{x}" for x in rng.integers(0, 9, 500)]),
        }), root / f"part-{i:05d}.parquet")
    return str(root)


def _sessions(system_path, **conf):
    conf = {"hyperspace.system.path": system_path, "hyperspace.index.numBuckets": 4, **conf}
    return hst.Session(conf=dict(conf)), ht.Session(conf=dict(conf), device="cpu")


def _rows(batch):
    return sorted(zip(*[np.asarray(batch[k]).tolist() for k in sorted(batch)]))


def _lines(rec, events):
    return [ln for ln in rec.summarize(events).splitlines() if not ln.startswith("decode:")]


# --- C4: the cache expiry is read on every lookup ----------------------------


def test_cache_expiry_zero_refetches_roster(lake, tmp_path):
    import shutil

    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "sys"), ht.keys.NUM_BUCKETS: 2}, device="cpu")
    hs = ht.Hyperspace(sess)
    hs.create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("ttl", ["k"], ["v"]))
    mgr = sess.index_manager
    assert [e.name for e in mgr.get_indexes()] == ["ttl"]
    shutil.rmtree(str(tmp_path / "sys" / "ttl"))
    assert [e.name for e in mgr.get_indexes()] == ["ttl"]  # within the default 300 s
    sess.conf.set(ht.keys.CACHE_EXPIRY_SECONDS, 0)
    assert mgr.get_indexes() == []
    sess.conf.unset(ht.keys.CACHE_EXPIRY_SECONDS)
    assert sess.conf.cache_expiry_seconds == 300


# --- C5: the JAX package's key names, and unset ------------------------------


def test_reference_key_names_resolve():
    ref = {k: v for k, v in vars(hst.keys).items() if k.isupper()}
    port = {k: v for k, v in vars(ht.keys).items() if k.isupper()}
    shared = {k: v for k, v in ref.items() if v in set(port.values())}
    assert len(shared) >= 40
    for name, string in shared.items():
        assert getattr(ht.keys, name, None) == string, name
    for name in ("TPU_QUERY_DEVICE_MIN_ROWS", "TPU_BUILD_BATCH_ROWS", "TPU_JOIN_DEVICE_SPAN_MAX_BYTES",
                 "EXEC_STREAM_CHUNK_BYTES", "EXEC_AGG_DEVICE_GROUPED", "EXEC_FUSION_ENABLED",
                 "PARALLEL_MIN_ROWS", "NESTED_COLUMN_ENABLED", "CACHE_EXPIRY_SECONDS", "DISPLAY_MODE"):
        assert name in shared, name
    for name in ("PARALLEL_MIN_ROWS", "PARALLEL_BUILD_ENABLED", "PARALLEL_MESH_DEVICES",
                 "TPU_BUILD_DISTRIBUTED_MIN_ROWS", "NESTED_COLUMN_ENABLED", "CACHE_EXPIRY_SECONDS",
                 "DISPLAY_MODE", "HIGHLIGHT_BEGIN_TAG", "HIGHLIGHT_END_TAG"):
        assert hst.HyperspaceConf().get(ref[name]) == ht.HyperspaceConf().get(ref[name]), name


def test_conf_unset():
    conf = ht.HyperspaceConf({ht.keys.TPU_QUERY_DEVICE_MIN_ROWS: 0})
    assert conf.device_exec_min_rows == 0
    assert conf.unset(ht.keys.TPU_QUERY_DEVICE_MIN_ROWS) is conf
    assert conf.device_exec_min_rows == 1 << 25
    conf.unset("hyperspace.no.such.key")


# --- C3: parallel.enabled below minRows is the single-device path -----------


PARALLEL = {"hyperspace.parallel.enabled": "true", "hyperspace.tpu.query.deviceMinRows": 0}


def _both(system_path, query, **conf):
    """{package: (rows, trace lines)} of ``query`` over the index in both
    packages."""
    out = {}
    for sess, rec in zip(_sessions(system_path, **conf), (ref_trace, trace)):
        sess.enable_hyperspace()
        pkg = hst if isinstance(sess, hst.Session) else ht
        with rec.recording() as ev:
            got = query(sess, pkg)
        out[pkg] = (_rows(got), _lines(rec, ev))
    return out


FILTER = lambda sess, pkg, lake: sess.read_parquet(lake).filter(pkg.col("k") == 7).select("v").collect()  # noqa: E731
AGG = lambda sess, pkg, lake: (  # noqa: E731
    sess.read_parquet(lake).filter(pkg.col("k") < 20).group_by("k").agg(t=("v", "sum"), n=("*", "count")).collect())


@pytest.mark.parametrize("query", ["filter", "aggregate"])
def test_parallel_below_min_rows_runs_single_device(lake, tmp_path, query, monkeypatch):
    fn = {"filter": FILTER, "aggregate": AGG}[query]
    system = str(tmp_path / "sys")
    _, sess = _sessions(system)
    ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("byk", ["k"], ["v"]))
    got = _both(system, lambda s, p: fn(s, p, lake), **PARALLEL)
    plain = _both(system, lambda s, p: fn(s, p, lake), **{"hyperspace.tpu.query.deviceMinRows": 0})
    assert got[ht] == got[hst] == plain[ht]
    want = "filter: device x1" if query == "filter" else "agg: device-grouped-scan x1"
    assert want in got[ht][1], got[ht][1]
    # at minRows 0 the port shards it over its 8-shard CPU mesh, with the
    # single-device rows (the JAX package's sharded filter gives them too;
    # its sharded grouped aggregate fails on this JAX, ROADMAP §C)
    monkeypatch.setattr(PM, "SHARD_COUNT", 8)
    sharded = {**PARALLEL, "hyperspace.parallel.minRows": 0}
    ref, sess = _sessions(system, **sharded)
    sess.enable_hyperspace()
    with trace.recording() as ev:
        port = (_rows(fn(sess, ht, lake)), _lines(trace, ev))
    # float sums add per shard first: rtol 1e-9, the rest exact
    assert len(port[0]) == len(plain[ht][0])
    for a, b in zip(port[0], plain[ht][0]):
        assert all(x == y or (isinstance(x, float) and math.isclose(x, y, rel_tol=1e-9)) for x, y in zip(a, b)), (a, b)
    want = "filter: device-sharded x1" if query == "filter" else "agg: device-grouped-scan x1"
    assert want in port[1], port[1]
    if query == "filter":
        ref.enable_hyperspace()
        with ref_trace.recording() as ev:
            assert (_rows(fn(ref, hst, lake)), _lines(ref_trace, ev)) == port


def test_parallel_build_below_mesh_is_single_device(lake, tmp_path, monkeypatch):
    """On one device (a one-device mesh) the build under parallel.enabled
    writes the JAX package's bucket rows; on a mesh of four shards it runs
    the exchange where the JAX package would build on a mesh, and writes the
    same rows, and the plain build where the gates keep it off."""
    runs = {}
    for owner in ("jax", "torch"):
        sessions = _sessions(str(tmp_path / owner), **{"hyperspace.parallel.enabled": "true"})
        sess = sessions[0] if owner == "jax" else sessions[1]
        pkg = hst if owner == "jax" else ht
        entry = pkg.Hyperspace(sess).create_index(sess.read_parquet(lake), pkg.CoveringIndexConfig("b", ["k"], ["v"]))
        assert entry.state == "ACTIVE"
        by_bucket = {}
        for f in entry.content.files:
            by_bucket.setdefault(covering.bucket_of_file(f), []).extend(pq.read_table(f).to_pylist())
        runs[owner] = {b: sorted(r, key=repr) for b, r in by_bucket.items()}
    assert runs["torch"] == runs["jax"]
    monkeypatch.setattr(PM, "SHARD_COUNT", 4)
    for i, (conf, exchange) in enumerate((({}, True), ({"hyperspace.parallel.build.enabled": "false"}, False),
                                          ({"hyperspace.tpu.build.distributedMinRows": 10**6}, False))):
        _, sess = _sessions(str(tmp_path / f"mesh{i}"), **{"hyperspace.parallel.enabled": "true"}, **conf)
        PM.reset_collectives()
        entry = ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("b", ["k"], ["v"]))
        assert entry.state == "ACTIVE"
        assert (PM.collective_calls[("all_to_all", "buckets")] > 0) == exchange, conf
        by_bucket = {}
        for f in entry.content.files:
            by_bucket.setdefault(covering.bucket_of_file(f), []).extend(pq.read_table(f).to_pylist())
        assert {b: sorted(r, key=repr) for b, r in by_bucket.items()} == runs["jax"], conf


# --- lifecycle actions run with hyperspace disabled --------------------------


def test_lifecycle_actions_read_the_source(lake, tmp_path, monkeypatch):
    """With hyperspace on and an index ``cover`` over the lake, building,
    refreshing and optimizing a second index over the same DataFrame reads
    the source files: no index scan in the dispatch trace, the toggle off
    inside each action (and back on after), and the second index's rows
    equal the source's."""
    import shutil

    src_dir = str(tmp_path / "lake")
    shutil.copytree(lake, src_dir)
    _, sess = _sessions(str(tmp_path / "sys"))
    hs = ht.Hyperspace(sess)
    df = sess.read_parquet(src_dir)
    hs.create_index(df, ht.CoveringIndexConfig("cover", ["k"], ["v", "s"]))
    sess.enable_hyperspace()
    seen = []
    mgr = sess.index_manager
    for action in ("create", "refresh", "optimize"):
        orig = getattr(mgr, action)

        def spy(*a, _orig=orig, **kw):
            seen.append(sess.hyperspace_enabled)
            return _orig(*a, **kw)

        monkeypatch.setattr(mgr, action, spy)
    with trace.recording() as ev:
        hs.createIndex(df, ht.CoveringIndexConfig.builder().indexName("second").indexBy("s").include("k").create())
        pq.write_table(pq.read_table(os.path.join(lake, "part-00000.parquet")).slice(0, 100),
                       os.path.join(src_dir, "part-00003.parquet"))
        hs.refreshIndex("second", "incremental")
        hs.optimizeIndex("second", "full")
    assert seen == [False, False, False] and sess.hyperspace_enabled
    assert not [e for e in ev if e[0] == "scan"], ev
    entry = mgr.get_index("second")
    got = pa.concat_tables([pq.read_table(f) for f in entry.content.files])
    src = pa.concat_tables([pq.read_table(os.path.join(src_dir, f)) for f in sorted(os.listdir(src_dir))])
    assert sorted(zip(got["s"].to_pylist(), got["k"].to_pylist())) == sorted(
        zip(src["s"].to_pylist(), src["k"].to_pylist()))
