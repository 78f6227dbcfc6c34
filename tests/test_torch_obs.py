"""The port's query profiles, profile history, SLO tracking and plan
fingerprints, held to the JAX package's suites and to the JAX package.

tests/test_obs_serving.py (one disjoint span tree per served request, the
stats event against the registry, Chrome traces), test_obs_history.py (the
P² sketch, ``ProfileHistory`` and its JSONL log, the flight recorder, SLO
burn rates, the server's intelligence hooks, ``Session.estimate_cost``, the
HTTP telemetry endpoint ``obs/export.py``), test_profiler.py (``Session.profile`` writes a trace, here through
``torch.profiler``) and test_plan_fingerprint.py (fingerprints over the
TPC-H corpus, built by the port: ``torch_mirror.port_tpch_env``) run with
the package renamed to the port (tests/torch_mirror.py ``load_cases``), its
sessions the port's on the CPU (``torch_mirror.cpu_port``). The cases at
the end hold the port against the JAX package: the same span names in a
traced ``collect()``'s profile, one ``profile_history.jsonl`` read by
both packages' ``load_history`` to the same estimates, and each package's
telemetry endpoint over one registry content: the same replies, and
``/metrics`` byte-identical to the registry's exposition.

Nothing is left out (``LEFT_OUT`` is empty).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
SOURCES = {
    "test_obs_serving.py": dict(M.CPU_PORT_IMPORT),
    "test_obs_history.py": dict(M.CPU_PORT_IMPORT),
    "test_profiler.py": dict(M.CPU_PORT_IMPORT),
    "test_plan_fingerprint.py": {
        **M.CPU_PORT_IMPORT,
        "from test_tpch_queries import build_tpch_env\n": "from torch_mirror import port_tpch_env as build_tpch_env\n",
    },
}
LEFT_OUT = {}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    """test_profiler.py's session: the port's, on the CPU."""
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: tmp_system_path}, device="cpu")
    ht.set_session(sess)
    yield sess
    ht.set_session(None)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


def test_telemetry_endpoint_raises_not_yet_in_the_port(tmp_path):
    """``hyperspace.obs.http.port`` no longer raises: a server started with
    it serves the telemetry endpoint (``/metrics`` equal to its registry's
    exposition), closes it at shutdown, and without the key starts none."""
    import urllib.request

    sess = ht.Session(conf={ht.keys.OBS_HTTP_PORT: 0}, device="cpu")
    with ht.QueryServer(sess, workers=0) as srv:
        assert srv.telemetry is not None and srv.telemetry.port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.telemetry.port}/metrics", timeout=30) as resp:
            assert resp.status == 200
            assert resp.read().decode("utf-8") == srv.prometheus_text()
    sess.conf.unset(ht.keys.OBS_HTTP_PORT)
    with ht.QueryServer(sess, workers=0) as srv:
        assert srv.telemetry is None


# -- the port against the JAX package ------------------------------------------


def _pair(tmp_path):
    d = tmp_path / "lake"
    d.mkdir()
    rng = np.random.default_rng(3)
    n = 3000
    pq.write_table(pa.table({
        "k": rng.integers(0, 50, n).astype(np.int64),
        "v": np.round(rng.uniform(0, 10, n), 2),
    }), str(d / "part-00000.parquet"))
    conf = {"hyperspace.system.path": str(tmp_path / "idx"), "hyperspace.index.numBuckets": 4,
            "hyperspace.obs.tracing.enabled": True}
    port = ht.Session(conf=dict(conf), device="cpu")
    ref = hst.Session(conf=dict(conf))
    ht.Hyperspace(port).create_index(port.read_parquet(str(d)), ht.CoveringIndexConfig("ik", ["k"], ["v"]))
    for sess in (port, ref):
        sess.read_parquet(str(d)).create_or_replace_temp_view("t")
        sess.enable_hyperspace()
    return port, ref


def _span_names(profile):
    return sorted(sp.name for sp in profile.root.walk())


@pytest.mark.parametrize("text", [
    "SELECT v FROM t WHERE k = 9",
    "SELECT k, sum(v) AS s FROM t WHERE k < 10 GROUP BY k",
    "SELECT k, v FROM t ORDER BY v DESC LIMIT 3",
])
def test_profile_span_names_equal_the_jax_package(tmp_path, text):
    """A traced ``collect()`` leaves a profile whose span tree has the same
    names in both packages (the device programs' events aside, which name
    each package's own programs), the same indexes applied and the same
    rows; the profile folds into ``profile_history`` in both."""
    port, ref = _pair(tmp_path)
    M.same_rows(port.sql(text).collect(), ref.sql(text).collect(), text)
    a, b = port.last_query_profile(), ref.last_query_profile()
    assert a is not None and b is not None and a.error is None and b.error is None
    assert _span_names(a) == _span_names(b), (_span_names(a), _span_names(b))
    assert a.root.name == b.root.name == "query"
    assert a.indexes_applied == b.indexes_applied
    assert port.estimate_cost(text).samples == ref.estimate_cost(text).samples == 1


def _write_history(pkg, path, fps):
    from importlib import import_module

    hist = import_module(f"{pkg}.obs.history").ProfileHistory(persist_path=path)
    rng = np.random.default_rng(5)
    for i, fp in enumerate(fps):
        for _ in range(6 + 3 * i):
            hist.record(fp, float(rng.uniform(0.01, 0.2)), rows=int(rng.integers(1, 100)), error=False, query=fp)
        hist.record(fp, 0.0, error=True, query=fp)
    hist.close()
    return hist


@pytest.mark.parametrize("writer", ["hyperspace_tpu", "hyperspace_tpu_torch"])
def test_history_jsonl_reads_the_same_in_both_packages(tmp_path, writer):
    """A ``profile_history.jsonl`` written by either package loads through
    both packages' ``load_history`` to the same estimates and the same
    snapshot, with the writer's own sample counts (the log keeps latencies
    to the microsecond, so the writer's in-memory estimate differs in its
    last digits)."""
    from hyperspace_tpu.obs.history import load_history as ref_load
    from hyperspace_tpu_torch.obs.history import load_history as port_load

    path = str(tmp_path / "_telemetry" / "profile_history.jsonl")
    fps = ["a" * 40, "b" * 40, "c" * 40]
    wrote = _write_history(writer, path, fps)
    port, ref = port_load(path), ref_load(path)
    for fp in fps:
        got, want = port.estimate_cost(fp), ref.estimate_cost(fp)
        assert (got.latency_s, got.confidence, got.samples) == (want.latency_s, want.confidence, want.samples)
        assert got.samples == wrote.estimate_cost(fp).samples

    def stats(hist):  # the snapshot less its load-time clock readings
        snap = hist.snapshot()
        for e in snap["entries"]:
            e.pop("firstSeen", None), e.pop("lastSeen", None)
        return snap

    assert stats(port) == stats(ref)


@pytest.mark.parametrize("path", ["/metrics", "/statusz", "/nowhere"])
def test_telemetry_endpoint_serves_what_the_jax_package_serves(path):
    """One registry content, put into each package's own registry class and
    served by each package's ``TelemetryEndpoint`` on a loopback port:
    the same status, content type and body for ``/metrics`` (the
    registry's exposition, byte for byte), ``/statusz`` and a 404."""
    import urllib.error
    import urllib.request

    from hyperspace_tpu.obs.export import TelemetryEndpoint as RefEndpoint
    from hyperspace_tpu.obs.metrics import MetricsRegistry as RefRegistry
    from hyperspace_tpu_torch.obs.export import TelemetryEndpoint
    from hyperspace_tpu_torch.obs.metrics import MetricsRegistry

    def fill(reg):
        reg.counter("hs_test_requests_total", "requests", route="a").inc(3)
        reg.counter("hs_test_requests_total", "requests", route='b\\"q').inc()
        reg.gauge("hs_test_depth", "queue depth").set(7.5)
        h = reg.histogram("hs_test_seconds", "latency", program="p")
        for v in (0.001, 0.02, 0.3, 4.0):
            h.observe(v)
        return reg

    def get(endpoint_cls, reg):
        with endpoint_cls(reg, port=0, status_fn=lambda: {"ok": True, "n": 2}) as ep:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{ep.port}{path}", timeout=30) as resp:
                    return resp.status, resp.headers["Content-Type"], resp.read()
            except urllib.error.HTTPError as err:
                return err.code, err.headers["Content-Type"], err.read()

    port_reg, ref_reg = fill(MetricsRegistry()), fill(RefRegistry())
    got, want = get(TelemetryEndpoint, port_reg), get(RefEndpoint, ref_reg)
    assert got == want
    if path == "/metrics":
        assert got[2].decode("utf-8") == port_reg.prometheus_text() == ref_reg.prometheus_text()


# --------------------------------------------------------------------------
# the same metric families on the same queries
# --------------------------------------------------------------------------

_FAMILY_RUN = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
PKG = sys.argv[2]
root = sys.argv[3]
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
if PKG == "hyperspace_tpu":
    import hyperspace_tpu as hs
    make = lambda conf: hs.Session(conf=conf)
else:
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.parallel import mesh as _pm
    _pm.SHARD_COUNT = 8
    make = lambda conf: hs.Session(conf=conf, device="cpu")
from importlib import import_module
REGISTRY = import_module(PKG + ".obs.metrics").REGISTRY

rng = np.random.default_rng(5)
for part in range(4):
    n = 3000
    pq.write_table(pa.table({"k": rng.integers(0, 200, n), "g": rng.integers(0, 9, n),
                             "v": rng.standard_normal(n)}), os.path.join(root, "fact", f"p{part}.parquet"))
pq.write_table(pa.table({"dk": np.arange(200), "label": [f"l{i % 7}" for i in range(200)]}),
               os.path.join(root, "dim", "d.parquet"))
# native decode off in both: a fresh checkout's JAX package builds its
# library in place at first use, racing other test processes
base = {hs.keys.SYSTEM_PATH: os.path.join(root, "sys_" + PKG), hs.keys.TPU_QUERY_DEVICE_MIN_ROWS: 0,
        hs.keys.NUM_BUCKETS: 8, "hyperspace.exec.io.native.enabled": False}
sess = make({**base, hs.keys.PARALLEL_ENABLED: True, hs.keys.PARALLEL_MIN_ROWS: 0})
fact = sess.read_parquet(os.path.join(root, "fact"))
hs.Hyperspace(sess).create_index(fact, hs.CoveringIndexConfig("by_k", ["k"], ["g", "v"]))
sess.enable_hyperspace()
fact.filter(hs.col("k") == 7).select("v").collect()  # the sharded filter
sess = make(base)
sess.enable_hyperspace()
fact = sess.read_parquet(os.path.join(root, "fact"))
fact.filter(hs.col("k") < 50).group_by("g").agg(n=("*", "count"), s=("v", "sum")).collect()
stream = {hs.keys.EXEC_STREAM_AGG_MIN_BYTES: 1, hs.keys.EXEC_STREAM_CHUNK_BYTES: 1}
sess = make({**base, **stream, hs.keys.EXEC_FUSION_ENABLED: True})
fact = sess.read_parquet(os.path.join(root, "fact"))
fact.group_by("g").agg(n=("*", "count"), s=("v", "sum")).collect()
fact.order_by("v", ascending=[False]).limit(10).collect()
sess = make({**base, **stream})
fact = sess.read_parquet(os.path.join(root, "fact"))
fact.order_by("v", "k", ascending=[False, True]).limit(10).collect()
dim = sess.read_parquet(os.path.join(root, "dim"))
list(fact.join(dim, hs.col("k") == hs.col("dk")).select("v", "label").to_local_iterator())
print(json.dumps(sorted(n for n in REGISTRY.snapshot() if n.startswith("hs_"))))
'''


def test_same_metric_families_as_the_jax_package(tmp_path):
    """The same queries (a mesh build and a sharded filter, a device grouped
    aggregate, a fused streamed aggregate and top-k, a streamed top-k, a
    streamed broadcast join), each package in a fresh process on the CPU
    with native decode off (the JAX package would build its library in
    place): both registries then hold the same ``hs_*`` families, but for
    the JAX package's two XLA compile families, which the port never has."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(HERE)
    held = {}
    for pkg in ("hyperspace_tpu", "hyperspace_tpu_torch"):
        root = tmp_path / pkg
        (root / "fact").mkdir(parents=True)
        (root / "dim").mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   OMP_NUM_THREADS="2")
        out = subprocess.run([sys.executable, "-c", _FAMILY_RUN, repo, pkg, str(root)], env=env,
                             capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-3000:]
        held[pkg] = set(json.loads(out.stdout.strip().splitlines()[-1]))
    compile_families = {"hs_xla_compiles_total", "hs_device_compile_seconds_total"}
    assert compile_families <= held["hyperspace_tpu"]
    assert held["hyperspace_tpu_torch"] == held["hyperspace_tpu"] - compile_families
    for family in ("hs_agg_groups_total", "hs_join_broadcast_total", "hs_join_stream_chunks_total",
                   "hs_pipeline_chunks_total", "hs_pipeline_wait_seconds_total", "hs_topk_chunks_total",
                   "hs_topk_merges_total", "hs_topk_merge_seconds_total", "hs_topk_threshold_updates_total",
                   "hs_device_peak_bytes", "hs_mesh_devices", "hs_mesh_sharded_ops_total"):
        assert family in held["hyperspace_tpu_torch"], family
