"""The port's query profiles, profile history, SLO tracking and plan
fingerprints, held to the JAX package's suites and to the JAX package.

tests/test_obs_serving.py (one disjoint span tree per served request, the
stats event against the registry, Chrome traces), test_obs_history.py (the
P² sketch, ``ProfileHistory`` and its JSONL log, the flight recorder, SLO
burn rates, the server's intelligence hooks, ``Session.estimate_cost``),
test_profiler.py (``Session.profile`` writes a trace, here through
``torch.profiler``) and test_plan_fingerprint.py (fingerprints over the
TPC-H corpus, built by the port: ``torch_mirror.port_tpch_env``) run with
the package renamed to the port (tests/torch_mirror.py ``load_cases``), its
sessions the port's on the CPU (``torch_mirror.cpu_port``). The cases at
the end hold the port against the JAX package: the same span names in a
traced ``collect()``'s profile, and one ``profile_history.jsonl`` read by
both packages' ``load_history`` to the same estimates.

Left out, each with its reason (``LEFT_OUT``): test_obs_history.py's five
cases of the HTTP telemetry endpoint (``obs/export.py``), which the port
does not have yet (ROADMAP A9).
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
_EXPORT = "ROADMAP A9: the telemetry endpoint (obs/export.py) is not in the port"
SOURCES = {
    "test_obs_serving.py": dict(M.CPU_PORT_IMPORT),
    "test_obs_history.py": {
        **M.CPU_PORT_IMPORT,
        "from hyperspace_tpu_torch.obs.export import PROMETHEUS_CONTENT_TYPE, TelemetryEndpoint\n": "",
    },
    "test_profiler.py": dict(M.CPU_PORT_IMPORT),
    "test_plan_fingerprint.py": {
        **M.CPU_PORT_IMPORT,
        "from test_tpch_queries import build_tpch_env\n": "from torch_mirror import port_tpch_env as build_tpch_env\n",
    },
}
LEFT_OUT = {
    "test_endpoint_metrics_byte_identical_to_registry": _EXPORT,
    "test_endpoint_statusz_and_404": _EXPORT,
    "test_endpoint_profilez_overview_and_drilldown": _EXPORT,
    "test_endpoint_profilez_404_when_history_disabled": _EXPORT,
    "test_server_telemetry_endpoint_end_to_end": _EXPORT,
}

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
    """``hyperspace.obs.http.port`` is the one key of a server the port does
    not serve: starting a server with it set raises, and without it the
    server starts."""
    sess = ht.Session(conf={ht.keys.OBS_HTTP_PORT: 0}, device="cpu")
    srv = ht.QueryServer(sess, workers=0)
    with pytest.raises(NotImplementedError, match="not yet in the port"):
        srv.start()
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
