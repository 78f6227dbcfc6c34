"""The port's stage clock (``hyperspace_tpu_torch/obs/stages.py``): one
primitive times every stage of a query, adds it to the session's
``query_stage_seconds`` under a lock, charges it to the served requests
bound in the context, and opens an obs span or a ``torch.profiler`` range
only when one is recording. On the CPU."""

import ast
import collections
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu_torch.obs import spans, stages  # noqa: E402

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hyperspace_tpu_torch")
METRICS = os.path.join(REPO, "hsbench", "metrics")

#: the readers this change adds under hsbench/metrics/
NEW_READERS = ("plan_ms", "file_stat_ms", "host_wait_ms", "unattributed_ms")

POINT = "SELECT v, g FROM t WHERE k = {}"
GROUPED = "SELECT g, count(*) AS n, sum(v) AS s FROM t WHERE k < {} GROUP BY g"


class _Session:
    """A session's two stage clocks, nothing else."""

    def __init__(self):
        self.query_stage_seconds = collections.Counter()
        self.build_stage_seconds = collections.Counter()


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)


@pytest.fixture()
def served(tmp_path):
    """A port session on the CPU over a two-file lake and a covering index
    that every query here reads, device programs at any row count."""
    rng = np.random.default_rng(23)
    data = tmp_path / "lake"
    data.mkdir()
    for i in range(2):
        n = 1500
        pq.write_table(pa.table({
            "k": rng.integers(0, 40, n).astype(np.int64),
            "v": np.round(rng.uniform(0, 100, n), 3),
            "g": np.array([f"g{j % 5}" for j in range(n)]),
        }), str(data / f"part-{i:05d}.parquet"))

    def make(**conf):
        sess = ht.Session(conf={"hyperspace.system.path": str(tmp_path / "idx"), "hyperspace.index.numBuckets": 4,
                                ht.keys.DEVICE_MIN_ROWS: 0, **conf}, device="cpu")
        sess.read_parquet(str(data)).create_or_replace_temp_view("t")
        if not os.path.isdir(tmp_path / "idx" / "t_k"):
            ht.Hyperspace(sess).create_index(sess.sql("SELECT * FROM t"),
                                             ht.CoveringIndexConfig("t_k", ["k"], ["v", "g"]))
        sess.enable_hyperspace()
        return sess

    return make


def _serve(sess, texts, warm=True, **server):
    """Serve ``texts`` (all submitted before the first answer is read) on a
    cleared stage clock, after the first two alone (their cold runs) unless
    ``warm`` is false; returns the futures and the server's stats."""
    with ht.QueryServer(sess, **server) as srv:
        for q in texts[:2] if warm else ():
            srv.query(q)
        sess.query_stage_seconds.clear()
        futs = [srv.submit(q) for q in texts]
        for f in futs:
            f.result(timeout=60)
        return futs, srv.stats()


class _YieldingCounter(collections.Counter):
    """A stage clock whose every read gives up the GIL: another thread then
    runs between the read and the write of ``c[k] += x``."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_eight_threads_lose_no_update(monkeypatch):
    """Eight threads time one stage concurrently, each stage exactly 0.5 s
    on a per-thread fake clock, into a clock whose reads yield the GIL: the
    session's key holds every one."""
    local = threading.local()

    def fake_perf():
        t = getattr(local, "t", 0.0)
        local.t = t + 0.5
        return t

    monkeypatch.setattr(stages, "_perf", fake_perf)
    sess = _Session()
    sess.query_stage_seconds = _YieldingCounter()
    n, threads = 2000, 8
    go = threading.Barrier(threads)

    def run():
        go.wait()
        for _ in range(n):
            with stages.stage(sess, "decode"):
                pass

    workers = [threading.Thread(target=run) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert sess.query_stage_seconds["decode"] == 0.5 * n * threads
    assert set(sess.query_stage_seconds) == {"decode"}


@pytest.mark.parametrize("mode", ["plain", "traced", "batched"])
def test_request_is_queue_plus_stages_plus_unattributed(served, mode):
    """Every served request's clock: ``request`` equals its admission wait,
    its outermost stages and ``unattributed`` (to 1e-6 s), none of them
    negative; the session's ``request``, ``unattributed`` and ``host_wait``
    are the sums of the requests'. With micro-batches of 2, a shared scan
    charges its stages to each request of the batch."""
    conf = {"hyperspace.obs.tracing.enabled": True} if mode == "traced" else {}
    sess = served(**conf)
    server = {"workers": 1, "micro_batch_max_requests": 2, "micro_batch_max_wait_ms": 50} if mode == "batched" \
        else {"workers": 2, "micro_batch_enabled": False}
    texts = [POINT.format(i) for i in range(10)] + ([] if mode == "batched" else [GROUPED.format(i) for i in (9, 29)])
    futs, stats = _serve(sess, texts, **server)
    clocks = [f.request_clock for f in futs]
    for c in clocks:
        assert c.sealed and c.request_s > 0
        assert abs(c.request_s - (c.queue_s + c.attributed_s + c.unattributed_s)) < 1e-6
        assert c.queue_s >= 0 and c.attributed_s > 0 and c.unattributed_s > -1e-9 and c.host_wait_s >= 0
        assert {"parse", "admit", "resolve", "finish"} <= set(c.seconds), sorted(c.seconds)
        assert c.host_wait_s <= c.attributed_s + 1e-9
    q = sess.query_stage_seconds
    for key, attr in (("request", "request_s"), ("unattributed", "unattributed_s"), ("host_wait", "host_wait_s")):
        assert abs(q[key] - sum(getattr(c, attr) for c in clocks)) < 1e-6, key
    if mode == "batched":
        assert stats["batchedRequests"] >= 2
        shared = [c for c in clocks if "bucket_read" in c.seconds]
        # the batch read its scan once and charged it to each of its requests
        assert sum(c.seconds["bucket_read"] for c in shared) > q["bucket_read"] + 1e-9
    else:
        assert "agg_program" in q and "scan_identity" in q and "stream_gate" in q
    if mode == "traced":
        assert all(f.profile is not None for f in futs)


def _stage_calls():
    """(file, line, key) of every literal key the port passes to the
    primitive: ``stages.stage``, ``stages.start`` and a stage's ``next``."""
    found = []
    for dirpath, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                    continue
                fn = node.func
                primitive = isinstance(fn.value, ast.Name) and fn.value.id == "stages" and fn.attr in (
                    "stage", "start", "timed")
                if primitive and len(node.args) >= 2:
                    key = node.args[1]
                elif fn.attr == "next" and len(node.args) == 1 and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    key = node.args[0]
                else:
                    continue
                assert isinstance(key, ast.Constant) and isinstance(key.value, str), (path, node.lineno)
                found.append((os.path.relpath(path, REPO), node.lineno, key.value))
    return found


def test_every_key_has_one_layer():
    """Every key the port passes to the primitive, and every key a reader
    this change adds under hsbench/metrics/ reads, is in the layer map;
    nothing else writes ``query_stage_seconds`` or ``build_stage_seconds``
    but the primitive; every layer is one of PERF.md's."""
    calls = _stage_calls()
    assert len(calls) > 60
    unknown = [c for c in calls if c[2] not in stages.LAYERS]
    assert not unknown, unknown
    import importlib.util

    for name in NEW_READERS:
        spec = importlib.util.spec_from_file_location(f"_reader_{name}", os.path.join(METRICS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.KEYS and all(k in stages.LAYERS for k in mod.KEYS), name
    writers = []
    for dirpath, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in names:
            if name.endswith(".py") and name != "stages.py":
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    for i, line in enumerate(f, 1):
                        if "stage_seconds[" in line:
                            writers.append((name, i, line.strip()))
    assert not writers, writers
    import json

    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        layers = {m["layer"] for m in json.load(f)["per_layer"]}
    assert set(stages.LAYERS.values()) <= layers | {"index build"}


def test_traced_stage_is_one_span_of_its_layer(served):
    """With obs tracing on, each stage of a served request is one span named
    by its key, whose ``cat`` is the key's layer: as many spans of each
    layer-cat as the request's clock counted, and no span left of the ones
    the stages replaced (``resolve-plan``, ``optimize``, the per-file
    ``decode``, ``h2d-stage``, ``agg-merge``); the rewrite's facts annotate
    the ``resolve`` stage's span."""
    sess = served(**{"hyperspace.obs.tracing.enabled": True})
    texts = [POINT.format(3), GROUPED.format(21)]
    _serve(sess, texts, workers=1, micro_batch_enabled=False)
    counted = []
    real_start = stages.Stage._start

    def start(self):
        out = real_start(self)
        counted.append(self.key)
        return out

    stages.Stage._start = start
    try:
        futs, _ = _serve(sess, texts, warm=False, workers=1, micro_batch_enabled=False)
    finally:
        stages.Stage._start = real_start
    layer_cats = set(stages.LAYERS.values())
    seen = []
    for f in futs:
        for sp in f.profile.root.walk():
            if sp.cat in layer_cats and sp.name.replace(stages.PREFETCH, "", 1) in stages.LAYERS:
                assert sp.cat == stages.layer_of(sp.name), (sp.name, sp.cat)
                seen.append(sp.name)
            assert sp.name not in ("resolve-plan", "h2d-stage", "agg-merge", "optimize")
            assert not (sp.name == "decode" and sp.cat == "io")
    assert sorted(seen) == sorted(counted)
    assert futs[0].profile.indexes_applied == ["t_k"]
    assert {"parse", "admit", "resolve", "finish", "bucket_read", "scan_identity"} <= set(seen)


def test_profiler_ranges_nest_as_the_stages(served):
    """Under a CPU ``torch.profiler``, each stage is an ``hs:<layer>:<key>``
    range, nested as the stages nest; a served aggregate shows its layers."""
    from torch.profiler import ProfilerActivity, profile

    sess = _Session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stages.stage(sess, "resolve"):
            with stages.stage(sess, "rewrite"):
                time.sleep(0.001)
            with stages.stage(sess, "parse") as st:
                st.next("admit")
    events = {e.name: e for e in prof.events() if e.name.startswith("hs:")}
    assert set(events) == {"hs:plan and rewrite:resolve", "hs:plan and rewrite:rewrite",
                           "hs:plan and rewrite:parse", "hs:serving admission:admit"}
    outer = events["hs:plan and rewrite:resolve"]
    for inner in ("hs:plan and rewrite:rewrite", "hs:plan and rewrite:parse", "hs:serving admission:admit"):
        ev = events[inner]
        assert ev.cpu_parent is not None and ev.cpu_parent.name == outer.name, inner
        assert outer.time_range.start <= ev.time_range.start and ev.time_range.end <= outer.time_range.end
    assert events["hs:plan and rewrite:parse"].time_range.end <= events["hs:serving admission:admit"].time_range.start

    port = served()
    port.sql(GROUPED.format(11)).collect()  # cold run outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port.sql(GROUPED.format(11)).collect()
    names = {e.name for e in prof.events() if e.name.startswith("hs:")}
    assert {"hs:plan and rewrite:rewrite", "hs:sources and decode:scan_identity",
            "hs:device programs:agg_program"} <= names, names


def test_off_path_makes_no_span_and_no_range(served, monkeypatch):
    """With neither an obs trace nor a profiler, a query's stages make no
    span and call no ``record_function``; with a trace on, they do."""
    made = {"span": 0, "range": 0}
    real_span = spans.Span.__init__

    def span_init(self, *a, **k):
        made["span"] += 1
        real_span(self, *a, **k)

    class Range:
        def __init__(self, name):
            made["range"] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans.Span, "__init__", span_init)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    sess = served()
    q = sess.sql(GROUPED.format(17))
    q.collect()
    with stages.stage(sess, "resolve") as st:
        st.next("parse")
    assert made == {"span": 0, "range": 0}
    assert sess.query_stage_seconds["agg_program"] > 0
    traced = served(**{"hyperspace.obs.tracing.enabled": True})
    traced.sql(GROUPED.format(17)).collect()
    assert made["span"] > 0 and made["range"] == 0
