"""The port's filter query (slice 3) against the JAX package, end to end.

One parquet lake, made from a seed with numpy, is indexed by both packages
(``hyperspace_tpu`` on the JAX CPU backend, ``hyperspace_tpu_torch`` with
``device="cpu"``). Every query then runs in both packages over each
package's indexes — so each package also queries the index the other built —
with ``deviceMinRows=0`` (the device filter) and at the default (the host
filter), and with hyperspace off. The comparisons are exact: the optimized
plans and the files they read, the dispatch trace's ``filter:`` and
``scan:`` lines, and the collected columns byte for byte and in order.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 8
COVERING = [
    ("by_k", ["k"], ["s", "f", "p", "n", "d"]),
    ("by_s", ["s"], ["k", "f"]),
    ("by_d", ["d"], ["k", "f", "n"]),
]


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """Five files with an int key, a float column with NaN / -0.0 / ±inf, a
    string column with nulls, a nullable int64 column (decodes as float64),
    a date column with nulls and an int64 column around 2^53."""
    root = tmp_path_factory.mktemp("query_lake")
    rng = np.random.default_rng(23)
    for i, n in enumerate([500, 700, 1500, 300, 400]):
        f = np.round(rng.standard_normal(n) * 3, 1)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.05] = -0.0
        f[:2] = [np.inf, -np.inf]
        dates = np.datetime64("1996-01-01") + rng.integers(0, 900, n).astype("timedelta64[D]")
        table = pa.table({
            "k": rng.integers(0, 100, n),
            "f": f,
            "s": pa.array([f"s{x}" for x in rng.integers(0, 60, n)], mask=rng.random(n) < 0.05),
            "n": pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.1),
            "d": pa.array(dates, mask=rng.random(n) < 0.05),
            "p": 2**53 + rng.integers(-4, 4, n),
        })
        pq.write_table(table, root / f"part-{i:05d}.parquet")
    return str(root)


def _conf(keys, system_path, **extra):
    return {keys.SYSTEM_PATH: system_path, keys.NUM_BUCKETS: NUM_BUCKETS,
            "hyperspace.tpu.build.batchRows": 900, **extra}


@pytest.fixture(scope="module")
def systems(lake, tmp_path_factory):
    """{owner: system path} with every covering index built by that package."""
    out = {}
    for owner, pkg in (("jax", hst), ("torch", ht)):
        path = str(tmp_path_factory.mktemp(f"{owner}_indexes"))
        kwargs = {} if pkg is hst else {"device": "cpu"}
        sess = pkg.Session(conf=_conf(pkg.keys, path), **kwargs)
        df = sess.read_parquet(lake)
        for name, indexed, included in COVERING:
            pkg.Hyperspace(sess).create_index(df, pkg.CoveringIndexConfig(name, indexed, included))
        out[owner] = path
    return out


QUERIES = {
    "k_eq": (lambda c: c("k") == 7, ["k", "s", "p"]),
    "k_in": (lambda c: c("k").isin(3, 9, 42), ["k", "f", "d"]),
    "k_range_f": (lambda c: (c("k") > 50) & (c("f") < 0.5), ["k", "f"]),
    "k_not_s": (lambda c: (c("k") >= 90) & ~(c("s") == "s17"), ["k", "s", "n"]),
    "k_mod": (lambda c: (c("k") % 7) == 3, ["k", "p"]),
    "k_div": (lambda c: (c("k") / 3) > 30.5, ["k", "f"]),
    "k_p_big": (lambda c: (c("k") < 20) & (c("p") > 9007199254740993.0), ["k", "p"]),
    "k_or_null": (lambda c: (c("k") < 5) | (c("n").is_null() & (c("k") < 40)), ["k", "n"]),
    "s_eq_absent": (lambda c: (c("s") == "s17") | (c("s") == "nope"), ["s", "k"]),
    "s_in_null": (lambda c: c("s").isin("s1", "s2") | c("s").is_null(), ["s", "f"]),
    "d_range": (lambda c: (c("d") >= np.datetime64("1996-06-01")) & (c("d") < np.datetime64("1997-01-01")),
                ["d", "k", "n"]),
    "d_not_null": (lambda c: ~(c("d") < np.datetime64("1997-06-01")) & (c("f") >= -0.0), ["d", "f"]),
    # outside the device language: the device path falls back to the host
    "k_unsupported": (lambda c: (c("k") > 90) | (c("k") + 1).is_null(), ["k", "s"]),
}

MODES = {
    "device": {"hyperspace.tpu.query.deviceMinRows": 0, "hyperspace.index.filterRule.useBucketSpec": "true"},
    "default": {},
}


def _run(pkg, path, q, mode, hyperspace: bool, lake):
    """(optimized plan, collected batch, filter:/scan: trace lines)."""
    kwargs = {} if pkg is hst else {"device": "cpu"}
    sess = pkg.Session(conf=_conf(pkg.keys, path, **MODES[mode]), **kwargs)
    if hyperspace:
        sess.enable_hyperspace()
    pred, columns = QUERIES[q]
    df = sess.read_parquet(lake).filter(pred(pkg.col)).select(*columns)
    plan = df.optimized_plan()
    rec = ref_trace if pkg is hst else trace
    with rec.recording() as events:
        got = df.collect()
    lines = [ln for ln in rec.summarize(events).splitlines() if ln.startswith(("filter:", "scan:"))]
    return plan, got, lines


def _assert_same_batch(got, ref):
    assert list(got) == list(ref)
    for name in ref:
        g, r = got[name], ref[name]
        assert g.dtype == r.dtype, name
        if r.dtype == object:
            assert g.tolist() == r.tolist(), name
        else:
            assert g.tobytes() == r.tobytes(), name


def _multiset(batch):
    return sorted(zip(*(v.astype(str).tolist() for v in batch.values())))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("owner", ["jax", "torch"])
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_query_matches_jax(systems, lake, q, owner, mode):
    path = systems[owner]
    ref_plan, ref, ref_lines = _run(hst, path, q, mode, True, lake)
    plan, got, lines = _run(ht, path, q, mode, True, lake)

    assert plan.pretty() == ref_plan.pretty()
    ref_scans = RL.collect(ref_plan, lambda p: isinstance(p, RL.IndexScan))
    scans = L.collect(plan, lambda p: isinstance(p, L.IndexScan))
    assert len(scans) == len(ref_scans) == 1, plan.pretty()
    assert scans[0].files == ref_scans[0].files
    assert scans[0].pruned_buckets == ref_scans[0].pruned_buckets
    if mode == "device" and q == "k_eq":
        assert scans[0].pruned_buckets is not None and len(scans[0].pruned_buckets) == 1

    _assert_same_batch(got, ref)
    assert lines == ref_lines
    if q == "k_unsupported":
        want = "filter: host-fallback x1" if mode == "device" else "filter: host x1"
    else:
        want = "filter: device x1" if mode == "device" else "filter: host x1"
    assert want in lines, lines

    # hyperspace off: the host filter over the source, in source order, in
    # both packages; the same rows as through the index
    _, ref_off, ref_off_lines = _run(hst, path, q, mode, False, lake)
    _, off, off_lines = _run(ht, path, q, mode, False, lake)
    _assert_same_batch(off, ref_off)
    assert off_lines == ref_off_lines == ["filter: host x1"]
    assert _multiset(off) == _multiset(got)
    assert len(next(iter(got.values()))) > 0


def test_unsupported_predicate_uploads_nothing(systems, lake, monkeypatch):
    """A predicate outside the device language is rejected before any
    column goes to the device, and the host evaluates it."""

    def no_upload(*args, **kwargs):
        raise AssertionError("a column was uploaded for a predicate the device cannot run")

    monkeypatch.setattr(D, "_put_encoded", no_upload)
    D.clear_device_cache()
    _, got, lines = _run(ht, systems["torch"], "k_unsupported", "device", True, lake)
    assert "filter: host-fallback x1" in lines
    assert len(next(iter(got.values()))) > 0


def test_device_dispatches_and_cache(systems, lake):
    """Each device filter is one ``fused-filter`` dispatch; a repeated query
    finds its columns resident and uploads nothing."""
    D.clear_device_cache()
    D.reset_dispatches()
    _run(ht, systems["torch"], "k_range_f", "device", True, lake)
    assert D.dispatches["fused-filter"] == 1
    resident = len(D._device_cache)
    assert resident == 2  # k and f
    calls = []
    real = D._put_encoded
    D._put_encoded = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        _run(ht, systems["torch"], "k_range_f", "device", True, lake)
    finally:
        D._put_encoded = real
    assert not calls and D.dispatches["fused-filter"] == 2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_query_stage_seconds(systems, lake, mode):
    """A collect() adds its host time per layer to the session's
    ``query_stage_seconds``: the device layers on the device path, the host
    predicate on the host path, and an upload only when the device cache
    misses."""
    D.clear_device_cache()
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"], **MODES[mode]), device="cpu")
    sess.enable_hyperspace()
    df = sess.read_parquet(lake).filter((ht.col("k") > 50) & (ht.col("f") < 0.5)).select("k", "f")
    device = {"scan_identity", "upload", "predicate_launch", "wait_copy_mask"}
    want = {"rewrite", "decode", "mask_rows"} | (device if mode == "device" else {"host_predicate"})
    df.collect()
    assert set(sess.query_stage_seconds) == want
    assert all(v >= 0 for v in sess.query_stage_seconds.values())
    sess.query_stage_seconds.clear()
    df.collect()
    assert set(sess.query_stage_seconds) == want - {"upload"}


def test_toggle_and_count(systems, lake):
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"]), device="cpu")
    assert not sess.is_hyperspace_enabled()
    df = sess.read_parquet(lake).filter(ht.col("k") == 7).select("k")
    assert not L.collect(df.optimized_plan(), lambda p: isinstance(p, L.IndexScan))
    with sess.hyperspace_scope(True):
        assert L.collect(df.optimized_plan(), lambda p: isinstance(p, L.IndexScan))
    sess.enableHyperspace()
    assert sess.isHyperspaceEnabled()
    n = df.count()
    sess.disableHyperspace()
    assert df.count() == n > 0
    assert df.explain() == df.plan.pretty() and df.columns == ["k"]


def test_not_ported_features_raise(systems, lake):
    """The sharded filter is not in the port yet: asking for it raises
    instead of quietly running something else. Hybrid scan is in the port:
    over an unchanged lake it serves the index as the plain rewrite does."""
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"], **{"hyperspace.index.hybridscan.enabled": "true"}),
                      device="cpu")
    q = sess.read_parquet(lake).filter(ht.col("k") == 7)
    off = q.collect()
    sess.enable_hyperspace()
    assert L.collect(q.optimized_plan(), lambda p: isinstance(p, L.IndexScan))
    assert _multiset(q.collect()) == _multiset(off)
    sess = ht.Session(conf=_conf(ht.keys, systems["torch"], **{"hyperspace.parallel.enabled": "true",
                                                                 "hyperspace.tpu.query.deviceMinRows": 0}),
                      device="cpu")
    sess.enable_hyperspace()
    with pytest.raises(NotImplementedError, match="sharded"):
        sess.read_parquet(lake).filter(ht.col("k") == 7).collect()
    with pytest.raises(NotImplementedError, match="IN-subqueries"):
        ht.col("k").isin(sess.read_parquet(lake))
