"""The port's serving runtime, held to the JAX package's suites and to the
JAX package itself.

tests/test_serving.py (the plan cache, admission, the bucket cache, serving
metrics, micro-batch decomposition, QueryServer against ``collect()``) and
test_serving_stress.py (concurrent clients, a toggle racing the server,
overload, the lock order) run with the package renamed to the port
(tests/torch_mirror.py ``load_cases``). ``hst.Session`` there is the port's
session on the CPU (``torch_mirror.cpu_port``). The queries are not
mirrored into the JAX package: a served request never calls ``collect()``.
(test_sched.py runs in tests/test_torch_snapshot.py and
test_plan_fingerprint.py in tests/test_torch_obs.py: their ``simple``
fixtures differ from test_serving.py's.)
The cases at the end hold the port against the JAX package on one lake:
the same fingerprints (but for the listing token the port folds into a
scan's, ROADMAP C8), the same served rows, the same data-version brands.

Left out, each with its reason (``LEFT_OUT``):

- ``test_serving_stress.py::test_plan_cache_throughput_3x``: a wall-clock
  ratio, unsteady in the JAX package itself (ROADMAP end of §C);
- ``test_serving_stress.py::test_serving_soak_bounded``: marked slow and
  soak, which tier-1 does not run.
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
    "test_serving.py": dict(M.CPU_PORT_IMPORT),
    "test_serving_stress.py": dict(M.CPU_PORT_IMPORT),
}
LEFT_OUT = {
    "test_plan_cache_throughput_3x": "a wall-clock ratio; unsteady in the JAX package itself (ROADMAP §C)",
    "test_serving_soak_bounded": "marked slow and soak; tier-1 runs neither",
}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


# -- the port against the JAX package ------------------------------------------


def _lake(root):
    rng = np.random.default_rng(14)
    n = 2000
    data = os.path.join(root, "lake")
    os.makedirs(data)
    for i in range(2):
        pq.write_table(pa.table({
            "k": rng.integers(0, 40, n // 2).astype(np.int64),
            "v": np.round(rng.uniform(0, 100, n // 2), 3),
            "g": np.array([f"g{j % 5}" for j in range(n // 2)]),
        }), os.path.join(data, f"part-{i:05d}.parquet"))
    dim = os.path.join(root, "dim")
    os.makedirs(dim)
    pq.write_table(pa.table({
        "dk": np.arange(40, dtype=np.int64),
        "label": np.array([f"d{j % 7}" for j in range(40)]),
    }), os.path.join(dim, "part-00000.parquet"))
    return data, dim


def _pair(tmp_path, **conf):
    """A port session on the CPU and a JAX package session over one lake and
    one index system path (the port builds the index; both serve it)."""
    data, dim = _lake(str(tmp_path))
    base = {"hyperspace.system.path": str(tmp_path / "idx"), "hyperspace.index.numBuckets": 4, **conf}
    port = ht.Session(conf=dict(base), device="cpu")
    ref = hst.Session(conf=dict(base))
    for sess in (port, ref):
        sess.read_parquet(data).create_or_replace_temp_view("t")
        sess.read_parquet(dim).create_or_replace_temp_view("d")
    ht.Hyperspace(port).create_index(port.sql("SELECT * FROM t"), ht.CoveringIndexConfig("t_k", ["k"], ["v", "g"]))
    port.enable_hyperspace()
    ref.enable_hyperspace()
    return port, ref, data


TEXTS = [
    "SELECT v, g FROM t WHERE k = 7",
    "SELECT v, g FROM t WHERE k = 11",
    "SELECT v AS w FROM t WHERE k > 30 AND v < 50.5",
    "SELECT g, count(*) AS n, sum(v) AS s FROM t WHERE k < 20 GROUP BY g",
    "SELECT k, v, label FROM t JOIN d ON k = dk WHERE v > 90",
    "SELECT k, v FROM t WHERE k > 3 ORDER BY v DESC, k LIMIT 5",
    "SELECT s FROM (SELECT k, sum(v) AS s FROM t GROUP BY k) x WHERE s > (SELECT avg(v) FROM t)",
]


def test_fingerprints_equal_the_jax_package(tmp_path):
    """The same text plans to the same canonical form, parameter tokens,
    literals and output columns in both packages, but for the file listing
    the port folds into each ``Scan``'s token (ROADMAP C8, repaired in the
    port only): without it the canonical forms are equal, so the structure
    and exact hashes differ by the listing alone."""
    port, ref, _ = _pair(tmp_path)
    from hyperspace_tpu.serving.fingerprint import canonical_form as ref_canon
    from hyperspace_tpu.serving.fingerprint import plan_fingerprint as ref_fp
    from hyperspace_tpu_torch.plan import logical as PL
    from hyperspace_tpu_torch.serving.fingerprint import canonical_form as port_canon
    from hyperspace_tpu_torch.serving.fingerprint import plan_fingerprint as port_fp

    for text in TEXTS:
        plan = port.sql(text).plan
        a, b = port_fp(plan), ref_fp(ref.sql(text).plan)
        canon = port_canon(plan)
        sigs = {s.relation.signature() for s in PL.collect(plan, lambda p: isinstance(p, PL.Scan))}
        assert sigs and all(f";{sig}]" in canon for sig in sigs), text
        for sig in sigs:
            canon = canon.replace(f";{sig}]", "]")
        assert canon == ref_canon(ref.sql(text).plan), text
        assert a.structure != b.structure and a.has_subquery == b.has_subquery, text
        assert a.slot_sigs == b.slot_sigs and list(a.literals) == list(b.literals), text
        assert list(a.output_columns) == list(b.output_columns), text


def test_served_rows_equal_the_jax_package(tmp_path):
    """Every text, and sixteen literal variants of a point filter, served
    through both packages' QueryServer: the same rows in the same order,
    each also equal to its session's own ``collect()``."""
    port, ref, _ = _pair(tmp_path, **{"hyperspace.serving.resultCache.enabled": True})
    texts = TEXTS + [f"SELECT v, g FROM t WHERE k = {i}" for i in range(16)]
    with ht.QueryServer(port, workers=4) as ps, hst.QueryServer(ref, workers=4) as rs:
        pf = [ps.submit(q) for q in texts]
        rf = [rs.submit(q) for q in texts]
        for q, a, b in zip(texts, pf, rf):
            got, want = a.result(timeout=60), b.result(timeout=60)
            M.same_rows(got, want, q)
            M.same_rows(got, port.sql(q).collect(), q)
        stats = ps.stats()
    assert stats["errors"] == 0 and stats["completed"] == len(texts)
    assert stats["batches"] >= 1  # the literal variants shared scans


def test_version_brands_equal_the_jax_package_across_a_refresh(tmp_path):
    """``data_version_brand`` agrees between the packages before an append,
    rotates in both after it, and agrees again after the port's refresh."""
    port, ref, data = _pair(tmp_path)
    text = "SELECT v, g FROM t WHERE k = 7"

    def brands():
        ref.index_manager.clear_cache()
        return port.data_version_brand(text), ref.data_version_brand(text)

    b0 = brands()
    assert b0[0] is not None and b0[0] == b0[1]
    pq.write_table(pa.table({"k": np.arange(7, 9, dtype=np.int64), "v": [1.5, 2.5], "g": ["g9", "g9"]}),
                   os.path.join(data, "part-00009.parquet"))
    for sess in (port, ref):
        sess.read_parquet(data).create_or_replace_temp_view("t")
    b1 = brands()
    assert b1[0] == b1[1] and b1[0] != b0[0]
    from hyperspace_tpu_torch.lifecycle import RefreshManager

    outcome = RefreshManager(port).poll_once()
    assert [o["outcome"] for o in outcome] == ["committed"]
    b2 = brands()
    assert b2[0] == b2[1] and b2[0] not in (b0[0], b1[0])
    # both serve the appended rows from the refreshed index
    M.same_rows(port.sql(text).collect(), ref.sql(text).collect(), text)


def test_listing_skips_a_file_still_being_written(tmp_path):
    """ROADMAP C10, repaired in the port: an atomic writer's ``*.tmp`` file,
    not yet renamed, is not a data file of the port's listing (the JAX
    package lists it, and a reader that listed it finds it gone once it is
    renamed). A served request over a listing taken mid-write therefore
    reads the committed files, as ``collect()`` does."""
    port, ref, data = _pair(tmp_path)
    inflight = os.path.join(data, "part-00009.parquet.tmp")
    pq.write_table(pa.table({"k": np.full(3, 7, dtype=np.int64), "v": [1.5, 2.5, 3.5], "g": ["g9"] * 3}), inflight)
    assert inflight not in [fi.name for fi in port.read_parquet(data).plan.relation.all_file_infos()]
    assert inflight in [fi.name for fi in ref.read_parquet(data).plan.relation.all_file_infos()]
    frame = port.read_parquet(data).filter(ht.col("k") == 7).select("v", "g")
    with ht.QueryServer(port, workers=2) as ps:
        served = ps.query(frame, timeout=60)
    os.remove(inflight)
    M.same_rows(served, port.read_parquet(data).filter(ht.col("k") == 7).select("v", "g").collect(), "mid-write")


def test_plan_cache_serves_the_new_listing_in_the_port_and_the_old_in_the_jax_package(tmp_path):
    """ROADMAP C8, repaired in the port: its plan cache keys a scan by its
    file listing (path, size, mtime), so a DataFrame read after a file lands
    binds a new template and the server returns the new file's rows, those
    of the same DataFrame's ``collect()``. The JAX package keys a scan by
    its root path and still serves the old listing's rows from the template
    compiled over it."""
    port, ref, data = _pair(tmp_path)

    def frame(sess):
        c = ht.col if sess is port else hst.col
        return sess.read_parquet(data).filter(c("k") == 7).select("v", "g")

    old = {s: frame(s) for s in (port, ref)}
    with ht.QueryServer(port, workers=2) as ps, hst.QueryServer(ref, workers=2) as rs:
        first = {port: ps.query(old[port], timeout=60), ref: rs.query(old[ref], timeout=60)}
        pq.write_table(pa.table({"k": np.full(3, 7, dtype=np.int64), "v": [1.5, 2.5, 3.5], "g": ["g9"] * 3}),
                       os.path.join(data, "part-00009.parquet"))
        new = {s: frame(s) for s in (port, ref)}
        served = {port: ps.query(new[port], timeout=60), ref: rs.query(new[ref], timeout=60)}
        assert ps.stats()["planCache"]["hits"] == 0 and rs.stats()["planCache"]["hits"] >= 1
    M.same_rows(first[port], first[ref], "the old listing")
    fresh = {s: new[s].collect() for s in (port, ref)}
    M.same_rows(fresh[port], fresh[ref], "collect() over the new listing")
    assert len(fresh[port]["v"]) == len(first[port]["v"]) + 3
    M.same_rows(served[port], fresh[port], "the port serves the new listing's rows")
    M.same_rows(served[ref], first[ref], "the JAX package serves the old listing's rows")
