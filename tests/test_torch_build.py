"""The port's index build (slice 1) against the JAX package, end to end.

The same parquet lake goes through ``create_index`` in both packages:
``hyperspace_tpu`` (JAX, CPU backend, Pallas in interpret mode) and
``hyperspace_tpu_torch`` with ``device="cpu"`` (the kernels' plain
versions). ``batchRows`` is small enough to force several chunks. The
comparisons are exact — bucket rows and their order, parquet schemas, log
entries, sketch values including nulls — so no tolerance applies anywhere.
The lake state carries across: each package reads the index the other
built.
"""

import os
import re

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.indexes import covering as ref_covering  # noqa: E402
from hyperspace_tpu.indexes.registry import index_of_entry as ref_index_of_entry  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
from hyperspace_tpu_torch.actions.base import HyperspaceActionException  # noqa: E402
from hyperspace_tpu_torch.indexes import covering  # noqa: E402
from hyperspace_tpu_torch.indexes.registry import index_of_entry  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 8
BATCH_ROWS = 700


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """Five files, one larger than batchRows (sliced), with a string key, a
    float key with NaN / -0.0 / negatives, a nullable int64 column (decodes
    as float64) and a date column."""
    root = tmp_path_factory.mktemp("lake")
    rng = np.random.default_rng(11)
    for i, n in enumerate([500, 500, 1500, 300, 400]):
        f = np.round(rng.standard_normal(n) * 3, 1)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.05] = -0.0
        nullable = pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.1)
        strings = pa.array([f"s{x}" for x in rng.integers(0, 60, n)], mask=rng.random(n) < 0.05)
        table = pa.table({
            "k": rng.integers(0, 100, n),
            "f": f,
            "s": strings,
            "n": nullable,
            "d": pa.array(np.datetime64("1996-01-01") + rng.integers(0, 900, n).astype("timedelta64[D]")),
            "p": rng.integers(-(10**6), 10**6, n),
        })
        pq.write_table(table, root / f"part-{i:05d}.parquet")
    return str(root)


def _conf(keys, system_path):
    return {keys.SYSTEM_PATH: system_path, keys.NUM_BUCKETS: NUM_BUCKETS,
            "hyperspace.tpu.build.batchRows": BATCH_ROWS}


COVERING = [
    ("by_k", ["k"], ["s", "f", "p"]),
    ("by_f", ["f"], ["k"]),
    ("by_s_d", ["s", "d"], ["p", "n"]),
    ("by_n", ["n"], ["k"]),
]
SKETCHES = ["MinMax:f", "MinMax:k", "MinMax:n", "MinMax:p", "BloomFilter:s", "ValueList:k"]


def _sketches(pkg):
    kinds = {"MinMax": pkg.MinMaxSketch, "BloomFilter": pkg.BloomFilterSketch, "ValueList": pkg.ValueListSketch}
    return [kinds[s.split(":")[0]](s.split(":")[1]) for s in SKETCHES]


@pytest.fixture(scope="module")
def built(lake, tmp_path_factory):
    """Every index built by both packages over the same lake."""
    out = {}
    for name, sess in (
        ("jax", hst.Session(conf=_conf(hst.keys, str(tmp_path_factory.mktemp("jax_indexes"))))),
        ("torch", ht.Session(conf=_conf(ht.keys, str(tmp_path_factory.mktemp("torch_indexes"))), device="cpu")),
    ):
        pkg = hst if name == "jax" else ht
        hs = pkg.Hyperspace(sess)
        df = sess.read_parquet(lake)
        entries = {}
        for idx, indexed, included in COVERING:
            entries[idx] = hs.create_index(df, pkg.CoveringIndexConfig(idx, indexed, included))
        entries["skip"] = hs.create_index(df, pkg.DataSkippingIndexConfig("skip", *_sketches(pkg)))
        out[name] = {"session": sess, "hs": hs, "entries": entries}
    return out


def _runs(entry):
    """{bucket: sorted [file contents]}: a bucket's runs (one per chunk)
    carry random file-name tags, so they compare as a set of whole files."""
    runs = {}
    for f in entry.content.files:
        t = pq.read_table(f)
        runs.setdefault(covering.bucket_of_file(f), []).append((repr(t.to_pydict()), t.schema))
    return {b: sorted(v, key=lambda x: x[0]) for b, v in runs.items()}


@pytest.mark.parametrize("index", [c[0] for c in COVERING])
def test_covering_bucket_files_match(built, index):
    ref = _runs(built["jax"]["entries"][index])
    got = _runs(built["torch"]["entries"][index])
    assert sorted(got) == sorted(ref)
    for b in ref:
        assert [c for c, _ in got[b]] == [c for c, _ in ref[b]], f"bucket {b}: rows differ"
        for (_, g), (_, r) in zip(got[b], ref[b]):
            assert g.equals(r, check_metadata=True), f"bucket {b}: parquet schema differs"
    # several chunks: some bucket holds more than one sorted run
    assert max(len(v) for v in ref.values()) > 1


def _normalized(entry, system_path):
    """The log entry as a dict, with what legitimately differs between two
    builds taken out: timestamps, the index root path, and the random tag
    in each bucket file name. The tree is compared as a file list; file ids
    follow file-name order, so which file gets which id follows the random
    tags too, and only the set of ids is compared."""
    d = entry.to_dict()
    d["timestamp"] = 0
    infos = entry.content.file_infos()
    d["content"] = sorted(
        (re.sub(r"-[0-9a-f]{12}\.parquet$", "", os.path.relpath(fi.name, system_path)), fi.size)
        for fi in infos
    )
    d["content_ids"] = sorted(fi.file_id for fi in infos)
    return d


@pytest.mark.parametrize("index", [c[0] for c in COVERING] + ["skip"])
def test_log_entries_match(built, index):
    ref = built["jax"]["entries"][index]
    got = built["torch"]["entries"][index]
    assert got.state == ref.state == "ACTIVE"
    assert _normalized(got, built["torch"]["session"].conf.system_path) == _normalized(
        ref, built["jax"]["session"].conf.system_path
    )


def test_sketch_tables_match(built):
    ref_entry = built["jax"]["entries"]["skip"]
    got_entry = built["torch"]["entries"]["skip"]
    ref = ref_index_of_entry(ref_entry).read_sketch_table(ref_entry)
    got = index_of_entry(got_entry).read_sketch_table(got_entry)
    assert got.schema.equals(ref.schema)
    assert repr(got.to_pydict()) == repr(ref.to_pydict())
    # the nullable int column's MinMax went through the device path
    assert got.column("MinMax_n__min").null_count == 0


def test_write_bucketed_chunk_order_matches(lake, tmp_path):
    """The writer's own output order — bucket order within each chunk,
    chunk-major — is the reference's, run for run, for one group sliced
    into several chunks."""
    table = pq.read_table(os.path.join(lake, "part-00002.parquet"))
    ref_paths = ref_covering.write_bucketed_groups(
        [(table, None)], ["s", "k"], NUM_BUCKETS, str(tmp_path / "jax"), batch_rows=400,
        session=hst.Session(conf=_conf(hst.keys, str(tmp_path / "sys_jax"))),
    )
    got_paths = covering.write_bucketed_groups(
        [(table, None)], ["s", "k"], NUM_BUCKETS, str(tmp_path / "torch"), batch_rows=400,
        session=ht.Session(conf=_conf(ht.keys, str(tmp_path / "sys_torch")), device="cpu"),
    )
    assert len(got_paths) == len(ref_paths) > NUM_BUCKETS
    for g, r in zip(got_paths, ref_paths):
        assert covering.bucket_of_file(g) == covering.bucket_of_file(r)
        # repr, not Table.equals: NaN keys must compare equal to themselves
        assert repr(pq.read_table(g).to_pydict()) == repr(pq.read_table(r).to_pydict())


def _sorted_batch(batch):
    order = np.lexsort([np.asarray(v).astype("U64") if v.dtype == object else v for v in reversed(list(batch.values()))])
    return {k: v[order] for k, v in batch.items()}


@pytest.mark.parametrize(
    "index,predicate,columns",
    [
        ("by_k", lambda c: c("k") == 7, ["k", "s", "p"]),
        ("by_f", lambda c: c("f") == -0.3, ["f", "k"]),
        ("by_s_d", lambda c: c("s") == "s17", ["s", "d", "p"]),
    ],
)
def test_jax_package_serves_port_built_index(built, lake, index, predicate, columns):
    """State carried across: the JAX package lists the port-built indexes
    and answers a filter query from one exactly as from its own index."""
    answers = {}
    for name in ("jax", "torch"):
        sess = hst.Session(conf=_conf(hst.keys, built[name]["session"].conf.system_path))
        listed = hst.Hyperspace(sess).indexes()
        assert sorted(listed["name"]) == sorted(c[0] for c in COVERING) + ["skip"]
        assert set(listed["state"]) == {"ACTIVE"}
        sess.enable_hyperspace()
        q = sess.read_parquet(lake).filter(predicate(hst.col)).select(*columns)
        scans = [p for p in RL.collect(q.optimized_plan(), lambda p: True) if isinstance(p, RL.IndexScan)]
        assert [s.entry.name for s in scans] == [index], q.optimized_plan().pretty()
        answers[name] = _sorted_batch(q.collect())
        sess.disable_hyperspace()
        answers[f"{name}-source"] = _sorted_batch(q.collect())
    assert len(next(iter(answers["jax"].values()))) > 0
    for other in ("torch", "torch-source", "jax-source"):
        assert answers[other].keys() == answers["jax"].keys()
        for k in answers["jax"]:
            np.testing.assert_array_equal(answers[other][k], answers["jax"][k], err_msg=f"{other}: {k}")


def test_port_lists_jax_built_indexes(built):
    """The port's ``Hyperspace.indexes()`` reads a log the JAX package wrote."""
    jax_path = built["jax"]["session"].conf.system_path
    sess = ht.Session(conf=_conf(ht.keys, jax_path), device="cpu")
    got = ht.Hyperspace(sess).indexes().sort_values("name").reset_index(drop=True)
    ref = hst.Hyperspace(built["jax"]["session"]).indexes().sort_values("name").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, ref)
    entry = sess.index_manager.get_index("by_k")
    assert entry.to_dict() == built["jax"]["entries"]["by_k"].to_dict()
    assert ht.Hyperspace(sess).index("by_k") == hst.Hyperspace(built["jax"]["session"]).index("by_k")
    assert index_of_entry(entry).bucket_spec().num_buckets == NUM_BUCKETS


def test_lineage_and_mesh_builds(lake, tmp_path, monkeypatch):
    """The mesh build (``parallel.enabled`` and ``parallel.build.enabled``, a
    mesh of more than one shard, at least ``distributedMinRows`` rows) runs
    the exchange, and writes the bucket files of the build without
    ``parallel.enabled``, run for run and row for row, as the JAX package's
    8-device mesh build does; on one device (a one-device mesh) it is the
    plain build. The lineage build and the lifecycle actions are in the
    port: a lineage index carries ``_data_file_id``, and an action on a
    missing index raises the JAX package's error, not
    ``NotImplementedError``, and a format no source provider reads raises the
    providers' error."""
    from hyperspace_tpu_torch.indexes import covering
    from hyperspace_tpu_torch.parallel import mesh as PM

    def bucket_runs(entry):
        runs = {}
        for f in entry.content.files:
            runs.setdefault(covering.bucket_of_file(f), []).append(pq.read_table(f).to_pylist())
        return {b: sorted(r, key=repr) for b, r in runs.items()}

    buckets = {}
    mesh = {"hyperspace.parallel.enabled": "true"}
    for name, shards, extra in (("plain", 1, {}), ("mesh1", 1, mesh), ("mesh8", 8, mesh)):
        monkeypatch.setattr(PM, "SHARD_COUNT", shards)
        sess = ht.Session(conf={**_conf(ht.keys, str(tmp_path / name)), **extra}, device="cpu")
        PM.reset_collectives()
        entry = ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("i", ["k"], ["p"]))
        assert entry.state == "ACTIVE"
        assert (PM.collective_calls[("all_to_all", "buckets")] > 0) == (shards > 1), name
        buckets[name] = bucket_runs(entry)
    ref = hst.Session(conf={**_conf(hst.keys, str(tmp_path / "jax_mesh8")), **mesh})
    entry = hst.Hyperspace(ref).create_index(ref.read_parquet(lake), hst.CoveringIndexConfig("i", ["k"], ["p"]))
    assert len(ref.mesh.devices.flat) == 8
    buckets["jax_mesh8"] = bucket_runs(entry)
    assert buckets["mesh8"] == buckets["mesh1"] == buckets["plain"] == buckets["jax_mesh8"]
    monkeypatch.undo()
    sess = ht.Session(conf={**_conf(ht.keys, str(tmp_path / "lineage")), "hyperspace.index.lineage.enabled": "true"},
                      device="cpu")
    entry = ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("i", ["k"], ["p"]))
    assert pq.read_schema(entry.content.files[0]).names == ["k", "p", "_data_file_id"]
    hs = ht.Hyperspace(ht.Session(conf=_conf(ht.keys, str(tmp_path / "x")), device="cpu"))
    for op in (hs.refresh_index, hs.optimize_index, hs.delete_index, hs.vacuum_index, hs.restore_index):
        with pytest.raises(HyperspaceActionException, match="does not exist|is DOESNOTEXIST"):
            op("i")
    with pytest.raises(Exception, match="exactly one source provider"):
        hs.session.read(lake, "xml")


def test_nested_columns_raise(tmp_path):
    """A dotted name into a struct is a nested column: indexing it needs
    ``hyperspace.index.nestedColumn.enabled`` (else the JAX package's
    ``ValueError``), and with it the index stores the leaf as the flat
    column ``__hs_nested.st.a``, as the JAX package does; an unknown name
    stays a resolution error."""
    src = tmp_path / "nested"
    src.mkdir()
    pq.write_table(pa.table({"id": [1, 2], "st": pa.array([{"a": 1}, {"a": 2}])}), src / "p.parquet")
    sess = ht.Session(conf=_conf(ht.keys, str(tmp_path / "sys")), device="cpu")
    df = sess.read_parquet(str(src))
    with pytest.raises(ValueError, match="nestedColumn"):
        ht.Hyperspace(sess).create_index(df, ht.CoveringIndexConfig("n", ["st.a"], ["id"]))
    with pytest.raises(ValueError, match="could not be resolved"):
        ht.Hyperspace(sess).create_index(df, ht.CoveringIndexConfig("m", ["nope"], ["id"]))
    sess.conf.set(ht.keys.NESTED_COLUMN_ENABLED, True)
    entry = ht.Hyperspace(sess).create_index(df, ht.CoveringIndexConfig("n", ["st.a"], ["id"]))
    assert entry.derived_dataset.properties["indexedColumns"] == ["__hs_nested.st.a"]
    assert pq.read_schema(entry.content.files[0]).names == ["__hs_nested.st.a", "id"]
