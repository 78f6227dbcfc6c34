"""The port's other sources against the JAX package: Delta Lake, Iceberg and
the non-parquet file formats.

Tables are made from a seed with numpy and written by the packages' own
writers (the Delta log, Iceberg's metadata and Avro manifests). Both
packages (``hyperspace_tpu`` on the JAX CPU backend,
``hyperspace_tpu_torch`` with ``device="cpu"``) must read the same
relations: files, versions and snapshots, options, schemas and
signatures. An index over a Delta table or an Iceberg table, built by
the port, is refreshed in each mode by each package from one copied
state; the log entries (paths and timestamps aside) and the bucket files'
rows must agree. Time travel picks the same index version; hybrid scan
serves a new Delta version and a new Iceberg snapshot with the JAX
package's plan and rows; ORC, Avro, text and CSV (with its reader
options) go through a covering index and a data-skipping index alike.
The source builders of either package's conf resolve in the port.
"""

import json
import os
import re
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
from hyperspace_tpu.sources import delta as ref_delta  # noqa: E402
from hyperspace_tpu.sources import iceberg as ref_iceberg  # noqa: E402
from hyperspace_tpu.utils import avro as ref_avro  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu_torch.indexes.covering import bucket_of_file  # noqa: E402
from hyperspace_tpu_torch.sources import delta, formats, iceberg, manager  # noqa: E402
from hyperspace_tpu_torch.utils import avro  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 4


def _table(seed, n=300, k_lo=0):
    rng = np.random.default_rng([41, seed])
    f = np.round(rng.standard_normal(n) * 5, 2)
    f[rng.random(n) < 0.05] = np.nan
    return pa.table({
        "k": (k_lo + rng.integers(0, 100, n)).astype(np.int64),
        "f": f,
        "s": pa.array([f"v{x}" for x in rng.integers(0, 9, n)], mask=rng.random(n) < 0.05),
        "d": np.datetime64("1995-01-01") + rng.integers(0, 400, n).astype("timedelta64[D]"),
    })


def _conf(pkg, system, **extra):
    return {pkg.keys.SYSTEM_PATH: system, pkg.keys.NUM_BUCKETS: NUM_BUCKETS,
            "hyperspace.tpu.build.batchRows": 500, "hyperspace.tpu.query.deviceMinRows": 0, **extra}


def _session(pkg, system, **extra):
    if pkg is hst:
        return hst.Session(conf=_conf(pkg, system, **extra))
    return ht.Session(conf=_conf(pkg, system, **extra), device="cpu")


_TAG = re.compile(r"-[0-9a-f]{12}\.parquet")


def _norm_entry(entry, system):
    d = entry.to_dict()
    d["timestamp"] = 0
    infos = entry.content.file_infos()
    d["content"] = sorted((_TAG.sub(".parquet", fi.name.replace(system, "<sys>")), fi.size) for fi in infos)
    d["content_ids"] = sorted(fi.file_id for fi in infos)
    return json.loads(_TAG.sub(".parquet", json.dumps(d, sort_keys=True, default=str).replace(system, "<sys>")))


def _runs(entry):
    runs = {}
    for f in entry.content.files:
        t = pq.read_table(f)
        runs.setdefault(bucket_of_file(f), []).append(repr(t.to_pydict()))
    return {b: sorted(v) for b, v in runs.items()}


def _same(got, ref):
    assert list(got) == list(ref)
    for c in ref:
        assert got[c].dtype == ref[c].dtype, c
        if ref[c].dtype == object:
            norm = [("<nan>" if isinstance(v, float) and np.isnan(v) else v) for v in ref[c].tolist()]
            assert [("<nan>" if isinstance(v, float) and np.isnan(v) else v) for v in got[c].tolist()] == norm, c
        else:
            assert got[c].tobytes() == ref[c].tobytes(), c


def _multiset(batch):
    return sorted(zip(*(np.asarray(v).astype(str).tolist() for v in batch.values())))


# --------------------------------------------------------------------------
# Delta Lake
# --------------------------------------------------------------------------


def _relation_facts(rel):
    return ([(fi.name, fi.size, fi.modified_time) for fi in rel.all_file_infos()], rel.signature(), rel.options,
            rel.root_paths, rel.file_format, rel.has_parquet_as_source_format(), str(rel.schema))


def test_delta_relations_match_jax(tmp_path):
    """Versions, files, options, schema and signature at every version,
    from a table written by either package's writer."""
    for writer in (delta, ref_delta):
        root = str(tmp_path / writer.__name__.split(".")[0])
        assert writer.write_delta_table(_table(0), root) == 0
        assert writer.write_delta_table(_table(1), root) == 1
        first = sorted(delta._replay(root, 0))[0]
        assert writer.delete_delta_files(root, [first]) == 2
        assert writer.write_delta_table(_table(2), root, mode="overwrite") == 3
        assert delta.list_versions(root) == ref_delta.list_versions(root) == [0, 1, 2, 3]
        for v in (0, 1, 2, 3, None):
            assert _relation_facts(delta.DeltaLakeRelation(root, v)) == _relation_facts(
                ref_delta.DeltaLakeRelation(root, v))
        for v in (0, 2):
            got = ht.Session(device="cpu").read_delta(root, version=v).collect()
            _same(got, hst.Session().read_delta(root, version=v).collect())


def _delta_lake(root):
    lake = os.path.join(root, "delta")
    delta.write_delta_table(_table(0), lake)
    delta.write_delta_table(_table(1), lake)
    delta.write_delta_table(_table(2), lake)
    system = os.path.join(root, "sys")
    sess = _session(ht, system, **{"hyperspace.index.lineage.enabled": True})
    hs = ht.Hyperspace(sess)
    hs.create_index(sess.read_delta(lake), ht.CoveringIndexConfig("dcov", ["k"], ["f", "s"]))
    hs.create_index(sess.read_delta(lake), ht.DataSkippingIndexConfig("dskip", ht.MinMaxSketch("k")))
    return lake, system


def _change_delta(lake):
    delta.write_delta_table(_table(3, n=120, k_lo=100), lake)
    delta.delete_delta_files(lake, [sorted(delta._replay(lake, 0))[0]])


@pytest.mark.parametrize("mode", ["incremental", "full", "quick"])
def test_delta_refresh_matches_jax(tmp_path, mode):
    """Each refresh mode over a Delta table with a new version and a removed
    file gives the same log entries, bucket rows and sketches in both
    packages, each from a copy of one state."""
    lake, system = _delta_lake(str(tmp_path))
    _change_delta(lake)
    out = {}
    for pkg in (hst, ht):
        sys_copy = str(tmp_path / f"sys_{pkg.__name__}")
        shutil.copytree(system, sys_copy)
        sess = _session(pkg, sys_copy)
        hs = pkg.Hyperspace(sess)
        for name in ("dcov", "dskip"):
            hs.refresh_index(name, mode)
        entries = {n: sess.index_manager.get_index(n) for n in ("dcov", "dskip")}
        sketch = pq.read_table(entries["dskip"].content.files[0]).to_pydict()
        out[pkg] = ({n: _norm_entry(e, sys_copy) for n, e in entries.items()}, _runs(entries["dcov"]), sketch,
                    entries)
    (ref_norm, ref_runs, ref_sketch, _), (norm, runs, sketch, entries) = out[hst], out[ht]
    assert norm == ref_norm
    assert runs == ref_runs
    assert repr(sketch) == repr(ref_sketch)
    assert "deltaVersions" in entries["dcov"].properties


def test_delta_time_travel_picks_the_same_index_version(tmp_path):
    """After a refresh at a later version, a query of the first version
    serves the index version recorded for it, in both packages."""
    lake, system = _delta_lake(str(tmp_path))
    delta.write_delta_table(_table(3, n=120, k_lo=100), lake)
    ht.Hyperspace(_session(ht, system)).refresh_index("dcov", "incremental")
    for version in (2, 3, None):
        out = {}
        for pkg in (hst, ht):
            sess = _session(pkg, system)
            sess.enable_hyperspace()
            q = sess.read_delta(lake, version=version).filter(pkg.col("k") == 42).select("k", "f")
            out[pkg] = (q.optimized_plan().pretty(), q.collect())
        assert out[ht][0] == out[hst][0]
        assert ("LogVersion: 1" in out[ht][0]) == (version == 2), out[ht][0]
        _same(out[ht][1], out[hst][1])


def test_delta_hybrid_scan_matches_jax(tmp_path):
    """Over a new Delta version (a file appended, one removed) the lineage
    index serves through hybrid scan with the JAX package's plan and rows."""
    lake, system = _delta_lake(str(tmp_path))
    _change_delta(lake)
    for query in (lambda df, c: df.filter(c("k") < 30).select("k", "f", "s"),
                  lambda df, c: df.filter(c("k") > 90).select("k", "s")):
        out = {}
        for pkg in (hst, ht):
            sess = _session(pkg, system, **{"hyperspace.index.hybridscan.enabled": True,
                                            "hyperspace.index.hybridscan.maxDeletedRatio": 0.5})
            sess.enable_hyperspace()
            q = query(sess.read_delta(lake), pkg.col)
            out[pkg] = (q.optimized_plan().pretty(), q.collect())
            sess.disable_hyperspace()
            off = q.collect()
        assert out[ht][0] == out[hst][0]
        assert "BucketUnion" in out[ht][0] and "_data_file_id" in out[ht][0]
        _same(out[ht][1], out[hst][1])
        assert _multiset(out[ht][1]) == _multiset(off)


# --------------------------------------------------------------------------
# Iceberg
# --------------------------------------------------------------------------


def test_iceberg_relations_match_jax(tmp_path):
    """Snapshots, files, options, schema and signature of a table written by
    either package's writer; the Avro manifests decode alike."""
    for writer in (iceberg, ref_iceberg):
        root = str(tmp_path / writer.__name__.split(".")[0])
        s0 = writer.write_iceberg_table(_table(0), root)
        s1 = writer.write_iceberg_table(_table(1), root)
        for sid in (s0, s1, None):
            assert _relation_facts(iceberg.IcebergRelation(root, sid)) == _relation_facts(
                ref_iceberg.IcebergRelation(root, sid))
        md = os.path.join(root, "metadata")
        for name in sorted(os.listdir(md)):
            if name.endswith(".avro"):
                assert avro.read_container(os.path.join(md, name)) == ref_avro.read_container(os.path.join(md, name))
        _same(ht.Session(device="cpu").read_iceberg(root, snapshot_id=s0).collect(),
              hst.Session().read_iceberg(root, snapshot_id=s0).collect())


@pytest.mark.parametrize("mode", ["incremental", "full", "quick"])
def test_iceberg_refresh_and_hybrid_match_jax(tmp_path, mode):
    """An index over an Iceberg table refreshes alike in each mode after a
    new snapshot; before the refresh, hybrid scan serves the new snapshot
    with the JAX package's plan and rows."""
    root = str(tmp_path / "ice")
    iceberg.write_iceberg_table(_table(0), root)
    iceberg.write_iceberg_table(_table(1), root)
    system = str(tmp_path / "sys")
    sess = _session(ht, system)
    ht.Hyperspace(sess).create_index(sess.read_iceberg(root), ht.CoveringIndexConfig("icov", ["k"], ["f", "d"]))
    iceberg.write_iceberg_table(_table(2, n=100, k_lo=100), root)
    out = {}
    for pkg in (hst, ht):
        s = _session(pkg, system, **{"hyperspace.index.hybridscan.enabled": True})
        s.enable_hyperspace()
        q = s.read_iceberg(root).filter(pkg.col("k") >= 95).select("k", "f", "d")
        out[pkg] = (q.optimized_plan().pretty(), q.collect())
    assert out[ht][0] == out[hst][0] and "BucketUnion" in out[ht][0]
    _same(out[ht][1], out[hst][1])
    refreshed = {}
    for pkg in (hst, ht):
        sys_copy = str(tmp_path / f"sys_{pkg.__name__}")
        shutil.copytree(system, sys_copy)
        s = _session(pkg, sys_copy)
        pkg.Hyperspace(s).refresh_index("icov", mode)
        e = s.index_manager.get_index("icov")
        refreshed[pkg] = (_norm_entry(e, sys_copy), _runs(e))
    assert refreshed[ht] == refreshed[hst]


# --------------------------------------------------------------------------
# the other file formats
# --------------------------------------------------------------------------


def _write_formats(root):
    """{format: (directory, reader options)} holding the same rows."""
    out = {}
    tables = [_table(i, n=200, k_lo=100 * i).drop(["d"]) for i in range(3)]
    for fmt in ("orc", "avro", "csv", "csv_opts", "json", "text"):
        d = os.path.join(root, fmt)
        os.makedirs(d)
        for i, t in enumerate(tables):
            path = os.path.join(d, f"part-{i:05d}.{fmt.split('_')[0]}")
            if fmt == "orc":
                orc.write_table(t, path)
            elif fmt == "avro":
                schema = {"type": "record", "name": "r", "fields": [
                    {"name": "k", "type": "long"}, {"name": "f", "type": "double"},
                    {"name": "s", "type": ["null", "string"]}]}
                avro.write_container(path, schema, t.to_pylist())
            elif fmt == "csv":
                pacsv.write_csv(t, path)
            elif fmt == "csv_opts":
                with open(path, "w") as f:
                    for row in t.to_pylist():
                        f.write(f"{row['k']};{row['f']};{row['s'] or ''}\n")
            elif fmt == "json":
                with open(path, "w") as f:
                    for row in t.to_pylist():
                        f.write(json.dumps({"k": row["k"], "s": row["s"]}) + "\n")
            else:
                formats.write_text(path, [f"{row['k']},{row['s']}" for row in t.to_pylist()])
        out[fmt] = (d, {"delimiter": ";", "header": "false"} if fmt == "csv_opts" else {})
    return out


@pytest.fixture(scope="module")
def format_lakes(tmp_path_factory):
    return _write_formats(str(tmp_path_factory.mktemp("formats")))


def _reader(sess, fmt, path, options):
    kind = fmt.split("_")[0]
    return sess.read(path, kind, **options)


@pytest.mark.parametrize("fmt", ["orc", "avro", "csv", "csv_opts", "json", "text"])
def test_formats_index_and_skip_like_jax(format_lakes, tmp_path, fmt):
    """Each format reads alike in both packages; a covering index and a
    MinMax data-skipping index built by the port serve both packages with
    the same plans and rows."""
    path, options = format_lakes[fmt]
    system = str(tmp_path / "sys")
    sess = _session(ht, system)
    df = _reader(sess, fmt, path, options)
    key = {"text": "value", "csv_opts": "f0"}.get(fmt, "k")
    other = [c for c in df.columns if c != key][:1]
    ht.Hyperspace(sess).create_index(df, ht.CoveringIndexConfig("fcov", [key], other))
    if fmt not in ("text",):
        ht.Hyperspace(sess).create_index(df, ht.DataSkippingIndexConfig("fskip", ht.MinMaxSketch(key)))
    assert df.columns == _reader(_session(hst, system), fmt, path, options).columns
    lit = "123,v4" if fmt == "text" else 42
    out = {}
    for pkg in (hst, ht):
        s = _session(pkg, system)
        full = _reader(s, fmt, path, options).collect()
        s.enable_hyperspace()
        q = _reader(s, fmt, path, options).filter(pkg.col(key) == lit).select(key, *other)
        q2 = _reader(s, fmt, path, options).filter(pkg.col(key) == lit)
        out[pkg] = (full, q.optimized_plan().pretty(), q.collect(), q2.optimized_plan().pretty(), q2.collect())
    for got, ref in zip(out[ht], out[hst]):
        if isinstance(ref, str):
            assert got == ref
        else:
            _same(got, ref)
    assert "IndexScan" in out[ht][1]
    # every column: the data-skipping index prunes to one file where the
    # covering index cannot cover the query
    assert "Hyperspace(Type: DS" in out[ht][3] or "IndexScan" in out[ht][3], out[ht][3]


def test_source_builders_resolve_either_package_names(tmp_path):
    """The builders key takes the port's class names and the JAX package's
    as aliases; an unknown name raises."""
    jax_names = ",".join(f"hyperspace_tpu.sources.{m}" for m in (
        "default.DefaultFileBasedSourceBuilder", "delta.DeltaLakeSourceBuilder", "iceberg.IcebergSourceBuilder"))
    lake = str(tmp_path / "d")
    delta.write_delta_table(_table(0), lake)
    for names in (jax_names, ht.config.DEFAULTS[ht.keys.SOURCE_BUILDERS]):
        sess = ht.Session(conf={ht.keys.SOURCE_BUILDERS: names}, device="cpu")
        assert sess.read(lake, "delta").count() == 300
        assert sess.read(lake, "delta", versionAsOf="0").count() == 300
    sess = ht.Session(conf={ht.keys.SOURCE_BUILDERS: "hyperspace_tpu.sources.default.DefaultFileBasedSourceBuilder"},
                      device="cpu")
    with pytest.raises(manager.HyperspaceException):
        sess.read(lake, "delta")
    with pytest.raises(manager.HyperspaceException, match="Unknown source builder"):
        manager.builder_class("some.module.Builder")
