"""The port's scan pruning against the JAX package.

Row-group pruning: a parquet read under a pushed-down predicate decodes
only the row groups whose footer min/max may match
(``exec/io.py::prune_row_groups``). Over files of 10-row groups made from a
seed with numpy (ints, floats with NaN, strings, dates, a column written
without statistics, a shuffled column) the kept groups (or None) must be
the JAX package's for every predicate shape, including shapes outside the
evaluator's language; the pruned reads give the same batches. A Filter
over a source scan, over a covering index and over streamed chunks gets
the same rows into its mask in the same order as in the JAX package, with
pruning on and with ``hyperspace.exec.io.rowGroupPruning=false``, and the
streamed pipelined run equals the serial one.

Hive-partition pruning: over a lake partitioned by an int, a string with
``__HIVE_DEFAULT_PARTITION__`` and URL-escaped values, the files a Filter
reads and its rows are the JAX package's; a mixed layout is unpartitioned
in both; a data-skipping partition sketch prunes the same files.
Both packages run on the CPU (``hyperspace_tpu`` on the JAX CPU backend,
``hyperspace_tpu_torch`` with ``device="cpu"``). Every comparison is exact.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
from hyperspace_tpu.exec import executor as RE  # noqa: E402
from hyperspace_tpu.exec import io as RIO  # noqa: E402
from hyperspace_tpu.indexes.dataskipping import PartitionSketch as RPartitionSketch  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu_torch.exec import executor as E  # noqa: E402
from hyperspace_tpu_torch.exec import io as IO  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.indexes.dataskipping import PartitionSketch  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

D0 = np.datetime64("1998-01-01")
ROWS_PER_GROUP = 10


def _table(i, n=80):
    """One file's rows: ``i`` ascending from 100 i, ``f`` ascending with NaN
    in every third group, ``s`` ascending strings with nulls, ``d`` dates,
    ``nostat`` without footer statistics, ``shuf`` shuffled."""
    rng = np.random.default_rng([21, i])
    base = np.arange(n) + 100 * i
    f = base * 0.5 + np.round(rng.uniform(0, 0.4, n), 2)
    f[(np.arange(n) // ROWS_PER_GROUP) % 3 == 1] = np.nan
    return pa.table({
        "i": base.astype(np.int64),
        "f": f,
        "s": pa.array([f"s{x:04d}" for x in base], mask=rng.random(n) < 0.05),
        "d": D0 + base.astype("timedelta64[D]"),
        "nostat": base.astype(np.int64),
        "shuf": rng.permutation(n).astype(np.int64),
    })


def _write(path, i):
    pq.write_table(_table(i), path, row_group_size=ROWS_PER_GROUP,
                   write_statistics=["i", "f", "s", "d", "shuf"])


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("prune_lake")
    d = root / "src"
    d.mkdir()
    for i in range(3):
        _write(str(d / f"part-{i:05d}.parquet"), i)
    return str(d)


PREDICATES = {
    "int_ge": lambda c, lit: c("i") >= 35,
    "int_below_all": lambda c, lit: c("i") < -1,
    "int_keeps_all": lambda c, lit: c("i") >= 0,
    "int_eq": lambda c, lit: c("i") == 117,
    "int_range": lambda c, lit: (c("i") > 20) & (c("i") < 30),
    "int_or": lambda c, lit: (c("i") < 5) | (c("i") > 270),
    "int_in": lambda c, lit: c("i").isin(3, 155, 999),
    "int_not": lambda c, lit: ~(c("i") < 240),
    "int_ne": lambda c, lit: c("i") != 5,
    "lit_left": lambda c, lit: lit(50) > c("i"),
    "float_gt": lambda c, lit: c("f") > 110.0,
    "float_lt": lambda c, lit: c("f") < 3.0,
    "float_is_null": lambda c, lit: c("f").is_null(),
    "string_eq": lambda c, lit: c("s") == "s0117",
    "string_ge": lambda c, lit: c("s") >= "s0275",
    "date_lt": lambda c, lit: c("d") < D0 + np.timedelta64(15, "D"),
    "date_range": lambda c, lit: (c("d") >= D0 + np.timedelta64(120, "D")) & (c("d") < D0 + np.timedelta64(140, "D")),
    "no_statistics": lambda c, lit: c("nostat") > 250,
    "shuffled": lambda c, lit: c("shuf") > 70,
    "arithmetic": lambda c, lit: c("i") + 1 > 240,
    "mixed_and": lambda c, lit: (c("nostat") > 5) & (c("i") < 12),
}


def _pred(pkg, name):
    return PREDICATES[name](pkg.col, pkg.lit)


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_prune_row_groups_matches_jax(lake, name):
    """The kept row groups of each file, or None, are the JAX package's."""
    for f in sorted(os.listdir(lake)):
        path = os.path.join(lake, f)
        assert IO.prune_row_groups(path, _pred(ht, name)) == RIO.prune_row_groups(path, _pred(hst, name))


def test_prune_row_groups_spec_cases(lake):
    """``tests/test_scan_pipeline.py::test_prune_semantics``'s shapes: a
    range keeps its groups, a miss keeps none, a predicate every group may
    match prunes nothing (None)."""
    path = os.path.join(lake, "part-00000.parquet")
    assert IO.prune_row_groups(path, ht.col("i") >= 35) == [3, 4, 5, 6, 7]
    assert IO.prune_row_groups(path, ht.col("s") == "s0017") == [1]
    assert IO.prune_row_groups(path, ht.col("i") < -1) == []
    assert IO.prune_row_groups(path, ht.col("i") >= 0) is None


def _nan_free(v):
    return "<nan>" if isinstance(v, float) and np.isnan(v) else v


def _same(got, ref):
    assert list(got) == list(ref)
    for c in ref:
        assert got[c].dtype == ref[c].dtype, c
        if ref[c].dtype == object:
            assert [_nan_free(v) for v in got[c].tolist()] == [_nan_free(v) for v in ref[c].tolist()], c
        else:
            assert got[c].tobytes() == ref[c].tobytes(), c


@pytest.mark.parametrize("name", ["int_ge", "int_below_all", "int_keeps_all", "string_eq", "date_range", "shuffled"])
def test_pruned_reads_match_jax(lake, name):
    """A pruned read gives the JAX package's batch (a fully pruned file the
    typed empty batch), never poisons the full read's cache, and a repeated
    pruned read of several files is one cache hit."""
    files = [os.path.join(lake, f) for f in sorted(os.listdir(lake))]
    cols = ["i", "f", "s", "d"]
    for fs in ([files[0]], files):
        IO.clear_io_cache()
        RIO.clear_io_cache()
        got = IO.read_parquet_batch(fs, cols, predicate=_pred(ht, name))
        _same(got, RIO.read_parquet_batch(fs, cols, predicate=_pred(hst, name)))
        if len(fs) > 1:
            with trace.recording() as events:
                _same(IO.read_parquet_batch(fs, cols, predicate=_pred(ht, name)), got)
            assert set(events) == {("decode", "cached")}, events
        assert len(IO.read_parquet_batch(fs, cols)["i"]) == 80 * len(fs)


def _session(pkg, root, **extra):
    conf = {pkg.keys.SYSTEM_PATH: os.path.join(root, "sys"), pkg.keys.NUM_BUCKETS: 4,
            "hyperspace.tpu.query.deviceMinRows": 0, **extra}
    return hst.Session(conf=conf) if pkg is hst else ht.Session(conf=conf, device="cpu")


def _filter_inputs(pkg, monkeypatch):
    """Record every batch a Filter masks (the rows that reach it)."""
    mod = RE if pkg is hst else E
    seen = []
    real = mod.Executor._filter_mask

    def spy(self, plan, child, *a, **k):
        seen.append({c: v for c, v in child.items()})
        return real(self, plan, child, *a, **k)

    monkeypatch.setattr(mod.Executor, "_filter_mask", spy)
    return seen


@pytest.mark.parametrize("pruning", [True, False])
@pytest.mark.parametrize("name", ["int_range", "string_eq", "date_lt", "int_or", "no_statistics"])
def test_filter_inputs_match_jax(lake, tmp_path, monkeypatch, name, pruning):
    """With pruning on, a Filter directly over the source scan (the query
    keeps every column, so no Project sits between them) gets only the
    kept row groups' rows; off, every row; in both packages alike."""
    out = {}
    for pkg in (hst, ht):
        RIO.clear_io_cache()
        IO.clear_io_cache()
        sess = _session(pkg, str(tmp_path / pkg.__name__), **{"hyperspace.exec.io.rowGroupPruning": pruning})
        seen = _filter_inputs(pkg, monkeypatch)
        got = sess.read_parquet(lake).filter(_pred(pkg, name)).collect()
        out[pkg] = (got, seen)
    (ref, ref_seen), (got, seen) = out[hst], out[ht]
    _same(got, ref)
    assert len(seen) == len(ref_seen) == 1
    _same(seen[0], ref_seen[0])
    if pruning and name != "no_statistics":
        assert len(seen[0]["i"]) < 240


@pytest.mark.parametrize("pruning", [True, False])
def test_index_scan_filter_inputs_match_jax(lake, tmp_path, monkeypatch, pruning):
    """A Filter over a covering index pushes its predicate onto a clone of
    the IndexScan: the index files' row groups prune alike."""
    system = str(tmp_path / "idx")
    sess = _session(ht, system, **{"hyperspace.tpu.build.batchRows": 40})
    ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("by_i", ["i"], ["s"]))
    out = {}
    for pkg in (hst, ht):
        RIO.clear_io_cache()
        IO.clear_io_cache()
        s = _session(pkg, system, **{"hyperspace.exec.io.rowGroupPruning": pruning})
        s.enable_hyperspace()
        seen = _filter_inputs(pkg, monkeypatch)
        q = s.read_parquet(lake).filter((pkg.col("i") > 100) & (pkg.col("i") < 130)).select("i", "s")
        assert "IndexScan" in q.optimized_plan().pretty()
        out[pkg] = (q.collect(), seen)
    (ref, ref_seen), (got, seen) = out[hst], out[ht]
    _same(got, ref)
    assert len(seen) == len(ref_seen) == 1
    _same(seen[0], ref_seen[0])


@pytest.mark.parametrize("pipeline", [True, False])
def test_streamed_chunks_prune_like_jax(lake, tmp_path, monkeypatch, pipeline):
    """A streamed aggregate's chunks carry the pushed-down predicate: each
    file's kept row groups are the JAX package's, the result is too, and
    the pipelined run equals the serial one."""
    stream = {"hyperspace.exec.stream.aggMinBytes": 1, "hyperspace.exec.stream.chunkBytes": 1,
              "hyperspace.exec.pipeline.enabled": pipeline}
    out = {}
    for pkg in (hst, ht):
        RIO.clear_io_cache()
        IO.clear_io_cache()
        mod = RIO if pkg is hst else IO
        kept = []
        real = mod.prune_row_groups

        def spy(path, predicate, real=real, kept=kept):
            got = real(path, predicate)
            kept.append((os.path.basename(path), got))
            return got

        monkeypatch.setattr(mod, "prune_row_groups", spy)
        sess = _session(pkg, str(tmp_path / pkg.__name__), **stream)
        q = sess.read_parquet(lake).filter((pkg.col("i") % 7 == 0) & (pkg.col("i") > 150)).group_by("s").agg(
            n=("*", "count"), m=("f", "max"))
        rec = trace if pkg is ht else __import__("hyperspace_tpu.exec.trace", fromlist=["x"])
        with rec.recording() as events:
            got = q.collect()
        out[pkg] = (got, sorted(kept, key=str), [e for e in events if e[0] == "agg"])
    (ref, ref_kept, ref_agg), (got, kept, agg) = out[hst], out[ht]
    _same(got, ref)
    assert kept == ref_kept and any(k is not None for _, k in kept)
    assert agg == ref_agg and ("agg", "streamed-partial") in agg


# --------------------------------------------------------------------------
# hive-partition pruning
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hive(tmp_path_factory):
    """``y`` (int) x ``c`` (string: plain, URL-escaped, and the hive null)."""
    root = tmp_path_factory.mktemp("hive") / "t"
    rng = np.random.default_rng(31)
    for y in (1994, 1995, 1996):
        for c in ("east", "new%20york", "__HIVE_DEFAULT_PARTITION__"):
            d = root / f"y={y}" / f"c={c}"
            d.mkdir(parents=True)
            n = 30
            pq.write_table(pa.table({"v": rng.integers(0, 1000, n).astype(np.int64),
                                     "w": np.round(rng.standard_normal(n), 3)}), d / "part-0.parquet")
    return str(root)


HIVE_PREDICATES = {
    "int_eq": lambda c: c("y") == 1995,
    "int_range": lambda c: (c("y") >= 1995) & (c("v") < 500),
    "string_eq": lambda c: c("c") == "east",
    "escaped": lambda c: c("c") == "new york",
    "hive_null": lambda c: c("c").is_null(),
    "both": lambda c: (c("y") == 1996) & (c("c") != "east"),
    "or_across": lambda c: (c("y") == 1994) | (c("v") > 900),
    "not_partition": lambda c: c("v") > 990,
}


def _files_read(pkg, monkeypatch):
    mod = RE if pkg is hst else E
    seen = []
    real = mod._read_files

    def spy(files, *a, **k):
        seen.append(sorted(files))
        return real(files, *a, **k)

    monkeypatch.setattr(mod, "_read_files", spy)
    return seen


@pytest.mark.parametrize("name", sorted(HIVE_PREDICATES))
def test_partition_pruning_matches_jax(hive, tmp_path, monkeypatch, name):
    """The files a Filter over a hive-partitioned source reads, and its rows
    (partition columns attached), are the JAX package's."""
    out = {}
    for pkg in (hst, ht):
        sess = _session(pkg, str(tmp_path / pkg.__name__))
        seen = _files_read(pkg, monkeypatch)
        got = sess.read_parquet(hive).filter(HIVE_PREDICATES[name](pkg.col)).select("y", "c", "v", "w").collect()
        out[pkg] = (got, seen)
    (ref, ref_seen), (got, seen) = out[hst], out[ht]
    _same(got, ref)
    assert seen == ref_seen
    if name in ("int_eq", "string_eq", "escaped", "hive_null"):
        assert len(seen[-1]) == 3
    if name == "both":
        assert len(seen[-1]) == 1  # NULL != 'east' is not true


def test_mixed_layout_is_unpartitioned(tmp_path, monkeypatch):
    """A lake with a partition directory and a flat file has no partition
    columns in either package, and every file is read."""
    root = tmp_path / "mixed"
    (root / "a=1").mkdir(parents=True)
    pq.write_table(pa.table({"v": np.arange(4, dtype=np.int64)}), root / "a=1" / "x.parquet")
    pq.write_table(pa.table({"v": np.arange(4, 8, dtype=np.int64)}), root / "flat.parquet")
    out = {}
    for pkg in (hst, ht):
        sess = _session(pkg, str(tmp_path / pkg.__name__))
        df = sess.read_parquet(str(root))
        seen = _files_read(pkg, monkeypatch)
        out[pkg] = (df.columns, df.filter(pkg.col("v") > 2).collect(), seen)
    assert out[ht][0] == out[hst][0] == ["v"]
    _same(out[ht][1], out[hst][1])
    assert out[ht][2] == out[hst][2] and len(out[ht][2][-1]) == 2


def test_partition_sketch_prunes_like_jax(tmp_path):
    """A data-skipping partition sketch keeps the same one file of three,
    with the same plan and rows."""
    root = tmp_path / "parts"
    root.mkdir()
    for i, region in enumerate(["east", "west", "north"]):
        pq.write_table(pa.table({"region": np.array([region] * 100), "v": np.arange(100, dtype=np.int64)}),
                       root / f"part-{i:05d}.parquet")
    system = str(tmp_path / "sys")
    sess = _session(ht, system)
    ht.Hyperspace(sess).create_index(sess.read_parquet(str(root)),
                                     ht.DataSkippingIndexConfig("dsPart", PartitionSketch("region")))
    out = {}
    for pkg, lg in ((hst, RL), (ht, L)):
        s = _session(pkg, system)
        s.enable_hyperspace()
        q = s.read_parquet(str(root)).filter(pkg.col("region") == "west").select("v")
        plan = q.optimized_plan()
        fscans = lg.collect(plan, lambda p: type(p).__name__ == "FileScan")
        assert len(fscans) == 1 and len(fscans[0].files) == 1
        out[pkg] = (plan.pretty(), q.collect())
    assert out[ht][0] == out[hst][0]
    _same(out[ht][1], out[hst][1])
    assert RPartitionSketch("region").output_names() == PartitionSketch("region").output_names()
