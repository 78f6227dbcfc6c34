"""The port's index lifecycle against the JAX package.

One small lake, made from a seed with numpy (an int key, floats with NaN
and -0.0, strings and dates with nulls, a nullable int64 column), is
indexed by both packages (``hyperspace_tpu`` on the JAX CPU backend,
``hyperspace_tpu_torch`` with ``device="cpu"``) at 8 buckets: a covering
index, a covering index with lineage and a data-skipping index. The lake
then changes (files appended, a file dropped) and the lifecycle runs phase
by phase: incremental refresh (append-only, with deletes and lineage, and
its error without lineage), quick and full refresh, quick and full
optimize (and its ``NoChangesException``), delete, restore, vacuum and
cancel.

Each phase starts both packages from one index state: a copy of the state
the previous phase left in one package's system path, alternately the JAX
package's and the port's. So each package acts on the other's indexes, and
the two results can be held byte for byte even where an action reads old
index files in the content's order (incremental refresh with deletes,
optimize): that order follows the random tags in the file names. After
every action the returned entry or the exception, every index's log entry
(ids, timestamps and absolute paths aside), every bucket file's rows in
order, every sketch row and ``Hyperspace.indexes()`` must be the JAX
package's; after every phase each package answers the queries over both
packages' results as hyperspace off does. The shapes of
``tests/test_refresh_optimize.py`` (less hybrid scan),
``test_index_manager_matrix.py`` and ``test_action_failure.py`` follow.
"""

import json
import os
import re
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.plan import logical as RL  # noqa: E402
from hyperspace_tpu_torch.indexes.covering import bucket_of_file  # noqa: E402
from hyperspace_tpu_torch.indexes.registry import index_of_entry  # noqa: E402
from hyperspace_tpu_torch.plan import logical as L  # noqa: E402

pytestmark = pytest.mark.torch_port

NUM_BUCKETS = 8
BATCH_ROWS = 700
PACKAGES = (("jax", hst), ("torch", ht))


def write_part(root, idx, n=600, seed=0, k_lo=0):
    """One file; its ``k`` in [k_lo, k_lo + 100), as a later ingest lands a
    later key range."""
    rng = np.random.default_rng([seed, idx])
    f = np.round(rng.standard_normal(n) * 3, 1)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    dates = np.datetime64("1996-01-01") + rng.integers(0, 900, n).astype("timedelta64[D]")
    pq.write_table(pa.table({
        "k": k_lo + rng.integers(0, 100, n),
        "f": f,
        "s": pa.array([f"s{x}" for x in rng.integers(0, 30, n)], mask=rng.random(n) < 0.05),
        "d": pa.array(dates, mask=rng.random(n) < 0.05),
        "n": pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.1),
    }), os.path.join(root, f"part-{idx:05d}.parquet"))


def _session(pkg, path, **extra):
    conf = {pkg.keys.SYSTEM_PATH: path, pkg.keys.NUM_BUCKETS: NUM_BUCKETS,
            "hyperspace.tpu.build.batchRows": BATCH_ROWS, **extra}
    return pkg.Session(conf=conf) if pkg is hst else pkg.Session(conf=conf, device="cpu")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the exception itself is what is compared
        return ("raised", type(e).__name__, str(e))


_TAG = re.compile(r"-[0-9a-f]{12}\.parquet")


def _norm(text: str, roots) -> str:
    for name, root in roots.items():
        text = text.replace(root, f"<{name}>")
    return _TAG.sub(".parquet", text)


def _norm_entry(entry, roots):
    """The log entry as a dict, with what legitimately differs taken out:
    timestamps, the system path, the random tag in each index file name and
    which file got which id (ids follow file-name order); sizes stay."""
    if entry is None:
        return None
    d = entry.to_dict()
    d["timestamp"] = 0
    infos = entry.content.file_infos()
    d["content"] = sorted((_norm(fi.name, roots), fi.size) for fi in infos)
    d["content_ids"] = sorted(fi.file_id for fi in infos)
    return json.loads(_norm(json.dumps(d, sort_keys=True, default=str), roots))


def _runs(entry):
    """{bucket: sorted [file rows in order]}: a bucket's runs carry random
    file-name tags, so they compare as a set of whole files."""
    runs = {}
    for f in entry.content.files:
        t = pq.read_table(f)
        runs.setdefault(bucket_of_file(f), []).append(repr(t.to_pydict()) + repr(t.schema))
    return {b: sorted(v) for b, v in runs.items()}


def _data(entry):
    if entry is None or entry.state == "DOESNOTEXIST":
        return None
    if entry.kind == "CoveringIndex":
        return _runs(entry)
    return repr(index_of_entry(entry).read_sketch_table(entry).to_pydict())


INDEXES = ("cov", "lin", "skip")


def _snapshot(sess, hs, roots):
    out = {}
    for name in INDEXES:
        entry = sess.index_manager.get_index(name)
        out[name] = {"entry": _norm_entry(entry, roots), "data": _data(entry)}
    listed = hs.indexes()
    out["indexes()"] = _norm(json.dumps(listed.to_dict(orient="records"), default=str), roots)
    entry = sess.index_manager.get_index("cov")
    out["cov_files"] = list(entry.content.files) if entry is not None else []
    return out


def _create(pkg, hs, sess, lake):
    df = sess.read_parquet(lake)
    out = [hs.create_index(df, pkg.CoveringIndexConfig("cov", ["k"], ["s", "f", "d"]))]
    sess.conf.set(pkg.keys.LINEAGE_ENABLED, True)
    out.append(hs.create_index(df, pkg.CoveringIndexConfig("lin", ["s"], ["k", "d", "n"])))
    sess.conf.set(pkg.keys.LINEAGE_ENABLED, False)
    out.append(hs.create_index(df, pkg.DataSkippingIndexConfig(
        "skip", pkg.MinMaxSketch("k"), pkg.MinMaxSketch("f"), pkg.BloomFilterSketch("s"))))
    return out[-1]


def _stuck_then_cancel(pkg, hs, sess, lake):
    """A transient REFRESHING entry left by a crashed action, then cancel."""
    from importlib import import_module

    log_manager = import_module(f"{pkg.__name__}.models.log_manager")
    path = os.path.join(sess.conf.get(pkg.keys.SYSTEM_PATH), "lin")
    log_m = log_manager.IndexLogManager(path)
    stuck = log_m.get_latest_log()
    stuck.state = "REFRESHING"
    assert log_m.write_log(log_m.get_latest_id() + 1, stuck)
    hs._manager.clear_cache()
    return hs.cancel("lin")


def _drop(lake, idx):
    os.remove(os.path.join(lake, f"part-{idx:05d}.parquet"))


# phase -> (lake edit before it, the package whose previous state both start
# from, [(action id, action)]); an action is fn(pkg, hs, sess, lake)
PHASES = [
    ("create", None, None, [("create", _create)]),
    ("append", lambda lake: [write_part(lake, 3, 500, seed=1, k_lo=100),
                             write_part(lake, 4, 300, seed=1, k_lo=100)], "torch", [
        ("incremental_append", lambda p, hs, s, l: hs.refresh_index("cov", "incremental")),
        ("incremental_skip", lambda p, hs, s, l: hs.refresh_index("skip", "incremental")),
        ("quick_lin", lambda p, hs, s, l: hs.refresh_index("lin", "quick")),
        ("incremental_no_changes", lambda p, hs, s, l: hs.refresh_index("cov", "incremental")),
        ("bad_mode", lambda p, hs, s, l: hs.refresh_index("cov", "sometimes")),
    ]),
    ("optimize", None, "jax", [
        ("optimize_skip", lambda p, hs, s, l: hs.optimize_index("skip", "quick")),
        ("optimize_quick", lambda p, hs, s, l: hs.optimize_index("cov", "quick")),
        ("optimize_full_no_changes", lambda p, hs, s, l: hs.optimize_index("cov", "full")),
        ("optimize_bad_mode", lambda p, hs, s, l: hs.optimize_index("cov", "fast")),
    ]),
    ("delete", lambda lake: _drop(lake, 1), "torch", [
        ("incremental_without_lineage", lambda p, hs, s, l: hs.refresh_index("cov", "incremental")),
        ("incremental_lineage", lambda p, hs, s, l: hs.refresh_index("lin", "incremental")),
        ("full_cov", lambda p, hs, s, l: hs.refresh_index("cov", "full")),
        ("quick_skip", lambda p, hs, s, l: hs.refresh_index("skip", "quick")),
        ("full_skip", lambda p, hs, s, l: hs.refresh_index("skip", "full")),
    ]),
    ("append_again", lambda lake: write_part(lake, 5, 400, seed=2, k_lo=200), "jax", [
        ("incremental_lineage_append", lambda p, hs, s, l: hs.refresh_index("lin", "incremental")),
        ("optimize_full_lineage", lambda p, hs, s, l: hs.optimize_index("lin", "full")),
        ("incremental_skip_append", lambda p, hs, s, l: hs.refresh_index("skip", "incremental")),
    ]),
    ("maintenance", None, "torch", [
        ("restore_active", lambda p, hs, s, l: hs.restore_index("cov")),
        ("vacuum_active", lambda p, hs, s, l: hs.vacuum_index("cov")),
        ("cancel_stable", lambda p, hs, s, l: hs.cancel("cov")),
        ("delete", lambda p, hs, s, l: hs.delete_index("cov")),
        ("refresh_deleted", lambda p, hs, s, l: hs.refresh_index("cov", "full")),
        ("optimize_deleted", lambda p, hs, s, l: hs.optimize_index("cov", "full")),
        ("restore", lambda p, hs, s, l: hs.restore_index("cov")),
        ("delete_again", lambda p, hs, s, l: hs.delete_index("cov")),
        ("vacuum", lambda p, hs, s, l: hs.vacuum_index("cov")),
        ("vacuum_again", lambda p, hs, s, l: hs.vacuum_index("cov")),
        ("delete_missing", lambda p, hs, s, l: hs.delete_index("nope")),
        ("cancel_stuck", _stuck_then_cancel),
        ("delete_skip", lambda p, hs, s, l: hs.delete_index("skip")),
        ("cancel_deleted", lambda p, hs, s, l: hs.cancel("skip")),
        ("recreate_after_vacuum", lambda p, hs, s, l: hs.create_index(
            s.read_parquet(l), p.CoveringIndexConfig("cov", ["k"], ["s", "f", "d"]))),
    ]),
]
ACTIONS = [(ph[0], a[0]) for ph in PHASES for a in ph[3]]


def _queries(pkg):
    c = pkg.col
    return {
        "cov": lambda df: df.filter(c("k") == 7).select("k", "s", "f", "d"),
        "lin": lambda df: df.filter(c("s") == "s3").select("s", "k", "n"),
        "skip": lambda df: df.filter((c("k") >= 100) & (c("k") < 200)).select("k", "n"),
        "lin_in": lambda df: df.filter(c("s").isin("s20", "s21")).select("s", "d"),
    }


def _sorted_rows(batch):
    cols = sorted(batch)
    return sorted(zip(*[[repr(v) for v in batch[k].tolist()] for k in cols])), cols


def _plan_leaves(plan, mod):
    out = []
    for p in mod.collect(plan, lambda p: True):
        if isinstance(p, mod.IndexScan):
            out.append(("IndexScan", p.entry.name))
        elif isinstance(p, mod.FileScan):
            out.append(("FileScan", p.via_index, len(p.files)))
        elif isinstance(p, mod.Scan):
            out.append(("Scan",))
    return out


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """Runs every phase in both packages; returns {(phase, action): {owner:
    snapshot}} and {phase: {(server, owner): {query: (leaves, rows, off)}}}."""
    base = tmp_path_factory.mktemp("lifecycle")
    lake = str(base / "lake")
    os.makedirs(lake)
    for i in range(3):
        write_part(lake, i, [900, 600, 1100][i])
    actions, queries = {}, {}
    state = {}
    for phase, edit, leader, steps in PHASES:
        if edit is not None:
            edit(lake)
        paths = {}
        for owner, pkg in PACKAGES:
            paths[owner] = str(base / f"{phase}_{owner}")
            if leader is not None:
                shutil.copytree(state[leader], paths[owner], symlinks=True)
        roots = {"base": str(base)}
        for owner, pkg in PACKAGES:
            sess = _session(pkg, paths[owner])
            hs = pkg.Hyperspace(sess)
            own_roots = {"sys": paths[owner], **roots}
            for action_id, fn in steps:
                got = _outcome(lambda: fn(pkg, hs, sess, lake))
                if got[0] == "ok":
                    got = ("ok", _norm_entry(got[1], own_roots))
                actions.setdefault((phase, action_id), {})[owner] = {
                    "outcome": got, **_snapshot(sess, hs, own_roots)}
        # each package serves both packages' results
        served = {}
        for server, pkg in PACKAGES:
            for owner in paths:
                sess = _session(pkg, paths[owner])
                mod = RL if pkg is hst else L
                out = {}
                for qname, make in _queries(pkg).items():
                    q = make(sess.read_parquet(lake))
                    sess.enable_hyperspace()
                    leaves = _plan_leaves(q.optimized_plan(), mod)
                    on = q.collect()
                    sess.disable_hyperspace()
                    out[qname] = (leaves, _sorted_rows(on), _sorted_rows(q.collect()))
                served[(server, owner)] = out
        queries[phase] = served
        state = paths
    return actions, queries


@pytest.mark.parametrize("phase,action", ACTIONS)
def test_action_matches_jax(scenario, phase, action):
    """The action's result (entry or exception), every index's log entry,
    bucket files and sketches, and ``indexes()`` are the JAX package's."""
    got = scenario[0][(phase, action)]
    ref, port = got["jax"], got["torch"]
    assert port["outcome"] == ref["outcome"]
    for name in INDEXES:
        assert port[name]["entry"] == ref[name]["entry"], f"{name}: log entry"
        assert port[name]["data"] == ref[name]["data"], f"{name}: index data"
    assert port["indexes()"] == ref["indexes()"]


EXPECTED = {
    ("append", "incremental_no_changes"): "NoChangesException",
    ("append", "bad_mode"): "HyperspaceActionException",
    ("optimize", "optimize_skip"): "HyperspaceActionException",
    ("optimize", "optimize_full_no_changes"): "NoChangesException",
    ("optimize", "optimize_bad_mode"): "HyperspaceActionException",
    ("delete", "incremental_without_lineage"): "HyperspaceActionException",
    ("maintenance", "restore_active"): "HyperspaceActionException",
    ("maintenance", "vacuum_active"): "HyperspaceActionException",
    ("maintenance", "cancel_stable"): "HyperspaceActionException",
    ("maintenance", "refresh_deleted"): "HyperspaceActionException",
    ("maintenance", "optimize_deleted"): "HyperspaceActionException",
    ("maintenance", "vacuum_again"): "HyperspaceActionException",
    ("maintenance", "delete_missing"): "HyperspaceActionException",
    ("maintenance", "cancel_deleted"): "HyperspaceActionException",
}


def test_expected_outcomes(scenario):
    """The spec's outcomes: which actions raise, and with what; every
    other action commits."""
    for key in ACTIONS:
        outcome = scenario[0][key]["torch"]["outcome"]
        want = EXPECTED.get(key, "ok")
        assert (outcome[0] if want == "ok" else outcome[1]) == want, f"{key}: {outcome}"


def test_spec_shapes(scenario):
    """The JAX spec files' checks, on the port's own snapshots."""
    acts = scenario[0]

    def port(phase, action, name):
        return acts[(phase, action)]["torch"][name]

    # incremental append-only keeps the old version's files and adds a
    # delta version holding only the appended files' 800 rows
    content = [f for f, _ in port("append", "incremental_append", "cov")["entry"]["content"]]
    assert {"v__=0", "v__=1"} <= {part for f in content for part in f.split("/")}
    delta = sum(pq.read_metadata(f).num_rows for f in acts[("append", "incremental_append")]["torch"]["cov_files"]
                if "/v__=1/" in f)
    assert delta == 800
    # quick refresh records the two appended files, content untouched
    lin = port("append", "quick_lin", "lin")["entry"]
    update = lin["source"]["plan"]["properties"]["relations"][0]["data"]["update"]
    assert update is not None and "part-00003" in json.dumps(update) and "part-00004" in json.dumps(update)
    # optimize leaves one file per bucket
    opt = [re.search(r"part-(\d+)", f).group(1) for f, _ in port("optimize", "optimize_quick", "cov")["entry"]["content"]]
    assert len(opt) == len(set(opt))
    # lineage: the index files carry the lineage column
    assert "_data_file_id" in next(iter(port("delete", "incremental_lineage", "lin")["data"].values()))[0]
    # the listing keeps DELETED indexes and drops vacuumed ones
    listed = json.loads(acts[("maintenance", "delete")]["torch"]["indexes()"])
    assert {r["name"]: r["state"] for r in listed}["cov"] == "DELETED"
    listed = json.loads(acts[("maintenance", "vacuum")]["torch"]["indexes()"])
    assert "cov" not in {r["name"] for r in listed}
    assert port("maintenance", "cancel_stuck", "lin")["entry"]["state"] == "ACTIVE"
    assert port("maintenance", "cancel_deleted", "skip")["entry"]["state"] == "DELETED"


@pytest.mark.parametrize("phase", [p[0] for p in PHASES])
def test_each_package_serves_both_results(scenario, phase):
    """Every query answers as hyperspace off does, through either package
    over either package's indexes, with the same plan leaves."""
    served = scenario[1][phase]
    ref_leaves = served[("jax", "jax")]
    for key, out in served.items():
        for qname, (leaves, on, off) in out.items():
            assert on == off, f"{key} {qname}: hyperspace on != off"
            assert leaves == ref_leaves[qname][0], f"{key} {qname}: {leaves} != {ref_leaves[qname][0]}"
            assert on == ref_leaves[qname][1], f"{key} {qname}: rows differ from the JAX package's"


def test_lineage_and_quick_refresh_in_plans(scenario):
    """A quick-refreshed index is not a candidate while hybrid scan is off
    (its signature is the old source's): after the append the lineage index
    serves nothing, after its incremental refresh it serves again, and its
    lineage column never reaches a query's output."""
    queries = scenario[1]
    assert ("IndexScan", "lin") not in queries["append"][("torch", "torch")]["lin"][0]
    assert ("IndexScan", "lin") in queries["delete"][("torch", "torch")]["lin"][0]
    for phase in queries:
        for out in queries[phase].values():
            for _, (rows, cols), _ in out.values():
                assert "_data_file_id" not in cols
    # the data-skipping index prunes every file before the append, then
    # keeps only the two appended files
    assert queries["create"][("torch", "torch")]["skip"][0] == [("FileScan", "skip", 0)]
    for phase in ("append", "delete", "append_again"):
        assert queries[phase][("torch", "torch")]["skip"][0] == [("FileScan", "skip", 2)], phase


@pytest.mark.parametrize("direction", ["jax_refresh_port_optimize", "port_refresh_jax_optimize"])
def test_optimize_over_the_other_packages_refresh(tmp_path, direction):
    """One package refreshes incrementally, the other optimizes the result;
    both packages serve the optimized index like hyperspace off."""
    lake = str(tmp_path / "lake")
    os.makedirs(lake)
    for i in range(2):
        write_part(lake, i, 500, seed=7)
    system = str(tmp_path / "sys")
    first, second = (hst, ht) if direction.startswith("jax") else (ht, hst)
    sess = _session(first, system)
    hs = first.Hyperspace(sess)
    hs.create_index(sess.read_parquet(lake), first.CoveringIndexConfig("cov", ["k"], ["s", "f"]))
    write_part(lake, 2, 300, seed=7)
    hs.refresh_index("cov", "incremental")
    sess2 = _session(second, system)
    entry = second.Hyperspace(sess2).optimize_index("cov", "quick")
    buckets = [bucket_of_file(f) for f in entry.content.files]
    assert len(buckets) == len(set(buckets))
    for pkg in (hst, ht):
        s = _session(pkg, system)
        q = s.read_parquet(lake).filter(pkg.col("k") == 7).select("k", "s", "f")
        s.enable_hyperspace()
        assert any(leaf[0] == "IndexScan" for leaf in _plan_leaves(q.optimized_plan(), RL if pkg is hst else L))
        on = q.collect()
        s.disable_hyperspace()
        assert _sorted_rows(on) == _sorted_rows(q.collect())


def test_partitioned_incremental_refresh_matches_jax(tmp_path):
    """A hive-partitioned source gains a partition; the incremental refresh
    indexes its rows with the partition column, as in the JAX package."""
    base = tmp_path / "part"
    rng = np.random.default_rng(8)
    for pv in ("p=1", "p=2"):
        (base / pv).mkdir(parents=True)
        pq.write_table(pa.table({"k": rng.integers(0, 20, 300), "v": rng.standard_normal(300)}),
                       base / pv / "f0.parquet")
    sessions = {owner: _session(pkg, str(tmp_path / owner)) for owner, pkg in PACKAGES}
    for owner, pkg in PACKAGES:
        pkg.Hyperspace(sessions[owner]).create_index(
            sessions[owner].read_parquet(str(base)), pkg.CoveringIndexConfig("partIdx", ["k"], ["v", "p"]))
    (base / "p=3").mkdir()
    pq.write_table(pa.table({"k": rng.integers(0, 20, 300), "v": rng.standard_normal(300)}),
                   base / "p=3" / "f0.parquet")
    results = {}
    for owner, pkg in PACKAGES:
        sess = sessions[owner]
        entry = pkg.Hyperspace(sess).refresh_index("partIdx", "incremental")
        sess.enable_hyperspace()
        q = sess.read_parquet(str(base)).filter(pkg.col("k") == 3).select("v", "p")
        assert any(leaf[0] == "IndexScan" for leaf in _plan_leaves(q.optimized_plan(), RL if pkg is hst else L))
        on = q.collect()
        sess.disable_hyperspace()
        assert _sorted_rows(on) == _sorted_rows(q.collect())
        assert "3" in {str(x) for x in on["p"]}
        results[owner] = (_norm_entry(entry, {"sys": str(tmp_path / owner)}), _runs(entry), _sorted_rows(on))
    assert results["torch"] == results["jax"]


FAILING = {
    "refresh_full": ("actions.refresh", "RefreshFullAction", lambda hs: hs.refresh_index("cov", "full")),
    "refresh_incremental": ("actions.refresh", "RefreshIncrementalAction",
                            lambda hs: hs.refresh_index("cov", "incremental")),
    "optimize": ("actions.optimize", "OptimizeAction", lambda hs: hs.optimize_index("cov", "quick")),
}


@pytest.mark.parametrize("when", ["early", "late"])
@pytest.mark.parametrize("action", sorted(FAILING))
def test_failing_action_matches_jax(tmp_path, monkeypatch, action, when):
    """An ``op`` that fails leaves the last stable entry and no allocated
    version behind; a failure after the final entry is committed keeps the
    data it references. Both packages end in the same state."""
    from importlib import import_module

    module, cls_name, run = FAILING[action]
    states = {}
    for owner, pkg in PACKAGES:
        lake = str(tmp_path / owner / "lake")
        os.makedirs(lake)
        for i in range(2):
            write_part(lake, i, 400, seed=3)
        system = str(tmp_path / owner / "sys")
        sess = _session(pkg, system)
        hs = pkg.Hyperspace(sess)
        hs.create_index(sess.read_parquet(lake), pkg.CoveringIndexConfig("cov", ["k"], ["s"]))
        write_part(lake, 2, 300, seed=3)
        if action == "optimize":
            hs.refresh_index("cov", "incremental")
        with monkeypatch.context() as m:
            if when == "early":
                cls = getattr(import_module(f"{pkg.__name__}.{module}"), cls_name)
                real_op = cls.op

                def failing_op(self, real_op=real_op):
                    real_op(self)
                    raise RuntimeError("op failed after writing data")

                m.setattr(cls, "op", failing_op)
            else:
                log_cls = import_module(f"{pkg.__name__}.models.log_manager").IndexLogManager

                def boom(self, log_id):
                    raise OSError("disk hiccup writing latestStable")

                m.setattr(log_cls, "create_latest_stable_log", boom)
            with pytest.raises((RuntimeError, OSError)):
                run(hs)
        hs._manager.clear_cache()
        entry = hs._manager.get_index("cov")
        assert entry is not None and entry.state == "ACTIVE"
        for f in entry.content.files:
            assert os.path.exists(f), f"a committed index file was deleted: {f}"
        versions = sorted(n for n in os.listdir(os.path.join(system, "cov")) if n.startswith("v__="))
        sess.enable_hyperspace()
        q = sess.read_parquet(lake).filter(pkg.col("k") == 7).select("s")
        on = q.collect()
        sess.disable_hyperspace()
        assert _sorted_rows(on) == _sorted_rows(q.collect())
        states[owner] = (entry.id, len(entry.content.files), versions)
    assert states["torch"] == states["jax"]
    if when == "early":
        # the failed action's version directory is gone
        assert len(states["torch"][2]) == (2 if action == "optimize" else 1)


def test_entry_and_index_methods_match_jax(tmp_path):
    """The log-entry, file-id tracker and index methods the lifecycle reads
    give the JAX package's answers on the same lake."""
    from hyperspace_tpu.indexes.registry import index_of_entry as ref_index_of_entry
    from hyperspace_tpu.models.log_entry import FileInfo as RefFileInfo
    from hyperspace_tpu_torch.models.log_entry import FileInfo

    lake = str(tmp_path / "lake")
    os.makedirs(lake)
    for i in range(3):
        write_part(lake, i, 300, seed=4)
    got = {}
    for owner, pkg in PACKAGES:
        sess = _session(pkg, str(tmp_path / owner), **{pkg.keys.LINEAGE_ENABLED: True})
        hs = pkg.Hyperspace(sess)
        df = sess.read_parquet(lake)
        entries = [hs.create_index(df, pkg.CoveringIndexConfig("cov", ["k"], ["s"])),
                   hs.create_index(df, pkg.DataSkippingIndexConfig("skip", pkg.MinMaxSketch("k")))]
        revive = ref_index_of_entry if pkg is hst else index_of_entry
        info = RefFileInfo if pkg is hst else FileInfo
        out = []
        for entry in entries:
            tracker = entry.file_id_tracker()
            index = revive(entry)
            files = entry.source_file_infos()
            update = entry.copy_with_update([info.from_path(files[0].name)], files[1:2])
            out.append((
                entry.has_lineage_column(), entry.source_files_size(), tracker.max_id,
                sorted(tracker.file_to_id_map().items()), [tracker.get_file_id(fi.key) for fi in files],
                entry.with_next_id(7).id, [f.name for f in update.appended_files()],
                [f.name for f in update.deleted_files()], update.content.files == entry.content.files,
                index.can_handle_deleted_files(), index.stats(),
                index.with_new_properties({"extra": "1"}).properties,
            ))
        got[owner] = json.loads(_norm(json.dumps(out, default=str), {"sys": str(tmp_path / owner)}))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] is True and got["torch"][1][9] is True
