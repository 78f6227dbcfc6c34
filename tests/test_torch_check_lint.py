"""The port's AST lint against the JAX package's spec, the conf keys both
packages register, and ROADMAP C11 (a row-group-pruned scan's device cache
key).

tests/test_check_lint.py runs with the package renamed to the port
(tests/torch_mirror.py ``load_cases``) over the same fixtures
(tests/fixtures/check/): each of the eleven rules fires on its ``bad_*``
fixture and stays silent on its ``clean_*`` one exactly as in the JAX
package, the CLI keeps its exit codes (0 clean, 1 findings, 2 an unknown
rule), and the port's own tree, with ``chip_smoke.py``, lints clean.
Rewritten for the port: ``test_default_scope_excludes_tests`` asserts
that the scope takes the port's driver ``chip_smoke.py`` (the JAX
package's takes ``bench.py``). Nothing is left out (``LEFT_OUT`` is empty).

The cases of this file:

- the CLI exits 1 on each ``bad_*`` fixture and prints what the JAX
  package's CLI prints;
- every key of ``hyperspace_tpu.config.keys`` is registered in the port
  under the same string, with the same default, and ``HyperspaceConf.get``
  of each gives the same value in both packages (a default that names a
  module of the package names the port's module in the port);
- C11: two aggregates over the same index files, with row-group pruning on
  and different pushed predicates on the scan leaf (as ``_stream_chunks``
  attaches them), give the same rows in both packages and the rows of the
  host aggregate, and each package brands its device-cache key with the
  predicate the same way. Tolerance: exact.
"""

import copy
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.check]

HERE = os.path.dirname(__file__)
REWRITES = {
    # the port's lint scope takes its driver, chip_smoke.py, where the JAX
    # package's takes bench.py and __graft_entry__.py
    '        assert any(p.endswith("bench.py") for p in paths)\n': (
        '        assert any(p.endswith("chip_smoke.py") for p in paths)\n'
        '        assert not any(p.endswith("bench.py") for p in paths)\n'),
}
LEFT_OUT: dict = {}

_suite = M.load_cases(os.path.join(HERE, "test_check_lint.py"), "_torch_test_check_lint_suite", rewrites=REWRITES)
M.export_cases(_suite, globals(), LEFT_OUT)


def test_every_case_is_run_or_listed():
    M.assert_every_case([_suite], globals(), LEFT_OUT)


FIXTURES = os.path.join(HERE, "fixtures", "check")
BAD = sorted(os.path.relpath(os.path.join(d, f), FIXTURES) for d, _, fs in os.walk(FIXTURES)
             for f in fs if f.startswith("bad_") and f.endswith(".py"))


@pytest.mark.parametrize("fixture", BAD)
def test_cli_exits_one_on_each_bad_fixture_as_the_jax_package(fixture, capsys):
    """``python -m hyperspace_tpu_torch.check <bad fixture>`` exits 1 and
    prints the same findings as the JAX package's CLI."""
    from hyperspace_tpu.check.__main__ import main as ref_main
    from hyperspace_tpu_torch.check.__main__ import main

    path = os.path.join(FIXTURES, fixture)
    assert main([path]) == 1
    got = capsys.readouterr().out
    assert ref_main([path]) == 1
    assert got == capsys.readouterr().out and got


def test_scope_is_the_ports_tree():
    """The port's lint reads only the port's package and its driver; the
    JAX package's lint reads only its own."""
    from hyperspace_tpu.check.lint import default_paths as ref_paths
    from hyperspace_tpu_torch.check.lint import default_paths, default_root

    root = default_root()
    paths = [os.path.relpath(p, root) for p in default_paths(root)]
    assert all(p.startswith("hyperspace_tpu_torch" + os.sep) or p == "chip_smoke.py" for p in paths)
    assert os.path.join("hyperspace_tpu_torch", "check", "program_lint.py") in paths
    assert not any(p.startswith("hyperspace_tpu_torch") for p in (os.path.relpath(q, root) for q in ref_paths(root)))


# --------------------------------------------------------------------------
# conf keys: the same registry and defaults in both packages
# --------------------------------------------------------------------------


def _registered(pkg):
    return {k: v for k, v in vars(pkg.config.keys).items() if not k.startswith("_") and isinstance(v, str)}


def test_every_jax_key_is_registered_in_the_port_with_its_default():
    import hyperspace_tpu.config  # noqa: F401
    import hyperspace_tpu_torch.config  # noqa: F401

    ref, port = _registered(hst), _registered(ht)
    assert set(ref.values()) <= set(port.values()), sorted(set(ref.values()) - set(port.values()))
    for name, key in ref.items():
        assert port.get(name) == key, name  # the JAX package's name resolves in the port too
    ref_conf, port_conf = hst.config.HyperspaceConf({}), ht.config.HyperspaceConf({})
    for key in sorted(set(ref.values())):
        want = hst.config.DEFAULTS[key]
        if isinstance(want, str):
            want = want.replace("hyperspace_tpu.", "hyperspace_tpu_torch.")
        assert key in ht.config.DEFAULTS, key
        assert ht.config.DEFAULTS[key] == want, key
        got, ref_got = port_conf.get(key), ref_conf.get(key)
        if isinstance(ref_got, str):
            ref_got = ref_got.replace("hyperspace_tpu.", "hyperspace_tpu_torch.")
        assert got == ref_got, key


@pytest.mark.parametrize("key,accessor,value", [
    ("hyperspace.check.hlo.enabled", "check_hlo_enabled", True),
    ("hyperspace.index.dataskipping.targetIndexDataFileSize", "dataskipping_target_file_size", 1 << 20),
    ("hyperspace.lifecycle.refresh.enabled", "lifecycle_refresh_enabled", True),
])
def test_the_three_keys_read_alike(key, accessor, value):
    """The three keys the port lacked: default and set, through ``get`` and
    the typed accessor, equal in both packages."""
    ref, port = hst.config.HyperspaceConf({}), ht.config.HyperspaceConf({})
    assert port.get(key) == ref.get(key) is not None
    assert getattr(port, accessor) == getattr(ref, accessor)
    ref.set(key, value)
    port.set(key, value)
    assert getattr(port, accessor) == getattr(ref, accessor) == value


# --------------------------------------------------------------------------
# C11: the device aggregate brands its cache key with the pruning predicate
# --------------------------------------------------------------------------

ROWS = 400
ROW_GROUP = 100


@pytest.fixture()
def pruned_index(tmp_path):
    """One bucket file of an index on ``k`` (0..399, sorted), rewritten with
    row groups of 100 rows, so ``k < 100`` and ``k >= 300`` each keep one
    row group of the same size. The rewrite is committed as the index's
    writers commit theirs: a new log entry records the rewritten files'
    (path, size, mtime), which an index scan's device-cache key reads."""
    rng = np.random.default_rng(11)
    data = tmp_path / "lake"
    data.mkdir()
    k = rng.permutation(ROWS).astype(np.int64)
    pq.write_table(pa.table({"k": k, "g": k % 3, "v": rng.integers(0, 1000, ROWS).astype(np.int64)}),
                   str(data / "part-00000.parquet"))
    system = str(tmp_path / "idx")
    conf = {ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 1}
    sess = ht.Session(conf=dict(conf), device="cpu")
    ht.Hyperspace(sess).create_index(sess.read_parquet(str(data)), ht.CoveringIndexConfig("c11", ["k"], ["g", "v"]))
    files = [os.path.join(d, f) for d, _, fs in os.walk(system) for f in fs if f.endswith(".parquet")
             and "_hyperspace_log" not in d]
    assert files
    for f in files:
        t = pq.read_table(f)
        pq.write_table(t, f, row_group_size=ROW_GROUP, use_dictionary=False, compression="NONE")
        assert pq.ParquetFile(f).metadata.num_row_groups == ROWS // ROW_GROUP
    from hyperspace_tpu_torch.models.log_entry import Content, FileInfo
    from hyperspace_tpu_torch.models.log_manager import IndexLogManager

    logs = IndexLogManager(os.path.join(system, "c11"))
    entry = logs.get_latest_stable_log()
    entry.content = Content.from_leaf_files(FileInfo.from_path(fi.name, fi.file_id)
                                            for fi in entry.content.file_infos())
    log_id = logs.get_latest_id() + 1
    assert logs.write_log(log_id, entry) and logs.create_latest_stable_log(log_id)
    return str(data), conf


def _aggregate_over_pruned_leaf(pkg, ex_mod, sess, data, cond):
    """Aggregate(Filter(IndexScan)) with the scan leaf cloned and given the
    filter as its pushed predicate, as a streamed chunk's leaf carries it."""
    df = sess.read_parquet(data).filter(cond).group_by("g").agg(s=("v", "sum"), n=("*", "count"))
    plan = df.optimized_plan()
    assert isinstance(plan, pkg.plan.logical.Aggregate), plan.pretty()
    filt = plan.child
    scan = filt.child
    assert isinstance(scan, pkg.plan.logical.IndexScan), plan.pretty()
    leaf = copy.copy(scan)
    leaf.pushdown_predicate = filt.condition
    tree = plan.with_children([filt.with_children([leaf])])
    out = ex_mod.Executor(sess).execute(tree, prepruned=True)
    order = np.argsort(out["g"], kind="stable")
    return {c: np.asarray(v)[order] for c, v in out.items()}


def test_c11_pruned_scan_key_and_rows_equal_the_jax_package(pruned_index, monkeypatch):
    from hyperspace_tpu.exec import device as RD
    from hyperspace_tpu.exec import executor as REX
    from hyperspace_tpu_torch.exec import aggregate as A
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import executor as EX

    data, conf = pruned_index
    extra = {ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.EXEC_IO_ROWGROUP_PRUNING: True}
    port = ht.Session(conf={**conf, **extra}, device="cpu")
    ref = hst.Session(conf={**conf, **extra})
    keys = {"port": [], "jax": []}

    def spy(mod, name, side):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            keys[side].append(kw.get("scan_key"))
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    spy(A, "device_grouped_aggregate", "port")
    spy(RD, "device_grouped_aggregate", "jax")
    D.clear_device_cache()
    RD.clear_device_cache()
    for sess in (port, ref):
        sess.enable_hyperspace()
    host = ht.Session(conf=dict(conf), device="cpu")
    try:
        for lo, hi in ((0, 100), (300, 400)):
            got = _aggregate_over_pruned_leaf(ht, EX, port, data, (ht.col("k") >= lo) & (ht.col("k") < hi))
            want = _aggregate_over_pruned_leaf(hst, REX, ref, data, (hst.col("k") >= lo) & (hst.col("k") < hi))
            oracle = host.read_parquet(data).filter((ht.col("k") >= lo) & (ht.col("k") < hi)).group_by("g").agg(
                s=("v", "sum"), n=("*", "count")).collect()
            order = np.argsort(oracle["g"], kind="stable")
            for c in ("g", "s", "n"):
                np.testing.assert_array_equal(got[c], want[c], err_msg=f"{c} k in [{lo}, {hi})")
                np.testing.assert_array_equal(got[c], np.asarray(oracle[c])[order], err_msg=c)
            assert int(got["n"].sum()) == hi - lo
    finally:
        ht.set_session(None)
        hst.set_session(None)
    # each package brands the same key with the pushed predicate
    assert len(keys["port"]) == len(keys["jax"]) == 2
    assert keys["port"] == keys["jax"]
    for key in keys["port"]:
        assert key[-1][0] == "rg-pred", key
    assert keys["port"][0] != keys["port"][1]
    # and its device cache holds the columns under those keys
    port_cached = {k[0] for k in D._device_cache.keys() if isinstance(k, tuple)}
    ref_cached = {k[0] for k in RD._device_cache.keys() if isinstance(k, tuple)}
    assert set(keys["port"]) <= port_cached
    assert set(keys["jax"]) <= ref_cached
