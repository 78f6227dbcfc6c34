"""The port's mesh-sharded execution and mesh build against the JAX package.

tests/test_mesh_exec.py and tests/test_distributed_build.py run with the
package renamed to the port (tests/torch_mirror.py), their sessions
``MirroredSession``s on the CPU: every ``collect()`` is also run by the JAX
package under the same conf, and the rows must be the same, in the same
order (float sums at rtol 1e-9). The port's CPU mesh has 8 shards
(``parallel.mesh.SHARD_COUNT``, set by this file's fixture), as the JAX
package's tests run over 8 virtual CPU devices (tests/conftest.py).

``TestShardedGroupedAgg`` (three cases) fails in the JAX package itself: its
``shard_map`` takes no ``check_rep`` on this JAX, so its one-shot sharded
grouped aggregate raises and its streamed one falls back to the host
(ROADMAP §C). Its cases run unmirrored here: each holds the port's sharded
run against the port's single-device run, and the cases at the end hold
the same queries against a pandas oracle.

The cases at the end also hold: the port's 8-shard build writes bucket
files byte for byte equal to the JAX package's 8-device build and to both
packages' single-device builds, and each package serves the other's; the
sharded programs' gathers move ``n_shards * cap`` entries per table and no
row payload (the intent of tests/test_hlo_collectives.py, whose subject,
the compiled HLO, a torch program does not have).

Tolerance: keys, counts, int sums, min, max and row order byte-identical;
float sums, averages and standard deviations at rtol 1e-9 (shard-local sums
reassociate float addition).
"""

import glob
import math
import os

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.parallel import mesh as PM  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.mesh]

HERE = os.path.dirname(__file__)
SHARDS = 8

_MIRRORED = {
    "import hyperspace_tpu_torch as hst\n": "import hyperspace_tpu_torch as hst\nimport torch_mirror as _mirror\n",
    "    return hst.Session(conf=merged)\n": "    return _mirror.mirrored_session(conf=merged)\n",
}
_CPU_WRITER = "session=_mirror.CpuSession())\n"
#: ``TestMeshHelpers``' bare mesh constructors, asked for the CPU: the
#: port's build on the card unless asked (ROADMAP C15)
CPU_MESH_CALLS = {f"{call})": f'{call}, device_type="cpu")' for call in (
    "make_mesh(9", "make_mesh(0", "make_mesh(-2", "make_mesh(8", "make_mesh(4", "make_mesh_2d(n_slices=3",
    "make_mesh_2d(n_slices=4, per_slice=4", "make_mesh_2d(n_slices=2, per_slice=4")}
MESH_REWRITES = {
    **_MIRRORED,
    **CPU_MESH_CALLS,
    '        write_bucketed(t, ["ship"], 16, d_host, session=None)\n': (
        '        write_bucketed(t, ["ship"], 16, d_host, ' + _CPU_WRITER),
}
BUILD_REWRITES = {
    **_MIRRORED,
    '    import jax\n    from jax.sharding import Mesh\n\n    return Mesh(np.array(jax.devices()[:1]), ("buckets",))\n': (
        '    from hyperspace_tpu_torch.parallel import make_mesh\n\n    return make_mesh(1, device_type="cpu")\n'),
    '        import jax\n\n        assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"\n': (
        "        from hyperspace_tpu_torch.parallel import mesh as _pm\n\n"
        '        assert _pm.SHARD_COUNT == 8, "the port\'s tests set 8 CPU shards"\n'),
    '        write_bucketed(skew, ["k"], 16, d_single, session=None)\n': (
        '        write_bucketed(skew, ["k"], 16, d_single, ' + _CPU_WRITER),
    '        write_bucketed(t, ["k"], nb, d_single, session=None)\n': (
        '        write_bucketed(t, ["k"], nb, d_single, ' + _CPU_WRITER),
}
UNMIRRORED = "TestShardedGroupedAgg"
LEFT_OUT = {
    UNMIRRORED: "fails in the JAX package (ROADMAP §C): runs unmirrored below, and against the pandas oracle",
}

_mesh = M.load_cases(os.path.join(HERE, "test_mesh_exec.py"), "_torch_test_mesh_exec_suite", rewrites=MESH_REWRITES)
_build = M.load_cases(os.path.join(HERE, "test_distributed_build.py"), "_torch_test_distributed_build_suite",
                      rewrites=BUILD_REWRITES)
_port_only = M.load_cases(os.path.join(HERE, "test_mesh_exec.py"), "_torch_test_mesh_exec_port_only",
                          rewrites={**M.CPU_PORT_IMPORT, '        write_bucketed(t, ["ship"], 16, d_host, '
                                    'session=None)\n': '        write_bucketed(t, ["ship"], 16, d_host, '
                                    'session=_mirror.CpuSession())\n'})
M.export_cases(_mesh, globals(), LEFT_OUT)
M.export_cases(_build, globals(), {})
TestShardedGroupedAgg = type(UNMIRRORED, (_port_only.TestShardedGroupedAgg,), {"__module__": __name__})


@pytest.fixture(autouse=True)
def _mesh_of_eight(monkeypatch):
    monkeypatch.setattr(PM, "SHARD_COUNT", SHARDS)
    with M.mirroring():
        yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    namespace = {k: v for k, v in globals().items() if k != UNMIRRORED}
    M.assert_every_case([_mesh, _build], namespace, LEFT_OUT)
    assert sorted(c for c in M.cases_of(_port_only) if c.startswith(UNMIRRORED + "::")) == sorted(
        f"{UNMIRRORED}::{m}" for m in dir(TestShardedGroupedAgg) if m.startswith("test_"))


# --------------------------------------------------------------------------
# the JAX package's failing sharded aggregates, against a pandas oracle
# --------------------------------------------------------------------------


def _oracle(frame: pd.DataFrame, keys, spec) -> pd.DataFrame:
    """Grouped aggregates in first-appearance order (pandas
    ``groupby(sort=False, dropna=False)``): count(*), sum, avg, min, max,
    count and stddev_samp of the non-null values."""
    g = frame.groupby(keys, sort=False, dropna=False)
    out = {}
    for name, (col, fn) in spec.items():
        if col == "*":
            out[name] = g.size()
        else:
            out[name] = getattr(g[col], {"avg": "mean", "stddev_samp": "std", "count": "count"}.get(fn, fn))()
    return pd.DataFrame(out).reset_index()


def _same_as_oracle(got, want: pd.DataFrame, keys):
    """The oracle's groups, matched by key (an index scan's rows come in
    bucket order, not the source's), values exact but float ones, at rtol
    1e-9."""
    missing = lambda x: x is None or (isinstance(x, float) and math.isnan(x))  # noqa: E731
    key_of = lambda row: tuple("<null>" if missing(v) else v for v in row)  # noqa: E731
    got_rows = {key_of(k): i for i, k in enumerate(zip(*[np.asarray(got[c]).tolist() for c in keys]))}
    want_rows = {key_of(k): i for i, k in enumerate(zip(*[want[c].tolist() for c in keys]))}
    assert got_rows.keys() == want_rows.keys() and len(got_rows) == len(np.asarray(got[keys[0]]))
    for c in want.columns:
        g, w = np.asarray(got[c]).tolist(), want[c].tolist()
        for key, i in want_rows.items():
            a, b = g[got_rows[key]], w[i]
            if missing(a) or missing(b):
                assert missing(a) and missing(b), (c, key, a, b)
            elif isinstance(a, float) or isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-9), (c, key, a, b)
            else:
                assert a == b, (c, key, a, b)


Q1 = {"sum_qty": ("qty", "sum"), "sum_price": ("price4", "sum"), "avg_qty": ("qty", "avg"),
      "sd_messy": ("messy", "stddev_samp"), "avg_messy": ("messy", "avg"), "n": ("*", "count"),
      "nm": ("messy", "count"), "lo": ("price4", "min"), "hi": ("qty", "max")}
FKEY = {"n": ("*", "count"), "s": ("qty", "sum"), "m": ("messy", "avg")}
STREAM = {ht.keys.EXEC_STREAM_AGG_MIN_BYTES: 1, ht.keys.EXEC_STREAM_CHUNK_BYTES: 1}


@pytest.mark.parametrize("case", ["q1_shape_multi_key", "null_float_group_keys", "streamed_grouped_agg"])
def test_sharded_grouped_aggregates_match_pandas_oracle(tmp_path, dataset, case):
    keys, spec = (["fkey"], FKEY) if case == "null_float_group_keys" else (["rf", "ls"], Q1)
    conf = {ht.keys.SYSTEM_PATH: str(tmp_path / "sys"), ht.keys.TPU_QUERY_DEVICE_MIN_ROWS: 0,
            ht.keys.PARALLEL_MIN_ROWS: 0, ht.keys.PARALLEL_ENABLED: True}
    if case != "q1_shape_multi_key":
        conf.update(STREAM)
    sess = ht.Session(conf=conf, device="cpu")
    df = sess.read_parquet(dataset)
    frame = pd.concat([pq.read_table(f).to_pandas() for f in sorted(glob.glob(os.path.join(dataset, "*.parquet")))],
                      ignore_index=True)
    if case == "q1_shape_multi_key":
        ht.Hyperspace(sess).create_index(df, ht.CoveringIndexConfig("q1", ["ship"], ["rf", "ls", "qty", "price4",
                                                                                      "messy"]))
        sess.enable_hyperspace()
    if case != "null_float_group_keys":
        df = df.filter(ht.col("ship") <= 2400)
        frame = frame[frame["ship"] <= 2400]
    before = D.dispatches["sharded-grouped"] + D.dispatches["fused-stage-agg-sharded"]
    got = df.group_by(*keys).agg(**{n: (c, "count" if c == "*" else f) for n, (c, f) in spec.items()}).collect()
    assert D.dispatches["sharded-grouped"] + D.dispatches["fused-stage-agg-sharded"] > before
    _same_as_oracle(got, _oracle(frame, keys, spec), keys)


# --------------------------------------------------------------------------
# bucket files across packages and topologies
# --------------------------------------------------------------------------


def _bucket_bytes(files):
    out = {}
    for f in files:
        with open(f, "rb") as fh:
            out.setdefault(int(os.path.basename(f).split("-")[1]), []).append(fh.read())
    return {b: sorted(v) for b, v in out.items()}


def test_mesh_build_files_equal_across_packages_and_topologies(tmp_path, dataset):
    """``create_index`` through the port's 8-shard exchange, the JAX
    package's 8-device exchange and both packages' single-device builds:
    the bucket files are equal byte for byte; each package serves the
    index the other built on its mesh with the same rows."""
    from hyperspace_tpu.parallel.mesh import make_mesh as ref_make_mesh

    files, sessions = {}, {}
    for pkg, mesh in ((ht, True), (ht, False), (hst, True), (hst, False)):
        tag = f"{'port' if pkg is ht else 'jax'}_{'mesh' if mesh else 'one'}"
        conf = {pkg.keys.SYSTEM_PATH: str(tmp_path / tag), pkg.keys.PARALLEL_ENABLED: True,
                pkg.keys.NUM_BUCKETS: 16}
        sess = pkg.Session(conf=conf, device="cpu") if pkg is ht else pkg.Session(conf=conf)
        if not mesh:
            sess.set_mesh(PM.make_mesh(1, device_type="cpu") if pkg is ht else ref_make_mesh(1))
        PM.reset_collectives()
        entry = pkg.Hyperspace(sess).create_index(
            sess.read_parquet(dataset), pkg.CoveringIndexConfig("idx", ["ship", "rf"], ["qty", "messy"]))
        if pkg is ht:
            assert (PM.collective_calls[("all_to_all", "buckets")] == 1) == mesh, tag
        files[tag] = _bucket_bytes(entry.content.files)
        sessions[tag] = sess
    assert files["port_mesh"] == files["jax_mesh"] == files["port_one"] == files["jax_one"]
    # each package serves the other's mesh-built index
    rows = {}
    for reader, built in ((ht, "jax_mesh"), (hst, "port_mesh")):
        conf = {reader.keys.SYSTEM_PATH: str(tmp_path / built), reader.keys.TPU_QUERY_DEVICE_MIN_ROWS: 0}
        sess = reader.Session(conf=conf, device="cpu") if reader is ht else reader.Session(conf=conf)
        sess.enable_hyperspace()
        q = sess.read_parquet(dataset).filter(reader.col("ship") == 7).select("qty", "messy")
        assert "IndexScan" in q.optimized_plan().pretty()
        got = q.collect()
        rows[reader] = sorted(zip(np.asarray(got["qty"]).tolist(), np.asarray(got["messy"]).tolist()), key=repr)
    assert rows[ht] == rows[hst] and rows[ht]


# --------------------------------------------------------------------------
# the sharded programs move partial tables, never rows
# --------------------------------------------------------------------------


def test_sharded_programs_gather_tables_not_rows():
    """Each gather of the sharded grouped and top-k programs moves
    ``n_shards * cap`` entries per table (keys, first-seen rows, state
    slots; the candidate planes), and the grouped one's count gather one a
    shard, whatever the row count; the sharded filter moves nothing."""
    from hyperspace_tpu_torch.exec.aggregate import _grouped_slots
    from hyperspace_tpu_torch.parallel import collectives as C

    mesh = PM.make_mesh(device_type="cpu")
    n, cap = 50_000, 64
    rng = np.random.default_rng(5)
    cols = {"g": torch.from_numpy(rng.integers(0, 40, n)), "v": torch.from_numpy(rng.standard_normal(n))}
    slots, _ = _grouped_slots([("s", "sum", "v"), ("n", "count", None)], {"v": False})
    key_specs = (("g", "i"),)
    PM.reset_collectives()
    n_g, fs, keys, out = C.sharded_grouped_chunk_program(mesh, "buckets", None, key_specs, slots, cap)(
        cols, (), n, 0)
    tables = 1 + len(key_specs) + len(slots)
    # and one gather of the shards' group counts, one entry a shard
    assert n_g == 40 and PM.collective_calls[("all_gather", "buckets")] == tables + 1
    assert PM.collective_entries[("all_gather", "buckets")] == tables * SHARDS * cap + SHARDS < n
    PM.reset_collectives()
    planes = torch.from_numpy(np.stack([rng.integers(0, 1000, n), np.arange(n)]))
    cand = C.sharded_topk_chunk_program(mesh, "buckets", 1, cap)(planes)
    assert cand.shape == (2, cap)
    assert PM.collective_calls[("all_gather", "buckets")] == 1
    assert PM.collective_entries[("all_gather", "buckets")] == 2 * SHARDS * cap
    PM.reset_collectives()
    mask = C.sharded_elementwise(mesh, "buckets", lambda c, lits: c["v"] > lits[0])(
        {"v": cols["v"]}, (torch.tensor(0.0, dtype=torch.float64),))
    assert torch.equal(mask, cols["v"] > 0) and not PM.collective_calls


# --------------------------------------------------------------------------
# the mesh constructors build on the card unless asked for the CPU
# (ROADMAP C15)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("build", ["make_mesh", "make_mesh_2d"])
def test_mesh_constructors_raise_without_a_card(monkeypatch, build):
    """With no CUDA device, a constructor not asked for the CPU raises as
    ``Session`` does; it never returns a CPU mesh silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"device_type": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            getattr(PM, build)(**kwargs)
    assert getattr(PM, build)(device_type="cpu").size == SHARDS


def test_cpu_meshes_are_the_jax_package_grids():
    """Asked for the CPU, the constructors give the ``SHARD_COUNT`` shards
    the JAX package's give over its 8 virtual devices; a 2 x 2 mesh over a
    repeated device is the JAX package's grid for four devices."""
    from hyperspace_tpu.parallel import mesh as ref_mesh

    pairs = [(PM.make_mesh(device_type="cpu"), ref_mesh.make_mesh()),
             (PM.make_mesh(4, device_type="cpu"), ref_mesh.make_mesh(4)),
             (PM.make_mesh_2d(device_type="cpu"), ref_mesh.make_mesh_2d()),
             (PM.make_mesh_2d(2, 4, device_type="cpu"), ref_mesh.make_mesh_2d(2, 4)),
             (PM.make_mesh_2d(2, 2, devices=[torch.device("cpu")] * 4), ref_mesh.make_mesh_2d(2, 2))]
    for got, want in pairs:
        assert PM.mesh_fingerprint(got) == ref_mesh.mesh_fingerprint(want)
        assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
        assert all(d == torch.device("cpu") for d in got.devices.flat)
    grid, ref = pairs[-1]
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    assert ids.tolist() == [[0, 1], [2, 3]]
    assert PM._groups(grid, "ici") == ids.tolist() and PM._groups(grid, "dcn") == ids.T.tolist()
