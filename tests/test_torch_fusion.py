"""Whole-stage fusion in the port against the JAX package.

tests/test_fusion.py runs with the package renamed to the port
(tests/torch_mirror.py), its sessions ``MirroredSession``s on the CPU: every
``collect()`` is also run by the JAX package under the same conf (fusion on
in both), and the rows must be the same, in the same order. Its
``REGISTRY`` reads go to the port's counters (``torch_mirror.PORT_REGISTRY``:
``exec/device.dispatches``, ``exec/trace.fallbacks``,
``exec/stage_ir.stage_compiles`` and ``stage_ir.peak_bytes()``), and the
q3 case's ``GroupedAggStream`` is the port's ``exec/aggregate.py`` one.

The cases of this file hold the port's fused q1, q3 and top-k against the
JAX package's own fused runs on the same seeded lakes, and against the
port's fusion-off path; a session that never sets the conf dispatches no
fused program; donated state keeps its storage, and an overflow leaves it
as it was.

Tolerance: ints, keys, counts and row order byte-identical; float sums,
averages and standard deviations at rtol 1e-9 against the JAX package
(its segment sums add in another order), byte-identical within the port
(fusion on against off, donation on against off).

``TestShardedFused`` runs on the port's 8-shard CPU mesh: the sharded fused
fold against the sharded per-family run (byte for byte) and the port's
unsharded fused run (rtol 1e-9 for float sums; the top-k byte for byte).
Both cases fail in the JAX package itself (its ``shard_map`` takes no
``check_rep`` on this JAX, ROADMAP §C), whose streams then fall back to
its host paths: the mirror still holds the port's rows to those.

Left out of tests/test_fusion.py:

- ``TestDonation::test_donated_state_buffer_is_deleted``: torch has no
  donation; ``test_donated_state_keeps_its_storage`` here holds the
  in-place state instead.
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
from hyperspace_tpu_torch.exec import aggregate as A  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import stage_ir  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.fusion]

HERE = os.path.dirname(__file__)
REWRITES = {
    "from hyperspace_tpu_torch.obs.metrics import REGISTRY": "from torch_mirror import PORT_REGISTRY as REGISTRY",
    "import hyperspace_tpu_torch as hst\n": "import hyperspace_tpu_torch as hst\nimport torch_mirror as _mirror\n",
    "    sess = hst.Session(conf=base)": "    sess = _mirror.mirrored_session(conf=base)",
    # the port keeps the aggregate's internals in exec/aggregate.py
    "        from hyperspace_tpu_torch.exec import device as D\n": (
        "        from hyperspace_tpu_torch.exec import aggregate as D\n"),
    # the port's program contracts (check/program_lint.py, the counterpart
    # of check/hlo_lint.py)
    "        from hyperspace_tpu_torch.check import hlo_lint\n": (
        "        from hyperspace_tpu_torch.check import program_lint as hlo_lint\n"),
}
LEFT_OUT = {
    "TestDonation::test_donated_state_buffer_is_deleted": (
        "torch has no donation: test_donated_state_keeps_its_storage holds the in-place state"),
}

_suite = M.load_cases(os.path.join(HERE, "test_fusion.py"), "_torch_test_fusion_suite", rewrites=REWRITES)
M.export_cases(_suite, globals(), LEFT_OUT)


@pytest.fixture(autouse=True)
def _mirrored(monkeypatch):
    from hyperspace_tpu_torch.parallel import mesh as PM

    # the JAX package's tests run over 8 virtual CPU devices (conftest.py)
    monkeypatch.setattr(PM, "SHARD_COUNT", 8)
    with M.mirroring():
        yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case([_suite], globals(), LEFT_OUT)


# --------------------------------------------------------------------------
# the port's fused runs against the JAX package's and its own fusion-off
# --------------------------------------------------------------------------


def _conf(pkg, root, fusion, donation=True, **extra):
    conf = {
        pkg.keys.SYSTEM_PATH: str(root / "idx"),
        pkg.keys.TPU_QUERY_DEVICE_EXECUTION: True,
        pkg.keys.TPU_QUERY_DEVICE_MIN_ROWS: 0,
        pkg.keys.EXEC_STREAM_AGG_MIN_BYTES: 1,
        pkg.keys.EXEC_STREAM_CHUNK_BYTES: 1,
    }
    if fusion is not None:
        conf[pkg.keys.EXEC_FUSION_ENABLED] = fusion
        conf[pkg.keys.EXEC_FUSION_DONATION] = donation
    conf.update(extra)
    return conf


def _port(root, fusion, donation=True, **extra):
    return ht.Session(conf=_conf(ht, root, fusion, donation, **extra), device="cpu")


def _ref(root, fusion, donation=True, **extra):
    return hst.Session(conf=_conf(hst, root, fusion, donation, **extra))


def _same_bytes(got, want):
    """The same columns, byte for byte (object columns value for value)."""
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.dtype == object or b.dtype == object:
            assert a.dtype == b.dtype and a.tolist() == b.tolist(), k
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _fused_count() -> int:
    return sum(D.dispatches[p] for p in ("fused-stage-agg", "fused-stage-topk", "fused-stage-join-agg"))


def _q1(pkg, df):
    return _suite._q1(df) if pkg is ht else (
        df.filter(hst.col("qty") > 40).group_by("g").agg(
            n=("*", "count"), sq=("qty", "sum"), sp=("price", "sum"), aq=("qty", "avg"),
            lo=("price", "min"), hi=("qty", "max"), sd=("price", "stddev_samp")))


def _q3(pkg, sess, probe_dir, build_dir):
    probe, build = sess.read_parquet(probe_dir), sess.read_parquet(build_dir)
    return (
        probe.join(build, on=pkg.col("k") == pkg.col("k2"), how="inner")
        .filter(pkg.col("v") > -0.5)
        .group_by("g")
        .agg(n=("*", "count"), s=("v", "sum"), a=("w", "avg"), mn=("v", "min"), mx=("w", "max"))
    )


def _topk(pkg, sess, d):
    return sess.read_parquet(d).order_by("v", "k", ascending=[False, True]).limit(25)


@pytest.mark.parametrize("shape", ["q1", "q3", "topk"])
def test_fused_equals_jax_fused_and_port_unfused(tmp_path, shape):
    if shape == "q1":
        data = _suite._write_q1(str(tmp_path / "q1"))
        run = lambda pkg, s: _q1(pkg, s.read_parquet(data)).collect()  # noqa: E731
        family, trace_line = "fused-stage-agg", ("agg", "device-grouped-stream")
    elif shape == "q3":
        probe_dir, build_dir = _suite._write_q3(str(tmp_path / "q3"))
        run = lambda pkg, s: _q3(pkg, s, probe_dir, build_dir).collect()  # noqa: E731
        family, trace_line = "fused-stage-join-agg", ("agg", "fused-join-agg-stream")
    else:
        data = _suite._write_topk(str(tmp_path / "tk"))
        run = lambda pkg, s: _topk(pkg, s, data).collect()  # noqa: E731
        family, trace_line = "fused-stage-topk", ("topk", "device-topk-stream")
    d0 = D.dispatches[family]
    with trace.recording() as events:
        got = run(ht, _port(tmp_path, True))
    assert trace_line in events
    assert D.dispatches[family] - d0 >= 3
    want = run(hst, _ref(tmp_path, True))
    M.same_rows(got, want, shape)  # JAX's fused run: floats at rtol 1e-9
    off = run(ht, _port(tmp_path, False))
    if shape == "q3":
        # fusion off, the q3 chain's aggregate is the host pandas one (no
        # streamed or device tier takes an Aggregate over a join): its
        # float sums add in another order
        M.same_rows(got, off, shape)
    else:
        _same_bytes(got, off)  # the port's per-family device path


def test_untouched_session_dispatches_no_fused_program(tmp_path):
    data = _suite._write_q1(str(tmp_path / "q1"))
    probe_dir, build_dir = _suite._write_q3(str(tmp_path / "q3"))
    tk = _suite._write_topk(str(tmp_path / "tk"))
    sess = _port(tmp_path, None)
    assert sess.conf.fusion_enabled is False and sess.conf.fusion_donation is True
    d0 = _fused_count()
    _q1(ht, sess.read_parquet(data)).collect()
    _q3(ht, sess, probe_dir, build_dir).collect()
    _topk(ht, sess, tk).collect()
    assert _fused_count() == d0


def _fold_state(gs):
    p = gs._partial
    return [p["fs"], *p["keys"], *p["slots"]]


@pytest.mark.parametrize("donation", [True, False])
def test_donated_state_keeps_its_storage(tmp_path, donation):
    """With donation the state tensors keep their storage across folds at a
    fixed capacity; without it every fold rebinds them. The tables are the
    same either way."""
    data = _suite._write_q1(str(tmp_path / "q1"), num_files=4)
    sess = _port(tmp_path, True, donation)
    files = sorted(os.path.join(data, f) for f in os.listdir(data))
    gs = A.GroupedAggStream(sess, ["g"], [("n", "count", None), ("sp", "sum", "price")],
                            max_groups=1 << 20, cap_floor=256)
    ptrs = []
    for f in files:
        t = pq.read_table(f)
        gs.update({c: t[c].to_numpy() for c in t.column_names}, ht.col("qty") > 40)
        ptrs.append([x.data_ptr() for x in _fold_state(gs)])
    assert gs._partial["cap"] == 256
    if donation:
        assert all(p == ptrs[0] for p in ptrs[1:]), ptrs
    else:
        for a, b in zip(ptrs, ptrs[1:]):
            assert all(x != y for x, y in zip(a, b)), (a, b)
    got = gs.finalize()
    ref = hst.Session(conf={hst.keys.SYSTEM_PATH: str(tmp_path / "ridx")})
    want = ref.read_parquet(data).filter(hst.col("qty") > 40).group_by("g").agg(
        n=("*", "count"), sp=("price", "sum")).collect()
    M.same_rows(got, want, "fold")


def test_topk_state_keeps_its_storage(tmp_path):
    data = _suite._write_topk(str(tmp_path / "tk"))
    from hyperspace_tpu_torch.exec.topk import TopKStream

    ptrs = {}
    for donation in (True, False):
        sess = _port(tmp_path, True, donation)
        stream = TopKStream(sess, [("v", False), ("k", True)], 25)
        seen = []
        for f in sorted(os.listdir(data)):
            t = pq.read_table(os.path.join(data, f))
            stream.update({c: t[c].to_numpy(zero_copy_only=False) for c in t.column_names})
            seen.append(stream._state.data_ptr())
        ptrs[donation] = (seen, stream.finalize())
    assert len(set(ptrs[True][0])) == 1  # the first chunk's candidates, written in place
    # rebound: each fold allocates while the state it replaces is alive
    assert all(a != b for a, b in zip(ptrs[False][0], ptrs[False][0][1:]))
    _same_bytes(ptrs[True][1], ptrs[False][1])


def test_overflow_leaves_the_state_and_redoes_per_family(tmp_path):
    """A chunk with more groups than the state's capacity is not written:
    the state's values are as they were, the chunk is redone per-family
    (counted in trace.fallbacks), and the result is the fusion-off one."""
    d = tmp_path / "ov"
    d.mkdir()
    rng = np.random.default_rng(11)
    for i, groups in enumerate((3, 3, 40, 5)):
        n = 300
        pq.write_table(pa.table({
            "g": rng.integers(0, groups, n).astype(np.int64) + 100 * i,
            "x": np.round(rng.uniform(-50, 50, n), 3),
        }), d / f"p{i}.parquet")
    files = sorted(d.iterdir())
    sess = _port(tmp_path, True, True, **{ht.keys.EXEC_AGG_CAPACITY_FLOOR: 8})
    aggs = [("n", "count", None), ("s", "sum", "x"), ("lo", "min", "x")]
    gs = A.GroupedAggStream(sess, ["g"], aggs, max_groups=1 << 20, cap_floor=8)
    fb0 = trace.fallbacks[("fusion", "grouped-overflow")]
    for f in files[:2]:
        t = pq.read_table(f)
        gs.update({c: t[c].to_numpy() for c in t.column_names}, None)
    before = [x.clone() for x in _fold_state(gs)]
    n_before = gs._partial["n"]
    # the overflow check alone, on the state as it stands
    key_specs = (("g", "i"),)
    state_keys, state_slots, state_fs, state_n = gs._ensure_fused_state(key_specs, gs._partial["cap"])
    t = pq.read_table(files[2])
    cols = {c: torch.from_numpy(t[c].to_numpy()) for c in ("g", "x")}
    program = A.fused_grouped_update_program(None, key_specs, gs._slots, gs._partial["cap"], True)
    n_b, n_m, n_out, *_ = program(state_keys, state_slots, state_fs, state_n, cols, (), t.num_rows, 600)
    assert n_b > gs._partial["cap"] and n_out == n_before
    for a, b in zip(before, _fold_state(gs)):
        assert torch.equal(a, b)
    # through the stream: the redo, then the last chunk fused again
    for f in files[2:]:
        t = pq.read_table(f)
        gs.update({c: t[c].to_numpy() for c in t.column_names}, None)
    assert trace.fallbacks[("fusion", "grouped-overflow")] == fb0 + 1
    got = gs.finalize()
    off = _port(tmp_path, False)
    gs_off = A.GroupedAggStream(off, ["g"], aggs, max_groups=1 << 20, cap_floor=8)
    for f in files:
        t = pq.read_table(f)
        gs_off.update({c: t[c].to_numpy() for c in t.column_names}, None)
    _same_bytes(got, gs_off.finalize())


def test_join_agg_pair_overflow_redoes_the_chunk(tmp_path):
    """More matched pairs than ``pair_cap`` (here every probe row meets
    twelve build rows): the chunk is redone per-family, the pair capacity
    grows, and the rows equal the fusion-off run."""
    probe, build = tmp_path / "probe", tmp_path / "build"
    probe.mkdir()
    build.mkdir()
    rng = np.random.default_rng(19)
    for i in range(3):
        n = 5000
        pq.write_table(pa.table({
            "k": rng.integers(0, 4, n).astype(np.int64),
            "g": rng.integers(0, 7, n).astype(np.int64),
            "v": np.round(rng.standard_normal(n), 4),
        }), probe / f"p{i}.parquet")
    pq.write_table(pa.table({
        "k2": np.repeat(np.arange(4, dtype=np.int64), 12),
        "w": np.round(rng.standard_normal(48), 4),
    }), build / "b.parquet")
    fb0 = trace.fallbacks[("fusion", "join-agg-overflow")]
    with trace.recording() as events:
        got = _q3(ht, _port(tmp_path, True), str(probe), str(build)).collect()
    assert ("agg", "fused-join-agg-stream") in events
    assert trace.fallbacks[("fusion", "join-agg-overflow")] > fb0
    # fusion off, the aggregate over the join is the host pandas one
    want = _q3(ht, _port(tmp_path, False), str(probe), str(build)).collect()
    M.same_rows(got, want, "q3")


def test_join_agg_equals_the_per_family_device_fold(tmp_path):
    """The fused join aggregate is the per-family sequence it replaces
    (hash-probe, verify, fused-postjoin, grouped-agg-chunk, grouped-merge
    over the same chunks), byte for byte, and dispatches at least 3x
    fewer programs."""
    probe_dir, build_dir = _suite._write_q3(str(tmp_path / "q3"))
    from hyperspace_tpu_torch.exec.executor import Executor

    sess = _port(tmp_path, False)
    before = sum(D.dispatches.values())
    gs = A.GroupedAggStream(
        sess, ["g"], [("n", "count", None), ("s", "sum", "v"), ("a", "avg", "w"), ("mn", "min", "v"),
                      ("mx", "max", "w")],
        max_groups=sess.conf.agg_max_groups, cap_floor=sess.conf.agg_capacity_floor,
    )
    probe, build = sess.read_parquet(probe_dir), sess.read_parquet(build_dir)
    joined = probe.join(build, on=ht.col("k") == ht.col("k2"), how="inner").filter(ht.col("v") > -0.5)
    for chunk in Executor(sess).execute_stream(joined.plan):
        gs.update({c: np.asarray(v) for c, v in chunk.items()}, None)
    want = gs.finalize()
    per_family = sum(D.dispatches.values()) - before
    before = sum(D.dispatches.values())
    got = _q3(ht, _port(tmp_path, True), probe_dir, build_dir).collect()
    fused = sum(D.dispatches.values()) - before
    assert per_family >= 3 * fused, (per_family, fused)
    _same_bytes(got, want)
