"""The broadcast hash join through the port, against the JAX package.

The cases of tests/test_join_stream.py run with the package renamed to the
port (tests/torch_mirror.py): their own assertions hold the port's answers
to the pandas oracle, and every ``collect()`` is held to the JAX package's
rows over the same lake, in the same order. The file's ``_counter`` reads
the port's metrics registry, ``hs_join_broadcast_total`` among them, as
the JAX package's does. The shared build cache of
``serving/build_cache.py`` runs under the port's ``QueryServer``.

Left out, each with its reason:

- ``TestQ3Chain::test_probe_compile_flatness_across_chunk_sizes``: XLA
  compile counts (torch compiles nothing).

Beside them, each package's streamed output (``execute_stream``) is held
to the other's chunk for chunk, and the three programs to numpy:
``hash-build`` and ``hash-probe`` bit for bit on random, duplicate and
colliding hash planes, ``fused-postjoin`` against the host ``eval`` of the
same predicate over the gathered pairs.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import torch_mirror as M  # noqa: E402

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.exec import trace as ref_trace  # noqa: E402
from hyperspace_tpu.exec.executor import Executor as RefExecutor  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import join_stream as JS  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402
from hyperspace_tpu_torch.exec.executor import Executor  # noqa: E402
from hyperspace_tpu_torch.ops.hashing import combine_hashes_np  # noqa: E402

pytestmark = pytest.mark.torch_port

LEFT_OUT = {
    "TestQ3Chain::test_probe_compile_flatness_across_chunk_sizes": "XLA compile counts",
}

_cases = M.load_cases(
    os.path.join(os.path.dirname(__file__), "test_join_stream.py"),
    "_torch_join_stream_cases",
    rewrites={
        "    sess = hst.Session(conf=base)\n": (
            "    import torch_mirror as M\n\n"
            "    sess = M.MirroredSession(base.pop(hst.keys.SYSTEM_PATH), conf=base)\n"
        ),
        # the port keeps the JAX package's exec/device.py join internals in
        # exec/join.py
        "        from hyperspace_tpu_torch.exec import device as D\n        from hyperspace_tpu_torch.obs.metrics import REGISTRY\n":
            "        from hyperspace_tpu_torch.exec import join as D\n        from hyperspace_tpu_torch.obs.metrics import REGISTRY\n",
        "        from hyperspace_tpu_torch.exec import device as D\n\n        sess, ldf, rdf, _lpd, _rpd = smj_sides":
            "        from hyperspace_tpu_torch.exec import join as D\n\n        sess, ldf, rdf, _lpd, _rpd = smj_sides",
        # the port's program contracts (check/program_lint.py, the
        # counterpart of check/hlo_lint.py)
        "        from hyperspace_tpu_torch.check import hlo_lint\n": (
            "        from hyperspace_tpu_torch.check import program_lint as hlo_lint\n"),
    },
)
M.export_cases(_cases, globals(), LEFT_OUT)


@pytest.fixture(autouse=True)
def _mirrored():
    with M.mirroring():
        yield


def test_every_case_is_run_or_listed():
    """Each case of tests/test_join_stream.py is collected here or left out
    by name (its own or its class's)."""
    M.assert_every_case([_cases], globals(), LEFT_OUT)


# --------------------------------------------------------------------------
# streamed output, chunk for chunk against the JAX package
# --------------------------------------------------------------------------


def _lake(tmp_path):
    """The broadcast_sides lake of tests/test_join_stream.py, the probe side
    in three files so it streams in chunks."""
    rng = np.random.default_rng(11)
    n, m = 2500, 110
    lk = rng.integers(0, 60, n).astype(np.float64)
    lk[rng.random(n) < 0.04] = np.nan
    ldata = {"k": lk, "c": np.array([f"g{v}" for v in rng.integers(0, 6, n)]),
             "v": np.round(rng.standard_normal(n), 4)}
    rk = rng.integers(0, 70, m).astype(np.float64)
    rk[rng.random(m) < 0.04] = np.nan
    rdata = {"k2": rk, "c2": np.array([f"g{v}" for v in rng.integers(0, 7, m)]),
             "w": np.round(rng.standard_normal(m), 4)}
    for name, data, parts in (("l", ldata, 3), ("r", rdata, 1)):
        d = tmp_path / name
        os.makedirs(d)
        rows = len(next(iter(data.values())))
        for i in range(parts):
            sl = slice(i * rows // parts, (i + 1) * rows // parts)
            pq.write_table(pa.table({k: v[sl] for k, v in data.items()}), str(d / f"part-{i}.parquet"))
    return str(tmp_path / "l"), str(tmp_path / "r")


SHAPES = {
    "inner": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2")),
    "left": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2"), how="left"),
    "right": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2"), how="right"),
    "outer": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2"), how="outer"),
    "composite": lambda p, l, r: l.join(r, on=(p.col("k") == p.col("k2")) & (p.col("c") == p.col("c2"))),
    "fused_filter_project": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2")).filter(
        p.col("w") > 0.25).select("k", "v", "w"),
    "string_filter": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2")).filter(
        (p.col("c2") == "g3") | (p.col("v") < -1.0)),
    "left_post_filter": lambda p, l, r: l.join(r, on=p.col("k") == p.col("k2"), how="left").filter(
        p.col("v") > 0.0),
    "build_left": lambda p, l, r: r.join(l, on=p.col("k2") == p.col("k")),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stream_chunks_match_jax(tmp_path, shape):
    ldir, rdir = _lake(tmp_path)
    conf = {"hyperspace.exec.stream.chunkBytes": 1}
    port = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "i"), **conf}, device="cpu")
    ref = hst.Session(conf={hst.keys.SYSTEM_PATH: str(tmp_path / "i"), **conf})
    D.reset_dispatches()
    with trace.recording() as pev:
        got = list(Executor(port).execute_stream(
            SHAPES[shape](ht, port.read_parquet(ldir), port.read_parquet(rdir)).optimized_plan()))
    with ref_trace.recording() as rev:
        want = list(RefExecutor(ref).execute_stream(
            SHAPES[shape](hst, ref.read_parquet(ldir), ref.read_parquet(rdir)).optimized_plan()))
    assert ("join", "broadcast-hash-stream") in pev
    assert [e for e in pev if e[0] == "join"] == [e for e in rev if e[0] == "join"]
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        M.same_rows(g, w, f"{shape} chunk {i}")
    assert D.dispatches["hash-build"] == 1 and D.dispatches["hash-probe"] == 3, dict(D.dispatches)
    if shape in ("fused_filter_project", "string_filter"):
        assert D.dispatches["fused-postjoin"] == 3, dict(D.dispatches)


def test_generic_merge_baseline_matches(tmp_path):
    """``broadcastMaxBytes=0`` sends the join to the generic merge: the same
    rows as a multiset."""
    ldir, rdir = _lake(tmp_path)
    port = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "i")}, device="cpu")
    q = SHAPES["outer"](ht, port.read_parquet(ldir), port.read_parquet(rdir))
    got = q.collect()
    port.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 0)
    with trace.recording() as events:
        base = q.collect()
    assert ("join", "generic-merge") in events

    def rows(b):
        return sorted(M._rows(b), key=lambda r: tuple(repr(x) for x in r))

    assert [tuple(repr(x) for x in r) for r in rows(got)] == [tuple(repr(x) for x in r) for r in rows(base)]


# --------------------------------------------------------------------------
# the programs against numpy
# --------------------------------------------------------------------------


def _plain_build(planes):
    h = combine_hashes_np(planes)
    order = np.argsort(h, kind="stable")
    return h[order].astype(np.int64), order


def _plain_probe(table, planes):
    h = combine_hashes_np(planes)
    return (np.searchsorted(table, h, side="left").astype(np.int64),
            np.searchsorted(table, h, side="right").astype(np.int64))


def _hash_planes(kind, rng, n, nkeys):
    if kind == "random":
        return [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(nkeys)]
    if kind == "duplicate":
        return [rng.integers(0, 7, n).astype(np.uint32) for _ in range(nkeys)]
    # colliding: every row the same planes, so every row hashes alike
    return [np.full(n, 0xDEADBEEF, dtype=np.uint32) for _ in range(nkeys)]


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "duplicate", "colliding"])
@pytest.mark.parametrize("n_build", [0, 1, 257])
def test_hash_programs_equal_numpy(kind, nkeys, n_build):
    rng = np.random.default_rng(nkeys * 1000 + n_build)
    bplanes = _hash_planes(kind, rng, n_build, nkeys)
    table, order = JS.hash_build_program(JS._upload_hash_planes(bplanes, torch.device("cpu")))
    want_table, want_order = _plain_build(bplanes)
    np.testing.assert_array_equal(table.numpy(), want_table)
    np.testing.assert_array_equal(order.numpy(), want_order)
    # probes: half drawn from the build's rows, half fresh (no hit)
    pplanes = [np.concatenate([p[rng.integers(0, max(n_build, 1), 40) % max(n_build, 1)] if n_build else p[:0],
                               q]) for p, q in zip(bplanes, _hash_planes("random", rng, 40, nkeys))]
    lo, hi = JS.hash_probe_program(table, n_build, JS._upload_hash_planes(pplanes, torch.device("cpu")))
    want_lo, want_hi = _plain_probe(want_table, pplanes)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)


def test_probe_chunk_verifies_collisions(tmp_path):
    """Rows whose hash planes collide but whose keys differ are candidates
    that the exact host check drops."""
    port = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "i")}, device="cpu")
    build_batch = {"k": np.array([1, 2, 3, 2], dtype=np.int64)}
    planes = [np.zeros(4, dtype=np.uint32)]  # every build row in one hash run
    table, order = JS.hash_build_program(JS._upload_hash_planes(planes, torch.device("cpu")))
    build = JS.BuildSide(build_batch, 4, table, order.numpy(), {"k": np.dtype(np.int64)}, 0)
    real = JS.hash_input_uint32
    try:
        JS.hash_input_uint32 = lambda arr: np.zeros(len(arr), dtype=np.uint32)
        p_i, b_i = JS._probe_chunk(port, build, {"k": np.array([2, 9, 3], dtype=np.int64)}, ["k"], ["k"])
    finally:
        JS.hash_input_uint32 = real
    assert list(zip(p_i.tolist(), b_i.tolist())) == [(0, 1), (0, 3), (2, 2)]


def test_postjoin_program_equals_host_eval(tmp_path):
    rng = np.random.default_rng(3)
    n_p, n_b, pairs = 500, 60, 900
    probe = {"k": rng.integers(0, 9, n_p).astype(np.int64), "v": rng.standard_normal(n_p),
             "c": np.array([f"g{x}" for x in rng.integers(0, 5, n_p)], dtype=object)}
    probe["v"][::17] = np.nan
    build_batch = {"k2": np.arange(n_b, dtype=np.int64), "w": rng.standard_normal(n_b),
                   "d": np.arange(n_b).astype("datetime64[D]")}
    table, order = JS.hash_build_program(JS._upload_hash_planes([JS.hash_input_uint32(build_batch["k2"])],
                                                                torch.device("cpu")))
    build = JS.BuildSide(build_batch, n_b, table, order.numpy(), {"k2": np.dtype(np.int64)}, 0)
    pidx = rng.integers(0, n_p, pairs).astype(np.int64)
    bidx = rng.integers(0, n_b, pairs).astype(np.int64)
    lout, rout = list(probe), list(build_batch)
    port = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "i")}, device="cpu")
    conds = [
        (ht.col("w") > 0.25) & (ht.col("v") < 0.5),
        (ht.col("c") == "g2") | ht.col("v").is_null(),
        ht.col("d") >= np.datetime64("1970-01-20"),
        ~(ht.col("k") + ht.col("k2") > 30),
    ]
    from hyperspace_tpu_torch.plan.expr import as_bool_mask

    for cond in conds:
        refs = sorted(cond.references())
        sources = {name: JS._join_column_source(name, lout, rout) for name in refs}
        D.reset_dispatches()
        got = JS._device_postjoin_mask(port, cond, probe, build, pidx, bidx, refs, sources, True)
        assert D.dispatches["fused-postjoin"] == 1
        gathered = JS._gather_pairs(refs, sources, probe, build_batch, pidx, bidx, {}, {})
        want = np.broadcast_to(np.asarray(as_bool_mask(cond.eval(gathered)), dtype=bool), (pairs,))
        np.testing.assert_array_equal(got, want, err_msg=repr(cond))
