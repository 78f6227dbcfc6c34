"""The port's grouped programs and the exchange staging, fixed-shape as the
JAX package's are (ROADMAP §C: C12 and C13, repaired), against the JAX
package's programs on the CPU.

The same seeded numpy inputs go through both packages: ``_segment_ids``,
``grouped-agg-chunk``, ``grouped-merge``, ``fused-stage-agg``, the sharded
twins on a 4-shard CPU mesh (held to the JAX package's single-device
programs: the sharded results equal them), ``fused-stage-join-agg`` and the
exchange's ``_stage_for_exchange``. Chunks with every row masked, one row,
exactly ``cap`` groups, ``cap + 1`` and far above ``cap``; float keys with
-0.0 and NaN; int and float count, sum, sum of squares (stddev), min and
max slots.

Exact: counts, first-seen rows, keys, group order, int slots and float
min/max; float sums at rtol 1e-9 (the packages add in different orders).
Above ``cap`` the tables hold the first ``cap`` groups in both. JAX's CPU
backend folds its ``k + 0.0`` away, so -0.0 keys would form a group of
their own there (ROADMAP §C): the reference is given +0.0 in their place,
and float keys compare by value.

Then each program's window, recorded with ``check/program_lint.py``, holds
no host wait (``aten::nonzero``, ``aten::_local_scalar_dense``, a copy to
the host) and no output sized by values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hyperspace_tpu.exec import device as RD  # noqa: E402
from hyperspace_tpu.exec import stage_ir as RS  # noqa: E402
from hyperspace_tpu.ops import bucketize as RB  # noqa: E402
from hyperspace_tpu.ops import hashing as RH  # noqa: E402
from hyperspace_tpu.utils.x64 import ensure_x64  # noqa: E402
from hyperspace_tpu_torch.check import program_lint as PL  # noqa: E402
from hyperspace_tpu_torch.exec import aggregate as A  # noqa: E402
from hyperspace_tpu_torch.exec import stage_ir as S  # noqa: E402
from hyperspace_tpu_torch.ops import bucketize as BZ  # noqa: E402
from hyperspace_tpu_torch.ops import hashing as H  # noqa: E402
from hyperspace_tpu_torch.parallel import collectives as C  # noqa: E402
from hyperspace_tpu_torch.parallel import mesh as PM  # noqa: E402

pytestmark = pytest.mark.torch_port

FLOAT_RTOL = 1e-9
CAP = 16
N_SHARDS = 4
SLOTS = [("cntm", None, True), ("cnt", "v", False), ("sum", "v", False), ("sumsq", "v", False),
         ("min", "v", False), ("max", "v", False), ("sum", "q", True), ("min", "q", True), ("max", "q", True),
         ("cnt", "q", True), ("sum", "q", False), ("sumsq", "q", False)]
#: (rows, distinct int keys, predicate threshold on ``p`` or None)
CASES = {
    "all-masked": (300, 40, -1),
    "one-row": (1, 1, None),
    "exactly-cap": (400, CAP, None),
    "cap+1": (400, CAP + 1, None),
    "far-above-cap": (800, 500, 7),
}
KEYS = {"int": (("ik", "i"),), "float-int": (("fk", "f"), ("ik", "i"))}


@pytest.fixture(autouse=True, scope="module")
def _x64():
    ensure_x64()


def _cols(case: str, seed: int = 0) -> dict:
    """A chunk's columns: an int key ``ik`` with exactly the case's distinct
    values, a float key ``fk`` with -0.0, +0.0 and NaN, a predicate column
    ``p``, an int input ``q`` above 2^53 and a float input ``v`` with NaN."""
    n, n_keys, _ = CASES[case]
    rng = np.random.default_rng(seed)
    ik = rng.permutation(np.arange(n) % n_keys).astype(np.int64) * 7 - 30
    v = np.round(rng.standard_normal(n), 3)
    v[rng.random(n) < 0.2] = np.nan
    return {
        "ik": ik,
        "fk": rng.choice(np.array([0.5, -0.0, 0.0, np.nan, -3.0]), n),
        "p": rng.integers(0, 10, n).astype(np.int64),
        "q": rng.integers(-(2**60), 2**60, n).astype(np.int64),
        "v": v,
    }


def _pred(case: str):
    keep = CASES[case][2]
    return None if keep is None else (lambda c, lits: c["p"] < keep)


def _t(cols: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in cols.items()}


def _j(cols: dict) -> dict:
    """The reference's columns: +0.0 for -0.0 in the float key."""
    return {k: jnp.asarray(v + 0.0 if k == "fk" else v) for k, v in cols.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables(got, ref, slot_specs, n: int, key_kinds=None):
    """The first ``n`` rows of two (fs, keys, slots) tables: fs, keys and
    order exactly (float keys by value), int slots and float min/max
    exactly, float sums at FLOAT_RTOL."""
    fs, keys, slots = got
    rfs, rkeys, rslots = ref
    assert _np(fs)[:n].tobytes() == _np(rfs)[:n].tobytes()
    for k, rk in zip(keys, rkeys):
        k, rk = _np(k)[:n], _np(rk)[:n]
        if rk.dtype.kind == "f" or k.dtype.kind == "f":
            assert np.array_equal(k.astype(np.float64), rk.astype(np.float64), equal_nan=True)
        else:
            assert k.astype(np.int64).tobytes() == rk.astype(np.int64).tobytes()
    for (kind, _, _), s, rs in zip(slot_specs, slots, rslots):
        s, rs = _np(s)[:n], _np(rs)[:n]
        assert s.dtype == rs.dtype, kind
        if s.dtype.kind == "f" and kind in ("sum", "sumsq"):
            np.testing.assert_allclose(s, rs, rtol=FLOAT_RTOL, equal_nan=True, err_msg=kind)
        else:
            assert s.tobytes() == rs.tobytes(), (kind, s, rs)


# --------------------------------------------------------------------------
# _segment_ids
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_segment_ids_match_jax(case, keys):
    """The sort order, the sorted mask and the group count exactly; a
    matched row's segment below ``cap`` exactly, and every other row's id
    in the scratch band past ``cap``, where JAX's is out of range."""
    cols = _t(_cols(case))
    n = cols["ik"].shape[0]
    pred = _pred(case)
    mask = pred(cols, ()) if pred is not None else torch.ones(n, dtype=torch.bool)
    codes = [A._key_code(cols[name], tag) for name, tag in KEYS[keys]]
    order, ms, n_groups, ids = A._segment_ids(codes, mask, CAP)
    r_order, r_ms, r_n, r_segs = RD._segment_ids([jnp.asarray(c.numpy()) for c in codes],
                                                 jnp.asarray(mask.numpy()), CAP)
    assert n_groups.dim() == 0 and int(n_groups) == int(r_n)
    assert order.numpy().tolist() == np.asarray(r_order).tolist()
    assert ms.numpy().tolist() == np.asarray(r_ms).tolist()
    r_segs = np.asarray(r_segs)
    inside = r_segs < CAP
    assert ids.numpy()[inside].tolist() == r_segs[inside].tolist()
    band = ids.numpy()[~inside]
    assert ((band >= CAP) & (band < CAP + A._SCRATCH_BAND)).all()


# --------------------------------------------------------------------------
# grouped-agg-chunk, and its sharded twin
# --------------------------------------------------------------------------


def _jax_chunk(case, key_specs, cap=CAP):
    cols = _cols(case)
    prog = jax.jit(RD._grouped_chunk_program(_pred(case), key_specs, SLOTS, cap))
    n = cols["ik"].shape[0]
    n_g, fs, keys, slots = prog(_j(cols), (), np.int64(n), np.int64(11))
    return int(n_g), (fs, keys, slots)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_chunk_program_matches_jax(case, keys):
    """The count as a 0-d tensor equal to JAX's, even above ``cap``, and
    ``cap``-row tables whose first ``min(count, cap)`` rows equal JAX's."""
    key_specs = KEYS[keys]
    cols = _cols(case)
    n = cols["ik"].shape[0]
    n_g, fs, key_out, slot_out = A.grouped_chunk_program(_pred(case), key_specs, SLOTS, CAP)(_t(cols), (), n, 11)
    r_n, ref = _jax_chunk(case, key_specs)
    assert n_g.dim() == 0 and int(n_g) == r_n
    assert fs.shape == (CAP,) and all(s.shape == (CAP,) for s in slot_out)
    _assert_tables((fs, key_out, slot_out), ref, SLOTS, min(r_n, CAP))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_sharded_chunk_program_matches_jax(case, keys):
    """The sharded twin on a 4-shard CPU mesh: every shard's table merged
    on the device equals JAX's single-device program; above ``cap`` its
    count is above ``cap`` too (the shards' counts maxed in), so the
    caller re-runs."""
    key_specs = KEYS[keys]
    cols = _cols(case)
    n = cols["ik"].shape[0]
    mesh = PM.make_mesh(devices=["cpu"] * N_SHARDS)
    n_g, fs, key_out, slot_out = C.sharded_grouped_chunk_program(
        mesh, "buckets", _pred(case), key_specs, SLOTS, CAP)(_t(cols), (), n, 11)
    r_n, ref = _jax_chunk(case, key_specs)
    assert n_g.dim() == 0
    if r_n > CAP:
        assert int(n_g) > CAP
    else:
        assert int(n_g) == r_n
        _assert_tables((fs, key_out, slot_out), ref, SLOTS, r_n)


# --------------------------------------------------------------------------
# grouped-merge
# --------------------------------------------------------------------------


def _partial(rng, n, base, cap_in):
    """A partial table of ``n`` distinct (int, float) groups padded to
    ``cap_in`` rows, first-seen rows from ``base`` up, slots with -0.0,
    NaN and int64 values above 2^53."""
    space = [(i, f) for i in range(-4, 6) for f in (0.5, 1.5, np.nan, -3.0, 2.0, 9.0)]
    pick = rng.choice(len(space), n, replace=False)
    ik = np.array([space[p][0] for p in pick], dtype=np.int64)
    fk = np.array([space[p][1] for p in pick], dtype=np.float64)
    fs = rng.permutation(np.sort(rng.choice(1000, n, replace=False)).astype(np.int64) + base)

    def fl():
        x = rng.choice(np.array([-0.0, 0.0, 1.5, np.inf, -np.inf]), n)
        return np.where(rng.random(n) < 0.5, np.round(rng.standard_normal(n), 3), x)

    slots = [rng.integers(0, 50, n), fl(), np.abs(fl()), fl(), fl(), rng.integers(-(2**60), 2**60, n),
             rng.integers(-(2**60), 2**60, n)]

    def pad(a, fill):
        return np.concatenate([a, np.full(cap_in - n, fill, dtype=a.dtype)])

    return [pad(ik, 0), pad(fk, np.nan)], [pad(s, 0) for s in slots], pad(fs, 2**63 - 1)


MERGE_SLOTS = [("cntm", None, True), ("sum", "v", False), ("sumsq", "v", False), ("min", "v", False),
               ("max", "v", False), ("min", "q", True), ("max", "q", True)]


@pytest.mark.parametrize("n_a,n_b,cap_out", [(0, 0, 16), (0, 1, 16), (1, 16, 32), (16, 16, 32),
                                              (16, 16, 8), (12, 9, 12)])
def test_merge_program_matches_jax(n_a, n_b, cap_out):
    """Two 16-row partial tables masked to their first ``n_a`` and
    ``n_b`` rows, merged into ``cap_out``: the count exactly (also above
    ``cap_out``), the first ``min(count, cap_out)`` rows as JAX's."""
    rng = np.random.default_rng(n_a * 100 + n_b)
    a, b = _partial(rng, n_a, 0, 16), _partial(rng, n_b, 1000, 16)
    key_specs = (("ik", "i"), ("fk", "f"))
    t = torch.from_numpy
    n_g, fs, keys, slots = A.grouped_merge_program(key_specs, MERGE_SLOTS, 16, cap_out)(
        tuple(t(k) for k in a[0]), tuple(t(k) for k in b[0]), tuple(t(s) for s in a[1]),
        tuple(t(s) for s in b[1]), t(a[2]), t(b[2]), n_a, n_b)
    prog = jax.jit(RD._grouped_merge_program(key_specs, MERGE_SLOTS, 16, cap_out))
    r_n, *ref = prog(tuple(jnp.asarray(k) for k in a[0]), tuple(jnp.asarray(k) for k in b[0]),
                     tuple(jnp.asarray(s) for s in a[1]), tuple(jnp.asarray(s) for s in b[1]),
                     jnp.asarray(a[2]), jnp.asarray(b[2]), np.int64(n_a), np.int64(n_b))
    assert n_g.dim() == 0 and int(n_g) == int(r_n)
    _assert_tables((fs, keys, slots), ref, MERGE_SLOTS, min(int(r_n), cap_out))


# --------------------------------------------------------------------------
# fused-stage-agg, and its sharded twin
# --------------------------------------------------------------------------

FUSED_SLOTS = [("cntm", None, True), ("sum", "v", False), ("min", "v", False), ("max", "q", True),
               ("cnt", "v", False), ("sumsq", "v", False)]
#: two chunks folded in turn, each (case, seed, shift of its int keys); the
#: name says what the second one does at CAP
FOLDS = {
    "fits": (("exactly-cap", 0, 0), ("exactly-cap", 1, 0)),
    "chunk-overflow": (("exactly-cap", 0, 0), ("far-above-cap", 1, 0)),
    "merge-overflow": (("one-row", 0, 0), ("exactly-cap", 1, 1000)),
    "all-masked": (("all-masked", 0, 0), ("all-masked", 1, 0)),
}


def _fold_inputs(case, seed, shift):
    cols = _cols(case, seed)
    cols["ik"] = cols["ik"] + shift
    return cols


def _fresh_state(key_specs, slot_specs, cap):
    key_dts, slot_dts = A._fused_state_dtypes(key_specs, slot_specs)
    return ([torch.zeros(cap, dtype=dt) for dt in key_dts], [torch.zeros(cap, dtype=dt) for dt in slot_dts],
            torch.full((cap,), A._FS_SENTINEL, dtype=torch.int64))


def _jax_fold(key_specs, pred, state, state_n, cols, row_base):
    prog = jax.jit(RD._fused_grouped_update_program(pred, key_specs, FUSED_SLOTS, CAP))
    keys, slots, fs = state
    n = next(iter(cols.values())).shape[0]
    out = prog(tuple(jnp.asarray(k.numpy()) for k in keys), tuple(jnp.asarray(s.numpy()) for s in slots),
               jnp.asarray(fs.numpy()), np.int64(state_n), _j(cols), (), np.int64(n), np.int64(row_base))
    return [int(x) for x in out[:3]], out[3:]


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_fused_program_matches_jax(fold, sharded):
    """Two chunks folded in turn: ``(n_b, n_m, n_out)`` as JAX's, and the
    state's first ``n_out`` rows. Where the second chunk overflows (in the
    chunk or in the merge) the state comes back as it was: with donation
    its storage and its values are unchanged, as JAX's donated buffers
    round-trip."""
    key_specs = KEYS["int"]
    mesh = PM.make_mesh(devices=["cpu"] * N_SHARDS)
    donate = not sharded
    state, state_n, row_base = _fresh_state(key_specs, FUSED_SLOTS, CAP), 0, 0
    for case, seed, shift in FOLDS[fold]:
        pred = _pred(case)
        if sharded:
            program = C.sharded_fused_grouped_program(mesh, "buckets", pred, key_specs, FUSED_SLOTS, CAP)
        else:
            program = A.fused_grouped_update_program(pred, key_specs, FUSED_SLOTS, CAP, donate)
        cols = _fold_inputs(case, seed, shift)
        n = cols["ik"].shape[0]
        r_counts, ref = _jax_fold(key_specs, pred, state, state_n, cols, row_base)
        before = [x.clone() for x in (state[2], *state[0], *state[1])]
        ptrs = [x.data_ptr() for x in (state[2], *state[0], *state[1])]
        n_b, n_m, n_out, fs, keys, slots = program(state[0], state[1], state[2], state_n, _t(cols), (), n, row_base)
        got_counts = A.read_counts(n_b, n_m, n_out)
        if sharded and r_counts[0] > CAP:
            # a shard over cap keeps its first cap groups: the count is a
            # bound above cap, as in the JAX package's sharded program
            assert got_counts[0] > CAP and got_counts[2] == r_counts[2], (case, got_counts, r_counts)
        else:
            assert got_counts == r_counts, (case, got_counts, r_counts)
        ok = r_counts[0] <= CAP and r_counts[1] <= CAP
        if not ok:
            assert r_counts[2] == state_n
            for x, y in zip(before, (fs, *keys, *slots)):
                assert x.numpy().tobytes() == y.numpy().tobytes()
        if donate:
            assert [x.data_ptr() for x in (fs, *keys, *slots)] == ptrs
        _assert_tables((fs, keys, slots), ref, FUSED_SLOTS, r_counts[2])
        state, state_n = (list(keys), list(slots), fs), r_counts[2]
        if ok:
            row_base += n
    assert fold != "chunk-overflow" or r_counts[0] > CAP
    assert fold != "merge-overflow" or (r_counts[0] <= CAP < r_counts[1])


# --------------------------------------------------------------------------
# fused-stage-join-agg
# --------------------------------------------------------------------------

JOIN_SLOTS = [("cntm", None, True), ("sum", "x", False), ("min", "x", False), ("max", "y", True),
              ("cnt", "x", False)]
#: (probe rows, build rows, key range, pair_cap, predicate threshold)
JOINS = {
    "fits": (60, 40, 30, 256, None),
    "pairs-overflow": (60, 40, 6, 64, None),
    "predicate-keeps-nothing": (60, 40, 30, 256, 1e9),
    "groups-overflow": (200, 120, 200, 512, None),
}


def _join_inputs(join: str, seed: int):
    n_probe, n_build, keys, _, _ = JOINS[join]
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, keys, n_build).astype(np.int64)
    pk = rng.integers(0, keys + 5, n_probe).astype(np.int64)
    x = np.round(rng.standard_normal(n_probe), 3)
    x[rng.random(n_probe) < 0.2] = np.nan
    g = (bk * 3 % max(2, keys // 2)).astype(np.int64) if join != "groups-overflow" else bk
    return bk, pk, {"x": x}, {"g": g, "y": rng.integers(-(2**60), 2**60, n_build).astype(np.int64)}


@pytest.mark.parametrize("join", sorted(JOINS))
def test_join_agg_program_matches_jax(join):
    """Two probe chunks folded in turn: the eight outputs of JAX's program
    (pair total, chunk, merged and kept counts, the fold's count, and the
    state's first ``n_out`` rows). Above ``pair_cap`` pairs, or with no
    pair kept, or above ``cap`` groups, the donated state keeps its storage
    and, on an overflow, its values."""
    _, _, _, pair_cap, thr = JOINS[join]
    gkey_specs = (("g", "i"),)
    needed = ("g", "x", "y")
    on_probe = {"g": False, "x": True, "y": False}
    pred = None if thr is None else (lambda c, lits: c["x"] > lits[0])
    port = S.fused_join_agg_program(("i",), pred, needed, on_probe, gkey_specs, JOIN_SLOTS, CAP, pair_cap, True)
    ref = jax.jit(RS.fused_join_agg_program(("i",), pred, needed, on_probe, gkey_specs, JOIN_SLOTS, CAP, pair_cap))
    bk, _, _, bcols = _join_inputs(join, 0)
    h = H.combine_hashes_np([H.numeric_hash32(bk)])
    assert h.tobytes() == RH.combine_hashes_np([RH.numeric_hash32(bk)]).tobytes()
    border = np.argsort(h, kind="stable").astype(np.int64)
    table = np.sort(h, kind="stable")
    state, state_n, row_base = _fresh_state(gkey_specs, JOIN_SLOTS, CAP), 0, 0
    lits_t = () if thr is None else (torch.tensor(thr, dtype=torch.float64),)
    lits_j = () if thr is None else (jnp.asarray(thr, dtype=jnp.float64),)
    for step in range(2):
        _, pk, pcols, _ = _join_inputs(join, step + 1)
        plane = H.numeric_hash32(pk)
        r = ref(tuple(jnp.asarray(k.numpy()) for k in state[0]), tuple(jnp.asarray(s.numpy()) for s in state[1]),
                jnp.asarray(state[2].numpy()), np.int64(state_n), jnp.asarray(table.astype(np.uint32)),
                jnp.asarray(border), np.int64(len(bk)), (jnp.asarray(bk),), (jnp.asarray(plane),),
                (jnp.asarray(pk),), {k: jnp.asarray(v) for k, v in pcols.items()},
                {k: jnp.asarray(v) for k, v in bcols.items()}, lits_j, np.int64(len(pk)), np.int64(row_base))
        r_counts = [int(v) for v in r[:5]]
        before = [x.clone() for x in (state[2], *state[0], *state[1])]
        ptrs = [x.data_ptr() for x in (state[2], *state[0], *state[1])]
        out = port(state[0], state[1], state[2], state_n, torch.from_numpy(table.astype(np.int64)),
                   torch.from_numpy(border), len(bk), (torch.from_numpy(bk),),
                   (torch.from_numpy(plane.view(np.int32)),), (torch.from_numpy(pk),), _t(pcols), _t(bcols),
                   lits_t, row_base)
        counts = A.read_counts(*out[:5])
        assert counts == r_counts, (step, counts, r_counts)
        total, n_chunk, n_m, n_kept, n_out = counts
        fs, keys, slots = out[5:]
        assert [x.data_ptr() for x in (fs, *keys, *slots)] == ptrs
        ok = total <= pair_cap and n_chunk <= CAP and n_m <= CAP
        if not ok:
            assert n_out == state_n
            for x, y in zip(before, (fs, *keys, *slots)):
                assert x.numpy().tobytes() == y.numpy().tobytes()
        _assert_tables((fs, keys, slots), r[5:], JOIN_SLOTS, n_out)
        state, state_n = (list(keys), list(slots), fs), n_out
        if ok:
            row_base += n_kept
    assert join != "pairs-overflow" or total > pair_cap
    assert join != "predicate-keeps-nothing" or (n_kept == 0 and n_out == 0)
    assert join != "groups-overflow" or n_chunk > CAP


# --------------------------------------------------------------------------
# the exchange staging (C13)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [4, 40, 400])
@pytest.mark.parametrize("with_valid", [False, True])
def test_stage_for_exchange_matches_jax(capacity, with_valid):
    """Per-destination counts, the staged grids and the slot mask equal
    JAX's, with rows past a destination's capacity and padding rows
    (``valid``) left out in both."""
    rng = np.random.default_rng(capacity)
    n, n_dev = 300, 4
    dest = rng.integers(0, n_dev, n).astype(np.int32)
    vals = [rng.integers(-(2**60), 2**60, n).astype(np.int64), rng.standard_normal(n)]
    valid = rng.random(n) < 0.7 if with_valid else None
    staged, mask, counts = BZ._stage_for_exchange(
        [torch.from_numpy(v) for v in vals], torch.from_numpy(dest), n_dev, capacity,
        valid=None if valid is None else torch.from_numpy(valid))
    r_staged, r_mask, r_counts = RB._stage_for_exchange(
        [jnp.asarray(v) for v in vals], jnp.asarray(dest), n_dev, capacity,
        valid=None if valid is None else jnp.asarray(valid))
    assert counts.numpy().tolist() == np.asarray(r_counts).tolist()
    assert mask.numpy().tolist() == np.asarray(r_mask).tolist()
    for s, rs in zip(staged, r_staged):
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()


# --------------------------------------------------------------------------
# the recorded windows
# --------------------------------------------------------------------------


def _windows():
    """{family: (program, args)} of one call of each fixed-shape program."""
    mesh = PM.make_mesh(devices=["cpu"] * N_SHARDS)
    key_specs = KEYS["float-int"]
    cols = _t(_cols("cap+1"))
    n = cols["ik"].shape[0]
    pred = _pred("far-above-cap")
    state = _fresh_state(key_specs, FUSED_SLOTS, CAP)
    fused_args = (state[0], state[1], state[2], 0, cols, (), n, 0)
    a, b = _partial(np.random.default_rng(1), 9, 0, 16), _partial(np.random.default_rng(2), 12, 1000, 16)
    t = torch.from_numpy
    merge_args = (tuple(t(k) for k in a[0]), tuple(t(k) for k in b[0]), tuple(t(s) for s in a[1]),
                  tuple(t(s) for s in b[1]), t(a[2]), t(b[2]), 9, 12)
    bk, pk, pcols, bcols = _join_inputs("fits", 0)
    h = H.combine_hashes_np([H.numeric_hash32(bk)])
    jstate = _fresh_state((("g", "i"),), JOIN_SLOTS, CAP)
    join_args = (jstate[0], jstate[1], jstate[2], 0, t(np.sort(h).astype(np.int64)),
                 t(np.argsort(h, kind="stable").astype(np.int64)), len(bk), (t(bk),),
                 (t(H.numeric_hash32(pk).view(np.int32)),), (t(pk),), _t(pcols), _t(bcols),
                 (torch.tensor(0.0, dtype=torch.float64),), 0)
    rng = np.random.default_rng(3)
    return {
        "grouped-agg-chunk": (A.grouped_chunk_program(pred, key_specs, SLOTS, CAP), (cols, (), n, 0)),
        "sharded-grouped": (C.sharded_grouped_chunk_program(mesh, "buckets", pred, key_specs, SLOTS, CAP),
                            (cols, (), n, 0)),
        "grouped-merge": (A.grouped_merge_program((("ik", "i"), ("fk", "f")), MERGE_SLOTS, 16, 32), merge_args),
        "fused-stage-agg": (A.fused_grouped_update_program(pred, key_specs, FUSED_SLOTS, CAP, True), fused_args),
        "fused-stage-agg-sharded": (C.sharded_fused_grouped_program(mesh, "buckets", pred, key_specs,
                                                                    FUSED_SLOTS, CAP), fused_args),
        "fused-stage-join-agg": (S.fused_join_agg_program(("i",), lambda c, lits: c["x"] > lits[0], ("g", "x", "y"),
                                                          {"g": False, "x": True, "y": False}, (("g", "i"),),
                                                          JOIN_SLOTS, CAP, 256, True), join_args),
        "exchange-staging": (BZ._stage_for_exchange, ([t(rng.integers(0, 9, 500))], t(rng.integers(0, 4, 500)),
                                                      4, 100)),
    }


@pytest.mark.parametrize("family", ["grouped-agg-chunk", "sharded-grouped", "grouped-merge", "fused-stage-agg",
                                    "fused-stage-agg-sharded", "fused-stage-join-agg", "exchange-staging"])
def test_window_has_no_host_wait_and_no_value_shaped_output(family):
    """The recorded dispatch of the program: no ``aten::nonzero``, no
    ``aten::_local_scalar_dense``, no other host wait or value-dependent
    output size, and the family's contract (where it has one) holds."""
    program, args = _windows()[family]
    rec = PL.record_of(program, *args)
    names = {op.name for op in rec.ops}
    assert rec.ops and not names & {"aten::nonzero", "aten::_local_scalar_dense", "aten::bincount"}
    assert [op.label for op in rec.ops if PL.host_wait(op) or PL.dynamic_shape(op)] == []
    if PL.contract_for(family) is not None:
        assert PL.verify_program(family, rec) == []
