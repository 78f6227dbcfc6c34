"""The port's distributed re-bucketing (ops/bucketize.py) and build
permutation against the JAX package's.

tests/test_hierarchical_rebucket.py runs with the package renamed to the
port (tests/torch_mirror.py), its ``jax`` the port's mesh
(``torch_mirror.port_jax_shim``: ``device_put`` places a host array on the
port's 8-shard CPU mesh; a ``ShardedTensor`` reads back as numpy, so
``jnp`` is numpy). The cases after it hold the port's exchange against the
JAX package's on the same inputs: the flat ``rebucket`` delivers each
owner shard the same rows in the same slots, ``rebucket_and_sort`` each
shard its rows sorted as a numpy oracle sorts them, the build's exchange program
the same (bucket, row) order per shard as the JAX package's and as the
single-device build's permutation, ``bucket_sort_perm`` the JAX package's
permutation; the planes carry every dtype bit for bit; and overflow is
counted, never dropped silently. Everything here is integer or bit-exact:
no tolerance applies.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_mirror as M  # noqa: E402
from hyperspace_tpu_torch.ops import bucketize as BZ  # noqa: E402
from hyperspace_tpu_torch.parallel import mesh as PM  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
REWRITES = {
    'jax = pytest.importorskip("jax")\nimport jax.numpy as jnp  # noqa: E402\n': (
        "import torch_mirror as _mirror  # noqa: E402\n\njax = _mirror.port_jax_shim()\njnp = np\n"),
    # the port's mesh constructors build on the card unless asked for the CPU
    "    return make_mesh_2d(n_slices=2, per_slice=4)\n": '    return make_mesh_2d(n_slices=2, per_slice=4, device_type="cpu")\n',
    "        flat_mesh = make_mesh()\n": '        flat_mesh = make_mesh(device_type="cpu")\n',
}
LEFT_OUT = {}


@pytest.fixture(scope="module", autouse=True)
def _mesh_of_eight():
    """8 CPU shards, as the JAX package's 8 virtual devices (tests/conftest.py);
    module-scoped, since the suite's ``mesh2d`` fixture is."""
    before = PM.SHARD_COUNT
    PM.SHARD_COUNT = 8
    yield
    PM.SHARD_COUNT = before


_suite = M.load_cases(os.path.join(HERE, "test_hierarchical_rebucket.py"), "_torch_test_hierarchical_suite",
                      rewrites=REWRITES)
M.export_cases(_suite, globals(), LEFT_OUT)


def test_every_case_is_run_or_listed():
    M.assert_every_case([_suite], globals(), LEFT_OUT)


# --------------------------------------------------------------------------
# the exchange against the JAX package's
# --------------------------------------------------------------------------


def _ref():
    from hyperspace_tpu.ops import bucketize as ref_bz
    from hyperspace_tpu.parallel import mesh as ref_mesh
    from hyperspace_tpu.utils.x64 import ensure_x64

    ensure_x64()  # int64 inputs stay int64 when placed
    return ref_bz, ref_mesh


def _inputs(n, num_buckets, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-10_000, 10_000, n).astype(np.int64)
    vals = rng.standard_normal(n)
    return keys, vals, (np.abs(keys) % num_buckets).astype(np.int32)


def _per_shard(x, n_dev):
    return np.asarray(x).reshape(n_dev, -1)


def test_rebucket_equals_the_jax_package():
    """The flat exchange: every shard's slots (values, buckets, mask) and
    overflow counts equal the JAX package's on the same inputs. (The JAX
    package's eager ``shard_map`` takes most of this file's time, so the
    hierarchical exchange is held to the flat one by the suite above.)"""
    ref_bz, ref_mesh = _ref()
    n_dev, n, nb, cap = 8, 8 * 48, 32, 96
    keys, vals, buckets = _inputs(n, nb, 3)
    mesh, rmesh = PM.make_mesh(device_type="cpu"), ref_mesh.make_mesh()
    place, rplace = PM.sharded(mesh), ref_mesh.sharded(rmesh)
    got = BZ.rebucket(mesh, {"k": place.put(keys), "v": place.put(vals)}, place.put(buckets), cap)
    want = ref_bz.rebucket(rmesh, {"k": jax.device_put(keys, rplace), "v": jax.device_put(vals, rplace)},
                           jax.device_put(buckets, rplace), cap)
    for name in ("k", "v"):
        assert np.asarray(got[0][name]).tobytes() == np.asarray(want[0][name]).tobytes(), name
    for i in (1, 2, 3):
        assert np.array_equal(np.asarray(got[i]), np.asarray(want[i])), i
    assert int(np.sum(got[3])) == 0 and int(np.sum(got[2])) == n
    owners = _per_shard(got[1], n_dev) % n_dev
    valid = _per_shard(got[2], n_dev)
    for g in range(n_dev):
        assert np.all(owners[g][valid[g]] == g)


def test_rebucket_and_sort_sorts_each_owner_shard():
    """Hash, exchange and sort: each shard holds, as its valid prefix,
    exactly the rows it owns, sorted by (bucket, key, global row)."""
    from hyperspace_tpu_torch.ops.hashing import bucket_ids_torch, numeric_hash32

    n_dev, n, nb, cap = 8, 8 * 40, 16, 80
    keys, vals, _ = _inputs(n, nb, 9)
    h = numeric_hash32(keys).astype(np.uint32)
    mesh = PM.make_mesh(device_type="cpu")
    place = PM.sharded(mesh)
    out, ob, ov, of = BZ.rebucket_and_sort(mesh, {"v": place.put(vals), "i": place.put(np.arange(n))},
                                           [place.put(h.view(np.int32))], [place.put(keys)], nb, cap)
    assert int(np.sum(of)) == 0
    bkt = bucket_ids_torch([torch.from_numpy(h.astype(np.int64))], nb).numpy()
    b, v, vals_out, rows = (_per_shard(x, n_dev) for x in (ob, ov, out["v"], out["i"]))
    for g in range(n_dev):
        mine = np.nonzero(bkt % n_dev == g)[0]
        want = mine[np.lexsort((mine, keys[mine], bkt[mine]))]
        nv = int(v[g].sum())
        assert v[g][:nv].all() and not v[g][nv:].any() and nv == want.size
        assert np.array_equal(rows[g][:nv], want) and np.array_equal(b[g][:nv], bkt[want])
        assert vals_out[g][:nv].tobytes() == vals[want].tobytes()


def test_build_exchange_equals_the_jax_package_and_the_single_device_build():
    """The build's exchange program over a key with every kind of hash
    input (an int64 key and a string hash plane): per shard the JAX
    package's (bucket, row) order, and its buckets' rows in the order of
    the single-device build's permutation."""
    ref_bz, ref_mesh = _ref()
    from hyperspace_tpu_torch.ops import encode
    from hyperspace_tpu_torch.ops.sort import bucket_sort_build

    n_dev, nb, n = 8, 16, 2000
    rng = np.random.default_rng(21)
    cols = [rng.integers(0, 300, n).astype(np.int64), np.array([f"s{v}" for v in rng.integers(0, 40, n)])]
    keys, kinds, hashes = encode.encode_sort_columns(cols)
    per = 256
    pad = per * n_dev

    def padded(a):
        out = np.zeros(pad, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    mesh, rmesh = PM.make_mesh(device_type="cpu"), ref_mesh.make_mesh()
    place, rplace = PM.sharded(mesh), ref_mesh.sharded(rmesh)
    ridx = np.arange(pad, dtype=np.int32)
    cap = 128
    got = BZ.distributed_bucket_sort_build(
        mesh, [place.put(padded(k)) for k in keys], [place.put(padded(h).view(np.int32)) for h in hashes],
        kinds, place.put(ridx), n, nb, cap)
    want = ref_bz.distributed_bucket_sort_build(
        rmesh, [jax.device_put(padded(k), rplace) for k in keys], [jax.device_put(padded(h), rplace) for h in hashes],
        kinds, jax.device_put(ridx, rplace), n, nb, cap)
    wb, wr, wv, wo = (_per_shard(x, n_dev) for x in want)
    assert int(wo.sum()) == 0 and sum(int(got[g][3].sum()) for g in got) == 0
    perm, counts = bucket_sort_build([torch.from_numpy(k) for k in keys],
                                     [torch.from_numpy(h.view(np.int32)) for h in hashes], kinds, nb, n)
    bounds = np.concatenate([[0], np.cumsum(counts.numpy())])
    for g in range(n_dev):
        b, r, v = (x.numpy() for x in got[g][:3])
        assert np.array_equal(b, wb[g]) and np.array_equal(v, wv[g]) and np.array_equal(r[v], wr[g][wv[g]]), g
        for bucket in range(g, nb, n_dev):
            mine = r[v & (b == bucket)]
            assert np.array_equal(mine, perm.numpy()[bounds[bucket]:bounds[bucket + 1]]), (g, bucket)


def test_bucket_sort_perm_equals_the_jax_package():
    from hyperspace_tpu.ops.hashing import numeric_hash32
    from hyperspace_tpu.ops.sort import bucket_sort_perm as ref_perm
    from hyperspace_tpu_torch.ops.sort import bucket_sort_perm

    rng = np.random.default_rng(4)
    a, b = rng.integers(0, 50, 3000).astype(np.int64), rng.integers(-5, 5, 3000).astype(np.int64)
    hashes = np.stack([numeric_hash32(a), numeric_hash32(b)]).astype(np.uint32)
    perm, sb = bucket_sort_perm([torch.from_numpy(h.astype(np.int64)) for h in hashes],
                                [torch.from_numpy(a), torch.from_numpy(b)], 13)
    rp, rsb = ref_perm(hashes, np.stack([a, b]), num_buckets=13)
    assert np.array_equal(perm.numpy(), np.asarray(rp)) and np.array_equal(sb.numpy(), np.asarray(rsb))


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int16", "float16", "bfloat16", "int32", "float32",
                                   "int64", "float64"])
def test_planes_carry_every_dtype_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 256, 64 * 8, dtype=np.uint8))
    dt = getattr(torch, dtype)
    v = (raw % 2).bool() if dt == torch.bool else raw.view(dt)
    planes = BZ._to_planes(v)
    assert all(p.dtype == torch.int32 for p in planes) and len(planes) == BZ._plane_count(dt)
    back = BZ._from_planes(planes, dt)
    assert back.dtype == dt and torch.equal(back.view(torch.uint8) if dt != torch.bool else back,
                                            v.view(torch.uint8) if dt != torch.bool else v)


def test_overflow_is_counted_and_returned():
    """All rows to one owner through too few slots: every row without a
    slot is counted, and every row with one arrives."""
    mesh = PM.make_mesh(device_type="cpu")
    place = PM.sharded(mesh)
    n, cap = 8 * 32, 5
    before = BZ.overflow_rows["rebucket"]
    out, _, valid, overflow = BZ.rebucket(mesh, {"k": place.put(np.arange(n, dtype=np.int64))},
                                          place.put(np.full(n, 3, dtype=np.int32)), cap)
    assert int(np.sum(overflow)) == n - 8 * cap == BZ.overflow_rows["rebucket"] - before
    assert int(np.sum(valid)) == 8 * cap
    assert set(np.asarray(out["k"])[np.asarray(valid)].tolist()) < set(range(n))
