"""The port's kernel wrappers and device sort against the JAX package.

On the CPU each wrapper runs its plain torch version (the CUDA kernels run
only on the card: ``chip_smoke.py`` holds them against these same plain
versions there). The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_kernels.py`` runs them. Every comparison is exact —
integer counts, permutations, and float64 results compared bit for bit,
NaN included — so no tolerance applies anywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hyperspace_tpu.ops import encode as ref_encode  # noqa: E402
from hyperspace_tpu.ops import kernels as ref_kernels  # noqa: E402
from hyperspace_tpu.ops import sort as ref_sort  # noqa: E402
from hyperspace_tpu_torch.ops import cuda_build, kernels  # noqa: E402
from hyperspace_tpu_torch.ops.sort import bucket_sort_build, lex_argsort  # noqa: E402

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


# --- bucket histogram ------------------------------------------------------


@pytest.mark.parametrize("n,nb", [(10_000, 64), (5, 8), (2048, 128), (3000, 200), (4097, 1)])
def test_bucket_histogram_matches_reference(n, nb):
    rng = np.random.default_rng(n)
    # -1 is the reference's padding id and nb the build's sentinel: both
    # must land in no bucket
    ids = rng.integers(-1, nb + 1, n).astype(np.int32)
    got = kernels.bucket_histogram(torch.from_numpy(ids), nb)
    assert got.dtype == torch.int32 and got.shape == (nb,)
    np.testing.assert_array_equal(got.numpy(), ref_kernels.bucket_histogram(ids, nb))


def _hard_ids(case: str, nb: int, n: int, rng) -> np.ndarray:
    """Id layouts the CUDA kernel finds hard: one long run (every thread on
    one counter), ids that all count nowhere, sorted runs."""
    if case == "all_equal":
        return np.full(n, nb // 2, np.int32)
    if case == "all_minus_one":
        return np.full(n, -1, np.int32)
    if case == "all_sentinel":
        return np.full(n, nb, np.int32)
    if case == "sorted":
        return np.sort(rng.integers(-1, nb + 1, n)).astype(np.int32)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["all_equal", "all_minus_one", "all_sentinel", "sorted"])
@pytest.mark.parametrize("n,nb", [(5003, 200), (4097, 1)])
def test_bucket_histogram_hard_inputs(case, n, nb):
    ids = _hard_ids(case, nb, n, np.random.default_rng(n))
    got = kernels.bucket_histogram(torch.from_numpy(ids), nb)
    np.testing.assert_array_equal(got.numpy(), ref_kernels.bucket_histogram(ids, nb))


def test_bucket_histogram_of_an_offset_view():
    """``ids[1:]``: a view whose storage starts one id in and whose length is
    not a multiple of 4 (the CUDA kernel's 16-byte loads start past it)."""
    ids = np.random.default_rng(9).integers(-1, 65, 4002).astype(np.int32)
    view = torch.from_numpy(ids)[1:]
    assert view.storage_offset() == 1 and view.numel() % 4 != 0
    np.testing.assert_array_equal(kernels.bucket_histogram(view, 64).numpy(),
                                  ref_kernels.bucket_histogram(ids[1:], 64))


def test_bucket_histogram_empty():
    got = kernels.bucket_histogram(torch.empty(0, dtype=torch.int32), 8)
    np.testing.assert_array_equal(got.numpy(), ref_kernels.bucket_histogram(np.array([], np.int64), 8))


def test_bucket_histogram_rejects_other_dtypes():
    with pytest.raises(ValueError):
        kernels.bucket_histogram(torch.zeros(4, dtype=torch.int64), 8)


# --- segmented min/max -----------------------------------------------------


def _assert_minmax_equal(segments):
    got = kernels.segmented_min_max(segments, CPU)
    want = ref_kernels.segmented_min_max(segments)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_segmented_min_max_random_segments():
    rng = np.random.default_rng(0)
    _assert_minmax_equal([rng.standard_normal(int(rng.integers(1, 700))) for _ in range(13)])


def test_segmented_min_max_nulls_and_empty():
    _assert_minmax_equal([np.array([1.0, np.nan, -3.0]), np.array([]), np.array([np.nan]), np.array([np.nan] * 9)])


def test_segmented_min_max_signed_zero_and_inf():
    segs = [np.array([0.0, -0.0]), np.array([-0.0, 0.0, np.nan]), np.array([-0.0]),
            np.array([np.inf, -np.inf, 1.0]), np.array([np.inf]), np.array([-np.inf, np.nan])]
    _assert_minmax_equal(segs)
    mins, maxs = kernels.segmented_min_max(segs, CPU)
    assert np.signbit(mins[0]) and not np.signbit(maxs[0])  # -0.0 orders below +0.0


def test_segmented_min_max_int_above_2_53():
    """Segments are taken as float64 exactly as the reference takes them, so
    int64 values past 2**53 round the same way (the sketch then widens)."""
    big = np.array([2**53 + 1, 2**62 + 3, -(2**61) - 7, 2**63 - 1, -(2**63)], dtype=np.int64)
    _assert_minmax_equal([big, np.arange(100, dtype=np.int64), np.array([7], dtype=np.int64),
                          np.array([], dtype=np.int64), np.array([2**53 + 1, 2**53], dtype=np.int64)])


def test_segmented_min_max_splits_large_segments(monkeypatch):
    """Oversized segments split into pieces that fold exactly; a smaller
    call cap on both sides forces pieces and several device calls."""
    monkeypatch.setattr(kernels, "_MINMAX_CALL_ELEMS", 64)
    monkeypatch.setattr(kernels, "_MAX_PIECE", 8)
    monkeypatch.setattr(ref_kernels, "_MINMAX_CALL_ELEMS", 64)
    rng = np.random.default_rng(3)
    segs = [rng.standard_normal(int(n)) for n in (100, 3, 0, 57, 8, 9)]
    segs[3][::5] = np.nan
    segs[3][7] = -0.0
    _assert_minmax_equal(segs)


def test_segmented_min_max_unequal_lengths_and_empty_ends(monkeypatch):
    """Empty segments first, in the middle and last, lengths from 0 to above
    the piece cap, under small caps on both sides (pieces, several calls)."""
    monkeypatch.setattr(kernels, "_MINMAX_CALL_ELEMS", 64)
    monkeypatch.setattr(kernels, "_MAX_PIECE", 8)
    monkeypatch.setattr(ref_kernels, "_MINMAX_CALL_ELEMS", 64)
    rng = np.random.default_rng(11)
    segs = [rng.standard_normal(n) * 1e3 for n in (0, 0, 1, 7, 8, 9, 0, 17, 64, 65, 2, 0, 3, 0)]
    segs[8][::3] = np.nan
    segs[9][:] = -0.0
    segs[9][40] = 0.0
    _assert_minmax_equal(segs)


def test_segmented_min_max_thousands_of_one_value_segments():
    rng = np.random.default_rng(12)
    values = rng.standard_normal(2000)
    values[::7] = np.nan
    values[3::11] = -0.0
    _assert_minmax_equal([values[i : i + 1] for i in range(2000)])


def test_segment_min_max_keys_plain_order_keys():
    values = torch.tensor([1.5, -0.0, 0.0, np.nan, -np.inf, 3.0, np.inf], dtype=torch.float64)
    offsets = torch.tensor([0, 2, 4, 4, 7], dtype=torch.int64)
    mins, maxs, empty = kernels.segment_min_max_keys(values, offsets)
    assert empty.tolist() == [False, False, True, False]
    lo = kernels.keys_to_f64(mins.numpy())
    hi = kernels.keys_to_f64(maxs.numpy())
    assert _bits(lo[:2]).tolist() == _bits([-0.0, 0.0]).tolist()  # [1.5, -0.0], [0.0, nan]
    assert hi[0] == 1.5 and _bits(hi[1]) == _bits(0.0)
    assert lo[3] == -np.inf and hi[3] == np.inf


# --- device sort -------------------------------------------------------------


def _key_columns(kind: str, n: int, rng):
    if kind == "int32":
        return [rng.integers(-50, 50, n)]
    if kind == "int64":
        return [rng.integers(-(2**40), 2**40, n) * 1024]
    if kind == "float":
        f = np.round(rng.standard_normal(n) * 4, 1)
        f[::17] = np.nan
        f[::13] = -0.0
        f[::11] = 0.0
        f[::19] = -np.inf
        return [f]
    if kind == "date":
        return [np.datetime64("1995-01-01") + rng.integers(0, 400, n).astype("timedelta64[D]")]
    if kind == "string":
        s = np.array([f"k{x}" for x in rng.integers(0, 40, n)], dtype=object)
        s[::23] = None
        return [s]
    if kind == "composite":
        s = np.array([f"k{x}" for x in rng.integers(0, 5, n)], dtype=object)
        return [s, rng.integers(0, 6, n), np.round(rng.standard_normal(n), 1)]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["int32", "int64", "float", "date", "string", "composite"])
@pytest.mark.parametrize("n,num_buckets", [(1000, 8), (3000, 200)])
def test_bucket_sort_build_matches_reference(kind, n, num_buckets):
    rng = np.random.default_rng(n + len(kind))
    cols = _key_columns(kind, n, rng)
    keys, kinds, host_hashes = ref_encode.encode_sort_columns(cols)
    n_p = ref_sort.padded_size(n)
    ref_perm, ref_counts = ref_sort.bucket_sort_build(
        [np.pad(k, (0, n_p - n)) for k in keys], [np.pad(h, (0, n_p - n)) for h in host_hashes],
        kinds, num_buckets, n,
    )
    ref_perm = np.asarray(ref_perm)[:n]
    ref_counts = np.asarray(ref_counts)

    # unpadded, as the port's build calls it
    perm, counts = bucket_sort_build(
        [torch.from_numpy(k) for k in keys], [torch.from_numpy(h.view(np.int32)) for h in host_hashes],
        kinds, num_buckets, n,
    )
    assert perm.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), ref_perm)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)

    # padded, as the reference calls it: padding takes the sentinel bucket
    # and sorts after every valid row
    perm_p, counts_p = bucket_sort_build(
        [torch.from_numpy(np.pad(k, (0, n_p - n))) for k in keys],
        [torch.from_numpy(np.pad(h, (0, n_p - n)).view(np.int32)) for h in host_hashes],
        kinds, num_buckets, n,
    )
    np.testing.assert_array_equal(perm_p.numpy()[:n], ref_perm)
    np.testing.assert_array_equal(counts_p.numpy(), ref_counts)


def test_float_keys_keep_the_reference_signed_order():
    """Within a bucket the reference sorts float keys SIGNED, which puts
    positive floats before negative ones; the port keeps that order."""
    f = np.array([-1.0, 2.0, -3.0, 4.0])
    keys, kinds, _ = ref_encode.encode_sort_columns([f])
    perm, _ = bucket_sort_build([torch.from_numpy(keys[0])], [], kinds, 1, len(f))
    assert f[perm.numpy()].tolist() == [2.0, 4.0, -3.0, -1.0]
    ref_perm, _ = ref_sort.bucket_sort_build(keys, [], kinds, 1, len(f))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_perm))


def test_lex_argsort_is_a_stable_lexicographic_order():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 4, 500), rng.integers(-3, 3, 500)
    got = lex_argsort([torch.from_numpy(a), torch.from_numpy(b)]).numpy()
    np.testing.assert_array_equal(got, np.lexsort([np.arange(500), b, a]))


# --- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """The CUDA kernels against their plain versions on the same card
    tensors, at the layouts each finds hard (chip_smoke.py runs the same
    checks at the build's shapes and larger)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for nb in (200, 1, 65_536):  # 65 536 counters take the global-memory path
        for case in ("all_equal", "all_minus_one", "all_sentinel", "sorted"):
            ids = torch.from_numpy(_hard_ids(case, nb, 100_003, rng)).to(dev)
            for view in (ids, ids[1:]):
                assert torch.equal(kernels.bucket_histogram(view, nb), kernels.bucket_histogram_plain(view, nb))
        ids = torch.from_numpy(rng.integers(-1, nb + 1, 100_003).astype(np.int32)).to(dev)
        assert torch.equal(kernels.bucket_histogram(ids, nb), kernels.bucket_histogram_plain(ids, nb))

    lengths = [0, 5_000_000, *rng.integers(1, 4, 20), 0, 1 << 20, 0, 1024, 0]
    lengths[-2] += 1 - sum(lengths) % 2  # an odd total length
    values = rng.standard_normal(int(sum(lengths)) + 1)
    values[rng.random(values.size) < 0.01] = np.nan
    values[5::97] = -0.0
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    short = np.arange(0, 8192 * 1024 + 1, 1024, dtype=np.int64)
    # the segment count grows and then shrinks, so a call also finds more
    # initialised outputs than it needs
    cases = ((values[:-1], offsets), (values[1:], offsets), (rng.standard_normal(8192 * 1024), short),
             (values[:10], np.array([0, 3, 3, 10], np.int64)))
    for v, o in cases:
        v_dev = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        o_dev = torch.from_numpy(o).to(dev)
        for unaligned in (v_dev, torch.cat([v_dev[:1], v_dev])[1:]):  # storage offset of 1 value
            for g, w in zip(kernels.segment_min_max_keys(unaligned, o_dev),
                            kernels.segment_min_max_keys_plain(unaligned, o_dev)):
                assert torch.equal(g, w)


def test_cuda_build_failure_raises_and_never_falls_back(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; a non-CPU tensor never takes the
    plain version."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_all()
    ids = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.bucket_histogram(ids, 8)
    values = torch.zeros(4, dtype=torch.float64, device="meta")
    offsets = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.segment_min_max_keys(values, offsets)
    assert not kernels.launches
