"""The port's device hashing (hyperspace_tpu_torch.ops) against the JAX
package's host hashing (hyperspace_tpu.ops.hashing, numpy).

Torch has no full uint32 op set, so the port holds the 32-bit lanes in
int64 and masks; these tests hold it bit-exact on adversarial inputs. Every
comparison is exact equality of integers: no tolerance applies anywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hyperspace_tpu.ops import encode as ref_encode  # noqa: E402
from hyperspace_tpu.ops import hashing as ref_hashing  # noqa: E402
from hyperspace_tpu_torch.ops import encode, hashing  # noqa: E402
from hyperspace_tpu_torch.ops.sort import _device_hash32  # noqa: E402

pytestmark = pytest.mark.torch_port

I64 = np.iinfo(np.int64)


def _adversarial(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"i": 1, "f": 2, "M": 3, "b": 4}[kind])
    if kind == "i":
        fixed = [0, 1, -1, 0xFFFFFFFF, 0x100000000, -0xFFFFFFFF, I64.min, I64.max, I64.min + 1,
                 2**53 - 1, 2**53, 2**53 + 1, -(2**53) - 1, 2**31 - 1, -(2**31)]
        return np.concatenate([np.array(fixed, dtype=np.int64), rng.integers(I64.min, I64.max, 500)])
    if kind == "f":
        fixed = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0, 3.0, 0.5, -2.5,
                 float(2**53 - 1), float(2**53), float(2**53 + 2), float(2**63), -float(2**63),
                 float(2**64), 1e308, -1e308, 5e-324, -5e-324, float(0xFFFFFFFF), 4294967296.0]
        return np.concatenate([np.array(fixed), rng.standard_normal(300) * 1e6,
                               rng.integers(-(10**9), 10**9, 200).astype(np.float64)])
    if kind == "M":
        days = rng.integers(-(10**5), 10**5, 300).astype("datetime64[D]")
        ns = np.array([I64.min + 1, -1, 0, 1, I64.max], dtype="int64").view("datetime64[ns]")
        return np.concatenate([days.astype("datetime64[ns]"), ns, np.array(["NaT"], dtype="datetime64[ns]")])
    return np.array([True, False, True, True, False])


@pytest.mark.parametrize("kind", ["i", "f", "M", "b"])
def test_device_hash32_matches_numeric_hash32(kind):
    values = _adversarial(kind)
    assert values.dtype.kind == kind
    want = ref_hashing.numeric_hash32(values).astype(np.int64)
    got = _device_hash32(kind, torch.from_numpy(encode.sort_key_int64(values))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["i", "f", "M", "b"])
def test_device_hash32_from_build_encoding(kind):
    """Through the build's own encoding: int/date/bool keys that fit int32
    ride as int32 and are widened back on the device before hashing."""
    values = _adversarial(kind)
    small = values[:5] if kind == "i" else values  # fits int32 -> downcast path
    for v in (values, small):
        keys, kinds, host_hashes = encode.encode_sort_columns([v])
        assert not host_hashes
        got = _device_hash32(kinds[0], torch.from_numpy(keys[0])).numpy()
        np.testing.assert_array_equal(got, ref_hashing.numeric_hash32(v).astype(np.int64))


@pytest.mark.parametrize("kind", ["i", "f", "M", "b"])
def test_port_encoding_is_the_reference_encoding(kind):
    values = _adversarial(kind)
    np.testing.assert_array_equal(encode.sort_key_int64(values), ref_encode.sort_key_int64(values))
    np.testing.assert_array_equal(encode.hash_input_uint32(values), ref_encode.hash_input_uint32(values))


def test_string_hash_inputs_match():
    values = np.array(["a", None, "", "ü", "a", "x" * 100, None], dtype=object)
    np.testing.assert_array_equal(encode.hash_input_uint32(values), ref_encode.hash_input_uint32(values))


def _hash_columns(n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000, 0xFFFF, 0x10000], dtype=np.uint32)
    cols = []
    for i in range(k):
        c = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        c[: len(edge)] = np.roll(edge, i)
        cols.append(c)
    return cols


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_combine_hashes_bit_exact(k):
    cols = _hash_columns(4000, k, seed=k)
    want = ref_hashing.combine_hashes_np(cols).astype(np.int64)
    # the build ships uint32 planes as int32 views; both forms must agree
    for as_torch in (lambda c: torch.from_numpy(c.view(np.int32)), lambda c: torch.from_numpy(c.astype(np.int64))):
        got = hashing.combine_hashes_torch([as_torch(c) for c in cols]).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_buckets", [1, 7, 8, 200, 4096, 2**31 - 1])
def test_bucket_ids_bit_exact(num_buckets):
    cols = _hash_columns(3000, 2, seed=num_buckets % 97)
    want = ref_hashing.bucket_ids_np(cols, num_buckets)
    got = hashing.bucket_ids_torch([torch.from_numpy(c.view(np.int32)) for c in cols], num_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_numpy_half_is_the_reference():
    """The port keeps its own copy of the numpy hashing; it must stay the
    JAX package's function."""
    cols = _hash_columns(1000, 3, seed=9)
    np.testing.assert_array_equal(hashing.combine_hashes_np(cols), ref_hashing.combine_hashes_np(cols))
    assert hashing.bucket_of_literals([7, "x"], 200) == ref_hashing.bucket_of_literals([7, "x"], 200)
