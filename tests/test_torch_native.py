"""The port's native Parquet decode against the JAX package's.

tests/test_native_decode.py and tests/test_native_rg.py run with the package
renamed to the port (tests/torch_mirror.py ``load_cases``): the port's own
build of libhs_native (``hyperspace_tpu_torch/native``, from
``hyperspace_tpu_torch/csrc/``) decodes, and ``read_parquet_batch`` is the
port's. Their sessions are CPU sessions (``device="cpu"``; the index
writer of ``test_index_files_are_native_decodable`` is given one). Rewritten
for the port:

- ``TestZeroCopy::test_decode_buffer_ships_pointer_identical``: the port
  pads no buffer to a shape bucket (torch has no shape-keyed compile cache),
  so the decode buffer holds exactly the file's rows, and the staging path's
  host tensor (``exec/device._staging_host``) must read that very memory;
- ``TestDictionaryShipping::test_dict_expand_on_device_matches_and_passes_contract``
  reads the port's program contracts (``check/program_lint.py``, the
  counterpart of ``check/hlo_lint.py``), its session a CPU one.

Left out, by name:

- ``TestZeroCopy::test_adoption_rejects_garbage_tail``: the port has no
  padded tail to adopt or reject; ``test_staged_host_tensor_is_the_decode_buffer``
  here is its pointer-identity counterpart on the CPU.

The cases of this file hold the port's ``read_parquet_batch`` against the
JAX package's on a seeded codec matrix (NONE, SNAPPY, GZIP, ZSTD x int,
float, date, string x nulls x pruned row groups), byte for byte, with the
same dictionary codes and entries and the same ``decode:`` trace;
``merge_spans`` and ``expand_pairs`` against the JAX package's; the
``dict-expand`` program against its numpy version; and each package's file
handles against its own library. Tolerance: exact everywhere.

The JAX package's side of those cases loads a library that this module
builds for itself (``_reference_library``): the JAX package compiles its
own in place and caches a failed load for the life of the process, so an
xdist worker that opened it half-written would hold the port against the
pyarrow fallback instead.
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
from hyperspace_tpu import native as ref_native  # noqa: E402
from hyperspace_tpu.exec import io as RIO  # noqa: E402
from hyperspace_tpu.exec import trace as RT  # noqa: E402
from hyperspace_tpu_torch import native  # noqa: E402
from hyperspace_tpu_torch.exec import batch as B  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.exec import io as IO  # noqa: E402
from hyperspace_tpu_torch.exec import trace  # noqa: E402

pytestmark = [
    pytest.mark.torch_port,
    pytest.mark.native,
    pytest.mark.skipif(not native.is_available(), reason="native toolchain unavailable"),
]

HERE = os.path.dirname(__file__)
_SESSION = 'hst.Session(device="cpu", conf={'
SOURCES = {
    "test_native_decode.py": {
        # the port's writer runs on the session's device: a CPU one here
        "    from hyperspace_tpu_torch.indexes.covering import write_bucketed\n": (
            "    import hyperspace_tpu_torch as ht\n    from hyperspace_tpu_torch.indexes.covering import write_bucketed\n"),
        '    files = write_bucketed(t, ["k"], 8, out)\n': (
            '    files = write_bucketed(t, ["k"], 8, out, session=ht.Session(device="cpu"))\n'),
    },
    "test_native_rg.py": {
        "        hst.Session(conf={": "        " + _SESSION,
        "        sess = hst.Session(conf={\n": "        sess = " + _SESSION + "\n",
        # the pointer-identity contract without a padded tail
        "        hio.set_staging_pad(8)\n": "        import torch\n",
        '            assert arr.base is not None and arr.base.shape == (4096,), c\n': (
            '            assert arr.shape == (1000,) and arr.flags["C_CONTIGUOUS"], c  # no padded tail\n'),
        "            padded = D._pad_to_bucket(enc, 8, fill)\n"
        "            assert padded is arr.base, c  # staging adopts the decoder's buffer\n": (
            '            host = D._staging_host(enc, torch.device("cpu"))\n'
            "            assert host.data_ptr() == arr.ctypes.data, c  # staging reads the decode buffer\n"),
        # the dict-expand case reads the port's program contracts
        "        from hyperspace_tpu_torch.check import hlo_lint\n": (
            "        from hyperspace_tpu_torch.check import program_lint as hlo_lint\n"),
        "        sess = hst.Session(conf={hst.keys.CHECK_HLO_ENABLED: True})\n": (
            '        sess = hst.Session(device="cpu", conf={hst.keys.CHECK_HLO_ENABLED: True})\n'),
    },
}
LEFT_OUT = {
    "TestZeroCopy::test_adoption_rejects_garbage_tail": (
        "the port pads no decode buffer; test_staged_host_tensor_is_the_decode_buffer is its counterpart"),
}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture(scope="module", autouse=True)
def _reference_library(tmp_path_factory):
    """A whole JAX-package library for this module, whatever another
    process is doing to the JAX package's own in-place build.

    The JAX package compiles ``libhs_native.so`` into its own source tree
    with ``g++ -o``, and remembers the first load failure for the life of
    the process, so a process that opens the file while another is still
    writing it loses native decode for good. Here the library is built by
    the JAX package's own ``_build`` from its own sources into a private
    path (named by the sources' digest, in the directory every xdist
    worker of the run shares), under an exclusive ``flock`` and a rename,
    so that workers share one build. The module then points the JAX
    package's loader at it, with its cached library and failure cleared,
    and restores all three afterwards. A library that cannot be had fails
    the module with the compiler's or the loader's message."""
    import fcntl
    import hashlib

    digest = hashlib.sha256()
    for name in ("hs_native.cc", "thrift_compact.h"):
        with open(os.path.join(ref_native._SRC_DIR, name), "rb") as f:
            digest.update(f.read())
    path = str(tmp_path_factory.getbasetemp().parent / f"ref-libhs_native-{digest.hexdigest()[:16]}.so")
    saved = (ref_native._SO_PATH, ref_native._lib, ref_native._load_failed)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                part = f"{path}.{os.getpid()}.part"
                ref_native._SO_PATH = part
                try:
                    ref_native._build()
                except ref_native.NativeUnsupported as e:
                    pytest.fail(f"cannot build the JAX package's libhs_native: {e}")
                finally:
                    ref_native._SO_PATH = saved[0]
                os.replace(part, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with ref_native._lock:
        ref_native._SO_PATH, ref_native._lib, ref_native._load_failed = path, None, None
    try:
        try:
            ref_native._load()
        except ref_native.NativeUnsupported as e:
            pytest.fail(f"cannot load the JAX package's libhs_native: {e}")
        yield path
    finally:
        with ref_native._lock:
            ref_native._SO_PATH, ref_native._lib, ref_native._load_failed = saved


@pytest.fixture(autouse=True)
def _fresh_state():
    IO.clear_io_cache()
    RIO.clear_io_cache()
    IO.set_native_options(enabled=True, rowgroup=True, max_dict_entries=4096)
    RIO.set_native_options(enabled=True, rowgroup=True, max_dict_entries=4096)
    yield
    IO.clear_io_cache()
    RIO.clear_io_cache()
    ht.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


# --- the port against the JAX package ----------------------------------------

CODECS = ["NONE", "SNAPPY", "GZIP", "ZSTD"]


def _lake_table(seed: int, n: int = 1800, nulls: bool = False) -> pa.Table:
    rng = np.random.default_rng(seed)

    def holes(values, period):
        mask = (rng.integers(0, period, n) == 0) if nulls else np.zeros(n, dtype=bool)
        return pa.array([None if m else v for m, v in zip(mask.tolist(), values.tolist())])

    ints = rng.integers(-(10**9), 10**9, n).astype(np.int64)
    floats = rng.standard_normal(n)
    days = np.datetime64("1995-01-01") + rng.integers(0, 2500, n).astype("timedelta64[D]")
    strings = np.array([f"s{int(v) % 41:03d}" for v in rng.integers(0, 10**6, n)], dtype=object)
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),  # sorted: the pruning key
        "i32": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
        "i64": holes(ints, 9),
        "f64": holes(floats, 7),
        "d": pa.array(days.astype("datetime64[D]")) if not nulls else holes(days.astype("datetime64[D]"), 5),
        "s": holes(strings, 11),
        "u": pa.array([f"unique-{i}" for i in range(n)]),  # written without a dictionary
    })


def _same_batch(got, ref, what):
    assert list(got) == list(ref), what
    for c in ref:
        g, r = np.asarray(got[c]), np.asarray(ref[c])
        assert g.dtype == r.dtype, (what, c, g.dtype, r.dtype)
        if r.dtype == object:
            assert len(g) == len(r) and all((x is None and y is None) or x == y for x, y in zip(g, r)), (what, c)
        else:
            assert g.tobytes() == r.tobytes(), (what, c)
        assert isinstance(got[c], B.DictBackedArray) == (type(ref[c]).__name__ == "DictBackedArray"), (what, c)
        if isinstance(got[c], B.DictBackedArray):
            assert got[c].hs_dict_codes.tobytes() == ref[c].hs_dict_codes.tobytes(), (what, c)
            assert list(got[c].hs_dict_uniques) == list(ref[c].hs_dict_uniques), (what, c)


@pytest.mark.parametrize("pruned", [False, True], ids=["whole", "pruned"])
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
@pytest.mark.parametrize("codec", CODECS)
def test_read_parquet_batch_matches_jax(tmp_path, codec, nulls, pruned):
    """Two files of every column type under one codec: the port's batch,
    dictionary codes and ``decode:`` trace equal the JAX package's, and the
    batch equals pyarrow's read of the same files."""
    files = []
    for i in range(2):
        p = str(tmp_path / f"part-{i}.parquet")
        pq.write_table(_lake_table(100 * i + 7, nulls=nulls), p, compression=codec, row_group_size=300,
                       use_dictionary=["s"])
        files.append(p)
    cols = ["k", "i32", "i64", "f64", "d", "s", "u"]
    pred_port = ht.col("k") < 700 if pruned else None
    pred_ref = hst.col("k") < 700 if pruned else None
    with trace.recording() as events:
        got = IO.read_parquet_batch(files, cols, predicate=pred_port)
    with RT.recording() as ref_events:
        ref = RIO.read_parquet_batch(files, cols, predicate=pred_ref)
    _same_batch(got, ref, codec)
    assert trace.summarize(events) == RT.summarize(ref_events)
    assert events == [("decode", "native-rg")] * 2
    assert isinstance(got["s"], B.DictBackedArray) and not isinstance(got["u"], B.DictBackedArray)
    if pruned:  # row groups of 300: k < 700 keeps the first three of each file
        assert len(got["k"]) == 2 * 900 and np.asarray(got["k"]).max() == 899
        return
    want = pa.concat_tables([pq.read_table(f, columns=cols) for f in files])
    for c in cols:
        exp = want[c].to_numpy(zero_copy_only=False)
        if exp.dtype == object:
            assert all((x is None and y is None) or x == y for x, y in zip(got[c], exp)), c
        else:
            assert np.asarray(got[c]).tobytes() == exp.tobytes(), c


def test_per_file_native_read_matches_jax(tmp_path):
    """With the row-group path off, each file decodes through
    ``native.read_columns`` (trace ``decode: native``) in both packages."""
    p = str(tmp_path / "f.parquet")
    pq.write_table(_lake_table(3, nulls=True), p, compression="SNAPPY", row_group_size=500)
    IO.set_native_options(rowgroup=False)
    RIO.set_native_options(rowgroup=False)
    cols = ["k", "i64", "f64", "d", "s"]
    with trace.recording() as events:
        got = IO.read_parquet_batch([p], cols)
    ref = RIO.read_parquet_batch([p], cols)
    _same_batch(got, ref, "per-file")
    assert events == [("decode", "native")]


def test_merge_spans_and_expand_pairs_match_jax():
    rng = np.random.default_rng(19)
    lk = np.sort(rng.integers(0, 400, 3000)).astype(np.int64)
    rk = np.sort(rng.integers(0, 400, 2000)).astype(np.int64)
    lo, hi = native.merge_spans(lk, rk)
    rlo, rhi = ref_native.merge_spans(lk, rk)
    assert lo.tobytes() == rlo.tobytes() and hi.tobytes() == rhi.tobytes()
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    li, ri = native.expand_pairs(lo, hi, total)
    rli, rri = ref_native.expand_pairs(rlo, rhi, total)
    assert li.tobytes() == rli.tobytes() and ri.tobytes() == rri.tobytes()
    assert li.dtype == ri.dtype == np.int32 and li.shape == (total,)


@pytest.mark.parametrize("k", [1, 5, 64, 300])
def test_dict_expand_program_matches_plain(k):
    """``dict-expand`` (a torch program) equals its numpy version, nulls (-1)
    kept, on a remap table of power-of-two length."""
    rng = np.random.default_rng(k)
    uniques = np.array([f"w{int(v):05d}" for v in rng.permutation(10 * k)[:k]], dtype=object)
    codes = rng.integers(-1, k, 5000).astype(np.int32)
    arr = B.dict_backed(np.where(codes >= 0, uniques[np.maximum(codes, 0)], None).astype(object), codes, uniques)
    plan_codes, remap, codec = D._dict_plan(arr)
    assert remap.shape[0] >= k and remap.shape[0] & (remap.shape[0] - 1) == 0
    got = D.dict_expand_program(torch.from_numpy(plan_codes), torch.from_numpy(remap)).numpy()
    assert got.dtype == np.int32 and got.tobytes() == D.dict_expand_plain(plan_codes, remap).tobytes()
    # the ranks index the codec's sorted entries: the same strings, -1 for null
    assert list(codec.uniques) == sorted(uniques)
    back = np.where(got >= 0, codec.uniques[np.maximum(got, 0)], None)
    assert back.tolist() == arr.tolist()


def test_dict_expand_equals_factorize_path():
    """Without nulls, the dictionary path's device column and codec equal the
    ``factorize_strings`` path's (``_put_encoded`` of the same strings as a
    plain object array)."""
    uniques = np.array(["pear", "apple", "fig", "kiwi"], dtype=object)
    codes = np.random.default_rng(4).integers(0, 4, 777).astype(np.int32)
    values = uniques[codes].astype(object)
    dev, codec, _ = D._put_encoded(B.dict_backed(values.copy(), codes, uniques), torch.device("cpu"))
    want, want_codec, _ = D._put_encoded(values.copy(), torch.device("cpu"))
    assert torch.equal(dev, want) and dev.dtype == want.dtype
    assert list(codec.uniques) == list(want_codec.uniques) and codec.kind == want_codec.kind == "string"


def test_staged_host_tensor_is_the_decode_buffer(tmp_path):
    """The staging path's host tensor reads the memory the decoder wrote
    (on the card that memory is pinned; chip_smoke.py checks that)."""
    p = str(tmp_path / "z.parquet")
    pq.write_table(pa.table({"a": np.arange(1234, dtype=np.int64), "t": np.arange(1234).astype("datetime64[s]")}),
                   p, compression="NONE", row_group_size=300)
    batch = IO.read_parquet_batch([p], ["a", "t"])
    for c in ("a", "t"):
        enc, _codec = D.encode_column(batch[c])
        host = D._staging_host(enc, torch.device("cpu"))
        assert host.data_ptr() == batch[c].ctypes.data and host.numel() == 1234, c


def test_each_package_calls_its_own_library(tmp_path):
    """Both libraries load side by side (``RTLD_LOCAL``): the port's file
    handles go to the port's build under ``hyperspace_tpu_torch/_build/``,
    the JAX package's to its own, and both decode the same file alike."""
    p = str(tmp_path / "both.parquet")
    pq.write_table(_lake_table(11), p, compression="ZSTD", row_group_size=400)
    with native.NativeParquetFile(p) as f, ref_native.NativeParquetFile(p) as rf:
        assert f._lib is native._load() and rf._lib is ref_native._load() and f._lib is not rf._lib
        port_path = os.path.realpath(f._lib._name)
        assert port_path.startswith(os.path.realpath(native.BUILD_DIR) + os.sep), port_path
        assert os.path.realpath(rf._lib._name) != port_path
        for c in ("k", "f64", "d"):
            a, _ = f.read_column(c)
            b, _ = rf.read_column(c)
            assert a.tobytes() == b.tobytes(), c
    info = native.build_info()
    assert info["path"] == native.library_path() and "uncompressed" in info["codecs"]
