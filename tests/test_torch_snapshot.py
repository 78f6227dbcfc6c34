"""The port's snapshot pins, refresh manager and result cache, held to the
JAX package's suites and to the JAX package.

tests/test_lifecycle.py (snapshot pins, the commit bus, the refresh
manager, crash-safe refresh, the hybrid-scan gates, the device lineage
filter, refresh while serving) and test_sched.py (the cost-aware scheduler,
the result cache and its data-version brands) run with the package renamed
to the port (tests/torch_mirror.py ``load_cases``), their sessions the
port's on the CPU (``torch_mirror.cpu_port``, and the ``session`` fixture
here). The case at the end holds the port's pins against the JAX package:
both packages read one system path while the port's refresh manager commits
a new version, and a pin taken before the commit keeps serving the old
version's rows in both.
``TestDeviceLineage::test_hlo_contract_zero_collectives`` reads the port's
program contracts (``check/program_lint.py``, the counterpart of
``check/hlo_lint.py``). Nothing is left out (``LEFT_OUT`` is empty).
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

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
SOURCES = {
    "test_lifecycle.py": {
        **M.CPU_PORT_IMPORT,
        # the port's device column cache is read and written directly (the
        # JAX package wraps it in two helpers)
        "        D._device_cache_put(dev_victim_key, ": "        D._device_cache.put(dev_victim_key, ",
        "        D._device_cache_put(dev_other_key, ": "        D._device_cache.put(dev_other_key, ",
        "            assert D._device_cache_get(dev_other_key) is not None": (
            "            assert D._device_cache.get(dev_other_key) is not None"),
        "            assert D._device_cache_get(dev_victim_key) is None": (
            "            assert D._device_cache.get(dev_victim_key) is None"),
        "        from hyperspace_tpu_torch.check import hlo_lint\n": (
            "        from hyperspace_tpu_torch.check import program_lint as hlo_lint\n"),
    },
    "test_sched.py": dict(M.CPU_PORT_IMPORT),
}
LEFT_OUT: dict = {}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    """test_lifecycle.py's session: the port's, on the CPU."""
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: tmp_system_path}, device="cpu")
    ht.set_session(sess)
    yield sess
    ht.set_session(None)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


# -- the port against the JAX package ------------------------------------------


def test_pins_hold_across_the_ports_refresh_in_both_packages(tmp_path):
    """One lake and one system path. Each package pins its roster, a file is
    appended and the port's refresh manager commits an incremental refresh.
    Under the pins both packages serve the old version's rows through the
    old index files (the same rows as before the commit); fresh captures see
    the new log version in both, and both serve the new rows."""
    from hyperspace_tpu.lifecycle import SnapshotHandle as RefHandle
    from hyperspace_tpu.lifecycle import snapshot_scope as ref_scope
    from hyperspace_tpu_torch.lifecycle import RefreshManager, SnapshotHandle, snapshot_scope

    data = tmp_path / "lake"
    data.mkdir()
    rng = np.random.default_rng(9)
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 30, 400).astype(np.int64),
                                 "v": rng.integers(0, 1000, 400).astype(np.int64)}),
                       str(data / f"part-{i:05d}.parquet"))
    conf = {"hyperspace.system.path": str(tmp_path / "idx"), "hyperspace.index.numBuckets": 4}
    port = ht.Session(conf=dict(conf), device="cpu")
    ref = hst.Session(conf=dict(conf))
    ht.Hyperspace(port).create_index(port.read_parquet(str(data)), ht.CoveringIndexConfig("pin_k", ["k"], ["v"]))
    for sess in (port, ref):
        sess.enable_hyperspace()

    def rows(sess):
        return sess.read_parquet(str(data)).filter(ht.col("k") == 5 if sess is port else hst.col("k") == 5) \
            .select("v").collect()

    before = rows(port)
    M.same_rows(before, rows(ref), "before")
    pin, ref_pin = SnapshotHandle.capture(port), RefHandle.capture(ref)
    old_frames = (port.read_parquet(str(data)).filter(ht.col("k") == 5).select("v"),
                  ref.read_parquet(str(data)).filter(hst.col("k") == 5).select("v"))
    pq.write_table(pa.table({"k": np.full(50, 5, dtype=np.int64), "v": np.arange(50, dtype=np.int64)}),
                   str(data / "part-00009.parquet"))
    assert [o["outcome"] for o in RefreshManager(port).poll_once()] == ["committed"]
    ref.index_manager.clear_cache()
    with snapshot_scope(pin):
        got = old_frames[0].collect()
        assert port.index_manager.get_index("pin_k").id == pin.index_version("pin_k")
    with ref_scope(ref_pin):
        want = old_frames[1].collect()
        assert ref.index_manager.get_index("pin_k").id == ref_pin.index_version("pin_k")
    M.same_rows(got, before, "port pinned")
    M.same_rows(want, before, "JAX package pinned")
    fresh, ref_fresh = SnapshotHandle.capture(port), RefHandle.capture(ref)
    assert fresh.index_version("pin_k") == ref_fresh.index_version("pin_k") > pin.index_version("pin_k")
    after = rows(port)
    M.same_rows(after, rows(ref), "after")
    assert len(after["v"]) == len(before["v"]) + 50


def test_refresh_under_the_lease_conf_raises_not_yet_in_the_port(tmp_path):
    """The lake-persisted refresh lease (``fabric/lease.py``) is in the
    port: with the fabric and the lease on, a refresh that another node's
    live lease holds back is ``busy`` and the index keeps its version; once
    that lease is released the refresh commits under a lease of its own
    (token 2, released after the commit) and writes its commit record."""
    from hyperspace_tpu_torch.fabric import lease as lease_mod
    from hyperspace_tpu_torch.fabric import records
    from hyperspace_tpu_torch.lifecycle import RefreshManager, SnapshotHandle

    data = tmp_path / "lake"
    data.mkdir()
    pq.write_table(pa.table({"k": np.arange(40, dtype=np.int64), "v": np.arange(40, dtype=np.int64)}),
                   str(data / "part-00000.parquet"))
    conf = {"hyperspace.system.path": str(tmp_path / "idx"), "hyperspace.index.numBuckets": 4,
            "hyperspace.lifecycle.refresh.mode": "incremental"}
    sess = ht.Session(conf=conf, device="cpu")
    ht.Hyperspace(sess).create_index(sess.read_parquet(str(data)), ht.CoveringIndexConfig("lease_k", ["k"], ["v"]))
    pq.write_table(pa.table({"k": np.arange(5, dtype=np.int64), "v": np.arange(5, dtype=np.int64)}),
                   str(data / "part-00001.parquet"))
    version = SnapshotHandle.capture(sess).index_version("lease_k")
    sess.conf.set(ht.keys.FABRIC_ENABLED, True)
    sess.conf.set(ht.keys.FABRIC_LEASE_ENABLED, True)
    peer = lease_mod.acquire(str(tmp_path / "idx"), "refresh/lease_k", "peer", ttl_s=600.0)
    assert [o["outcome"] for o in RefreshManager(sess).poll_once()] == ["busy"]
    assert SnapshotHandle.capture(sess).index_version("lease_k") == version
    peer.release()
    assert [o["outcome"] for o in RefreshManager(sess).poll_once()] == ["committed"]
    assert SnapshotHandle.capture(sess).index_version("lease_k") > version
    token, state = lease_mod.read_state(str(tmp_path / "idx"), "refresh/lease_k")
    assert token == 2 and state["expiresAt"] == 0.0  # released after its commit
    recs = records.read_commit_records(records.commits_dir(str(tmp_path / "idx"), "lease_k"))
    assert [r["kind"] for _, r in recs] == ["refresh-incremental"]
