"""The port's device-program contracts (check/program_lint.py) against the
JAX package's HLO contracts (check/hlo_lint.py).

tests/test_check_hlo.py's ``TestVerifyHlo``, ``TestForbiddenPatterns`` and
``TestMaybeVerify`` restated over small torch programs: a program's text is
its recorded dispatch (aten ops and collectives), so each case builds the
record by running a program instead of writing HLO text. Then:

- a recording window on one thread does not see another thread's ops, nor
  its collectives;
- tests/test_hlo_collectives.py's collective specs over the port's
  programs on a 4-shard CPU mesh: the build exchange is one all-to-all
  (also with composite keys), re-bucketing is one, the hierarchical
  exchange two; the bucketed join and its span program move no data; the
  sharded filter is shuffle-free; the sharded grouped aggregate gathers
  partial tables, not rows;
- the 22 families are registered in both packages with the same budgets;
- ``TestEndToEnd``: both packages run the same queries over the same lake
  with ``hyperspace.check.hlo.enabled`` on. The same families are
  verified, and neither package's programs break a contract (the port's
  grouped families did until ROADMAP §C's C12 was repaired).

Exact everywhere: counts of ops and collectives, and rows byte for byte.
"""

import os
import threading
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
from hyperspace_tpu.check import hlo_lint  # noqa: E402
from hyperspace_tpu.obs.metrics import REGISTRY as REF_REGISTRY  # noqa: E402
from hyperspace_tpu_torch.check import program_lint as PL  # noqa: E402
from hyperspace_tpu_torch.check.program_lint import (  # noqa: E402
    assert_contract,
    collective_counts,
    maybe_verify,
    record_of,
    recording,
    register_contract,
    reset_runtime_state,
    runtime_violations,
    set_default_enabled,
    verify_program,
)
# every module that registers a family (both packages), so the registries
# are whole before any case reads them
import hyperspace_tpu.exec.join_stream  # noqa: E402,F401
import hyperspace_tpu.exec.lineage  # noqa: E402,F401
import hyperspace_tpu.exec.stage_ir  # noqa: E402,F401
import hyperspace_tpu.ops.bucketize  # noqa: E402,F401
import hyperspace_tpu.ops.sort  # noqa: E402,F401
import hyperspace_tpu_torch.exec.join_stream  # noqa: E402,F401
import hyperspace_tpu_torch.exec.lineage  # noqa: E402,F401
import hyperspace_tpu_torch.exec.stage_ir  # noqa: E402,F401
import hyperspace_tpu_torch.exec.topk  # noqa: E402,F401
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.obs.metrics import REGISTRY  # noqa: E402
from hyperspace_tpu_torch.ops import bucketize as BZ  # noqa: E402
from hyperspace_tpu_torch.parallel import mesh as PM  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.check]

N_DEV = 4

#: the families the end-to-end query mix runs (dict-expand, lineage-antijoin
#: and fused-stage-join-agg: the mirrored suites' cases; the sharded and
#: exchange families: TestProgramCollectives)
EXPECTED_FAMILIES = {
    "fused-filter", "grouped-agg-chunk", "fused-agg", "bucketed-smj-span", "topk-chunk", "grouped-merge",
    "topk-merge", "fused-stage-agg", "fused-stage-topk", "hash-build", "hash-probe", "fused-postjoin",
}
#: the grouped families of the query mix: ROADMAP §C's C12, repaired (their
#: programs compacted rows with ``nonzero`` until then)
GROUPED_FAMILIES = {"grouped-agg-chunk", "grouped-merge", "fused-stage-agg"}


def _verified(family: str) -> float:
    return REGISTRY.counter("hs_check_programs_verified_total", program=family).value


@pytest.fixture()
def scratch_contract():
    """A throwaway family: exactly one all-to-all, any number of all-reduce."""
    name = "hscheck-test-family"
    register_contract(name, {"all-to-all": (1, 1), "all-reduce": (0, None)}, description="test fixture")
    yield name
    PL._CONTRACTS.pop(name, None)


@pytest.fixture()
def runtime_default_on():
    set_default_enabled(True)
    reset_runtime_state()
    yield
    set_default_enabled(False)
    reset_runtime_state()


def _mesh():
    return PM.make_mesh(devices=["cpu"] * N_DEV)


def _exchange(mesh):
    """One all-to-all over ``mesh`` (the port's collective, recorded by the
    thread's listener)."""
    staged = {g: torch.zeros((mesh.size, 2, 1), dtype=torch.int32) for g in range(mesh.size)}
    return PM.all_to_all(mesh, mesh.axis_names[0], staged)


def _program(*collectives_then_fn):
    """A program: the given collective calls, then an elementwise op."""
    mesh = _mesh()

    def run(x):
        for op in collectives_then_fn:
            if op == "all-to-all":
                _exchange(mesh)
            elif op == "all-gather":
                PM.all_gather([x, x], torch.device("cpu"))
        return x * 2

    return run


# --------------------------------------------------------------------------
# TestVerifyHlo, restated
# --------------------------------------------------------------------------


class TestVerifyProgram:
    def test_unknown_family_raises(self):
        with pytest.raises(KeyError, match="no contract registered"):
            verify_program("never-registered", PL.ProgramRecord())

    def test_conformant(self, scratch_contract):
        rec = record_of(_program("all-to-all"), torch.arange(8.0))
        assert collective_counts(rec)["all-to-all"] == 1
        assert verify_program(scratch_contract, rec) == []
        assert_contract(scratch_contract, rec)  # must not raise

    def test_below_minimum(self, scratch_contract):
        found = verify_program(scratch_contract, record_of(_program(), torch.arange(8.0)))
        assert [f.rule for f in found] == ["collective-budget:all-to-all"]
        assert "exactly 1" in found[0].message

    def test_above_maximum(self, scratch_contract):
        found = verify_program(scratch_contract, record_of(_program("all-to-all", "all-to-all"), torch.arange(8.0)))
        assert [f.rule for f in found] == ["collective-budget:all-to-all"]

    def test_unlisted_op_forbidden(self, scratch_contract):
        # a contract says everything it permits: all-gather isn't in the
        # budget, so one call is a violation
        found = verify_program(scratch_contract, record_of(_program("all-to-all", "all-gather"), torch.arange(8.0)))
        assert [f.rule for f in found] == ["collective-budget:all-gather"]

    def test_program_label(self, scratch_contract):
        found = verify_program(scratch_contract, PL.ProgramRecord(), program="my-key")
        assert found[0].path == "program:my-key"

    def test_assert_contract_raises(self, scratch_contract):
        with pytest.raises(AssertionError, match="collective-budget:all-to-all"):
            assert_contract(scratch_contract, PL.ProgramRecord())

    def test_records_aten_ops_with_their_tensors(self):
        rec = record_of(lambda x: (x > 3).sum(), torch.arange(10, dtype=torch.int64))
        assert [op.label for op in rec.ops] == ["aten::gt.Scalar", "aten::sum"]
        assert rec.ops[0].in_dtypes == (torch.int64,) and rec.ops[0].in_numels == (10,)
        assert rec.ops[0].out_dtypes == (torch.bool,) and rec.ops[0].out_devices == ("cpu",)


# --------------------------------------------------------------------------
# TestForbiddenPatterns, restated
# --------------------------------------------------------------------------


class TestForbiddenPatterns:
    @pytest.mark.parametrize("wait", [
        lambda x: x.sum().item(),
        lambda x: int(x.sum()),
        lambda x: bool((x > 3).any()),
        lambda x: torch.equal(x, x),
    ], ids=["item", "int", "bool", "equal"])
    def test_host_callback(self, scratch_contract, wait):
        def run(x):
            _exchange(_mesh())
            wait(x)
            return x

        found = verify_program(scratch_contract, record_of(run, torch.arange(8.0)))
        assert [f.rule for f in found] == ["forbidden-op:host-callback"]

    def test_device_to_host_copy_is_a_host_callback(self, scratch_contract):
        """A copy from the program's CUDA device to the CPU waits on the
        device (the rule reads the ops' devices; only a card runs one)."""
        op = PL.OpRecord("aten::_to_copy", "default", (torch.float32,), ("cuda:0",), (8,),
                         (torch.float32,), ("cpu",), (8,))
        assert PL.host_wait(op)
        up = PL.OpRecord("aten::_to_copy", "default", (torch.float32,), ("cpu",), (8,),
                         (torch.float32,), ("cuda:0",), (8,))
        assert not PL.host_wait(up)
        rec = PL.ProgramRecord(ops=[op], collectives=[("all-to-all", "buckets")])
        assert [f.rule for f in verify_program(scratch_contract, rec)] == ["forbidden-op:host-callback"]

    def test_f64_upcast(self, scratch_contract):
        def run(x):
            _exchange(_mesh())
            return x.to(torch.float64)

        found = verify_program(scratch_contract, record_of(run, torch.ones(1000, dtype=torch.float32)))
        assert [f.rule for f in found] == ["forbidden-op:f64-upcast"]

    def test_promoting_op_is_an_f64_upcast(self, scratch_contract):
        def run(x):
            _exchange(_mesh())
            return x + torch.zeros(1000, dtype=torch.float64)

        found = verify_program(scratch_contract, record_of(run, torch.ones(1000, dtype=torch.float32)))
        assert [f.rule for f in found] == ["forbidden-op:f64-upcast"]

    def test_scalar_f64_convert_allowed(self, scratch_contract):
        # only whole-ARRAY upcasts are flagged; a scalar convert is fine
        def run(x):
            _exchange(_mesh())
            return x.to(torch.float64)

        assert verify_program(scratch_contract, record_of(run, torch.ones((), dtype=torch.float32))) == []

    @pytest.mark.parametrize("dyn", [
        lambda x: torch.nonzero(x > 3),
        lambda x: torch.masked_select(x, x > 3),
        lambda x: x[x > 3],
        lambda x: torch.unique(x),
        lambda x: torch.repeat_interleave(torch.tensor([1, 2])),
    ], ids=["nonzero", "masked_select", "bool-index", "unique", "repeat_interleave"])
    def test_dynamic_shape(self, scratch_contract, dyn):
        def run(x):
            _exchange(_mesh())
            return dyn(x)

        found = {f.rule for f in verify_program(scratch_contract, record_of(run, torch.arange(8.0)))}
        assert "forbidden-op:dynamic-shape" in found
        # nonzero also waits on the host; the others are value-dependent only
        assert found <= {"forbidden-op:dynamic-shape", "forbidden-op:host-callback"}

    def test_fixed_shape_ops_are_clean(self, scratch_contract):
        def run(x):
            _exchange(_mesh())
            idx = torch.arange(4)
            return (x[idx], torch.repeat_interleave(torch.tensor([1, 2]), torch.tensor([2, 2]), output_size=4),
                    torch.where(x > 3, x, 0.0))

        assert verify_program(scratch_contract, record_of(run, torch.arange(8.0))) == []

    def test_opt_out(self):
        register_contract("hscheck-optout", {}, forbid=("host-callback",))
        try:
            assert verify_program("hscheck-optout", record_of(lambda x: x[x > 3], torch.arange(8.0))) == []
        finally:
            PL._CONTRACTS.pop("hscheck-optout", None)

    def test_single_fusion_holds_whatever_forbid_says(self):
        register_contract("hscheck-fused", {}, forbid=(), single_fusion=True)
        try:
            assert verify_program("hscheck-fused", record_of(lambda x: x * 2, torch.arange(8.0))) == []
            found = verify_program("hscheck-fused", record_of(lambda x: x[x > 3], torch.arange(8.0)))
            assert [f.rule for f in found] == ["single-fusion"]
        finally:
            PL._CONTRACTS.pop("hscheck-fused", None)


# --------------------------------------------------------------------------
# TestMaybeVerify, restated
# --------------------------------------------------------------------------


class TestMaybeVerify:
    def test_disabled_is_noop(self):
        reset_runtime_state()
        set_default_enabled(False)
        with maybe_verify(None, "never-registered", "k", (torch.zeros(4),)):
            torch.zeros(4) + 1
        # off: no window, nothing recorded or verified, an unknown family
        # never looked up
        assert runtime_violations() == []
        assert maybe_verify(None, "never-registered", "k", ()) is PL._OFF
        assert maybe_verify(ht.config.HyperspaceConf({}), "never-registered", "k", ()) is PL._OFF

    def test_disabled_path_dispatches_nothing(self):
        """With the check off, no dispatch mode is pushed: an outer
        recording sees the program's op and nothing of the check."""
        set_default_enabled(False)
        x = torch.zeros(4)
        with recording() as rec:
            with maybe_verify(None, "fused-filter", "k", (x,)):
                x + 1
        assert [op.label for op in rec.ops] == ["aten::add.Tensor"]

    def test_verifies_and_dedups(self, scratch_contract, runtime_default_on):
        before = _verified(scratch_contract)
        x = torch.arange(8, dtype=torch.float32)
        with maybe_verify(None, scratch_contract, "k1", (x,)):
            x * 2
        after = _verified(scratch_contract)
        assert after == before + 1
        # x*2 has no all-to-all: the budget violation lands in the log + metric
        assert [f.rule for f in runtime_violations()] == ["collective-budget:all-to-all"]
        assert REGISTRY.counter(
            "hs_check_violations_total", rule="collective-budget:all-to-all", program=scratch_contract,
        ).value >= 1
        # same key + same shapes: not recorded again
        assert maybe_verify(None, scratch_contract, "k1", (x,)) is PL._OFF
        assert _verified(scratch_contract) == after
        # new shape signature = verified again
        with maybe_verify(None, scratch_contract, "k1", (torch.arange(16, dtype=torch.float32),)):
            x * 2
        assert _verified(scratch_contract) == after + 1

    def test_the_program_runs_once(self, scratch_contract, runtime_default_on):
        """The window records the live call: fold state updated in place is
        updated once."""
        state = torch.zeros(4)
        with maybe_verify(None, scratch_contract, "k-once", (state,)):
            state.add_(1)
        assert state.tolist() == [1.0] * 4

    def test_violations_warn_never_raise(self, scratch_contract, runtime_default_on):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with maybe_verify(None, scratch_contract, "k2", (torch.ones(4),)):
                torch.ones(4) + 1
        assert any("contract violation" in str(x.message) for x in w)

    def test_a_window_that_cannot_record_warns(self, scratch_contract, runtime_default_on, monkeypatch):
        def broken(self):
            raise RuntimeError("no dispatch mode here")

        monkeypatch.setattr(PL._Recorder, "__enter__", broken)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with maybe_verify(None, scratch_contract, "k-broken", (torch.ones(4),)):
                out = torch.ones(4) + 1
        assert out.tolist() == [2.0] * 4  # the program still ran
        assert any("could not record" in str(x.message) for x in w)
        monkeypatch.undo()
        # and the next call records
        before = _verified(scratch_contract)
        with maybe_verify(None, scratch_contract, "k-broken", (torch.ones(4),)):
            torch.ones(4) + 1
        assert _verified(scratch_contract) == before + 1

    def test_a_program_that_raises_is_not_counted(self, scratch_contract, runtime_default_on):
        before = _verified(scratch_contract)
        with pytest.raises(ValueError):
            with maybe_verify(None, scratch_contract, "k-raise", (torch.ones(4),)):
                raise ValueError("overflow")
        assert _verified(scratch_contract) == before
        with maybe_verify(None, scratch_contract, "k-raise", (torch.ones(4),)):
            torch.ones(4) + 1
        assert _verified(scratch_contract) == before + 1

    def test_reset_clears_dedup_and_log(self, scratch_contract, runtime_default_on):
        x = torch.ones(4)
        with maybe_verify(None, scratch_contract, "k3", (x,)):
            x + 0
        assert runtime_violations()
        reset_runtime_state()
        assert runtime_violations() == []
        before = _verified(scratch_contract)
        with maybe_verify(None, scratch_contract, "k3", (x,)):
            x + 0
        assert _verified(scratch_contract) == before + 1

    def test_a_session_with_the_check_off_records_nothing(self, tmp_path):
        """Queries of a session at the default conf open no window: nothing
        is verified, recorded or remembered."""
        t, _o = _lake(tmp_path)
        sess = ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path / "idx"), ht.keys.DEVICE_MIN_ROWS: 0},
                          device="cpu")
        ht.Hyperspace(sess).create_index(sess.read_parquet(t), ht.CoveringIndexConfig("off_t", ["c1"], ["c2"]))
        sess.enable_hyperspace()
        reset_runtime_state()
        before = {f: _verified(f) for f in PL.registered_contracts()}
        D.reset_dispatches()
        df = sess.read_parquet(t)
        df.filter(ht.col("c1") > 20).select("c2").collect()
        df.filter(ht.col("c1") > 10).group_by("c1").agg(s=("c2", "sum")).collect()
        assert D.dispatches["fused-filter"] and D.dispatches["grouped-agg-chunk"]
        assert {f: _verified(f) for f in PL.registered_contracts()} == before
        assert PL._VERIFIED_SEEN == set() and runtime_violations() == []

    def test_session_sets_the_default(self, tmp_path):
        ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path), ht.keys.CHECK_HLO_ENABLED: True}, device="cpu")
        try:
            assert PL._default_enabled
        finally:
            ht.Session(conf={ht.keys.SYSTEM_PATH: str(tmp_path)}, device="cpu")
        assert not PL._default_enabled


def test_a_window_sees_only_its_own_threads_ops_and_collectives():
    """Pipeline threads run programs concurrently: a window on one thread
    records neither another thread's aten ops nor its collectives."""
    mesh = _mesh()
    started, stop = threading.Event(), threading.Event()

    def other():
        started.set()
        while not stop.is_set():
            torch.ones(3).neg()
            _exchange(mesh)

    t = threading.Thread(target=other)
    t.start()
    try:
        started.wait()
        with recording() as rec:
            for _ in range(50):
                torch.arange(4).sum()
        collectives_before = sum(PM.collective_calls.values())
    finally:
        stop.set()
        t.join()
    assert {op.label for op in rec.ops} == {"aten::arange", "aten::sum"}
    assert rec.collectives == []
    assert collectives_before > 0  # the other thread did exchange meanwhile


# --------------------------------------------------------------------------
# tests/test_hlo_collectives.py's specs over the port's programs
# --------------------------------------------------------------------------


@pytest.fixture()
def mesh(monkeypatch):
    monkeypatch.setattr(PM, "SHARD_COUNT", N_DEV)
    return PM.make_mesh(device_type="cpu")


class TestProgramCollectives:
    def test_build_exchange_is_one_all_to_all(self, mesh):
        """The distributed-build program create_index runs on a mesh of more
        than one shard: exactly one all-to-all, nothing else."""
        capacity = 16
        fn = BZ._build_exchange_program(mesh, ("i",), 4 * N_DEV, capacity)
        n = N_DEV * 32
        place = PM.sharded(mesh)
        keys = [place.put(np.arange(n, dtype=np.int64)).shards]
        ridx = place.put(np.arange(n, dtype=np.int64)).shards
        rec = record_of(fn, keys, [], ridx, n)
        assert_contract("index-build-exchange", rec, "build exchange")

    def test_build_exchange_composite_keys_still_one(self, mesh):
        """Packing keeps the count at one: a composite (int, string) key
        staging 4+ buffers still exchanges once."""
        capacity = 16
        fn = BZ._build_exchange_program(mesh, ("i", "s"), 4 * N_DEV, capacity)
        n = N_DEV * 32
        place = PM.sharded(mesh)
        keys = [place.put(np.arange(n, dtype=np.int64)).shards, place.put(np.arange(n, dtype=np.int64)).shards]
        hh = [place.put(np.arange(n, dtype=np.uint32).view(np.int32)).shards]
        ridx = place.put(np.arange(n, dtype=np.int64)).shards
        rec = record_of(fn, keys, hh, ridx, n)
        assert_contract("index-build-exchange", rec, "composite-key build exchange")

    def test_the_build_verifies_its_exchange_at_runtime(self, mesh, runtime_default_on):
        """``distributed_bucket_sort_build`` opens the window with no conf
        in reach (the module default), and reads overflow after it."""
        n = N_DEV * 32
        place = PM.sharded(mesh)
        before = _verified("index-build-exchange")
        BZ.distributed_bucket_sort_build(mesh, [place.put(np.arange(n, dtype=np.int64))], [], ("i",),
                                         place.put(np.arange(n, dtype=np.int64)), n, 4 * N_DEV, 16)
        assert _verified("index-build-exchange") == before + 1
        assert [f for f in runtime_violations() if "index-build-exchange" in f.path] == []

    def test_rebucket_is_one_all_to_all(self, mesh, runtime_default_on):
        """The re-bucketing exchange: one all-to-all; its overflow counts
        are read after the program's window."""
        n = N_DEV * 16
        place = PM.sharded(mesh)
        before = _verified("index-rebucket")
        BZ.rebucket(mesh, {"v": place.put(np.arange(n, dtype=np.float64))},
                    place.put((np.arange(n) % (2 * N_DEV)).astype(np.int32)), 32)
        assert _verified("index-rebucket") == before + 1
        assert runtime_violations() == []

    def test_hierarchical_is_two_all_to_alls(self, mesh, runtime_default_on):
        """DCN x ICI two-phase exchange: exactly two (one per phase)."""
        mesh2d = PM.make_mesh_2d(n_slices=2, per_slice=N_DEV // 2, device_type="cpu")
        sh2 = PM.sharded_2d(mesh2d)
        n = N_DEV * 16
        before = _verified("hierarchical-exchange")
        BZ.rebucket_hierarchical(mesh2d, {"v": sh2.put(np.arange(n, dtype=np.float64))},
                                 sh2.put((np.arange(n) % (4 * N_DEV)).astype(np.int32)), 32, 32)
        assert _verified("hierarchical-exchange") == before + 1
        assert runtime_violations() == []

    def test_bucketed_join_has_no_data_collectives(self, mesh):
        """Co-sharded buckets join device-locally: the port's sharded
        bucketed join over the mesh calls no collective at all (the JAX
        package's query-level scalar psum has no counterpart here)."""
        from hyperspace_tpu_torch.exec.join import bucketed_span

        rng = np.random.default_rng(0)
        lm = torch.from_numpy(np.sort(rng.integers(0, 1000, (N_DEV * 2, 32)), axis=1))
        rm = torch.from_numpy(np.sort(rng.integers(0, 1000, (N_DEV * 2, 48)), axis=1))
        rec = record_of(lambda a, b: [bucketed_span(a[s::N_DEV], b[s::N_DEV]) for s in range(N_DEV)], lm, rm)
        counts = collective_counts(rec)
        assert all(counts[op] == 0 for op in PL.SHUFFLE_OPS), counts
        assert counts["all-reduce"] <= 1, counts

    def test_bucketed_smj_span_program_is_shuffle_free(self):
        """The span program device joins execute conforms to its
        zero-collective contract."""
        from hyperspace_tpu_torch.exec.join import bucketed_span

        rng = np.random.default_rng(0)
        lm = torch.from_numpy(np.sort(rng.integers(0, 1000, (N_DEV * 2, 32)), axis=1))
        rm = torch.from_numpy(np.sort(rng.integers(0, 1000, (N_DEV * 2, 48)), axis=1))
        assert_contract("bucketed-smj-span", record_of(bucketed_span, lm, rm), "bucketed SMJ span program")

    def test_sharded_filter_program_is_shuffle_free(self, mesh):
        from hyperspace_tpu_torch.parallel import collectives as C

        fn = C.sharded_elementwise(mesh, "buckets", lambda cols, lits: cols["a"] > lits[0])
        rec = record_of(fn, {"a": torch.arange(N_DEV * 16, dtype=torch.int64)}, (torch.tensor(3),))
        PL.assert_shuffle_free(rec, "sharded filter")
        assert_contract("fused-filter", rec, "sharded filter")

    def _sharded_grouped_record(self, mesh):
        from hyperspace_tpu_torch.parallel import collectives as C

        prog = C.sharded_grouped_chunk_program(mesh, "buckets", None, (("k", "i"),), [("cntm", None, True)], 32)
        k = torch.from_numpy((np.arange(N_DEV * 64) % 17).astype(np.int64))
        return record_of(prog, {"k": k}, (), N_DEV * 64, 0)

    def test_sharded_grouped_agg_gathers_partials_not_rows(self, mesh):
        """The grouped aggregate gathers O(cap) per-shard partial tables —
        never a row exchange; its collective budget holds."""
        rec = self._sharded_grouped_record(mesh)
        got = collective_counts(rec)
        assert got["all-gather"] >= 1 and got["all-to-all"] == 0, got
        assert not [f for f in verify_program("sharded-grouped", rec) if f.rule.startswith("collective-budget")]

    def test_sharded_grouped_agg_verifies_clean(self, mesh):
        assert not verify_program("sharded-grouped", self._sharded_grouped_record(mesh))


def test_the_22_families_carry_the_jax_packages_budgets():
    ref, port = hlo_lint.registered_contracts(), PL.registered_contracts()
    families = {f for f in ref if not f.startswith("hscheck-")}
    assert len(families) == 22
    assert families == {f for f in port if not f.startswith("hscheck-")}
    for f in families:
        assert (port[f].collectives, port[f].forbid, port[f].single_fusion) == (
            ref[f].collectives, ref[f].forbid, ref[f].single_fusion), f
    assert set(PL.COLLECTIVE_OPS) == set(hlo_lint.COLLECTIVE_OPS)
    assert set(PL.SHUFFLE_OPS) == set(hlo_lint.SHUFFLE_OPS)
    assert [n for n, _, _ in PL.FORBIDDEN_PATTERNS] == [n for n, _, _ in hlo_lint.FORBIDDEN_PATTERNS]


# --------------------------------------------------------------------------
# TestEndToEnd: both packages, the same lake and queries, the check on
# --------------------------------------------------------------------------


def _lake(root):
    rng = np.random.default_rng(42)
    n = 1000
    t = root / "t"
    t.mkdir()
    table = pa.table({
        "c1": rng.integers(0, 100, n).astype(np.int64),
        "c2": rng.integers(0, 1000, n).astype(np.int64),
        "c3": rng.standard_normal(n),
    })
    for i in range(4):
        pq.write_table(table.slice(i * 250, 250), t / f"part-{i:05d}.parquet")
    o = root / "o"
    o.mkdir()
    pq.write_table(pa.table({"o1": np.arange(0, 100, 2, dtype=np.int64),
                             "o2": rng.integers(0, 9, 50).astype(np.int64)}), o / "part-00000.parquet")
    return str(t), str(o)


def _queries(pkg, sess, t, o):
    """The query mix of the end-to-end run: a filter, a grouped and a global
    aggregate, a bucketed join, a top-k, then the streamed grouped
    aggregate and top-k with fusion off and on, and the streamed broadcast
    join with a post-join filter."""
    col = pkg.col
    df, od = sess.read_parquet(t), sess.read_parquet(o)
    out = [
        df.filter(col("c1") > 20).select("c2").collect(),
        df.filter(col("c1") > 10).group_by("c1").agg(s=("c2", "sum")).collect(),
        df.filter(col("c1") > 10).agg(s=("c2", "sum"), n=("*", "count")).collect(),
        df.join(od, col("c1") == col("o1")).select("c2", "o2").collect(),
        df.order_by("c3", ascending=[False]).limit(7).collect(),
    ]
    for k, v in ((pkg.keys.EXEC_STREAM_AGG_MIN_BYTES, 1), (pkg.keys.EXEC_STREAM_CHUNK_BYTES, 1)):
        sess.conf.set(k, v)
    out.append(df.filter(col("c1") > 40).group_by("c1").agg(s=("c2", "sum")).collect())
    out.append(df.order_by("c2", ascending=[True]).limit(9).collect())
    sess.conf.set(pkg.keys.EXEC_FUSION_ENABLED, True)
    out.append(df.filter(col("c1") > 30).group_by("c1").agg(s=("c2", "sum")).collect())
    out.append(df.order_by("c3", ascending=[False]).limit(7).collect())
    for k in (pkg.keys.EXEC_STREAM_AGG_MIN_BYTES, pkg.keys.EXEC_STREAM_CHUNK_BYTES, pkg.keys.EXEC_FUSION_ENABLED):
        sess.conf.unset(k)
    # the streamed broadcast join with a post-join filter over both sides
    sess.disable_hyperspace()
    sess.conf.set(pkg.keys.EXEC_STREAM_CHUNK_BYTES, 1)
    q = df.join(od, on=col("c1") == col("o1")).filter(col("c2") > col("o2") * 50).select("c2", "o2")
    chunks = list(pkg.exec.executor.Executor(sess).execute_stream(q.optimized_plan()))
    out.append({c: np.concatenate([np.asarray(ch[c]) for ch in chunks]) for c in ("c2", "o2")})
    return out


def _run(pkg, root, t, o):
    conf = {
        pkg.keys.SYSTEM_PATH: str(root / "idx"),
        pkg.keys.CHECK_HLO_ENABLED: True,
        pkg.keys.TPU_QUERY_DEVICE_EXECUTION: True,
        pkg.keys.TPU_QUERY_DEVICE_MIN_ROWS: 0,
        pkg.keys.NUM_BUCKETS: 4,
        pkg.keys.EXEC_PIPELINE_ENABLED: False,
    }
    sess = pkg.Session(conf=conf, device="cpu") if pkg is ht else pkg.Session(conf=conf)
    pkg.set_session(sess)
    try:
        sess.enable_hyperspace()
        return _queries(pkg, sess, t, o)
    finally:
        pkg.set_session(None)


def _ref_verified(family):
    return REF_REGISTRY.counter("hs_check_programs_verified_total", program=family).value


def _end_to_end(root):
    """Both packages' runs of the query mix with the check on: (port rows,
    JAX rows, port families verified, JAX families verified, port
    violations, JAX violations)."""
    t, o = _lake(root)
    conf = {ht.keys.SYSTEM_PATH: str(root / "idx"), ht.keys.NUM_BUCKETS: 4}
    builder = ht.Session(conf=conf, device="cpu")
    hs = ht.Hyperspace(builder)
    hs.create_index(builder.read_parquet(t), ht.CoveringIndexConfig("chk_t", ["c1"], ["c2", "c3"]))
    hs.create_index(builder.read_parquet(o), ht.CoveringIndexConfig("chk_o", ["o1"], ["o2"]))
    families = sorted(PL.registered_contracts())
    port_before = {f: _verified(f) for f in families}
    ref_before = {f: _ref_verified(f) for f in families}
    D.clear_device_cache()
    reset_runtime_state()
    hlo_lint.reset_runtime_state()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_rows = _run(ht, root, t, o)
        port_bad = runtime_violations()
        ref_rows = _run(hst, root, t, o)
        ref_bad = hlo_lint.runtime_violations()
    port_fams = {f for f in families if _verified(f) > port_before[f]}
    ref_fams = {f for f in families if _ref_verified(f) > ref_before[f]}
    set_default_enabled(False)
    hlo_lint.set_default_enabled(False)
    reset_runtime_state()
    hlo_lint.reset_runtime_state()
    return port_rows, ref_rows, port_fams, ref_fams, port_bad, ref_bad


@pytest.fixture(scope="module")
def end_to_end(tmp_path_factory):
    return _end_to_end(tmp_path_factory.mktemp("check_e2e"))


class TestEndToEnd:
    def test_same_rows(self, end_to_end):
        port_rows, ref_rows = end_to_end[:2]
        assert len(port_rows) == len(ref_rows) == 10
        for i, (got, want) in enumerate(zip(port_rows, ref_rows)):
            assert sorted(got) == sorted(want), i
            order_g = np.lexsort([np.asarray(got[c]) for c in sorted(got)])
            order_w = np.lexsort([np.asarray(want[c]) for c in sorted(want)])
            for c in want:
                np.testing.assert_array_equal(np.asarray(got[c])[order_g], np.asarray(want[c])[order_w], err_msg=c)

    def test_the_same_families_are_verified(self, end_to_end):
        port_fams, ref_fams = end_to_end[2:4]
        assert port_fams == ref_fams, (sorted(port_fams), sorted(ref_fams))
        assert port_fams == EXPECTED_FAMILIES, sorted(port_fams)

    def test_the_jax_package_breaks_no_contract(self, end_to_end):
        ref_bad = end_to_end[5]
        assert ref_bad == [], [f.render() for f in ref_bad]

    def test_the_port_breaks_only_the_logged_faults(self, end_to_end):
        """The port's run reports no violation: no fault of ROADMAP §C is
        open against the contracts."""
        port_bad = end_to_end[4]
        assert port_bad == [], [f.render() for f in port_bad]

    @pytest.mark.parametrize("family", sorted(GROUPED_FAMILIES))
    def test_the_ports_family_verifies_clean(self, end_to_end, family):
        port_fams, port_bad = end_to_end[2], end_to_end[4]
        assert family in port_fams
        assert [f.render() for f in port_bad if f.detail["family"] == family] == []

    @pytest.mark.parametrize("family", sorted(EXPECTED_FAMILIES - GROUPED_FAMILIES))
    def test_the_ports_clean_families(self, end_to_end, family):
        port_fams, port_bad = end_to_end[2], end_to_end[4]
        assert family in port_fams
        assert [f.render() for f in port_bad if f.detail["family"] == family] == []
