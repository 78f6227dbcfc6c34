"""The port's reliability layer and metrics registry, held to the JAX
package's suites.

tests/test_reliability.py runs with the package renamed to the port
(tests/torch_mirror.py ``load_cases``): the typed error taxonomy, seeded
fault injection, the retry policy, the torn operation log, typed errors
through the scan pipeline, and the quarantine breaker with its fallback to
the source, its half-open probe and its commit on the invalidation bus.
Its sessions are CPU sessions (``Session(conf=base, device="cpu")``), and
``index_scans`` is the port's (``torch_mirror.index_scans``). The queries
are not mirrored into the JAX package: an injected fault fires in one
package's registry only.

tests/test_obs.py runs whole against the port: the metrics registry
(get-or-create, kind conflicts, gauges, histograms, Prometheus text and
escaping, the snapshot, thread safety), the span trees, query profiles of a
traced ``collect()`` (whose optimizer span is the port's ``rewrite`` stage),
the conf-chosen event sink, and the dispatch recorder under a running
``QueryServer``. Its sessions are the port's on the CPU
(``torch_mirror.cpu_port``).

Left out, each with its reason:

- ``test_reliability.py::TestChaosSoak``: it can list a
  ``part-0000N.parquet.tmp`` before its rename and count it as an
  unclassified error, and does so in the JAX package too (ROADMAP end of
  §C); ``TestChaosSoakLong`` is slow and a soak;
- ``test_reliability.py::TestPipelineTypedErrors::test_decode_fault_surfaces_typed_cancels_queue_leaks_no_spans``:
  its last assertion needs a prefetch still queued in the pipeline pool
  when the stream closes, which happens only under CPU contention; the JAX
  package's own case fails alone on an idle host (ROADMAP end of §C). Its
  typed error through the pipeline is held by
  ``test_pipeline_decode_fault_surfaces_typed`` here.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.faults]

HERE = os.path.dirname(__file__)
SOURCES = {
    "test_reliability.py": {
        "from conftest import index_scans  # noqa: E402": "from torch_mirror import index_scans  # noqa: E402",
        "    sess = hst.Session(conf=base)\n": '    sess = hst.Session(conf=base, device="cpu")\n',
    },
    "test_obs.py": {
        **M.CPU_PORT_IMPORT,
        # the port's optimizer runs inside its ``rewrite`` stage, whose span
        # is the one that times it (hyperspace_tpu_torch/obs/stages.py)
        '    assert {"query", "optimize", "execute", "decode"} <= names\n':
            '    assert {"query", "rewrite", "execute", "decode"} <= names\n',
    },
}
LEFT_OUT = {
    "TestChaosSoak": (
        "lists a part-N.parquet.tmp before its rename and counts it an unclassified error; "
        "unsteady in the JAX package too (ROADMAP end of §C)"),
    "TestChaosSoakLong": "slow and a soak",
    "TestPipelineTypedErrors::test_decode_fault_surfaces_typed_cancels_queue_leaks_no_spans": (
        "needs a prefetch still queued at close (CPU contention); fails alone in the JAX package too"),
}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


def test_pipeline_decode_fault_surfaces_typed(tmp_path):
    """A corrupt decode of a streamed chunk reaches the consumer as the
    typed ``CorruptDataError`` (counted as raised), the stream closes
    cleanly, and a clean rerun streams every row."""
    from hyperspace_tpu_torch.obs.metrics import REGISTRY
    from hyperspace_tpu_torch.reliability import errors as rerr
    from hyperspace_tpu_torch.reliability.faults import FaultRule, fault_scope

    suite = _modules[0]
    data = suite._write_files(str(tmp_path / "data"), num_files=4, rows_per=500)
    sess = suite._mk_session(tmp_path, **{ht.keys.EXEC_STREAM_CHUNK_BYTES: 1})
    q = sess.read_parquet(data).filter(ht.col("c1") >= 0).select("c1", "c2")
    raised = REGISTRY.counter("hs_io_errors_total", op="io.decode", kind="corrupt", outcome="raised")
    before = raised.value
    with fault_scope(FaultRule("io.decode", "corrupt", path_glob="*part-00000*")):
        it = q.to_local_iterator()
        with pytest.raises(rerr.CorruptDataError) as ei:
            next(it)
        it.close()
    assert isinstance(ei.value, rerr.FaultInjected) and raised.value > before
    assert sum(len(c["c1"]) for c in q.to_local_iterator()) == 2000
