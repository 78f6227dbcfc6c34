"""The JAX package's log-entry, data-skipping, Delta and Iceberg suites run
through the port, each query also held against the JAX package
(tests/torch_mirror.py): the same plans, the same rows in the same order,
the same explain and whyNot strings.

tests/test_log_entry.py, test_dataskipping_rule.py, test_delta_and_analysis.py
(``TestDeltaSource`` and ``TestDataSkippingIndexBuild``) and test_iceberg.py
run with the package renamed to the port, their ``session`` a
``MirroredSession`` on the CPU. No moved name, and no fault, was found.

``test_dataskipping_rule.py::test_usage_event_reports_applied_dataskipping_index``
builds its own session: it becomes a ``MirroredSession`` with the case's
conf, whose ``CollectingEventLogger`` is the port's sink
(telemetry/events.py).

Left out, with the item of ROADMAP.md that takes it:
``test_delta_and_analysis.py::TestExplainWhyNot``, which runs in
tests/test_torch_explain.py (A12b).

``test_iceberg.py::TestAvroCodec::test_snappy_codec_blocks`` runs on the
port's native library.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
SOURCES = ("test_log_entry.py", "test_dataskipping_rule.py", "test_delta_and_analysis.py", "test_iceberg.py")
REWRITES = {
    "test_dataskipping_rule.py": {
        "    sess = hst.Session(\n": "    import torch_mirror as _mirror\n\n    sess = _mirror.mirrored_session(\n"},
}
LEFT_OUT = {
    "TestExplainWhyNot": "A12b: runs in tests/test_torch_explain.py",
}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_lake_suite", rewrites=REWRITES.get(src))
            for src in SOURCES]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture(autouse=True)
def _mirrored():
    with M.mirroring():
        yield
    ht.set_session(None)


@pytest.fixture()
def session(tmp_system_path):
    sess = M.MirroredSession(tmp_system_path)
    ht.set_session(sess)
    yield sess


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)
