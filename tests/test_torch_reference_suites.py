"""The first batch of the JAX package's suites that no other port test
loads, run through the port, each query also held against the JAX package
(tests/torch_mirror.py): the same plans, the same rows in the same order,
the same explain strings.

tests/test_e2e_rules.py, test_e2e_matrix.py, test_tpcds_plan_stability.py,
test_aggregates.py, test_partitioned_data.py, test_source_addressing.py and
test_cache_and_multikey.py run with the package renamed to the port. Their
sessions are ``MirroredSession``s on the CPU: the ``session`` fixture here,
and the one ``test_tpcds_plan_stability.py`` builds for itself.
``conftest.index_scans`` becomes the port's (``torch_mirror.index_scans``),
and ``test_cache_and_multikey.py``'s ``TestCaseSensitivity`` is collected as
``TestCaseSensitivityMultikey`` beside ``test_e2e_rules.py``'s.

Left out, each with the item of ROADMAP.md that takes it:

- ``test_aggregates.py::TestAggregates::test_group_by_nested_key``: runs in
  tests/test_torch_nested.py (A12b).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
SOURCES = {
    "test_e2e_rules.py": {},
    "test_e2e_matrix.py": {
        "from conftest import check_answer, index_scans  # noqa: E402": (
            "from conftest import check_answer  # noqa: E402\nfrom torch_mirror import index_scans  # noqa: E402"),
    },
    "test_tpcds_plan_stability.py": {
        "import hyperspace_tpu_torch as hst\n": "import hyperspace_tpu_torch as hst\nimport torch_mirror as _mirror\n",
        "hst.Session(conf=": "_mirror.mirrored_session(conf=",
    },
    "test_aggregates.py": {
        # the port keeps the JAX package's exec/device.py internals of the
        # aggregate and the join in exec/aggregate.py and exec/join.py
        "from hyperspace_tpu_torch.exec.device import _int_magnitude": (
            "from hyperspace_tpu_torch.exec.join import _int_magnitude"),
        "        from hyperspace_tpu_torch.exec import device as D\n": (
            "        from hyperspace_tpu_torch.exec import aggregate as D\n"),
    },
    "test_partitioned_data.py": {},
    "test_source_addressing.py": {
        # the case switches the port's signature provider; the JAX package
        # it is held against switches too
        'monkeypatch.setattr(cand, "INDEX_SIGNATURE_PROVIDER", "IndexSignatureProvider/v99")\n': (
            'monkeypatch.setattr(cand, "INDEX_SIGNATURE_PROVIDER", "IndexSignatureProvider/v99")\n'
            '        import hyperspace_tpu.rules.candidate as ref_cand\n'
            '        import hyperspace_tpu.sources.signatures as ref_sigs\n\n'
            '        monkeypatch.setattr(ref_sigs, "INDEX_SIGNATURE_PROVIDER", "IndexSignatureProvider/v99")\n'
            '        monkeypatch.setattr(ref_cand, "INDEX_SIGNATURE_PROVIDER", "IndexSignatureProvider/v99")\n'),
    },
    "test_cache_and_multikey.py": {
        # test_e2e_rules.py has a class of the same name
        "class TestCaseSensitivity:": "class TestCaseSensitivityMultikey:",
    },
}
LEFT_OUT = {
    "TestAggregates::test_group_by_nested_key": "A12b: runs in tests/test_torch_nested.py",
}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
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
