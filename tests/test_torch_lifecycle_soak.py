"""The JAX package's refresh-while-serving soaks run through the port.

tests/test_lifecycle_soak.py's two cases (twenty append commits under four
serving workers; appends and lineage deletes under three client threads)
run with the package renamed to the port (tests/torch_mirror.py), their
``session`` the port's on the CPU, their helpers
(``run_refresh_serving_soak``, ``write_marked_part``) tests/test_lifecycle.py's
loaded the same way. They keep the JAX file's markers, ``slow`` among them,
so the tier-1 run (``-m 'not slow'``) leaves them out as it leaves out the
JAX file; ``-m slow`` runs them. The check that every case is run stays
in tier-1. No case is left out.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

HERE = os.path.dirname(__file__)
_HELPERS = "_torch_test_lifecycle_soak_helpers"
LEFT_OUT = {}

_helpers = M.load_cases(os.path.join(HERE, "test_lifecycle.py"), _HELPERS, rewrites=M.CPU_PORT_IMPORT)
_suite = M.load_cases(os.path.join(HERE, "test_lifecycle_soak.py"), "_torch_test_lifecycle_soak_suite", rewrites={
    **M.CPU_PORT_IMPORT,
    "from tests.test_lifecycle import run_refresh_serving_soak, write_marked_part\n": (
        f"from {_HELPERS} import run_refresh_serving_soak, write_marked_part\n"),
})
M.export_cases(_suite, globals(), LEFT_OUT)
for _name in M.cases_of(_suite):
    for _mark in _suite.pytestmark:  # lifecycle, soak, slow: the JAX file's own
        globals()[_name] = _mark(globals()[_name])

pytestmark = pytest.mark.torch_port


@pytest.fixture()
def session(tmp_system_path):
    """The soaks' session: the port's, on the CPU."""
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: tmp_system_path}, device="cpu")
    ht.set_session(sess)
    yield sess
    ht.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case([_suite], globals(), LEFT_OUT)
