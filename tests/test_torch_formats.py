"""The JAX package's source-format suite run through the port, each query
also held against the JAX package (tests/torch_mirror.py).

tests/test_formats.py's 20 cases (ORC, Avro and text lakes with covering
and data-skipping indexes and an incremental refresh, CSV options, and the
format helpers of ``sources/formats.py`` and ``utils/avro.py``) run with
the package renamed to the port, their ``session`` a ``MirroredSession``
on the CPU: every ``collect()`` and optimized plan is also run by the JAX
package over the same lake and index system path, the same rows in the
same order (floats at rtol 1e-9), the same plan text. No case is left
out.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
LEFT_OUT = {}

_suite = M.load_cases(os.path.join(HERE, "test_formats.py"), "_torch_test_formats_suite")
M.export_cases(_suite, globals(), LEFT_OUT)


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
    M.assert_every_case([_suite], globals(), LEFT_OUT)
