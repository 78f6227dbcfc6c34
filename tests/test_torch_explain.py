"""``Hyperspace.explain`` and ``whyNot`` through the port, each string also
held against the JAX package's (tests/torch_mirror.py).

The cases of tests/test_golden_explain.py run with the package renamed to
the port: every explain mode (plaintext, console, html) and every whyNot
report must equal ``tests/golden/*.txt`` after the suite's own root
normalization. The golden files are only read: the suite's regeneration
switch is forced off. Each ``explain`` and ``why_not`` call is also run in
the JAX package over the same lake and system path, and the two strings
must be equal. ``tests/test_delta_and_analysis.py::TestExplainWhyNot`` runs
the same way.

Left out of tests/test_delta_and_analysis.py, each waiting for the item of
ROADMAP.md that mirrors it: ``TestDeltaSource`` and
``TestDataSkippingIndexBuild`` (A12c, the second batch).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
SESSION = "hst.Session(conf="

_golden = M.load_cases(
    os.path.join(HERE, "test_golden_explain.py"),
    "_torch_test_golden_explain_cases",
    rewrites={
        'GENERATE = os.environ.get("HS_GENERATE_GOLDEN", "") == "1"': "GENERATE = False",
        "import hyperspace_tpu_torch as hst\n": "import hyperspace_tpu_torch as hst\nimport torch_mirror as _mirror\n",
        SESSION: "_mirror.mirrored_session(conf=",
    },
)
_analysis = M.load_cases(os.path.join(HERE, "test_delta_and_analysis.py"), "_torch_test_delta_and_analysis_cases")
LEFT_OUT = {
    "TestDeltaSource": "A12c (second batch): Delta source cases",
    "TestDataSkippingIndexBuild": "A12c (second batch): data-skipping build cases",
}
M.export_cases(_golden, globals(), {})
M.export_cases(_analysis, globals(), LEFT_OUT)


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
    M.assert_every_case([_golden], globals(), {})
    M.assert_every_case([_analysis], globals(), LEFT_OUT)


def test_golden_files_are_only_read():
    """The regeneration switch is off in the mirrored suite, whatever the
    environment says: a mismatch fails and leaves the golden file as it was."""
    assert _golden.GENERATE is False
    path = os.path.join(_golden.GOLDEN_DIR, "filter.txt")
    with open(path, encoding="utf-8") as f:
        before = f.read()
    with pytest.raises(AssertionError, match="golden mismatch"):
        _golden._check("filter.txt", before + "x")
    with open(path, encoding="utf-8") as f:
        assert f.read() == before
