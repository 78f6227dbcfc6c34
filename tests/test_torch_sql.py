"""The cases of tests/test_sql.py through the port's SQL front end, each
query also held against the JAX package (tests/torch_mirror.py).

Every case of the JAX package's SQL suite runs with the package renamed to
the port: its own assertions hold the port's answers, and each
``Session.sql`` call, optimized plan and ``collect()`` is compared with the
JAX package's over the same lake and indexes (the same plan text, the same
rows, the same error for the same bad text).

No case is left out: ``TestSqlUsesIndexes::test_explain_works_on_sql`` runs
since the port has ``Hyperspace.explain``, and its string is held against
the JAX package's too.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

LEFT_OUT: dict = {}

_cases = M.load_cases(
    os.path.join(os.path.dirname(__file__), "test_sql.py"),
    "_torch_sql_cases",
    rewrites={
        "        from test_subquery import subquery_plans\n": (
            "        from hyperspace_tpu_torch.rules.apply import iter_subquery_plans\n\n"
            "        def subquery_plans(p):\n"
            "            return list(iter_subquery_plans(p))\n"
        ),
    },
)
M.export_cases(_cases, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    sess = M.MirroredSession(tmp_system_path)
    with M.mirroring():
        yield sess


def test_every_case_is_run_or_listed():
    """Each case of tests/test_sql.py is collected here or left out by name."""
    M.assert_every_case([_cases], globals(), LEFT_OUT)