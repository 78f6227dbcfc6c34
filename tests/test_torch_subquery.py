"""Subqueries, decorrelation and residual joins through the port, each query
also held against the JAX package (tests/torch_mirror.py); then windows,
set operations and unions over SQL with nulls, -0.0 and NaN in the keys.

The cases of tests/test_subquery.py (``as_scalar``, ``isin(df)``, NULL
scalars, index rewrites inside subqueries), tests/test_decorrelate.py
(EXISTS, NOT EXISTS, correlated scalar and IN subqueries) and
tests/test_residual_join.py (residual inner, left, right and full joins)
run with the package renamed to the port, under their own assertions, and
every ``Session.sql``, optimized plan and ``collect()`` is compared with the
JAX package's over the same lake and indexes.

No case is left out: the two ``TestWhyNotSeesSubquery`` cases run since the
port has ``Hyperspace.why_not``, and each report is held against the JAX
package's too.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
LEFT_OUT: dict = {}
SOURCES = ("test_subquery.py", "test_decorrelate.py", "test_residual_join.py")

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_cases") for src in SOURCES]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    sess = M.MirroredSession(tmp_system_path)
    with M.mirroring():
        yield sess


def test_every_case_is_run_or_listed():
    """Each case of the three JAX test files is collected here or left out
    by name."""
    M.assert_every_case(_modules, globals(), LEFT_OUT)


# --- windows, set operations and unions over keys with NULL, -0.0 and NaN ---


@pytest.fixture()
def keyed(session, tmp_path):
    """Two views whose keys hold NULL strings, -0.0 and +0.0, NaN, and ties."""
    rng = np.random.default_rng(11)
    n = 240
    fk = rng.choice(np.array([1.5, -0.0, 0.0, np.nan, 2.5, -3.0]), n)
    sk = pa.array([f"s{x}" for x in rng.integers(0, 5, n)], mask=rng.random(n) < 0.15)
    a = pa.table({
        "g": rng.integers(0, 6, n).astype(np.int64),
        "fk": fk,
        "sk": sk,
        "v": np.round(rng.uniform(-50, 50, n), 2),
        "q": rng.integers(0, 4, n).astype(np.int64),
    })
    m = 150
    b = pa.table({
        "g": rng.integers(2, 9, m).astype(np.int64),
        "fk": rng.choice(np.array([-0.0, np.nan, 2.5, 7.0]), m),
        "sk": pa.array([f"s{x}" for x in rng.integers(3, 8, m)], mask=rng.random(m) < 0.15),
        "v": np.round(rng.uniform(-50, 50, m), 2),
        "q": rng.integers(0, 4, m).astype(np.int64),
    })
    for name, t in (("a", a), ("b", b)):
        root = tmp_path / name
        root.mkdir()
        pq.write_table(t, root / "p.parquet")
        session.read_parquet(str(root)).create_or_replace_temp_view(name)
    return session


WINDOWS = {
    "rank_by_float": "SELECT g, fk, v, RANK() OVER (PARTITION BY g ORDER BY fk) AS r FROM a",
    "dense_rank_by_string": "SELECT sk, v, DENSE_RANK() OVER (PARTITION BY q ORDER BY sk DESC) AS r FROM a",
    "row_number_two_keys": "SELECT g, fk, sk, ROW_NUMBER() OVER (PARTITION BY sk ORDER BY fk, v) AS r FROM a",
    "partition_by_float": "SELECT fk, v, SUM(v) OVER (PARTITION BY fk) AS s, COUNT(*) OVER (PARTITION BY fk) AS n FROM a",
    "cumulative": (
        "SELECT g, v, SUM(v) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) "
        "AS run, MAX(v) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) "
        "AS mx FROM a"
    ),
    "avg_over_group_by": "SELECT sk, SUM(v) AS t, AVG(SUM(v)) OVER (PARTITION BY 1) AS m FROM a GROUP BY sk",
}
SETOPS = {
    "intersect_float": "SELECT fk FROM a INTERSECT SELECT fk FROM b",
    "except_float": "SELECT fk FROM a EXCEPT SELECT fk FROM b",
    "intersect_string": "SELECT sk, q FROM a INTERSECT SELECT sk, q FROM b",
    "except_string": "SELECT sk FROM a EXCEPT SELECT sk FROM b",
    "intersect_mixed_types": "SELECT g FROM a INTERSECT SELECT fk FROM b",
    "union_all": "SELECT fk, sk FROM a UNION ALL SELECT fk, sk FROM b",
    "union_distinct": "SELECT fk, sk FROM a UNION SELECT fk, sk FROM b",
    "union_ordered_limit": "SELECT g, v FROM a UNION ALL SELECT g, v FROM b ORDER BY v DESC, g LIMIT 25",
    "union_then_except": "SELECT sk FROM a UNION SELECT sk FROM b EXCEPT SELECT sk FROM a WHERE q = 1",
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_window_matches_jax(keyed, name):
    got = keyed.sql(WINDOWS[name]).collect()
    assert len(next(iter(got.values()))) > 0


@pytest.mark.parametrize("name", sorted(SETOPS))
def test_setop_matches_jax(keyed, name):
    got = keyed.sql(SETOPS[name]).collect()
    assert len(next(iter(got.values()))) > 0
