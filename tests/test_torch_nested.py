"""Nested struct columns through the port, each query also held against the
JAX package (tests/torch_mirror.py): plans, rows in order and dispatch
traces.

The cases of tests/test_nested_columns.py (the ``nestedColumn.enabled``
gate, the ``__hs_nested.`` flat index columns, the array rejection, the
filter and join rules over a nested key, the select of a struct leaf, bucket
pruning, full and incremental refresh, and hybrid scan) and
``tests/test_aggregates.py::TestAggregates::test_group_by_nested_key`` run
with the package renamed to the port. Then the same shapes run with
``deviceMinRows=0``, where a nested filter takes the device filter and a
nested join the bucketed join's device programs, in both packages.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)

_nested = M.load_cases(os.path.join(HERE, "test_nested_columns.py"), "_torch_test_nested_columns_cases")
_aggs = M.load_cases(os.path.join(HERE, "test_aggregates.py"), "_torch_test_aggregates_nested_cases")
#: every other case of tests/test_aggregates.py runs in tests/test_torch_reference_suites.py
AGG_OTHERS = {n: "tests/test_torch_reference_suites.py" for n in M.cases_of(_aggs)
              if n != "TestAggregates::test_group_by_nested_key"}
M.export_cases(_nested, globals(), {})
M.export_cases(_aggs, globals(), AGG_OTHERS)


@pytest.fixture(params=["host", "device"])
def session(request, tmp_system_path):
    """A mirrored port session; ``device`` sends every filter and join over
    an index to the device programs (``deviceMinRows=0``)."""
    conf = {} if request.param == "host" else {ht.keys.DEVICE_MIN_ROWS: 0}
    sess = M.MirroredSession(tmp_system_path, conf=conf, compare_traces=True)
    ht.set_session(sess)
    with M.mirroring():
        yield sess
    ht.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case([_nested], globals(), {})
    M.assert_every_case([_aggs], globals(), AGG_OTHERS)


def _lake(tmp_path):
    d = tmp_path / "nl"
    d.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        v = rng.integers(0, 100, 300)
        pq.write_table(pa.table({
            "id": rng.integers(0, 1000, 300).astype(np.int64),
            "nested": pa.array([{"leaf": {"cnt": int(x % 9)}, "name": f"n{x % 4}"} for x in v]),
        }), d / f"p{i}.parquet")
    r = tmp_path / "r"
    r.mkdir()
    pq.write_table(pa.table({"cnt": np.arange(9, dtype=np.int64),
                             "label": np.array([f"L{i}" for i in range(9)])}), r / "p.parquet")
    return str(d), str(r)


def test_nested_filter_and_join_take_the_device_tiers(tmp_path):
    """With ``deviceMinRows=0`` a nested filter is ``filter: device`` and a
    join on a nested key the device span join, as in the JAX package."""
    sess = M.MirroredSession(str(tmp_path / "sys"), conf={ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.NUM_BUCKETS: 4,
                                                          ht.keys.NESTED_COLUMN_ENABLED: True},
                              compare_traces=True)
    ldir, rdir = _lake(tmp_path)
    hs = ht.Hyperspace(sess)
    ldf, rdf = sess.read_parquet(ldir), sess.read_parquet(rdir)
    hs.create_index(ldf, ht.CoveringIndexConfig("nl", ["nested.leaf.cnt"], ["id", "nested.name"]))
    hs.create_index(rdf, ht.CoveringIndexConfig("nr", ["cnt"], ["label"]))
    sess.enable_hyperspace()
    with M.mirroring():
        got = ldf.filter(ht.col("nested.leaf.cnt") == 3).select("id", "nested.name").collect()
        assert len(got["id"]) > 0 and "filter: device x1" in sess.last_trace_lines, sess.last_trace_lines
        got = ldf.join(rdf, on=ht.col("nested.leaf.cnt") == ht.col("cnt")).select("id", "label").collect()
        assert len(got["id"]) == 600 and "join: device-smj x1" in sess.last_trace_lines, sess.last_trace_lines


STRUCT_ROWS = {
    "plain": ([{"a": {"b": 1}, "c": "x"}, {"a": {"b": 2}, "c": "y"}], "s.a.b"),
    "null_rows": ([None, {"a": None, "c": "x"}, {"a": {"b": 3.5}, "c": None}], "s.a.b"),
    "string_leaf": ([{"a": {"b": 1}, "c": "x"}, None], "s.c"),
    "case_differs": ([{"A": {"b": 1}}, {"A": {"b": 2}}], "s.a.b"),
    "missing_field": ([{"a": {"b": 1}}, {"a": {}}], "s.a.b"),
    "root_case": ([{"a": 1}], "S.a"),
}


@pytest.mark.parametrize("case", sorted(STRUCT_ROWS))
def test_select_of_struct_leaf_matches_jax_get_column(case):
    """``exec.batch.select`` of a dotted path (dict lookups where they give
    the same array) equals the JAX package's ``get_column``, dtype and
    values, or fails where it finds nothing."""
    from hyperspace_tpu.plan.expr import get_column as ref_get_column
    from hyperspace_tpu_torch.exec import batch as B

    rows, name = STRUCT_ROWS[case]
    batch = {"s": np.array(rows + [None], dtype=object)[:-1], "k": np.arange(len(rows))}
    want = ref_get_column(dict(batch), name)
    if want is None:
        with pytest.raises(KeyError):
            B.select(batch, [name])
        return
    got = B.select(batch, [name])[name]
    assert got.dtype == want.dtype, (got, want)
    np.testing.assert_array_equal(got, want)
