"""The control comes out not correct: the references computed in float32
fail the comparison against float64 on every seed, at a test's size (the
cell's own size runs on the chip's host with ``python -m hsbench.control``)."""

import pytest

from hsbench import control, loader
from hsbench.tests.test_hsbench_pieces import bench_with_sql, small


@pytest.mark.parametrize("cell", ["cov-agg-dash", "sql-tpch-mix"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 977])
def test_the_float32_control_fails(cell, seed, tmp_path):
    w = loader.cell(bench_with_sql(), cell)
    out = control.control(small(loader.config(w["config"])), loader.traffic(w["traffic"]), seed, 20, str(tmp_path))
    assert not out["passed"], out
