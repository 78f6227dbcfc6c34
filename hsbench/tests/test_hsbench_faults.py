"""Whole runs on the CPU, past the harness's look for a card, with the
timed path broken underneath: each fault has to turn ``correct`` false, and
the sound run has to stay correct. The lake is a hundredth of the cell's."""

import pytest
import torch

from hsbench import run as R
from hsbench.tests.test_hsbench_pieces import bench_with_sql, small
from hsbench import loader

SEED = 2 ** 31 + 4242


def run_cell(cell: str, seconds: float = 5.0) -> dict:
    bench = bench_with_sql()
    cfg = small(loader.config(loader.cell(bench, cell)["config"]))
    return R.run(cell, SEED, seconds, False, device="cpu", cfg=cfg, log=lambda line: None, bench=bench)


def failing(result: dict) -> set:
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", ["cov-agg-dash", "sql-tpch-mix"])
def test_a_sound_run_is_correct(cell):
    result = run_cell(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    bench = bench_with_sql()
    assert result["attempted"] == round(loader.traffic(loader.cell(bench, cell)["traffic"])["rate"] * 5.0)
    assert set(result["metrics"]) == {m["name"] for m in loader.metrics_of(bench, cell, "end_to_end")}



def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """The device grouped aggregate's float sums off by one part in a million."""
    from hyperspace_tpu_torch.exec import aggregate as A

    orig = A._seg_sum

    def off(v, ids, cap):
        out = orig(v, ids, cap)
        return out * (1 + 1e-6) if out.is_floating_point() else out

    monkeypatch.setattr(A, "_seg_sum", off)
    result = run_cell("cov-agg-dash")
    assert not result["correct"] and "float_gap" in failing(result)


def test_sums_in_float32(monkeypatch):
    """The grouped aggregate's float sums taken in float32: the step a later
    change might be tempted by."""
    from hyperspace_tpu_torch.exec import aggregate as A

    orig = A._seg_sum

    def f32(v, ids, cap):
        if v.is_floating_point():
            return orig(v.to(torch.float32), ids, cap).to(v.dtype)
        return orig(v, ids, cap)

    monkeypatch.setattr(A, "_seg_sum", f32)
    result = run_cell("cov-agg-dash")
    assert not result["correct"] and "float_gap" in failing(result)


def test_half_of_the_batch_left_out(monkeypatch):
    """The device aggregate programs' row mask drops the second half of
    every batch of rows, so each aggregate is taken over the rest."""
    from hyperspace_tpu_torch.exec import aggregate as A

    orig = A._full_mask

    def half(pred_fn, cols, lits, n, device):
        mask = orig(pred_fn, cols, lits, n, device).clone()
        mask[mask.shape[0] // 2:] = False
        return mask

    monkeypatch.setattr(A, "_full_mask", half)
    result = run_cell("cov-agg-dash")
    assert not result["correct"] and "wrong_answers" in failing(result)


@pytest.mark.parametrize("cell", ["cov-agg-dash", "sql-tpch-mix"])
def test_a_stale_answer(monkeypatch, cell):
    """The server hands each request the first answer it gave for the same
    query shape, whatever the literals: state left unchanged."""
    from hyperspace_tpu_torch.serving import server as S

    orig = S.QueryServer._finish
    first = {}

    def stale(self, r, batch, entry):
        return orig(self, r, first.setdefault(r.fp.structure, batch), entry)

    monkeypatch.setattr(S.QueryServer, "_finish", stale)
    result = run_cell(cell, 10.0)
    assert not result["correct"] and failing(result) & {"wrong_answers", "float_gap"}


def test_an_index_row_altered_in_the_build(monkeypatch):
    """One row of one bucket file of each index holds another price than
    its source row."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from hsbench import deploy

    orig = deploy.build

    def altered(*a, **k):
        dep = orig(*a, **k)
        for entry in dep.entries.values():
            path = max(sorted(entry.content.files), key=lambda f: pq.read_metadata(f).num_rows)
            t = pq.read_table(path)
            name = next(c for c in t.column_names if pa.types.is_floating(t.schema.field(c).type))
            col = t.column(name).combine_chunks()
            bumped = pa.concat_arrays([pc.add(col.slice(0, 1), 1.0), col.slice(1)])
            pq.write_table(t.set_column(t.column_names.index(name), name, bumped), path)
        return dep

    monkeypatch.setattr(deploy, "build", altered)
    result = run_cell("cov-agg-dash")
    assert not result["correct"] and "index_rows" in failing(result)
