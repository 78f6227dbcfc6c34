"""The pieces of a run on the CPU: seeded draws, the byte counts, the import
guard, and each reference against the port on a tiny lake."""

import copy
import os

import numpy as np
import pytest

from hsbench import deploy, drive, guard, loader, verify

CELLS = [("cov-agg-dash", "tpch-sf1-covering", "agg-dash"), ("sql-tpch-mix", "tpch-sf1-sql", "sql-mix")]
#: the SQL cell, whose pieces stay tested while BENCHMARK.json leaves it out (its latency spreads past any bound)
SQL_CELL = {"name": "sql-tpch-mix", "config": "tpch-sf1-sql", "traffic": "sql-mix", "chips": 1,
            "why": "TPC-H SQL Q6, Q3, Q19 at SF1"}


def bench_with_sql() -> dict:
    """BENCHMARK.json with the SQL cell among its workloads."""
    bench = loader.benchmark()
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != SQL_CELL["name"]] + [dict(SQL_CELL)]
    return bench


def small(cfg: dict) -> dict:
    """A configuration cut to a test's size: a hundredth of the rows, 8 buckets."""
    cfg = copy.deepcopy(cfg)
    for t in cfg["tables"].values():
        if "rows" in t:
            t["rows"] //= 100
            t["files"] = max(2, t["files"] // 4)
        else:
            t["scale_factor"] = 0.01
    cfg["session"]["hyperspace.index.numBuckets"] = 8
    return cfg


@pytest.mark.parametrize("traffic", ["agg-dash", "sql-mix"])
def test_draws_repeat_by_seed_and_keep_the_mix(traffic):
    t = loader.traffic(traffic)
    block = sum(t["block"].values())

    def seq(seed, stream, n):
        s = drive.Schedule(t, seed, stream)
        return [s.next() for _ in range(n)]

    big = 2 ** 31 + 12345
    a, b = seq(big, 3, 5 * block), seq(big, 3, 5 * block)
    assert a == b
    assert seq(big + 1, 3, 5 * block) != a
    for seed in (big, 7):
        names = [n for n, _ in seq(seed, 0, 4 * block)]
        assert {n: names.count(n) for n in t["block"]} == {n: 4 * w for n, w in t["block"].items()}


@pytest.mark.parametrize("traffic", ["agg-dash", "sql-mix"])
def test_arrivals_offer_the_same_gaps_in_a_seeded_order(traffic):
    t = loader.traffic(traffic)
    big = 2 ** 31 + 12345
    a, b, c = (drive.arrivals(t, 51, s, 0) for s in (big, big, big + 1))
    assert a == b and a != c and len(a) == round(t["rate"] * 51)
    assert a[0] == 0.0 and all(x < y for x, y in zip(a, a[1:])) and a[-1] < 51
    gaps = [np.diff(x + [51.0]) for x in (a, c)]
    assert np.allclose(sorted(gaps[0]), sorted(gaps[1])) and np.isclose(gaps[0].sum(), 51)
    # the gaps of a Poisson process: a tenth of them under a tenth of the mean, a third over it
    mean = 51 / len(a)
    assert abs(np.mean(gaps[0] < 0.1 * mean) - (1 - np.exp(-0.1))) < 0.05
    assert abs(np.mean(gaps[0] > mean) - np.exp(-1)) < 0.05
    with pytest.raises(ValueError):
        drive.arrivals({**t, "arrivals": "even"}, 10, big, 0)


def test_draw_specs():
    rng = np.random.default_rng(1)
    assert all(60 <= drive.draw({"int": [60, 120]}, rng) <= 120 for _ in range(200))
    assert {drive.draw({"int": [1, 2]}, rng) for _ in range(200)} == {1, 2}
    assert drive.draw({"choice": ["x"]}, rng) == "x" and drive.draw({"fixed": 3}, rng) == 3
    with pytest.raises(ValueError):
        drive.draw({"normal": [0, 1]}, rng)


def tiny_lineitem():
    """Six lines: ship days, flags, and every other column q1/q6 read."""
    d = np.array(["1998-08-01", "1998-09-05", "1998-10-01", "1994-02-01", "1994-12-31", "1995-01-01"],
                 dtype="datetime64[D]")
    return {"lineitem": {"l_shipdate": d, "l_returnflag": np.array(list("RANNAR")),
                         "l_linestatus": np.array(list("FOOFFF")), "l_partkey": np.arange(6),
                         "l_orderkey": np.arange(6)}}


def test_bytes_once_counted_by_hand():
    tables = tiny_lineitem()
    q1 = loader.template("q1_pricing")
    # delta 90: cut-off 1998-09-02, so four lines (two in 1994) in groups RF, NF, AF: 3 groups
    assert q1.bytes_once(q1.prepare(tables), {"delta": 90}) == 4 * 36 + 3 * 64
    # delta 62: cut-off 1998-09-30, five lines in groups RF, AO, NF, AF: 4 groups
    assert q1.bytes_once(q1.prepare(tables), {"delta": 62}) == 5 * 36 + 4 * 64
    q6 = loader.template("q6_revenue")
    # the ship-date key selects 1994's two lines; 28 bytes read each, one 40-byte row out
    assert q6.bytes_once(q6.prepare(tables), {"year": 1994, "discount": 5, "quantity": 24}) == 2 * 28 + 40
    s6 = loader.template("sql_q6")
    assert s6.bytes_once(s6.prepare(tables), {"year": 1994, "discount": 5, "quantity": 24}) == 2 * 28 + 8
    q19 = loader.template("sql_q19")
    tables["part"] = {"p_partkey": np.arange(3)}
    assert q19.bytes_once(q19.prepare(tables), {}) == 6 * 40 + 3 * 24 + 8


def test_import_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden({"hyperspace_tpu_torch": 1, "hyperspace_tpu_torch.exec": 1}) == []
    assert guard.loaded_forbidden({"jax.numpy": 1, "hyperspace_tpu.exec": 1}) == ["hyperspace_tpu", "jax"]
    assert guard.loaded_forbidden({"benchmarks.tpch_full": 1, "chip_smoke": 1, "bench": 1, "benchmarks_x": 1}) == [
        "bench", "benchmarks", "chip_smoke"]
    assert guard.loaded_forbidden({"jaxlib": 1, "flax.linen": 1, "jaxtyping": 1}) == ["flax", "jaxlib"]


def test_this_process_holds_nothing_forbidden():
    import hsbench.run  # noqa: F401

    assert guard.loaded_forbidden() == []


def test_references_import_only_the_standard_library_numpy_pandas_and_pyarrow():
    ref_dir = os.path.join(loader.HERE, "reference")
    files = sorted(f for f in os.listdir(ref_dir) if f.endswith(".py"))
    assert len(files) >= 6
    for f in files:
        with open(os.path.join(ref_dir, f)) as fh:
            assert guard.reference_import_violations(fh.read()) == set(), f
    assert guard.reference_import_violations("import hyperspace_tpu_torch\nimport jax\nimport numpy") == {
        "hyperspace_tpu_torch", "jax"}
    assert guard.reference_import_violations("from . import x") == {"."}


@pytest.fixture(scope="module", params=CELLS, ids=[c[0] for c in CELLS])
def tiny(request, tmp_path_factory):
    cell, config, traffic = request.param
    dep = deploy.build(small(loader.config(config)), 2 ** 31 + 99, str(tmp_path_factory.mktemp(cell)), "cpu")
    return dep, loader.traffic(traffic)


def test_each_reference_equals_the_port_on_a_tiny_lake(tiny):
    dep, traffic = tiny
    ctx = deploy.Context(dep)
    columns = {n: t["columns"] for n, t in dep.tables.items()}
    sched = drive.Schedule(traffic, 5, 0)
    seen = {}
    for _ in range(6 * sum(traffic["block"].values())):
        name, params = sched.next()
        tpl, ref = loader.template(name), loader.reference(name)
        req = tpl.request(ctx, params)
        got = (dep.session.sql(req) if isinstance(req, str) else req).collect()
        want = ref.answer(ref.prepare(columns), params, np.float64)
        why, gap = verify.compare(got, want, tpl.KEYS, tpl.ORDERED)
        assert why is None, (name, params, why)
        assert gap <= verify.LIMITS["float_gap"], (name, params, gap)
        seen[name] = seen.get(name, 0) + 1
    assert set(seen) == set(traffic["block"])


def test_each_template_reads_its_configured_index(tiny):
    dep, traffic = tiny
    ctx = deploy.Context(dep)
    sched = drive.Schedule(traffic, 6, 0)
    for name in traffic["block"]:
        params = next(p for n, p in iter(sched.next, None) if n == name)
        tpl = loader.template(name)
        assert verify.plan_indexes(ctx, tpl, params) == sorted(tpl.INDEXES)


def test_each_index_holds_its_sources_rows(tiny):
    dep, _ = tiny
    assert verify.index_rows(dep) == {ix["name"]: None for ix in dep.cfg["indexes"]}


def test_compare_flags_what_differs():
    want = {"k": np.array(["a", "b"], dtype=object), "n": np.array([1, 2]), "x": np.array([1.0, 2.0])}
    assert verify.compare(dict(want), want, ("k",), False) == (None, 0.0)
    flipped = {c: v[::-1] for c, v in want.items()}
    assert verify.compare(flipped, want, ("k",), False)[0] is None
    assert verify.compare(flipped, want, ("k",), True)[0] is not None
    assert verify.compare({**want, "n": np.array([1, 3])}, want, ("k",), False)[0] is not None
    assert verify.compare({**want, "x": np.array([1.0, 2.0 * (1 + 1e-6)])}, want, ("k",), False)[1] == pytest.approx(1e-6)
    assert verify.compare({"k": want["k"]}, want, ("k",), False)[0] is not None
    assert verify.compare({**want, "x": np.array([1.0, np.nan])}, want, ("k",), False)[0] is not None
