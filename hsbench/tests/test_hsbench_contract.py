"""BENCHMARK.json against the rules a benchmark file keeps (names, units,
keys, bounds, cells and what their metrics move), and the loader finding
every piece of every cell by its name."""

import json
import os
import re

import pytest

from hsbench import loader

ROOT = loader.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return loader.benchmark()


def one_line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    for w in bench["command"]:
        assert not w.startswith("/") and ".." not in w


def test_run_seconds_fit_a_full_check(bench):
    r = bench["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    cells = 24
    assert (2 + 14 * cells) * (r + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_names_are_unique(bench):
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in bench[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_are_used_and_their_files_lie_under_paths(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_four_chip_cells_are_few(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_listed_cell_exists_and_reports_what_its_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in loader.metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert loader.metrics_of(bench, w["name"], "per_layer")


def test_layers_are_named_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel


def test_loader_finds_every_piece_by_name(bench):
    for w in bench["workloads"]:
        cfg = loader.config(w["config"])
        loader.datagen(cfg["datagen"])
        traffic = loader.traffic(w["traffic"])
        assert traffic["loop"] == "open" and traffic["rate"] > 0 and traffic["warmup_requests"] >= 1
        for name in traffic["block"]:
            tpl = loader.template(name)
            ref = loader.reference(name)
            assert callable(tpl.request) and callable(tpl.bytes_once) and callable(tpl.prepare)
            assert callable(ref.prepare) and callable(ref.answer)
            assert set(tpl.INDEXES) <= {ix["name"] for ix in cfg["indexes"]}
        for m in loader.metrics_of(bench, w["name"], "per_layer"):
            assert callable(loader.metric(m["name"]).read)


def test_a_missing_piece_is_an_error():
    with pytest.raises(FileNotFoundError):
        loader.template("no_such_template")
    with pytest.raises(FileNotFoundError):
        loader.config("no-such-config")
