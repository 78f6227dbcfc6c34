"""Finds each piece of a cell by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``datagen/<generator>.py``,
``templates/<template>.py``, ``reference/<template>.py`` and
``metrics/<metric>.py``, all under this folder; ``BENCHMARK.json`` at the
root of the checkout."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str):
    """``<kind>/<name>.py`` as the module ``hsbench.<kind>.<name>`` (a name may
    hold ``-`` or ``.``, which ``import`` cannot spell)."""
    key = f"hsbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def datagen(name: str):
    return _module("datagen", name)


def template(name: str):
    return _module("templates", name)


def reference(name: str):
    return _module("reference", name)


def metric(name: str):
    return _module("metrics", name)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell_name`` reports:
    those that list it under ``workloads``, or list no cells at all."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
