"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in float32, the precision
below the float64 the configurations state. It has to come out not correct.

    python -m hsbench.control --workload <cell> --seeds 1,2,3 [--requests 40]

For each seed it makes the cell's tables at the cell's size (no card and no
program: the reference alone), draws ``--requests`` requests of the cell's
traffic as a run's open loop would, and compares each float32 answer with the
float64 one by the run's comparison. One JSON line per seed: the numbers
compared and whether the control passed (it must not)."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

from hsbench import drive, loader, verify


def control(cfg: dict, traffic: dict, seed: int, requests: int, root: str) -> dict:
    tables = loader.datagen(cfg["datagen"]).generate(root, cfg["tables"], seed)
    columns = {n: t["columns"] for n, t in tables.items()}
    schedule = drive.Schedule(traffic, seed, 0)
    states, wrong, gap, by_template = {}, 0, 0.0, {}
    for i in range(requests):
        name, params = schedule.next()
        ref, tpl = loader.reference(name), loader.template(name)
        if name not in states:
            states[name] = ref.prepare(columns)
        why, g = verify.compare(ref.answer(states[name], params, np.float32),
                                ref.answer(states[name], params, np.float64), tpl.KEYS, tpl.ORDERED)
        wrong += why is not None
        gap = max(gap, g)
        by_template[name] = max(by_template.get(name, 0.0), g)
    checks = {"wrong_answers": wrong, "float_gap": gap}
    return {"seed": seed, "requests": requests, "checks": checks, "float_gap_by_template": by_template,
            "passed": all(v <= verify.LIMITS[k] for k, v in checks.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--requests", type=int, default=40)
    args = p.parse_args(argv)
    bench = loader.benchmark()
    cell = loader.cell(bench, args.workload)
    cfg, traffic = loader.config(cell["config"]), loader.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        root = tempfile.mkdtemp(prefix="hsbench-control-")
        t = time.perf_counter()
        try:
            out = control(cfg, traffic, seed, args.requests, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
