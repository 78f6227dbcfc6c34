"""Run one cell of ``BENCHMARK.json`` on one H100 and print one JSON line.

    python -m hsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's deployment from the seed (tables, a CUDA
``Session``, the covering indexes) in a temporary directory, starts a
``QueryServer`` over it, warms the cell's own templates, then offers the
cell's traffic for ``--seconds``: an open loop at the mix's fixed rate.
After the window it checks the build, the rewrite and a
seeded sample of the served answers against the plain references and prints,
as the last line of standard output, ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``breakdown``) and, last,
``checks``: each number compared, with its limit. With ``--trace 0`` the
metrics are the cell's end-to-end ones; with ``--trace 1`` its per-layer
ones, read from the server's counters, the session's stage clock and a
``torch.profiler`` slice. Without a card, or with JAX loaded, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from hsbench import deploy, drive, guard, loader, verify  # noqa: E402
from hsbench.peaks import HBM_BYTES_PER_S  # noqa: E402

#: exit codes of a run that prints no result
NO_CARD, FORBIDDEN_IMPORT = 2, 3
#: a request's deadline: an answer that comes late is late, not missing
REQUEST_TIMEOUT_S = 60.0
#: the traced slice: where it starts in the window (a share of it) and its longest length (s)
SLICE_AT, SLICE_MAX_S = 0.25, 10.0


class NoCard(RuntimeError):
    pass


def cache_dirs(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own kernels into ``hyperspace_tpu_torch/_build/``)."""
    build = os.path.join(root, "hyperspace_tpu_torch", "_build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {n}")


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def readings(server, session) -> dict:
    """The server's counters, the session's stage clock and the admission
    wait histogram (this server's series), read at one moment."""
    s = server.stats()
    wait_sum = wait_count = 0.0
    for series in server.registry.snapshot().get("hs_admission_wait_seconds", {}).get("series", []):
        if series["labels"].get("server") == server.server_name:
            wait_sum += series["sum"]
            wait_count += series["count"]
    return {"completed": s["completed"], "batched": s["batchedRequests"], "bucket_hits": s["bucketCache"]["hits"],
            "bucket_misses": s["bucketCache"]["misses"], "wait_sum": wait_sum, "wait_count": wait_count,
            "stages": dict(session.query_stage_seconds)}


def delta(r1: dict, r0: dict) -> dict:
    out = {k: r1[k] - r0[k] for k in r1 if k != "stages"}
    out["stages"] = {k: v - r0["stages"].get(k, 0.0) for k, v in r1["stages"].items()}
    return out


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def answered(requests) -> list:
    return [r for r in requests if r.error is None and r.t1 is not None]


def drive_traffic(server, make, traffic: dict, seed: int, seconds, warm: bool = False, log=None):
    """Start the mix's open loop on ``server`` at its fixed rate for
    ``seconds``; with ``warm``, its ``warmup_requests`` at that rate, on
    schedules and arrivals of their own. Returns (requests, a function that
    waits for every request sent, the start)."""
    if traffic["loop"] != "open":
        raise ValueError(f"unknown loop {traffic['loop']!r}: a mix offers load at a fixed rate")
    stream = (1 << 20) + 1 if warm else 0
    rate = float(traffic["rate"])
    due = drive.arrivals(traffic, int(traffic["warmup_requests"]) / rate if warm else seconds, seed, stream)
    done, sender, start, late = drive.open_loop(server, make, drive.Schedule(traffic, seed, stream), due,
                                                timeout=REQUEST_TIMEOUT_S)

    def finish():
        sender.join()
        for r in done:
            r.done.wait(REQUEST_TIMEOUT_S + 10.0)
        if late and log is not None:
            log(f"open loop: {len(due)} requests due at {rate} /s, sent up to {max(late) * 1e3:.3f} ms late")
    return done, finish, start


def warm_up(server, make, traffic: dict, templates: dict, seed: int) -> int:
    """Each template once alone (its cold run), then the mix's own warm-up
    load; returns the requests sent. A warm-up request that fails fails the run."""
    warm = drive.Schedule(traffic, seed, 1 << 20)
    seen = set()
    while len(seen) < len(templates):
        name, params = warm.next()
        if name not in seen:
            seen.add(name)
            server.submit(make(name, params), timeout=REQUEST_TIMEOUT_S).result()
    done, finish, _ = drive_traffic(server, make, traffic, seed, None, warm=True)
    finish()
    ok = answered(done)
    if len(ok) < len(done):
        raise RuntimeError(f"warm-up requests failed: {[r.error or 'no answer' for r in done if r not in ok][:3]}")
    return len(done) + len(templates)


def judge(dep, ctx, templates: dict, traffic: dict, requests, seed: int, log) -> dict:
    """The numbers that decide ``correct``: requests that failed or never
    came, sampled answers that differ from the reference outside the floats
    and the widest float gap, indexes whose rows are not their source's, and
    templates whose plan reads another index than configured."""
    import numpy as np

    t = time.perf_counter()
    bad_index = {k: v for k, v in verify.index_rows(dep).items() if v is not None}
    for k, v in bad_index.items():
        log(f"index {k}: {v}")
    bad_rewrite = 0
    draw = drive.Schedule(traffic, seed, 1 << 21)
    for name, tpl in templates.items():
        params = next(p for n, p in iter(draw.next, None) if n == name)
        got = verify.plan_indexes(ctx, tpl, params)
        if got != sorted(tpl.INDEXES):
            bad_rewrite += 1
            log(f"rewrite {name}: the plan reads {got}, the configuration names {list(tpl.INDEXES)}")
    ok = answered(requests)
    pick = np.random.default_rng([seed, 99]).permutation(len(ok))[:int(traffic["sample"])]
    columns = {name: t["columns"] for name, t in dep.tables.items()}
    states, memo, wrong, gap = {}, {}, 0, 0.0
    for i in sorted(pick):
        r = ok[i]
        ref, tpl = loader.reference(r.template), templates[r.template]
        if r.template not in states:
            states[r.template] = ref.prepare(columns)
        key = (r.template, json.dumps(r.params, sort_keys=True))
        if key not in memo:
            memo[key] = ref.answer(states[r.template], r.params, np.float64)
        why, g = verify.compare(r.result, memo[key], tpl.KEYS, tpl.ORDERED)
        gap = max(gap, g)
        if why is not None:
            wrong += 1
            log(f"answer {r.template} {r.params}: {why}")
    log(f"check: {len(pick)} sampled answers against the references, {len(dep.entries)} indexes, "
        f"{len(templates)} rewrites ({time.perf_counter() - t:.3f} s)")
    return {"missing": len(requests) - len(ok), "wrong_answers": wrong, "float_gap": gap,
            "index_rows": len(bad_index), "rewrite": bad_rewrite}


def traced_slice(slicer, dep, templates: dict, requests, log) -> dict:
    """The profiled slice, reduced, with the bytes its answered requests need
    (each template's ``bytes_once``) and the card's memory bandwidth."""
    import torch

    red = slicer.reduce()
    in_slice = [r for r in answered(requests) if slicer.t0 <= r.t1 <= slicer.t1]
    columns = {n: t["columns"] for n, t in dep.tables.items()}
    states, memo, nbytes = {}, {}, 0
    for r in in_slice:
        tpl = templates[r.template]
        if r.template not in states:
            states[r.template] = tpl.prepare(columns)
        key = (r.template, json.dumps(r.params, sort_keys=True))
        if key not in memo:
            memo[key] = tpl.bytes_once(states[r.template], r.params)
        nbytes += memo[key]
    log(f"slice {red['window_s']:.3f} s: device busy {red['busy_s']:.6f} s, {len(in_slice)} requests answered, "
        f"{nbytes} bytes once, trace {'aligned' if red['aligned'] else 'not aligned'}")
    return {**red, "requests": len(in_slice), "bytes": nbytes,
            "hbm_bytes_per_s": HBM_BYTES_PER_S.get(torch.cuda.get_device_name(0))}


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", cfg=None, traffic=None,
        log=None, bench=None):
    """One run of ``cell_name``; returns the result's dict (``checks``
    last). ``cfg`` and ``traffic`` replace the cell's configuration and mix
    (a test's small lake); ``log`` takes each line for standard error."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    bench = bench or loader.benchmark()
    cell = loader.cell(bench, cell_name)
    cfg = cfg or loader.config(cell["config"])
    traffic = traffic or loader.traffic(cell["traffic"])
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = str(v)
    cache_dirs(loader.ROOT)
    import torch

    if device == "cuda":
        require_cards(int(cell["chips"]))
    import hyperspace_tpu_torch as ht
    from hsbench.profile import DeviceSlice

    traced = trace and device == "cuda"
    tmp = tempfile.mkdtemp(prefix="hsbench-")
    server = None
    try:
        dep = deploy.build(cfg, seed, tmp, device)
        build_s = sum(dep.seconds["build"].values())
        ctx = deploy.Context(dep)
        templates = {name: loader.template(name) for name in traffic["block"]}

        def make(name, params):
            return templates[name].request(ctx, params)

        server = ht.QueryServer(dep.session, **cfg.get("server", {}))
        server.start()
        t = time.perf_counter()
        n_warm = warm_up(server, make, traffic, templates, seed)
        if device == "cuda":
            torch.cuda.synchronize()
        if traced:
            DeviceSlice.warm()
        warm_s = time.perf_counter() - t
        setup_s = time.perf_counter() - _T_START
        log(f"setup {setup_s:.3f} s: generate {dep.seconds['generate']:.3f} s, build {build_s:.3f} s "
            f"({', '.join(f'{k} {v:.3f}' for k, v in dep.seconds['build'].items())}), warm-up {warm_s:.3f} s "
            f"({n_warm} requests), the rest {setup_s - dep.seconds['generate'] - build_s - warm_s:.3f} s")

        # the window: the main thread reads the device's peak and starts and
        # stops the traced slice while the load runs
        r0 = readings(server, dep.session)
        peak = 0
        done, finish, t_start = drive_traffic(server, make, traffic, seed, seconds, log=log)
        t_end = t_start + seconds
        slicer = DeviceSlice(tmp) if traced else None
        slice_at, slice_len = t_start + SLICE_AT * seconds, min(seconds / 2, SLICE_MAX_S)
        while time.perf_counter() < t_end:
            now = time.perf_counter()
            if slicer is not None and slicer.t0 is None and now >= slice_at:
                slicer.start()
            elif slicer is not None and slicer.t1 is None and now >= slice_at + slice_len:
                slicer.stop()
            if device == "cuda":
                peak = max(peak, torch.cuda.max_memory_allocated())
            time.sleep(0.05)
        if slicer is not None and slicer.t1 is None:
            slicer.stop()
        finish()
        if device == "cuda":
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated())
        d = delta(readings(server, dep.session), r0)
        server.shutdown()
        server = None

        ok = answered(done)
        latencies = [(r.t1 - r.t0) * 1e3 for r in ok]
        in_window = sum(r.t1 <= t_end for r in ok)
        log(f"window {seconds:.3f} s: {len(done)} requests sent, {in_window} answered inside it, "
            f"{len(done) - len(ok)} failed; by template (answered, median ms): " + ", ".join(
                f"{n} {len(lat)} {percentile(lat, 50) if lat else float('nan'):.3f}"
                for n in templates for lat in [[(r.t1 - r.t0) * 1e3 for r in ok if r.template == n]]))
        if latencies:
            log(f"latency of all {len(latencies)} answered (ms): mean {sum(latencies) / len(latencies):.3f}, "
                f"p50 {percentile(latencies, 50):.3f}, p95 {percentile(latencies, 95):.3f}, max {max(latencies):.3f}")

        checks = judge(dep, ctx, templates, traffic, done, seed, log)
        sl = None
        if not trace:
            # every end-to-end reading the harness gives, so that a cell added later picks its own by data
            values = {"setup_s": setup_s, "qps": in_window / seconds,
                      "p50_ms": percentile(latencies, 50) if latencies else None,
                      "p95_ms": percentile(latencies, 95) if latencies else None}
        else:
            if slicer is not None:
                sl = traced_slice(slicer, dep, templates, done, log)
            log("stages (s, whole window): " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(d["stages"].items())))
            got = {"delta": d, "build_s": build_s, "slice": sl}
            values = {m["name"]: loader.metric(m["name"]).read(got)
                      for m in loader.metrics_of(bench, cell_name, "per_layer")}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in loader.metrics_of(bench, cell_name, "per_layer" if trace else "end_to_end")
                   if values.get(m["name"]) is not None}
        if device == "cuda":
            dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w()}
            if sl is not None:
                dev.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        result = {"correct": all(v <= verify.LIMITS[k] for k, v in checks.items()), "attempted": len(done),
                  "failed": len(done) - len(ok), "metrics": metrics, "device": dev}
        if sl is not None:
            result["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
        result["checks"] = {k: {"value": v, "limit": verify.LIMITS[k]} for k, v in checks.items()}
        return result
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"hsbench: no result: {e}", file=sys.stderr, flush=True)
        return NO_CARD
    loaded = guard.loaded_forbidden()
    if loaded:
        print(f"hsbench: no result: the process holds {loaded}", file=sys.stderr, flush=True)
        return FORBIDDEN_IMPORT
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
