"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over the
device, a sampler of what the program's threads are doing on the host, and
their reduction to the device's busy time, the operations that took the
most of it and the longest idle gaps with what the host did in each."""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

#: chrome-trace categories of work on the device itself
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PACKAGE = "hyperspace_tpu_torch"
#: frames of a thread that waits for work rather than doing it
WAITING = {("serving/admission.py", "take"), ("serving/admission.py", "take_nowait")}


def _label(frame):
    """The innermost frame of the port on a thread's stack, as
    ``<module path>:<function>``; None if the thread is outside the port or
    waits for work."""
    while frame is not None:
        path = frame.f_code.co_filename
        i = path.rfind(PACKAGE + os.sep)
        if i >= 0:
            rel = path[i + len(PACKAGE) + 1:].replace(os.sep, "/")
            if (rel, frame.f_code.co_name) in WAITING:
                return None
            return f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    return None


class HostSampler:
    """Samples every ``interval`` seconds which port function each thread
    is in: [(perf_counter, [label, ...])]."""

    def __init__(self, interval: float = 0.002):
        self.interval = interval
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="hsbench-sampler", daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.is_set():
            now = time.perf_counter()
            labels = [lab for tid, f in sys._current_frames().items()
                      if tid != me and (lab := _label(f)) is not None]
            self.samples.append((now, labels))
            self._stop.wait(self.interval)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()


class DeviceSlice:
    """``torch.profiler`` over the device between ``start`` and ``stop``,
    with a host sampler beside it; ``reduce`` reads the trace."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.sampler = HostSampler()
        self.prof = None
        self.t0 = self.t1 = self.anchor = None

    @staticmethod
    def warm():
        """A short profile, so that the tracer's start-up stays out of the slice."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.sampler.start()
        self.t0 = time.perf_counter()
        # a marker launch: its runtime call's timestamp ties the trace's
        # clock to the host's
        self.anchor = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self):
        self.t1 = time.perf_counter()
        self.sampler.stop()
        self.prof.stop()

    def reduce(self) -> dict:
        """{busy_s, window_s, device_ops, idle_gaps, aligned}: the union of
        the device's kernel, copy and set intervals inside the slice, the
        slice's length, the ten operations with the most device time, and the
        ten longest gaps in the union, each named by the port function the
        host's threads were sampled in most during it."""
        path = os.path.join(self.tmp, "hsbench-trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        os.remove(path)
        offset = None  # trace microseconds minus host microseconds
        spin = [e for e in events if e.get("cat") == "kernel" and "spin" in e.get("name", "")]
        if spin:
            corr = spin[0].get("args", {}).get("correlation")
            launch = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e.get("args", {}).get("correlation") == corr]
            if launch:
                offset = float(launch[0]["ts"]) - self.anchor * 1e6
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                     for e in events if e.get("cat") in DEVICE_CATEGORIES and "spin" not in e.get("name", ""))
        if offset is not None:
            lo, hi = self.t0 * 1e6 + offset, self.t1 * 1e6 + offset
        elif dev:  # not aligned: the slice's length from the first device operation the profiler saw
            lo = dev[0][0]
            hi = lo + (self.t1 - self.t0) * 1e6
        else:
            return {"busy_s": 0.0, "window_s": self.t1 - self.t0, "device_ops": [], "idle_gaps": [], "aligned": False}
        busy, end, gaps, by_name = 0.0, lo, [], collections.Counter()
        for a, b, name in dev:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            by_name[name] += (b - a) / 1e6
            if a > end:
                gaps.append((end, a))
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            if offset is None:
                named.append(["host (trace not aligned)", (b - a) / 1e6])
                continue
            ha, hb = (a - offset) / 1e6, (b - offset) / 1e6
            seen = collections.Counter(lab for t, labels in self.sampler.samples if ha <= t <= hb for lab in labels)
            named.append([seen.most_common(1)[0][0] if seen else "no port thread busy", (b - a) / 1e6])
        return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
                "device_ops": [[n, s] for n, s in by_name.most_common(10)], "idle_gaps": named,
                "aligned": offset is not None}
