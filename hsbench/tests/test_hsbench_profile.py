"""The traced slice's reduction on a hand-made trace: the device's busy
time as a union of intervals, the operations by time, the idle gaps and
the host function each is named by, with and without the clock marker."""

import json

import pytest

from hsbench.profile import DeviceSlice, _label


class FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def kernel(name, ts, dur, corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def make_slice(tmp_path, events, samples):
    s = DeviceSlice(str(tmp_path))
    # the host clock: the slice ran from 10.0 s to 10.01 s; the marker was launched at 10.0 s
    s.t0, s.t1, s.anchor = 10.0, 10.01, 10.0
    s.prof = FakeProfile(events)
    s.sampler.samples = samples
    return s


def test_busy_union_ops_and_named_gaps(tmp_path):
    # the trace's clock runs 1 000 000 us ahead of the host's (in microseconds)
    base = 10.0 * 1e6 + 1_000_000
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": base, "dur": 1, "args": {"correlation": 7}},
        kernel("spin_kernel", base + 1, 1, corr=7),
        kernel("a", base + 1000, 2000),          # 1 ms .. 3 ms
        kernel("b", base + 2000, 2000),          # overlaps a: union 1 ms .. 4 ms
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": base + 6000, "dur": 1000},  # 6 .. 7 ms
    ]
    # the host was decoding between 4 and 6 ms, and masking after 7 ms
    samples = [(10.0045, ["exec/io.py:decode"]), (10.0055, ["exec/io.py:decode"]), (10.008, ["exec/batch.py:mask"])]
    out = make_slice(tmp_path, events, samples).reduce()
    assert out["aligned"]
    assert out["busy_s"] == pytest.approx(0.004)
    assert out["window_s"] == pytest.approx(0.01)
    assert [n for n, _ in out["device_ops"]] == ["a", "b", "Memcpy HtoD"]
    assert out["idle_gaps"][0] == ["exec/batch.py:mask", pytest.approx(0.003)]
    assert out["idle_gaps"][1] == ["exec/io.py:decode", pytest.approx(0.002)]
    assert out["idle_gaps"][2] == ["no port thread busy", pytest.approx(0.001)]


def test_without_the_marker_the_slice_keeps_its_length(tmp_path):
    events = [kernel("a", 5000, 1000), kernel("b", 8000, 1000)]
    out = make_slice(tmp_path, events, []).reduce()
    assert not out["aligned"]
    assert out["busy_s"] == pytest.approx(0.002) and out["window_s"] == pytest.approx(0.01)
    assert all(name == "host (trace not aligned)" for name, _ in out["idle_gaps"])


def test_the_host_label_is_the_innermost_port_frame():
    import sys

    assert _label(sys._getframe()) is None  # a test's frame is outside the port
