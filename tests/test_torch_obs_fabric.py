"""The port's distributed observability across the serving fabric, held to
the JAX package's suite.

tests/test_obs_fabric.py runs with the package renamed to the port
(tests/torch_mirror.py ``load_cases``), its sessions the port's on the CPU
(``torch_mirror.cpu_port``): trace-context propagation over FrontDoor
hops, cross-process span stitching, byte-identical wire format when
disabled, federated profile and SLO merging, per-node staleness gauges,
build identity in every exposition, and the device-program timing hooks.

Rewritten for the port: ``TestDeviceProgramTiming::test_observe_program_metrics_and_span_event``
holds the port's ``_observe_program(family, clock)`` over a
``program_clock(None)`` (wall time, as on the CPU; two calls: two
observations in ``hs_device_program_seconds`` and two ``device-program``
span events) and loses its compile half: the port's eager programs compile
nothing, so it has no ``_note_compile``, no
``hs_device_compile_seconds_total`` and no "(compile)" mark.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.obs, pytest.mark.fabric]

HERE = os.path.dirname(__file__)
SOURCES = {
    "test_obs_fabric.py": {
        **M.CPU_PORT_IMPORT,
        # the port's timing hook: no compile to note or to count
        "        from hyperspace_tpu_torch.exec.device import _note_compile, _observe_program\n": (
            "        from hyperspace_tpu_torch.exec.device import _observe_program, program_clock\n"),
        "        assert _note_compile(family, sig) is True  # first sight compiles\n"
        "        assert _note_compile(family, sig) is False\n": "",
        "            t0 = time.perf_counter()\n"
        "            _observe_program(family, True, t0)\n"
        "            _observe_program(family, False, t0)\n": (
            "            t0 = program_clock(None)\n"
            "            _observe_program(family, t0)\n"
            "            _observe_program(family, t0)\n"),
        "        total = REGISTRY.counter(\"hs_device_compile_seconds_total\", program=family)\n"
        "        assert total.value > 0.0  # only the first-seen call contributed\n": "",
        "        assert any(\"(compile)\" in detail for _, detail in events)\n": (
            "        assert not any(\"(compile)\" in detail for _, detail in events)\n"),
    },
}
LEFT_OUT = {}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    """The suite's session: the port's, on the CPU."""
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: tmp_system_path}, device="cpu")
    ht.set_session(sess)
    yield sess
    ht.set_session(None)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)
