"""The port's lock watcher, expression semantics, caches under pressure and
cross-process concurrency, held to the JAX package's suites.

Four suites run with the package renamed to the port (tests/torch_mirror.py
``load_cases``):

- test_check_locks.py: the lock-order watcher (``check/locks.py``) and the
  serving caches' named locks;
- test_advice_semantics.py: three-valued ``IN``, HALF_UP rounding,
  ``substr`` and NULL-preserving projection (``plan/expr.py``); its
  sessions are ``MirroredSession``s, so each query is also held against
  the JAX package (the same rows, the same optimized plan);
- test_cache_pressure.py: the device, IO and rank caches
  (``BytesLRU``) shrunk far below an index working set; the rank cache
  is the port's ``exec/join.py::_RANK_CACHE`` (the JAX package keeps it in
  ``exec/device.py``);
- test_process_concurrency.py: four processes race ``create_index`` on one
  operation log, with the port's own child script
  (``torch_mirror.child_scripts``, which imports neither ``jax`` nor
  ``hyperspace_tpu`` and builds CPU sessions).

Sessions are the port's on the CPU. Nothing is left out (``LEFT_OUT`` is
empty).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
SOURCES = {
    "test_check_locks.py": {},
    "test_advice_semantics.py": {},
    "test_cache_pressure.py": {
        **M.CPU_PORT_IMPORT,
        # the port keeps the rank cache beside the join
        '    monkeypatch.setattr(D, "_RANK_CACHE", rank)\n': (
            "    from hyperspace_tpu_torch.exec import join as _join\n\n"
            '    monkeypatch.setattr(_join, "_RANK_CACHE", rank)\n'),
    },
    "test_process_concurrency.py": dict(M.CPU_PORT_IMPORT),
}
MIRRORED = {"test_advice_semantics.py"}
LEFT_OUT = {}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _src, _mod in zip(SOURCES, _modules):
    for _name, _text in M.child_scripts(os.path.join(HERE, _src)).items():
        setattr(_mod, _name, _text)
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(request, tmp_system_path):
    """The suites' session: the port's on the CPU; for
    test_advice_semantics.py a ``MirroredSession`` under ``mirroring``."""
    src = os.path.basename(getattr(request.function, "__code__").co_filename)
    if src in MIRRORED:
        with M.mirroring():
            sess = M.MirroredSession(tmp_system_path)
            ht.set_session(sess)
            yield sess
    else:
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
