"""Isolation of the PyTorch/CUDA port from the JAX package.

The port runs in a GPU process that must never load JAX, so no module of
``hyperspace_tpu_torch/`` — nor ``chip_smoke.py`` — may import ``jax`` or
anything of ``hyperspace_tpu``. The scan is static because this test
process already imports jax (tests/conftest.py). The port also must not
touch CUDA at import, and must not run anywhere but the GPU unless the
caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hyperspace_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build outputs, not sources
        out.extend(os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py"))
    return out


def _forbidden(module: str) -> bool:
    # importlib: a class named by a conf shared with the JAX package could
    # load that package at run time, so the port imports nothing by name
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "hyperspace_tpu", "importlib")


def test_port_has_sources():
    sources = _port_sources()
    assert len(sources) > 20
    assert os.path.exists(os.path.join(PORT, "csrc", "bucket_histogram.cu"))
    assert os.path.exists(os.path.join(PORT, "csrc", "segmented_min_max.cu"))


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad.extend(a.name for a in node.names if _forbidden(a.name))
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Name) and node.id == "__import__":
            bad.append("__import__")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # dotted names handed to importlib (conf class names) count too
            if node.value.startswith(("jax.", "hyperspace_tpu.")):
                bad.append(node.value)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_does_not_initialize_cuda_or_load_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import hyperspace_tpu_torch, hyperspace_tpu_torch.ops.sort, hyperspace_tpu_torch.ops.kernels\n"
        "import hyperspace_tpu_torch.indexes.covering, hyperspace_tpu_torch.indexes.dataskipping\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized(), 'import initialized CUDA'\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'hyperspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_native_loader_names_no_path_of_the_jax_package():
    """The port's native binding builds and loads its own library from
    ``hyperspace_tpu_torch/csrc/`` into ``hyperspace_tpu_torch/_build/``: its
    source names nothing under ``hyperspace_tpu/`` (nor the JAX package's
    ``native/`` build), and a process that uses it maps only the port's
    library."""
    import re

    with open(os.path.join(PORT, "native", "__init__.py"), encoding="utf-8") as f:
        text = f.read()
    assert re.search(r"hyperspace_tpu(?!_torch)", text) is None
    assert "libhs_native.so" not in text and "Makefile" not in text
    from hyperspace_tpu_torch import native

    assert native.CSRC_DIR == os.path.join(PORT, "csrc") and native.BUILD_DIR == os.path.join(PORT, "_build")
    assert native.library_path().startswith(native.BUILD_DIR + os.sep)
    code = (
        "from hyperspace_tpu_torch import native\n"
        "ok = native.is_available()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'hyperspace_tpu/native' not in maps, 'loaded the JAX package library'\n"
        "assert not ok or native.library_path() in maps\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_sql_front_end_imports_without_jax_or_cuda():
    """The SQL front end (``plan/sql.py`` and what it imports: the
    expressions, decorrelation, the span tracer) loads neither JAX nor the
    JAX package, and starts no CUDA context."""
    code = (
        "import sys\n"
        "import hyperspace_tpu_torch.plan.sql, hyperspace_tpu_torch.plan.decorrelate\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized(), 'import initialized CUDA'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hyperspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_serving_runtime_imports_without_jax_or_cuda():
    """The serving runtime and what it builds on (``serving/``,
    ``lifecycle/``, ``obs/``, ``fabric/``, ``telemetry/``) load neither JAX
    nor the JAX package, and start no CUDA context."""
    code = (
        "import sys\n"
        "import hyperspace_tpu_torch.serving, hyperspace_tpu_torch.serving.server\n"
        "import hyperspace_tpu_torch.serving.build_cache, hyperspace_tpu_torch.serving.batcher\n"
        "import hyperspace_tpu_torch.lifecycle, hyperspace_tpu_torch.lifecycle.refresh_manager\n"
        "import hyperspace_tpu_torch.obs, hyperspace_tpu_torch.obs.history, hyperspace_tpu_torch.obs.slo\n"
        "import hyperspace_tpu_torch.fabric, hyperspace_tpu_torch.telemetry.events\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized(), 'import initialized CUDA'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hyperspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_session_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.Session()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.Session(device="cuda")
    assert ht.Session(device="cpu").device == torch.device("cpu")


def test_session_takes_the_cuda_device_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ht.Session().device == torch.device("cuda")
    with pytest.raises(ValueError):
        ht.Session(device="mps")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """``chip_smoke.py`` prints no result and exits non-zero where there is
    no CUDA device, and where the port is not beside it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8").read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
