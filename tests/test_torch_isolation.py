"""Isolation of the PyTorch/CUDA port from the JAX package.

The port runs in a GPU process that must never load JAX, so no module of
``hyperspace_tpu_torch/`` — nor ``chip_smoke.py`` — may import ``jax`` or
anything of ``hyperspace_tpu``, and neither may the child-process scripts
that the port's tests start (``torch_mirror.child_scripts``). The scan is
static because this test process already imports jax (tests/conftest.py). The port also must not
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


def _bad_imports(text: str, filename: str) -> list:
    tree = ast.parse(text, filename=filename)
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
    return bad


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as f:
        bad = _bad_imports(f.read(), path)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def _child_scripts():
    import torch_mirror as M

    out = []
    for suite in ("test_fabric.py", "test_process_concurrency.py"):
        for name, text in sorted(M.child_scripts(os.path.join(REPO, "tests", suite)).items()):
            out.append(pytest.param(text, id=f"{suite}::{name}"))
    return out


@pytest.mark.parametrize("text", _child_scripts())
def test_child_scripts_import_neither_jax_nor_the_jax_package(text):
    """Each child-process script the port's tests run (the JAX suites'
    scripts, rewritten by ``torch_mirror.port_child_script``) imports
    neither ``jax`` nor ``hyperspace_tpu``, names JAX nowhere, and builds
    its sessions on the CPU."""
    assert not _bad_imports(text, "<child>")
    assert "jax" not in text.lower()
    assert "hst.Session = _CpuSession" in text


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
        "import hyperspace_tpu_torch.fabric.frontdoor, hyperspace_tpu_torch.fabric.lease\n"
        "import hyperspace_tpu_torch.fabric.watcher, hyperspace_tpu_torch.fabric.coherence\n"
        "import hyperspace_tpu_torch.fabric.health, hyperspace_tpu_torch.fabric.fsck\n"
        "import hyperspace_tpu_torch.obs.export, hyperspace_tpu_torch.fsck\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized(), 'import initialized CUDA'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hyperspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_sharded_path_imports_without_jax_or_cuda():
    """The sharded path (``parallel/``, ``ops/bucketize.py``) loads neither
    JAX nor the JAX package, starts no CUDA context and no process group,
    and a CPU session's mesh needs no card."""
    code = (
        "import sys\n"
        "import hyperspace_tpu_torch as ht\n"
        "import hyperspace_tpu_torch.parallel, hyperspace_tpu_torch.parallel.executor\n"
        "import hyperspace_tpu_torch.parallel.collectives, hyperspace_tpu_torch.parallel.distributed\n"
        "import hyperspace_tpu_torch.ops.bucketize\n"
        "import torch, torch.distributed as dist\n"
        "mesh = ht.Session(device='cpu').mesh\n"
        "assert mesh.size == 1 and str(mesh.device_of(0)) == 'cpu', mesh\n"
        "assert not torch.cuda.is_initialized(), 'import initialized CUDA'\n"
        "assert not dist.is_initialized(), 'a process group started'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hyperspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("HS_")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_static_analysis_imports_without_jax_or_cuda():
    """The lint, its eleven rules and the program contracts
    (``check/rules/``, ``check/program_lint.py``) load neither JAX nor the
    JAX package and start no CUDA context, and ``python -m
    hyperspace_tpu_torch.check`` lints the port's tree clean in such a
    process."""
    code = (
        "import runpy, sys\n"
        "import hyperspace_tpu_torch.check, hyperspace_tpu_torch.check.lint\n"
        "import hyperspace_tpu_torch.check.program_lint\n"
        "from hyperspace_tpu_torch.check.rules import all_rules\n"
        "assert len(all_rules()) == 11\n"
        "sys.argv = ['hyperspace_tpu_torch.check']\n"
        "try:\n"
        "    runpy.run_module('hyperspace_tpu_torch.check', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
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


def test_fsck_module_runs_without_jax(tmp_path):
    """``python -m hyperspace_tpu_torch.fsck <system path>`` runs in a
    process that loads neither JAX nor the JAX package, and prints its JSON
    report."""
    import json

    code = (
        "import runpy, sys\n"
        "sys.argv = ['hyperspace_tpu_torch.fsck', sys.argv[1]]\n"
        "try:\n"
        "    runpy.run_module('hyperspace_tpu_torch.fsck', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hyperspace_tpu'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    report = json.loads(r.stdout)
    assert report["systemPath"] == str(tmp_path)


def test_chip_smoke_fabric_worker_imports_only_the_port():
    """The fabric worker that ``chip_smoke.py`` starts on the card
    (``FABRIC_WORKER``, run with ``python -c``) imports neither ``jax`` nor
    ``hyperspace_tpu``, and takes its device from the parent."""
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    scripts = [node.value.value for node in tree.body
               if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "FABRIC_WORKER" for t in node.targets)]
    assert len(scripts) == 1
    assert not _bad_imports(scripts[0], "<FABRIC_WORKER>")
    assert "jax" not in scripts[0].lower()
    assert 'device=cfg["device"]' in scripts[0]
