"""Build and load the port's hand-written CUDA kernels.

Each source in ``hyperspace_tpu_torch/csrc/`` holds one kernel and a plain C
launcher. At first use ``nvcc`` compiles every source for Hopper
(``sm_90a``) into a shared library under ``hyperspace_tpu_torch/_build/``,
one ``nvcc`` process per source, all started together; ``ctypes`` loads the
result. A library's file name carries a digest of its source and flags, so
an edited source is never served by a stale build. A failed build raises:
nothing falls back to the plain versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("bucket_histogram.cu", "segmented_min_max.cu")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: compiler output (registers, shared memory, spills) of the builds this process ran
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled at first use and need the "
            "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
        )
    return path


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}-{digest}.so")


def build_all() -> Dict[str, str]:
    """Compile every source without a current library, all in parallel.
    Returns ``{source: library path}``; raises with the compiler output if
    any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    libs = {s: library_path(s) for s in SOURCES}
    nvcc = None
    running = []
    for source, lib in libs.items():
        if os.path.exists(lib):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        log, _ = proc.communicate()
        build_logs[source] = log
        if proc.returncode != 0:
            failed.append(f"--- {source} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building every kernel on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build_all()[source])
            lib.hs_error_string.argtypes = [ctypes.c_int]
            lib.hs_error_string.restype = ctypes.c_char_p
            _loaded[source] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}: {lib.hs_error_string(code).decode()}")
