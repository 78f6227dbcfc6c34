"""The three examples in examples/ print through the port what they print
through the JAX package.

Each file runs twice in this process, its stdout captured: once as it is,
on the JAX package's CPU backend, and once with its text rewritten the way
tests/torch_mirror.py's ``load_cases`` rewrites a module (``hyperspace_tpu``
to ``hyperspace_tpu_torch``), its ``Session(...)`` given ``device="cpu"``,
and quickstart's block that pins JAX's platform left out (the port imports
no JAX). Each run makes its lake under a temporary directory of its own
(``tempfile.mkdtemp``); that root, and the random id in an index or Delta
file's name, are masked.

The two outputs must be equal line for line: plans, ``explain`` and
``whyNot`` text, index listings and seeded results. Tolerance: a printed
float may differ from the JAX package's only within rtol 1e-9 once parsed
(thousands separators dropped); every other character is equal.
"""

import contextlib
import glob
import io
import math
import os
import re
import tempfile

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402

pytestmark = pytest.mark.torch_port

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
FLOAT_RTOL = 1e-9
_JAX_PLATFORM_PIN = re.compile(r'\nif os\.environ\.get\("JAX_PLATFORMS".*?jax\.config\.update\([^)]*\)\n', re.S)
_FILE_ID = re.compile(r"-[0-9a-f]{12}\.parquet")
_FLOAT = re.compile(r"[-+]?\d[\d,]*\.\d+(?:[eE][-+]?\d+)?")


def port_text(text: str) -> str:
    """An example's text as the port runs it."""
    text = _JAX_PLATFORM_PIN.sub("\n", re.sub(r"\bhyperspace_tpu\b", "hyperspace_tpu_torch", text))
    assert "jax" not in text and text.count("hst.Session(") == 1
    return text.replace("hst.Session(", 'hst.Session(device="cpu", ')


def run_example(path: str, text: str, tmp: str, monkeypatch) -> str:
    """``text`` run as ``__main__`` with its temporary files under ``tmp``:
    its stdout, the root it made and the random file ids masked."""
    os.makedirs(tmp)
    monkeypatch.setattr(tempfile, "tempdir", tmp)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(text, path, "exec"), {"__name__": "__main__", "__file__": path})
    finally:
        hst.set_session(None)
        ht.set_session(None)
    (root,) = os.listdir(tmp)
    return _FILE_ID.sub("-<id>.parquet", out.getvalue().replace(os.path.join(tmp, root), "<root>"))


def assert_same_output(got: str, want: str) -> None:
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for a, b in zip(got_lines, want_lines):
        assert _FLOAT.sub("<float>", a) == _FLOAT.sub("<float>", b), (a, b)
        for x, y in zip(_FLOAT.findall(a), _FLOAT.findall(b)):
            assert math.isclose(float(x.replace(",", "")), float(y.replace(",", "")), rel_tol=FLOAT_RTOL,
                                abs_tol=0.0), (a, b)


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in glob.glob(os.path.join(EXAMPLES, "*.py"))))
def test_example_prints_what_the_jax_package_prints(name, tmp_path, monkeypatch):
    path = os.path.abspath(os.path.join(EXAMPLES, name))
    with open(path, encoding="utf-8") as f:
        text = f.read()
    want = run_example(path, text, str(tmp_path / "jax"), monkeypatch)
    got = run_example(path, port_text(text), str(tmp_path / "port"), monkeypatch)
    assert want.strip()
    assert_same_output(got, want)
