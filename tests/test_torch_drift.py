"""The port's verbatim copies of the JAX package's device-free modules.

Sixty-seven modules of ``hyperspace_tpu_torch/`` are copies of their
counterparts in ``hyperspace_tpu/`` with only the package name rewritten
(and, in ``models/path_resolver.py``, one ``typing`` import fewer, since the
copy does not use ``Optional``; in ``serving/fingerprint.py``, a ``Scan``'s
token carries its file listing, ROADMAP C8), and the port builds its native decoder
from byte-identical copies of ``native/hs_native.cc`` and
``native/thrift_compact.h`` in ``hyperspace_tpu_torch/csrc/``. This test
compares the texts, so a change to either side that is not made to the
other fails here. It also holds that every module of the JAX package has
a port at the same path or a reason in ``NO_PORT``. It reads files only
and imports nothing of either package.
"""

import os
import re

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: module path -> {reference line: the copy's line, or its lines joined by
#: newlines} beyond the package rename
COPIES = {
    "actions/maintenance.py": {},
    "analysis/__init__.py": {},
    "analysis/explain.py": {},
    "analysis/reasons.py": {},
    "analysis/why_not.py": {},
    "check/locks.py": {},
    "obs/metrics.py": {},
    "reliability/__init__.py": {},
    "reliability/degrade.py": {},
    "reliability/errors.py": {},
    "reliability/faults.py": {},
    "utils/lru.py": {},
    "hyperspace.py": {},
    "plan/resolver.py": {},
    "rules/dataskipping_rule.py": {},
    "actions/optimize.py": {},
    "actions/refresh.py": {},
    "models/data_manager.py": {},
    "models/states.py": {},
    "obs/spans.py": {},
    "plan/decorrelate.py": {},
    "plan/expr.py": {},
    "plan/logical.py": {},
    "plan/ordering.py": {},
    "plan/sql.py": {},
    "indexes/registry.py": {},
    "sources/default.py": {},
    "sources/delta.py": {},
    "sources/formats.py": {},
    "sources/iceberg.py": {},
    "sources/partitions.py": {},
    "sources/signatures.py": {},
    "stats.py": {},
    "utils/avro.py": {},
    "utils/hashing.py": {},
    "version.py": {},
    "models/path_resolver.py": {"from typing import List, Optional": "from typing import List"},
    "fabric/records.py": {},
    "lifecycle/__init__.py": {},
    "lifecycle/refresh_manager.py": {},
    "lifecycle/snapshot.py": {},
    "obs/history.py": {},
    "obs/profile.py": {},
    "obs/slo.py": {},
    "serving/__init__.py": {},
    "serving/admission.py": {},
    "serving/batcher.py": {},
    "serving/bucket_cache.py": {},
    "serving/build_cache.py": {},
    # C8, repaired in the port only: a Scan's token carries its file listing
    "serving/fingerprint.py": {
        "        return f\"Scan[{rel.name};{rel.file_format};{','.join(plan.output_columns)}]\", env": (
            "        return f\"Scan[{rel.name};{rel.file_format};{','.join(plan.output_columns)};"
            "{_listing_token(rel)}]\", env"),
        "def _canon_plan(plan: L.LogicalPlan, st: _Canon, exact: bool = False) -> Tuple[str, Dict[str, str]]:": (
            "def _listing_token(rel) -> str:\n"
            '    """A source relation\'s file listing (path, size, mtime) as a token, so a\n'
            "    scan over a new listing binds a new template (ROADMAP C8). A listing\n"
            "    that cannot be read gives its error's name; the query raises when it\n"
            '    runs."""\n'
            "    try:\n"
            "        return rel.signature()\n"
            "    except OSError as e:\n"
            "        return type(e).__name__\n"
            "\n"
            "\n"
            "def _canon_plan(plan: L.LogicalPlan, st: _Canon, exact: bool = False) -> Tuple[str, Dict[str, str]]:"),
    },
    "serving/metrics.py": {},
    "serving/plan_cache.py": {},
    "serving/result_cache.py": {},
    "serving/scheduler.py": {},
    "serving/server.py": {},
    "fabric/__init__.py": {},
    "fabric/coherence.py": {},
    "fabric/frontdoor.py": {},
    "fabric/fsck.py": {},
    "fabric/health.py": {},
    "fabric/lease.py": {},
    "fabric/watcher.py": {},
    "fsck.py": {},
    "obs/__init__.py": {},
    "obs/export.py": {},
    "lifecycle/invalidation.py": {},
    "models/log_manager.py": {},
}


def _read(package: str, module: str) -> list:
    with open(os.path.join(REPO, package, module), encoding="utf-8") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_matches_reference(module):
    rewrite = COPIES[module]
    expected = [out for line in _read("hyperspace_tpu", module)
                for out in rewrite.get(line, re.sub(r"\bhyperspace_tpu\b", "hyperspace_tpu_torch", line)).split("\n")]
    got = _read("hyperspace_tpu_torch", module)
    assert got == expected, f"{module} drifted from hyperspace_tpu/{module}"


@pytest.mark.parametrize("source", ["hs_native.cc", "thrift_compact.h"])
def test_native_source_matches_reference(source):
    with open(os.path.join(REPO, "native", source), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "hyperspace_tpu_torch", "csrc", source), "rb") as f:
        assert f.read() == want, f"hyperspace_tpu_torch/csrc/{source} drifted from native/{source}"


#: reference modules with no port, each with its reason
NO_PORT = {
    "parallel/hlo_check.py": "reads an XLA program's compiled HLO text; a torch program has none",
    "utils/x64.py": "JAX's x64 switch; torch has 64-bit types without one",
    "check/": "static analysis, ROADMAP A11 (only check/locks.py is ported)",
}


def _modules(package: str) -> set:
    root = os.path.join(REPO, package)
    out = set()
    for dirpath, dirs, names in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        out.update(os.path.relpath(os.path.join(dirpath, n), root) for n in names if n.endswith(".py"))
    return out


def test_every_reference_module_has_a_port_or_a_reason():
    """Each module of ``hyperspace_tpu/`` has its counterpart at the same
    path in ``hyperspace_tpu_torch/`` (``parallel/`` and
    ``ops/bucketize.py`` among them), or is named in ``NO_PORT`` with its
    reason; no reason names a module that has a port."""
    ref, port = _modules("hyperspace_tpu"), _modules("hyperspace_tpu_torch")
    missing = {m for m in ref - port if not any(m == k or (k.endswith("/") and m.startswith(k)) for k in NO_PORT)}
    assert not missing, sorted(missing)
    assert not {k for k in NO_PORT if not k.endswith("/") and k in port}
    for module in ("parallel/__init__.py", "parallel/mesh.py", "parallel/executor.py", "parallel/collectives.py",
                   "parallel/distributed.py", "ops/bucketize.py"):
        assert module in port, module
