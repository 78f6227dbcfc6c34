"""The port's verbatim copies of the JAX package's device-free modules.

Sixty-seven modules of ``hyperspace_tpu_torch/`` are copies of their
counterparts in ``hyperspace_tpu/`` with only the package name rewritten
(and, in ``models/path_resolver.py``, one ``typing`` import fewer, since the
copy does not use ``Optional``), and the port builds its native decoder
from byte-identical copies of ``native/hs_native.cc`` and
``native/thrift_compact.h`` in ``hyperspace_tpu_torch/csrc/``. This test
compares the texts, so a change to either side that is not made to the
other fails here. It reads files only and imports nothing of either
package.
"""

import os
import re

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: module path -> {reference line: the copy's line} beyond the package rename
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
    "serving/fingerprint.py": {},
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
    expected = [rewrite.get(line, re.sub(r"\bhyperspace_tpu\b", "hyperspace_tpu_torch", line))
                for line in _read("hyperspace_tpu", module)]
    got = _read("hyperspace_tpu_torch", module)
    assert got == expected, f"{module} drifted from hyperspace_tpu/{module}"


@pytest.mark.parametrize("source", ["hs_native.cc", "thrift_compact.h"])
def test_native_source_matches_reference(source):
    with open(os.path.join(REPO, "native", source), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "hyperspace_tpu_torch", "csrc", source), "rb") as f:
        assert f.read() == want, f"hyperspace_tpu_torch/csrc/{source} drifted from native/{source}"
