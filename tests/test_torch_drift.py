"""The port's verbatim copies of the JAX package's device-free modules.

Fifty-five modules of ``hyperspace_tpu_torch/`` are copies of their
counterparts in ``hyperspace_tpu/`` with only the package name rewritten
(and, in ``models/path_resolver.py``, one ``typing`` import fewer, since the
copy does not use ``Optional``; in ``serving/server.py``, the telemetry
endpoint's import raises instead, since ``obs/export.py`` is not in the
port; in ``lifecycle/refresh_manager.py``, the refresh lease's import
raises instead and its docstring says so, since ``fabric/lease.py`` is not
in the port), and the port builds its native decoder
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
    "lifecycle/refresh_manager.py": {
        "  rather than double-build; with ``hyperspace.fabric.lease.enabled`` the":
            "  rather than double-build; the reference's cross-process lease with",
        "  same guarantee extends across *processes* via a lake-persisted lease with":
            "  heartbeat renewal and a fencing token verified at the commit point",
        "  heartbeat renewal and a fencing token verified at the commit point":
            "  (``fabric/lease.py``) is not yet in the port: under",
        "  (``fabric/lease.py``) — a holder killed mid-refresh is taken over by a":
            "  ``hyperspace.fabric.lease.enabled`` (and the fabric) a refresh raises",
        "  peer after lease expiry, and its late commit is fenced off;":
            "  ``NotImplementedError``, and no commit is fenced;",
        "        per index (``fabric/lease.py``) when the fabric + lease conf is on.":
            "        per index (``fabric/lease.py``, not yet in the port) under that conf.",
        "        from hyperspace_tpu.fabric import lease as lease_mod": (
            '        raise NotImplementedError("hyperspace.fabric.lease.enabled: the refresh lease '
            '(fabric/lease.py) is not yet in the port")'),
        "                    from hyperspace_tpu.fabric.lease import LeaseLostError":
            "                    LeaseLostError = ()  # the lease (fabric/lease.py) is not yet in the port",
    },
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
    "serving/server.py": {
        "            from hyperspace_tpu.obs.export import TelemetryEndpoint": (
            '            raise NotImplementedError("hyperspace.obs.http.port: the telemetry endpoint '
            '(obs/export.py) is not yet in the port")'),
    },
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
