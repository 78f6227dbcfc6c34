"""The port's verbatim copies of the JAX package's device-free modules.

Eighty-two modules of ``hyperspace_tpu_torch/`` are copies of their
counterparts in ``hyperspace_tpu/`` with only the package name rewritten
(and, in ``models/path_resolver.py``, one ``typing`` import fewer, since the
copy does not use ``Optional``; in ``serving/fingerprint.py``, a ``Scan``'s
token carries its file listing, ROADMAP C8; in five modules of ``check/``,
the lint's scope and the differences named beside them in ``COPIES``), and
the port builds its native decoder from byte-identical copies of
``native/hs_native.cc`` and ``native/thrift_compact.h`` in
``hyperspace_tpu_torch/csrc/``. This test compares the texts, so a change
to either side that is not made to the other fails here. It also holds
that every module of the JAX package has a port at the same path, at the
path ``RENAMED`` gives (``check/hlo_lint.py``: ``check/program_lint.py``),
or a reason in ``NO_PORT``. It reads files only and imports nothing of
either package.
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
    # static analysis: the lint, its rules and its result type; the rules
    # scope themselves to ``hyperspace_tpu_torch`` through the rename
    "check/findings.py": {},
    "check/rules/cache_branding.py": {},
    "check/rules/conf_keys.py": {},
    "check/rules/donated_buffer_reuse.py": {},
    "check/rules/io_error_swallow.py": {},
    "check/rules/lock_blocking.py": {},
    "check/rules/native_fallback.py": {},
    "check/rules/process_local_state.py": {},
    "check/rules/snapshot_pin.py": {},
    "check/rules/trace_context_drop.py": {},
    # the lint's scope is the port's tree and its driver, chip_smoke.py
    "check/lint.py": {
        'scope is the package tree plus the repo-root drivers (``bench.py``,':
            ("scope is the port's package tree plus its repo-root driver\n"
             '(``chip_smoke.py``); tests and fixtures are deliberately outside it'),
        '``__graft_entry__.py``); tests and fixtures are deliberately outside it':
            None,
        'fail the repo run).':
            ('fail the repo run). The docs the drift rules read (``docs/*.md`` and\n'
             "``README.md``) are the ones the JAX package's lint reads too."),
        '    """Lint scope: every package .py plus the repo-root driver scripts."""':
            '    """Lint scope: every package .py plus the repo-root driver script."""',
        '    for extra in ("bench.py", "__graft_entry__.py"):':
            '    for extra in ("chip_smoke.py",):',
    },
    # the CLI's docstring names the port's caller of main()
    'check/__main__.py': {
        '``run-tests`` invokes it before pytest, and ``--json`` emits a':
            ("``chip_smoke.py``'s ``check`` phase calls :func:`main` and requires 0, and\n"
             '``--json`` emits a machine-readable findings array for tooling.'),
        'machine-readable findings array for tooling.':
            None,
    },
    # the rules are imported by name: the port loads no module from a string
    'check/rules/__init__.py': {
        'defining ``RULE = Rule(...)``, and listing it in :data:`_RULE_MODULES` —':
            ('defining ``RULE = Rule(...)``, and listing it in :data:`_RULE_MODULES` and\n'
             "in :func:`all_rules`'s imports —"),
        'import importlib':
            None,
        'def all_rules() -> Dict[str, Rule]:':
            ('def all_rules() -> Dict[str, Rule]:\n'
             '    # imported by name, not through importlib: the port loads no module\n'
             '    # from a string (tests/test_torch_isolation.py). Each import binds its\n'
             "    # submodule in this package's namespace.\n"
             '    from hyperspace_tpu_torch.check.rules import (  # noqa: F401\n'
             '        cache_branding,\n'
             '        conf_keys,\n'
             '        donated_buffer_reuse,\n'
             '        io_error_swallow,\n'
             '        jit_purity,\n'
             '        lock_blocking,\n'
             '        metric_families,\n'
             '        native_fallback,\n'
             '        process_local_state,\n'
             '        snapshot_pin,\n'
             '        trace_context_drop,\n'
             '    )\n'
             ''),
        '        m = importlib.import_module(f"hyperspace_tpu.check.rules.{mod}")':
            '        rule = globals()[mod].RULE',
        '        rule = m.RULE':
            None,
    },
    # "jax.jit" as name parts: the port names no module of JAX as a dotted
    # string
    'check/rules/jit_purity.py': {
        'def _is_jit_decorator(dec: ast.AST) -> bool:':
            ('# ``jit`` and ``jax.jit``, as name parts: the port names no module of JAX\n'
             '# as a dotted string (tests/test_torch_isolation.py)\n'
             '_JIT_NAMES = {("jit",), ("jax", "jit")}\n'
             '\n'
             '\n'
             'def _is_jit_name(dotted: Optional[str]) -> bool:\n'
             '    return dotted is not None and tuple(dotted.split(".")) in _JIT_NAMES\n'
             '\n'
             '\n'
             'def _is_jit_decorator(dec: ast.AST) -> bool:'),
        '    if dotted in ("jit", "jax.jit"):':
            '    if _is_jit_name(dotted):',
        '        if callee in ("jit", "jax.jit"):':
            '        if _is_jit_name(callee):',
        '            return _dotted(dec.args[0]) in ("jit", "jax.jit")':
            '            return _is_jit_name(_dotted(dec.args[0]))',
    },
    # the two XLA compile families the shared docs list have no subject in
    # the port
    'check/rules/metric_families.py': {
        '   base family).':
            '   base family), except the families in :data:`NO_SUBJECT`.',
        '_REGISTRY_RECV = re.compile(r"registry|reg$", re.IGNORECASE)':
            ('_REGISTRY_RECV = re.compile(r"registry|reg$", re.IGNORECASE)\n'
             '\n'
             '#: families docs/observability.md documents for the JAX package that have no\n'
             '#: subject in the port, each with its reason; direction 3 skips them\n'
             'NO_SUBJECT = {\n'
             '    "hs_device_compile_seconds_total": (\n'
             '        "wall seconds of compiling program invocations; the port compiles no "\n'
             '        "program: its device programs are eager torch programs"\n'
             '    ),\n'
             '    "hs_xla_compiles_total": "XLA executable compilations; the port has no XLA",\n'
             '}'),
        '    for fam in sorted(doc_base - fams):':
            '    for fam in sorted(doc_base - fams - set(NO_SUBJECT)):',
    },
}


def _read(package: str, module: str) -> list:
    with open(os.path.join(REPO, package, module), encoding="utf-8") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_matches_reference(module):
    rewrite = COPIES[module]
    expected = [out for line in _read("hyperspace_tpu", module)
                if rewrite.get(line, "") is not None  # None: a line the copy drops
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
    "parallel/hlo_check.py": (
        "a shim re-exporting HLO-text helpers (hlo_text_of and the like); the port has no HLO text, "
        "and the counterparts live in check/program_lint.py"),
    "utils/x64.py": "JAX's x64 switch; torch has 64-bit types without one",
}

#: reference modules whose port lives at another path
RENAMED = {
    # program contracts over a torch program's recorded dispatch, not its HLO
    "check/hlo_lint.py": "check/program_lint.py",
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
    ``ops/bucketize.py`` among them) or at its ``RENAMED`` path, or is named
    in ``NO_PORT`` with its reason; no reason names a module that has a
    port."""
    ref, port = _modules("hyperspace_tpu"), _modules("hyperspace_tpu_torch")
    missing = {m for m in ref - port
               if not any(m == k or (k.endswith("/") and m.startswith(k)) for k in NO_PORT)
               and RENAMED.get(m) not in port}
    assert not missing, sorted(missing)
    assert not {k for k in NO_PORT if not k.endswith("/") and k in port}
    assert not {k for k in RENAMED if k in port}
    for module in ("parallel/__init__.py", "parallel/mesh.py", "parallel/executor.py", "parallel/collectives.py",
                   "parallel/distributed.py", "ops/bucketize.py"):
        assert module in port, module
