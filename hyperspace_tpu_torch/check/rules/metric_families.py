"""``metric-families``: every ``hs_*`` metric family is literal and
documented — bidirectionally.

The observability contract (docs/observability.md's family table, PR 5's
drift test) only works if registration sites are statically findable: a
family name built at runtime (``REGISTRY.counter(f"hs_{kind}_total")``)
escapes the drift check and the docs. Three directions:

1. every ``counter``/``gauge``/``histogram`` registration call on a registry
   must pass a LITERAL family name,
2. every literal ``hs_*`` family registered in code must appear in
   docs/observability.md,
3. every ``hs_*`` token in docs/observability.md must have a registration
   site (``_bucket``/``_sum``/``_count`` histogram series document their
   base family), except the families in :data:`NO_SUBJECT`.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set, Tuple

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "metric-families"

_REGISTRY_RECV = re.compile(r"registry|reg$", re.IGNORECASE)

#: families docs/observability.md documents for the JAX package that have no
#: subject in the port, each with its reason; direction 3 skips them
NO_SUBJECT = {
    "hs_device_compile_seconds_total": (
        "wall seconds of compiling program invocations; the port compiles no "
        "program: its device programs are eager torch programs"
    ),
    "hs_xla_compiles_total": "XLA executable compilations; the port has no XLA",
}


def _registration_calls(tree: ast.Module):
    """(line, literal-or-None) for every instrument-factory call on a
    registry-looking receiver (``REGISTRY.counter``, ``self.registry.gauge``,
    ``reg.histogram``)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in ("counter", "gauge", "histogram")):
            continue
        recv = fn.value
        recv_name = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else None
        )
        if recv_name is None or not _REGISTRY_RECV.search(recv_name):
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            yield node.lineno, arg.value
        else:
            yield node.lineno, None


def registered_families(ctx) -> Set[str]:
    """Every literal hs_* family name at a registration site in scope."""
    fams: Set[str] = set()
    for path in ctx.files:
        for _, name in _registration_calls(ctx.ast_of(path)):
            if name is not None and name.startswith("hs_"):
                fams.add(name)
    return fams


def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    fams: Set[str] = set()
    dynamic: List[Tuple[str, int]] = []
    for path in ctx.files:
        for line, name in _registration_calls(ctx.ast_of(path)):
            if name is None:
                dynamic.append((path, line))
            elif name.startswith("hs_"):
                fams.add(name)

    # 1. dynamic family names defeat drift checking
    for path, line in dynamic:
        findings.append(
            Finding(
                rule=NAME,
                path=ctx.relpath(path),
                line=line,
                message="metric family name must be a string literal (dynamic names escape the docs drift check)",
            )
        )

    if not ctx.full_scope:
        return findings  # drift directions need the whole tree in scope

    obs_doc = ctx.doc("docs/observability.md")
    doc_tokens = set(re.findall(r"\bhs_[a-z0-9_]+[a-z0-9]", obs_doc))
    doc_base = {
        re.sub(r"_(bucket|sum|count)$", "", t)
        if re.sub(r"_(bucket|sum|count)$", "", t) in fams
        else t
        for t in doc_tokens
    }

    # 2. registered -> documented
    for fam in sorted(fams - doc_base):
        findings.append(
            Finding(
                rule=NAME,
                path="docs/observability.md",
                line=0,
                message=f"metric family {fam!r} is registered in code but missing from the docs family table",
            )
        )
    # 3. documented -> registered
    for fam in sorted(doc_base - fams - set(NO_SUBJECT)):
        findings.append(
            Finding(
                rule=NAME,
                path="docs/observability.md",
                line=0,
                message=f"docs document metric family {fam!r} which no code registers",
            )
        )
    return findings


RULE = Rule(name=NAME, doc=__doc__.strip(), check=check)
