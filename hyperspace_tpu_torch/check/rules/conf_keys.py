"""``conf-keys``: every ``hyperspace.*`` conf key is registered and
documented — bidirectionally.

The repo's contract (docs/configuration.md, ``config.keys``) is that the
key namespace is CLOSED: a typo'd ``conf.get("hyperspace.serving.quueDepth")``
silently returns the fallback default forever. Three directions:

1. every ``conf.get/set/unset("hyperspace.…")`` string literal in code must
   be a key registered in ``config.keys``,
2. every registered key must appear (backticked) in docs/configuration.md,
3. every backticked ``hyperspace.…`` token in the docs/README must be a
   registered key (wildcard families like ``hyperspace.serving.*`` and bare
   namespace prefixes are fine).
"""

from __future__ import annotations

import ast
import re
from typing import List

from hyperspace_tpu_torch.check.findings import Finding
from hyperspace_tpu_torch.check.rules import Rule

NAME = "conf-keys"

_DOC_TOKEN = re.compile(r"`(hyperspace\.[A-Za-z0-9_.*]+)`")


def _literal_conf_calls(tree: ast.Module):
    """(line, key) for every conf.get/set/unset call with a literal
    hyperspace.* first argument. The receiver must be named ``conf`` (bare,
    ``self.conf``, ``session.conf``, …) so dict ``.get`` calls don't match."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in ("get", "set", "unset")):
            continue
        recv = fn.value
        recv_name = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else None
        )
        if recv_name not in ("conf", "_conf"):
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and arg.value.startswith("hyperspace."):
            yield node.lineno, arg.value


def check(ctx) -> List[Finding]:
    registered = ctx.registered_conf_keys
    findings: List[Finding] = []

    # 1. code literals -> registry
    for path in ctx.files:
        if path.endswith("config.py") and "hyperspace_tpu_torch" in path:
            continue  # the registry itself
        for line, key in _literal_conf_calls(ctx.ast_of(path)):
            if key not in registered:
                findings.append(
                    Finding(
                        rule=NAME,
                        path=ctx.relpath(path),
                        line=line,
                        message=f"conf key literal {key!r} is not registered in config.keys",
                    )
                )

    if not ctx.full_scope:
        return findings  # doc-drift directions need the whole tree in scope

    # 2. registry -> docs/configuration.md
    conf_doc = ctx.doc("docs/configuration.md")
    for key in sorted(registered):
        if f"`{key}`" not in conf_doc:
            findings.append(
                Finding(
                    rule=NAME,
                    path="docs/configuration.md",
                    line=0,
                    message=f"registered conf key {key!r} is not documented",
                )
            )

    # 3. docs -> registry
    for rel, text in sorted(ctx.docs.items()):
        for m in _DOC_TOKEN.finditer(text):
            token = m.group(1)
            if "*" in token:
                continue  # a documented family, e.g. hyperspace.serving.*
            if token in registered:
                continue
            # bare namespace prefix of some registered key ("the
            # hyperspace.obs keys") reads as prose, not a phantom key
            if any(k.startswith(token + ".") for k in registered):
                continue
            line = text.count("\n", 0, m.start()) + 1
            findings.append(
                Finding(
                    rule=NAME,
                    path=rel,
                    line=line,
                    message=f"doc mentions conf key {token!r} which is not registered in config.keys",
                )
            )
    return findings


RULE = Rule(
    name=NAME,
    doc=__doc__.strip(),
    check=check,
)
