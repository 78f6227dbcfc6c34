"""AST codebase lint: repo contracts and past-bug patterns as rules.

Each rule lives in :mod:`hyperspace_tpu_torch.check.rules` and receives a
:class:`LintContext` — parsed ASTs for every file in scope plus the doc
texts and the registered conf-key set — and returns Findings. The default
scope is the port's package tree plus its repo-root driver
(``chip_smoke.py``); tests and fixtures are deliberately outside it
(seeded-violation fixtures MUST fire when pointed at directly, and must not
fail the repo run). The docs the drift rules read (``docs/*.md`` and
``README.md``) are the ones the JAX package's lint reads too.

Suppression: a line containing ``# hscheck: disable=<rule>`` (or a bare
``# hscheck: disable``) suppresses findings anchored to that line — for the
rare site where the flagged pattern is the point (e.g. a lock whose purpose
is serializing file IO). Every suppression is visible in the diff, which is
the point.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from hyperspace_tpu_torch.check.findings import Finding

_PRAGMA = "# hscheck: disable"


def default_root() -> str:
    """The repo root: parent of the installed package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def default_paths(root: str) -> List[str]:
    """Lint scope: every package .py plus the repo-root driver script."""
    out: List[str] = []
    pkg = os.path.join(root, "hyperspace_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    for extra in ("chip_smoke.py",):
        p = os.path.join(root, extra)
        if os.path.exists(p):
            out.append(p)
    return out


@dataclass
class LintContext:
    root: str
    files: List[str]
    #: True when linting the whole default scope. The bidirectional doc-drift
    #: directions (registered-but-undocumented / documented-but-unregistered)
    #: only make sense against the full tree — on an explicit file list every
    #: documented family would look unregistered — so rules gate them on this.
    full_scope: bool = True
    _sources: Dict[str, str] = field(default_factory=dict)
    _asts: Dict[str, ast.Module] = field(default_factory=dict)
    _docs: Optional[Dict[str, str]] = None

    def source(self, path: str) -> str:
        got = self._sources.get(path)
        if got is None:
            with open(path, encoding="utf-8") as f:
                got = self._sources[path] = f.read()
        return got

    def ast_of(self, path: str) -> ast.Module:
        got = self._asts.get(path)
        if got is None:
            got = self._asts[path] = ast.parse(self.source(path), filename=path)
        return got

    def relpath(self, path: str) -> str:
        rel = os.path.relpath(path, self.root)
        return path if rel.startswith("..") else rel

    @property
    def docs(self) -> Dict[str, str]:
        """{repo-relative path: text} for every markdown doc the drift rules
        read (docs/*.md + README.md). Missing files read as empty."""
        if self._docs is None:
            self._docs = {}
            docs_dir = os.path.join(self.root, "docs")
            if os.path.isdir(docs_dir):
                for f in sorted(os.listdir(docs_dir)):
                    if f.endswith(".md"):
                        p = os.path.join(docs_dir, f)
                        with open(p, encoding="utf-8") as fh:
                            self._docs[os.path.join("docs", f)] = fh.read()
            readme = os.path.join(self.root, "README.md")
            if os.path.exists(readme):
                with open(readme, encoding="utf-8") as fh:
                    self._docs["README.md"] = fh.read()
        return self._docs

    def doc(self, rel: str) -> str:
        return self.docs.get(rel, "")

    @property
    def registered_conf_keys(self) -> set:
        from hyperspace_tpu_torch import config

        return {
            v
            for k, v in vars(config.keys).items()
            if not k.startswith("_") and isinstance(v, str)
        }

    def suppressed(self, path: str, line: int, rule: str) -> bool:
        if line <= 0:
            return False
        lines = self.source(path).splitlines()
        if line > len(lines):
            return False
        text = lines[line - 1]
        i = text.find(_PRAGMA)
        if i < 0:
            return False
        rest = text[i + len(_PRAGMA):].strip()
        if not rest.startswith("="):
            return True  # bare disable: everything on this line
        names = {n.strip() for n in rest[1:].split(",")}
        return rule in names


def run_lint(
    root: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run the named rules (default: all) over ``paths`` (default: the
    package scope) and return pragma-filtered findings sorted by location."""
    from hyperspace_tpu_torch.check.rules import all_rules

    root = root or default_root()
    file_list = [os.path.abspath(p) for p in paths] if paths else default_paths(root)
    ctx = LintContext(root=root, files=file_list, full_scope=paths is None)
    selected = all_rules()
    if rules:
        unknown = set(rules) - set(selected)
        if unknown:
            raise KeyError(f"unknown lint rules: {sorted(unknown)} (have: {sorted(selected)})")
        selected = {k: v for k, v in selected.items() if k in rules}
    findings: List[Finding] = []
    for name in sorted(selected):
        for f in selected[name].check(ctx):
            abspath = os.path.join(ctx.root, f.path)
            if os.path.exists(abspath) and ctx.suppressed(abspath, f.line, f.rule):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
