"""The import guard: no module of JAX, of the JAX package or of the repo's
older benchmarks may be loaded in a run's process. Names are compared by
their top level (the part before the first dot), whole, so the port
(``hyperspace_tpu_torch``) passes though its name begins with the JAX
package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hyperspace_tpu", "benchmarks", "bench", "chip_smoke"})
#: what a plain reference may import: the standard library and these
REFERENCE_ALLOWED = frozenset({"numpy", "pandas", "pyarrow"})


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def reference_imports(source: str) -> set:
    """The top-level names a reference module's source imports."""
    import ast

    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else (node.module or "").split(".", 1)[0])
    return out


def reference_import_violations(source: str) -> set:
    """What a reference imports beyond the standard library, numpy, pandas
    and pyarrow (a relative import counts as a violation)."""
    return {m for m in reference_imports(source) if m not in REFERENCE_ALLOWED and m not in sys.stdlib_module_names}
