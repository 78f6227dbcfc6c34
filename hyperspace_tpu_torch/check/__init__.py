"""``hyperspace_tpu_torch.check`` — static codebase-invariant analysis,
device-program contracts and the lock-order watcher.

- :mod:`hyperspace_tpu_torch.check.lint` + :mod:`hyperspace_tpu_torch.check.rules`
  — the JAX package's eleven AST rules (conf-key and metric-family drift
  against the shared docs, lock-hold blocking calls, dropped cache-branding
  kwargs, snapshot pins, swallowed IO errors, process-local state, dropped
  trace context, uncounted native fallbacks; ``jit-purity`` and
  ``donated-buffer-reuse`` find nothing in a tree without ``jax.jit``),
  scoped to the port's tree and ``chip_smoke.py``. CLI:
  ``python -m hyperspace_tpu_torch.check`` (nonzero exit on findings).
- :mod:`hyperspace_tpu_torch.check.program_lint` — device-program contracts,
  the counterpart of the JAX package's ``check/hlo_lint.py``: each program
  family declares its collective budget and forbidden patterns next to its
  builder, and behind ``hyperspace.check.hlo.enabled`` one live call of each
  new program is recorded (its aten ops and collectives) and verified.
- :mod:`hyperspace_tpu_torch.check.locks` — the runtime lock-order watcher
  (``hyperspace.check.locks``), a verbatim copy of the JAX package's.

This ``__init__`` stays import-light on purpose: ``session.py`` imports the
lock watcher at construction time, and pulling the AST lint (ast parsing of
the whole tree) into that path would tax every session start.
"""

from __future__ import annotations

__all__ = ["Finding"]

from hyperspace_tpu_torch.check.findings import Finding
