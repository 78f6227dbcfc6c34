"""The JAX package's docs suite run against the port.

tests/test_docs.py's four checks run with the package renamed to the port
(tests/torch_mirror.py): every key of the port's ``config.keys`` is
documented in the unchanged docs/configuration.md, the port's ``DEFAULTS``
appear there, every ``hs_*`` family registered under
``hyperspace_tpu_torch/`` is documented in docs/observability.md, and the
doc files the code names exist.

One rewrite: docs/observability.md documents two XLA compile families
(``hs_xla_compiles_total``, ``hs_device_compile_seconds_total``) that have
no subject in the port, whose device programs are eager torch programs.
They are the port's documented families without a subject
(``check/rules/metric_families.py::NO_SUBJECT``), and the drift check
subtracts them; the case below holds that they are exactly the families
the docs name and the port does not register. No case is left out.
"""

import os

import pytest

import torch_mirror as M

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
REWRITES = {
    "    phantom = sorted(doc_base - code)\n": (
        "    from hyperspace_tpu_torch.check.rules.metric_families import NO_SUBJECT\n\n"
        "    phantom = sorted(doc_base - code - set(NO_SUBJECT))\n"),
}
LEFT_OUT = {}

_suite = M.load_cases(os.path.join(HERE, "test_docs.py"), "_torch_test_docs_suite", rewrites=REWRITES)
M.export_cases(_suite, globals(), LEFT_OUT)


def test_every_case_is_run_or_listed():
    M.assert_every_case([_suite], globals(), LEFT_OUT)


def test_families_without_a_subject_are_documented_and_unregistered():
    """``NO_SUBJECT`` names exactly the documented families the port never
    registers, and the JAX package registers each of them."""
    import re

    import test_docs as jax_docs
    from hyperspace_tpu_torch.check.rules.metric_families import NO_SUBJECT

    port, jax = _suite._registered_metric_families(), jax_docs._registered_metric_families()
    doc = set()
    for f in re.findall(r"\bhs_[a-z0-9_]+[a-z0-9]", open(_suite.OBS_DOCS).read()):
        base = re.sub(r"_(bucket|sum|count)$", "", f)
        doc.add(base if base in port | jax else f)
    assert set(NO_SUBJECT) == doc - port
    assert set(NO_SUBJECT) <= jax
