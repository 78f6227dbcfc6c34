"""The JAX package's device-execution suites run through the port, each
query also held against the JAX package (tests/torch_mirror.py): the same
plans, the same rows in the same order.

tests/test_device_exec.py (the device filter, the bucketed join and its
device materialization, hybrid, composite-key and outer bucketed joins, the
fused aggregate over a join) and tests/test_group_agg.py (the grouped
aggregate against the host oracle, streamed, its fallbacks and the pruned
scan's cache brand) run with the package renamed to the port, their
``session`` a ``MirroredSession`` on the CPU. Moved names:

- the JAX package keeps the bucketed join's and the aggregate's internals
  in ``exec/device.py``; the port keeps them in ``exec/join.py``
  (``device_bucketed_join``, ``host_bucketed_join``, ``join_sides_compatible``,
  ``_expand_join_pairs``, ``_device_materialize_inner``, ``_composite_ranks``,
  ``aggregate_over_bucketed_join``, ...) and ``exec/aggregate.py``. The
  suite's ``D`` is ``torch_mirror.ModuleUnion`` over the three modules, and
  its ``monkeypatch`` targets name the module that holds each function;
- ``REGISTRY`` reads go to the port's counters (``torch_mirror.PORT_REGISTRY``).

Found here (ROADMAP.md §C): C6, ``host_bucketed_join`` and
``device_bucketed_join`` required the ``compat`` and ``setup`` arguments
that the JAX package's compute when left out
(``TestDeviceJoin::test_host_bucketed_join_matches_device_and_pandas``);
C7, the port's ``BytesLRU`` had no ``keys()``
(``test_join_input_device_cache_reuses_and_invalidates``,
``test_materialize_byte_budget_routes_to_host_expansion``).

Nothing is left out: ``test_group_agg.py::TestStreaming::test_streamed_equals_materialized_and_host``
reads ``hs_agg_groups_total`` and ``hs_agg_merge_seconds_total``, which
the port's registry now counts (``torch_mirror.PORT_REGISTRY`` hands such
names to it), and ``TestServingBatchedAggregate`` runs the serving
batcher, ported with the serving runtime.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(__file__)
_UNION = (
    "import torch_mirror as _mirror\n"
    "D = _mirror.ModuleUnion('hyperspace_tpu_torch.exec.device', 'hyperspace_tpu_torch.exec.join',\n"
    "                        'hyperspace_tpu_torch.exec.aggregate')\n"
)
SOURCES = {
    "test_device_exec.py": {
        # the function-local imports use the module-level union
        "        from hyperspace_tpu_torch.exec import device as D\n": "",
        "\nfrom hyperspace_tpu_torch.exec import device as D\n": "\n" + _UNION,
        "from hyperspace_tpu_torch.exec.device import _expand_join_pairs": (
            "from hyperspace_tpu_torch.exec.join import _expand_join_pairs"),
        '"hyperspace_tpu_torch.exec.device._device_materialize_inner"': (
            '"hyperspace_tpu_torch.exec.join._device_materialize_inner"'),
        '"hyperspace_tpu_torch.exec.device.device_bucketed_join"': (
            '"hyperspace_tpu_torch.exec.join.device_bucketed_join"'),
    },
    "test_group_agg.py": {
        "from hyperspace_tpu_torch.obs.metrics import REGISTRY": "from torch_mirror import PORT_REGISTRY as REGISTRY",
    },
}
LEFT_OUT = {}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _mod in _modules:
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture(autouse=True)
def _mirrored():
    with M.mirroring():
        yield
    ht.set_session(None)


@pytest.fixture()
def session(tmp_system_path):
    sess = M.MirroredSession(tmp_system_path)
    ht.set_session(sess)
    yield sess


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)
