"""Mesh-sharded execution: mesh helpers and the sharded programs.

The port of ``hyperspace_tpu/parallel/``. Eagerly exported: the mesh and
placement helpers. ``ShardedExecutor`` and the collectives load lazily:
they import ``exec/device.py``'s program machinery, which a caller of a
bare ``make_mesh`` should not pay for.

Left out: ``hlo_check.py`` and its four names (``assert_collectives``,
``assert_shuffle_free``, ``collective_counts``, ``hlo_text_of``). They read
the compiled HLO text of an XLA program, and a torch program has none;
``mesh.collective_calls`` and ``mesh.collective_entries`` count what the
sharded programs' collectives move instead.
"""

from hyperspace_tpu_torch.parallel.mesh import (
    DEFAULT_AXIS,
    Mesh,
    ShardedTensor,
    device_of_bucket,
    make_mesh,
    make_mesh_2d,
    mesh_fingerprint,
    replicated,
    sharded,
    sharded_2d,
)

__all__ = [
    "DEFAULT_AXIS",
    "Mesh",
    "ShardedExecutor",
    "ShardedTensor",
    "device_of_bucket",
    "make_mesh",
    "make_mesh_2d",
    "mesh_fingerprint",
    "replicated",
    "sharded",
    "sharded_2d",
]


def __getattr__(name):
    if name == "ShardedExecutor":
        from hyperspace_tpu_torch.parallel.executor import ShardedExecutor

        return ShardedExecutor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
