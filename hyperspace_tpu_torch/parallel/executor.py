"""ShardedExecutor: the conf-gated entry point of the mesh-sharded path.

The port of ``hyperspace_tpu/parallel/executor.py``, less its three
forwarding methods (``filter_mask``, ``grouped_aggregate``,
``grouped_stream``), which nothing calls. One instance per (session, mesh
shape): it holds the 1-D mesh the sharded programs run over and is
threaded, as the ``parallel=`` argument, through the device filter, the
grouped aggregate, the top-k and the lineage filter, which then run the
sharded programs of parallel/collectives.py.

Gating (``ShardedExecutor.maybe``): ``hyperspace.parallel.enabled`` is the
default-off master switch; off, ``maybe`` returns None and every caller
takes the single-device path. The mesh spans
``hyperspace.parallel.mesh.devices`` devices, or with 0 is the session's
mesh (``Session.mesh``: every local device, a 1-device mesh on the one
H100; ``Session.set_mesh`` replaces it); chunks below
``hyperspace.parallel.minRows`` rows stay on the single-device path.

On the CPU the mesh has ``parallel.mesh.SHARD_COUNT`` shards of the CPU
device (the port's tests set 8), the counterpart of the JAX package's
``--xla_force_host_platform_device_count=8``.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from hyperspace_tpu_torch.parallel.mesh import make_mesh, mesh_fingerprint


class ShardedExecutor:
    """Holds the execution mesh and the sharded path's metrics."""

    def __init__(self, session, mesh=None):
        conf = session.conf
        if mesh is None:
            n = conf.parallel_mesh_devices
            mesh = session.mesh if n <= 0 else make_mesh(n, axis=conf.mesh_axis, device_type=session.device.type)
        self.session = session
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.fingerprint = mesh_fingerprint(mesh)
        # decode buffers pad to this mesh's shard count (exec/io.py)
        from hyperspace_tpu_torch.exec import io as _io

        _io.set_staging_pad(mesh.size)
        self.min_rows = conf.parallel_min_rows
        from hyperspace_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.gauge(
            "hs_mesh_devices",
            "Devices in the sharded-execution mesh (0 when the parallel path is off)",
        ).set(mesh.size)

    # -- gating ---------------------------------------------------------------

    @classmethod
    def maybe(cls, session) -> Optional["ShardedExecutor"]:
        """The session's executor, or None when ``hyperspace.parallel.enabled``
        is off. Memoized on the session per mesh-shaping conf, so repeated
        queries reuse one mesh."""
        conf = session.conf
        if not conf.parallel_enabled:
            return None
        key = (conf.parallel_mesh_devices, conf.mesh_axis, id(session.mesh))
        cached = getattr(session, "_parallel_executor", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        px = cls(session)
        session._parallel_executor = (key, px)
        return px

    def rows_ok(self, n_rows: int) -> bool:
        return n_rows >= self.min_rows

    # -- metrics --------------------------------------------------------------

    def note_op(self, op: str) -> None:
        from hyperspace_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.counter(
            "hs_mesh_sharded_ops_total",
            "Operations executed through the mesh-sharded path",
            op=op,
        ).inc()

    def timed_call(self, op: str, fn, *args):
        """Run one sharded program to its end, as the JAX package's
        ``block_until_ready`` does, and add its time (the per-shard programs
        and the merge of their gathered tables) to
        ``hs_mesh_collective_seconds_total``: CUDA events on the mesh's
        first device, whose stream the merge ends on, else wall time."""
        from hyperspace_tpu_torch.obs.metrics import REGISTRY

        self.note_op(op)
        dev = self.mesh.device_of(0)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            out = fn(*args)
            end.record(torch.cuda.current_stream(dev))
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            out = fn(*args)
            seconds = time.perf_counter() - t0
        REGISTRY.counter(
            "hs_mesh_collective_seconds_total",
            "Cumulative time of sharded programs incl. collective merges (seconds)",
        ).inc(seconds)
        return out
