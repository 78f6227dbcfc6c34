"""Device meshes: bucket id == device shard.

The port of ``hyperspace_tpu/parallel/mesh.py``. The JAX package's mesh is a
``jax.sharding.Mesh``: one process drives every device of it, and a sharded
array holds one block of rows per device. Here a :class:`Mesh` is an ordered
grid of ``torch.device`` entries with axis names, and a :class:`ShardedTensor`
holds one tensor per shard, on that shard's device. Bucket ``b`` lives on
shard ``b % n_shards``, so a bucketed join needs no collective, and
re-bucketing is one all-to-all (ops/bucketize.py).

``make_mesh`` and ``make_mesh_2d`` build on the card unless the caller asks
for the CPU, as ``Session`` does: by default they span
``torch.cuda.device_count()`` cards and raise when no CUDA device is
present; ``device_type="cpu"`` spans ``SHARD_COUNT`` shards of the CPU
device, the counterpart of the JAX package's
``--xla_force_host_platform_device_count`` (1 by default; the port's tests
set 8). Both also take an explicit device list, which may repeat a device:
a 4-shard mesh (or a 2 x 2 ``("dcn", "ici")`` one) on ``cuda:0`` runs every
per-shard program, the gather and the exchanges on one card. That is test
scaffolding, like the JAX package's virtual CPU devices; no conf key
reaches it.

Inside one process the collectives are copies between the shards' tensors
(``all_gather``: a concatenation of fixed-size per-shard tables; ``all_to_all``:
a transpose of the staged per-destination slots, one copy per pair of
distinct devices). Across processes (a 2-D mesh whose ``dcn`` axis is the
process boundary, parallel/distributed.py) the ``dcn`` exchange goes through
``torch.distributed.all_to_all_single``: gloo on the CPU, NCCL across cards.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_AXIS = "buckets"

#: shards of a CPU mesh: the port's counterpart of the JAX package's
#: ``--xla_force_host_platform_device_count`` (the port's tests set 8)
SHARD_COUNT = 1

#: collective calls per (kind, axis) since the last ``reset_collectives()``;
#: ``("all_to_all", "dcn", "process")`` counts the exchanges that cross a
#: process boundary
collective_calls: collections.Counter = collections.Counter()
#: entries each collective moved per (kind, axis), summed over tables
collective_entries: collections.Counter = collections.Counter()


def reset_collectives() -> None:
    collective_calls.clear()
    collective_entries.clear()


#: this thread's collective listener: the list a recording program window
#: (check/program_lint.py) appends ``(op, axis)`` to. Per thread, because
#: pipeline threads run programs concurrently and ``collective_calls`` is
#: the process's total.
_listener = threading.local()


@contextlib.contextmanager
def listening_collectives(sink: list):
    """Append ``(op, axis)`` to ``sink`` for each collective this thread
    calls inside the block (op names as in the JAX package's HLO:
    ``all-gather``, ``all-to-all``)."""
    prev = getattr(_listener, "sink", None)
    _listener.sink = sink
    try:
        yield sink
    finally:
        _listener.sink = prev


def _heard(op: str, axis: str) -> None:
    sink = getattr(_listener, "sink", None)
    if sink is not None:
        sink.append((op, axis))


class Mesh:
    """An ordered grid of devices with one name per axis.

    ``devices`` is an object array of ``torch.device`` (shape ``(n,)`` for a
    1-D mesh, ``(slices, per_slice)`` for a 2-D ``("dcn", "ici")`` one); the
    global shard order is row-major, as in the JAX package. In a
    multi-process mesh each process drives the shards of its own slice
    (``process_index``); the others' entries only hold the grid's shape."""

    def __init__(self, devices, axis_names: Sequence[str], process_index: int = 0, process_count: int = 1):
        grid = np.empty(np.shape(devices)[:len(axis_names)], dtype=object)
        for idx in np.ndindex(grid.shape):
            sub = devices
            for i in idx:
                sub = sub[i]
            grid[idx] = torch.device(sub)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_shards(self) -> List[int]:
        """Global shard indices this process drives (every shard of a
        single-process mesh; the ``process_index``-th slice of a
        multi-process 2-D mesh)."""
        if self.process_count == 1:
            return list(range(self.size))
        per = self.devices.shape[-1]
        lo = self.process_index * per
        return list(range(lo, lo + per))

    def device_of(self, shard: int) -> torch.device:
        return self.devices.flat[shard]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _local_devices(devices, device_type: Optional[str]) -> List[torch.device]:
    """The shards a mesh may span: ``devices`` when given (repeats allowed),
    else every card, or ``SHARD_COUNT`` CPU shards for ``device_type="cpu"``.
    Raises, as ``session.resolve_device`` does, when the card is asked for
    or implied and none is present: a mesh never falls back to the CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    from hyperspace_tpu_torch.session import resolve_device

    if resolve_device(device_type).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * max(1, int(SHARD_COUNT))


def make_mesh(n_devices: Optional[int] = None, axis: str = DEFAULT_AXIS, *, devices=None,
              device_type: Optional[str] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices (all by default):
    every card, or ``SHARD_COUNT`` CPU shards for ``device_type="cpu"``.
    ``devices`` names the shards explicitly and may repeat a device.

    Raises ``ValueError`` when the request oversubscribes the host: a
    silently truncated mesh would shard programs across fewer devices than
    the caller planned capacity for."""
    avail = _local_devices(devices, device_type)
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if n_devices > len(avail):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(avail)} "
                f"devices are available ({avail[0].type}); on the CPU, raise the "
                "count with hyperspace_tpu_torch.parallel.mesh.SHARD_COUNT"
            )
        avail = avail[:n_devices]
    if not avail:
        raise ValueError("no device is available for a mesh")
    return Mesh(avail, (axis,))


def make_mesh_2d(n_slices: Optional[int] = None, per_slice: Optional[int] = None, *, devices=None,
                 device_type: Optional[str] = None) -> Mesh:
    """2-D ``("dcn", "ici")`` mesh: ``ici`` spans the shards of one slice (one
    process), ``dcn`` the slices. In a multi-process world
    (parallel/distributed.py) the slice count defaults to the world size and
    each process's local devices form its own slice, so the hierarchical
    exchange crosses the process boundary once per row. ``devices`` and
    ``device_type`` pick the local devices as in ``make_mesh``."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    local = _local_devices(devices, device_type)
    if n_slices is None:
        n_slices = max(1, world)
    if world > 1:
        if n_slices != world:
            raise ValueError(f"a {world}-process mesh has {world} slices, not {n_slices}")
        per_slice = len(local) if per_slice is None else per_slice
        if per_slice > len(local):
            raise ValueError(
                f"requested {n_slices}x{per_slice} mesh but only {len(local)} devices are available per process"
            )
        grid = [local[:per_slice] for _ in range(n_slices)]
        return Mesh(grid, ("dcn", "ici"), process_index=rank, process_count=world)
    if per_slice is None:
        if len(local) % n_slices:
            raise ValueError(
                f"{len(local)} devices do not divide evenly into {n_slices} slices; pass per_slice explicitly"
            )
        per_slice = len(local) // n_slices
    if n_slices * per_slice > len(local):
        raise ValueError(f"requested {n_slices}x{per_slice} mesh but only {len(local)} devices are available")
    flat = local[: n_slices * per_slice]
    return Mesh([flat[s * per_slice:(s + 1) * per_slice] for s in range(n_slices)], ("dcn", "ici"))


def mesh_fingerprint(mesh: Mesh) -> str:
    """Stable identity of a mesh: device type, grid shape and axis names
    (``cuda:4:buckets``), as the JAX package's."""
    first = next(iter(mesh.devices.flat), None)
    platform = getattr(first, "type", "none")
    shape = "x".join(str(s) for s in mesh.devices.shape)
    return f"{platform}:{shape}:{','.join(mesh.axis_names)}"


def device_of_bucket(bucket: int, n_devices: int) -> int:
    return bucket % n_devices


# --------------------------------------------------------------------------
# placements and sharded tensors
# --------------------------------------------------------------------------


def row_blocks(n: int, n_shards: int) -> List[tuple]:
    """``[lo, hi)`` row range of each shard when ``n`` rows split into
    ``n_shards`` contiguous blocks of ``ceil(n / n_shards)`` rows (the last
    blocks shorter, or empty)."""
    per = -(-n // n_shards) if n_shards else 0
    return [(min(d * per, n), min((d + 1) * per, n)) for d in range(n_shards)]


def shard_rows(t: torch.Tensor, mesh: Mesh, n: Optional[int] = None) -> List[torch.Tensor]:
    """The row blocks of ``t``'s first ``n`` rows, each on its shard's
    device: views where the shard's device is ``t``'s, else one copy."""
    n = t.shape[0] if n is None else n
    return [t[lo:hi].to(mesh.device_of(d), non_blocking=True)
            for d, (lo, hi) in enumerate(row_blocks(n, mesh.size))]


class ShardedTensor:
    """One tensor per shard of a mesh (the shards this process drives), in
    global shard order: the port's counterpart of a ``jax.Array`` placed
    with a sharded or replicated ``NamedSharding``. ``np.asarray`` gives the
    rows of the local shards concatenated (a replicated tensor gives one
    copy)."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, replicated: bool = False):
        self.shards = list(shards)
        self.mesh = mesh
        self.replicated = replicated

    def __array__(self, dtype=None, copy=None):
        if self.replicated:
            out = self.shards[0].cpu().numpy()
        else:
            out = np.concatenate([s.cpu().numpy() for s in self.shards])
        return out.astype(dtype) if dtype is not None else out



class Placement:
    """Where a host array goes: row blocks over the mesh's shards
    (``sharded``) or a copy on each (``replicated``)."""

    def __init__(self, mesh: Mesh, replicated: bool = False):
        self.mesh = mesh
        self.replicated = replicated

    def put(self, array) -> ShardedTensor:
        """The global ``array`` placed on the mesh. A sharded placement needs
        a row count divisible by the shard count, as JAX's does."""
        host = torch.as_tensor(np.ascontiguousarray(np.asarray(array)))
        shards = self.mesh.local_shards()
        if self.replicated:
            return ShardedTensor([host.to(self.mesh.device_of(d)) for d in shards], self.mesh, replicated=True)
        n_dev = self.mesh.size
        if host.shape[0] % n_dev:
            raise ValueError(f"{host.shape[0]} rows do not divide evenly over {n_dev} shards")
        per = host.shape[0] // n_dev
        return ShardedTensor([host[d * per:(d + 1) * per].to(self.mesh.device_of(d)) for d in shards], self.mesh)

    def put_local(self, array) -> ShardedTensor:
        """This process's rows of a sharded array (the counterpart of
        ``jax.make_array_from_process_local_data``): split evenly over the
        local shards."""
        host = torch.as_tensor(np.ascontiguousarray(np.asarray(array)))
        shards = self.mesh.local_shards()
        if host.shape[0] % len(shards):
            raise ValueError(f"{host.shape[0]} rows do not divide evenly over {len(shards)} local shards")
        per = host.shape[0] // len(shards)
        return ShardedTensor([host[i * per:(i + 1) * per].to(self.mesh.device_of(d))
                              for i, d in enumerate(shards)], self.mesh)


def sharded(mesh: Mesh) -> Placement:
    """Row sharding of a 1-D array across the shards of a 1-D mesh."""
    return Placement(mesh)


def sharded_2d(mesh: Mesh) -> Placement:
    """Row sharding of a 1-D array across every shard of a 2-D mesh, in
    row-major shard order."""
    return Placement(mesh)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, replicated=True)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def all_gather(parts: Sequence[torch.Tensor], device: torch.device, axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """Every shard's fixed-size table, concatenated in shard order on
    ``device`` (where the replicated merge runs): one copy per table whose
    shard lives on another device."""
    collective_calls[("all_gather", axis)] += 1
    _heard("all-gather", axis)
    collective_entries[("all_gather", axis)] += sum(int(p.numel()) for p in parts)
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def _groups(mesh: Mesh, axis: str) -> List[List[int]]:
    """Global shard indices of each group that exchanges along ``axis``, in
    axis order: the whole mesh for a 1-D mesh; a slice (``ici``) or a local
    position across slices (``dcn``) for a 2-D one."""
    if len(mesh.axis_names) == 1:
        return [list(range(mesh.size))]
    n_s, n_l = mesh.devices.shape
    if axis == mesh.axis_names[1]:
        return [[s * n_l + l for l in range(n_l)] for s in range(n_s)]
    return [[s * n_l + l for s in range(n_s)] for l in range(n_l)]


def all_to_all(mesh: Mesh, axis: str, staged: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """The tiled all-to-all over ``axis``: ``staged[g]`` is shard ``g``'s
    ``(n_axis, capacity, planes)`` slots, row ``j`` bound for the ``j``-th
    shard of its group; shard ``g`` receives ``(n_axis * capacity, planes)``,
    the slots its group's shards bound for it, in axis order. In one
    process a transpose of the slots (one copy per pair of distinct
    devices); along a ``dcn`` axis that crosses processes one
    ``torch.distributed.all_to_all_single`` of every local shard's slots."""
    if mesh.process_count > 1 and axis == mesh.axis_names[0] and len(mesh.axis_names) == 2:
        return _all_to_all_processes(mesh, staged)
    collective_calls[("all_to_all", axis)] += 1
    _heard("all-to-all", axis)
    out: Dict[int, torch.Tensor] = {}
    for group in _groups(mesh, axis):
        if group[0] not in staged:  # another process's slice
            continue
        for j, g in enumerate(group):
            dev = mesh.device_of(g)
            out[g] = torch.cat([staged[src][j].to(dev, non_blocking=True) for src in group])
            collective_entries[("all_to_all", axis)] += int(out[g].numel())
    return out


def _all_to_all_processes(mesh: Mesh, staged: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """The ``dcn`` exchange of a multi-process 2-D mesh: each process packs
    its local shards' slots as ``(slices, local positions, capacity, planes)``
    and one ``all_to_all_single`` hands slice ``s`` its share, so every row
    crosses the process boundary once."""
    import torch.distributed as dist

    local = mesh.local_shards()
    send = torch.stack([staged[g] for g in local], dim=1).contiguous()  # (S, L, cap, planes)
    if dist.get_backend() == "nccl":
        send = send.to(torch.device("cuda", torch.cuda.current_device()))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    collective_calls[("all_to_all", mesh.axis_names[0], "process")] += 1
    _heard("all-to-all", mesh.axis_names[0])
    collective_entries[("all_to_all", mesh.axis_names[0], "process")] += int(send.numel())
    n_s = recv.shape[0]
    return {g: recv[:, i].reshape(n_s * recv.shape[2], recv.shape[3]).to(mesh.device_of(g))
            for i, g in enumerate(local)}
