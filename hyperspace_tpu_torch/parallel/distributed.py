"""Multi-process runtime start-up over ``torch.distributed``.

The port of ``hyperspace_tpu/parallel/distributed.py``. A multi-process mesh
comes up through ``torch.distributed.init_process_group``: every process
calls ``initialize_from_env()`` before it builds a mesh, then ``make_mesh_2d``
(parallel/mesh.py) aligns the mesh's ``dcn`` axis with the process
boundary, so the hierarchical exchange (ops/bucketize.rebucket_hierarchical)
keeps its first phase inside each process and crosses the boundary once
per row.

Configuration, by environment variable or keyword, as in the JAX package:

  HS_COORDINATOR     ``host:port`` of process 0's rendezvous
                     (default ``127.0.0.1:29500``)
  HS_NUM_PROCESSES   world size
  HS_PROCESS_ID      this process's rank in [0, world size)

The backend is gloo on the CPU and NCCL when CUDA is available. NCCL
refuses two ranks on one card, so the multi-process path needs a card per
process; tests/test_torch_multihost.py runs it on the CPU under gloo.
"""

from __future__ import annotations

import os
from typing import Optional

#: True only when THIS module started the process group: ``shutdown()``
#: never tears down a group a launcher owns
_owns_runtime = False


def configured_from_env() -> bool:
    """True when the environment configures a multi-process world (both
    ``HS_NUM_PROCESSES`` > 1 and ``HS_PROCESS_ID`` set)."""
    n = _int_env("HS_NUM_PROCESSES")
    return n is not None and n > 1 and _int_env("HS_PROCESS_ID") is not None


def initialize_from_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Start the process group from the environment or the keywords.

    Returns True when a multi-process group is up after the call (this call
    started it, an earlier one did, or a launcher did); False in
    single-process mode. Idempotent."""
    global _owns_runtime
    if _owns_runtime or _runtime_up():
        return True
    num_processes = num_processes if num_processes is not None else _int_env("HS_NUM_PROCESSES")
    if num_processes is None or num_processes <= 1:
        return False
    process_id = process_id if process_id is not None else _int_env("HS_PROCESS_ID")
    if process_id is None:
        raise ValueError("HS_PROCESS_ID must be set when HS_NUM_PROCESSES > 1")
    coordinator = coordinator or os.environ.get("HS_COORDINATOR", "127.0.0.1:29500")

    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    _owns_runtime = True
    return True


def _runtime_up() -> bool:
    try:
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized()
    except Exception:
        return False


def shutdown() -> None:
    """Tear the process group down, only if this module started it."""
    global _owns_runtime
    if _owns_runtime:
        import torch.distributed as dist

        dist.destroy_process_group()
        _owns_runtime = False


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None
