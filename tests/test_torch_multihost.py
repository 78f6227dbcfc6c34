"""Two processes, one mesh: the port's multi-process path on the CPU.

The port of tests/test_multihost.py. Two processes start
``torch.distributed`` through ``parallel.distributed.initialize_from_env``
(gloo, from ``HS_COORDINATOR``, ``HS_NUM_PROCESSES`` and ``HS_PROCESS_ID``),
each holding 4 CPU shards of a 2 x 4 ``(dcn, ici)`` mesh whose ``dcn`` axis
is the process boundary, and run the hierarchical re-bucketing exchange
(ops/bucketize.rebucket_hierarchical): every row must land on the shard
that owns its bucket, and cross the process boundary at most once: one
exchange between the processes, carrying exactly the rows whose owner is
in the other process. NCCL would refuse two ranks on one card, so the
path stays unverified on NCCL until a machine has two cards. The worker
imports nothing of JAX.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist

from hyperspace_tpu_torch.parallel import mesh as PM
from hyperspace_tpu_torch.parallel.distributed import initialize_from_env, shutdown

PM.SHARD_COUNT = 4  # each process drives 4 CPU shards
assert initialize_from_env(), "HS_* env must configure the two-process world"
assert initialize_from_env(), "initialize_from_env is idempotent"
pid = int(os.environ["HS_PROCESS_ID"])
assert dist.get_world_size() == 2 and dist.get_rank() == pid and dist.get_backend() == "gloo"

from hyperspace_tpu_torch.ops.bucketize import rebucket_hierarchical

mesh = PM.make_mesh_2d(device_type="cpu")  # n_slices defaults to the world size
assert mesh.shape == {"dcn": 2, "ici": 4}, mesh.shape
assert mesh.local_shards() == list(range(4 * pid, 4 * pid + 4))
sh = PM.sharded_2d(mesh)

rows_per_dev = 32
n = 8 * rows_per_dev
num_buckets = 16
rng = np.random.default_rng(11)
buckets_global = rng.integers(0, num_buckets, n).astype(np.int32)
vals_global = np.arange(n, dtype=np.float64)
local = slice(pid * n // 2, (pid + 1) * n // 2)
hb = sh.put_local(buckets_global[local])
arr = {"v": sh.put_local(vals_global[local])}

PM.reset_collectives()
out, out_buckets, valid, overflow = rebucket_hierarchical(
    mesh, arr, hb, capacity_ici=2 * rows_per_dev, capacity_dcn=2 * rows_per_dev
)
# one exchange inside each process (ici), one between them (dcn)
assert PM.collective_calls[("all_to_all", "ici")] == 1, dict(PM.collective_calls)
assert PM.collective_calls[("all_to_all", "dcn", "process")] == 1, dict(PM.collective_calls)
assert ("all_to_all", "dcn") not in PM.collective_calls

crossed = 0
v_sum = 0.0
for g, b, m, v in zip(mesh.local_shards(), out_buckets.shards, valid.shards, out["v"].shards):
    assert bool(((b[m] % 8) == g).all()), (pid, g, sorted(set((b[m] % 8).tolist())))
    v_sum += float(v[m].sum())
    slots = m.reshape(2, -1)  # block s: the rows slice s sent this shard
    crossed += int(slots[1 - pid].sum())
totals = torch.tensor([float(sum(int(m.sum()) for m in valid.shards)),
                       float(sum(int(o.sum()) for o in overflow.shards)), v_sum, float(crossed)], dtype=torch.float64)
dist.all_reduce(totals)
owner_slice = (buckets_global % 8) // 4
source_slice = np.arange(n) // (n // 2)
assert int(totals[0]) == n, f"rows not conserved: {int(totals[0])} != {n}"
assert int(totals[1]) == 0, f"exchange overflowed: {int(totals[1])}"
assert abs(float(totals[2]) - vals_global.sum()) < 1e-6, (float(totals[2]), vals_global.sum())
assert int(totals[3]) == int((owner_slice != source_slice).sum()), "a row crossed the boundary twice or not at all"

shutdown()
assert not dist.is_initialized()
print(f"WORKER{pid} OK", flush=True)
'''


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_hierarchical_rebucket(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env_base = dict(
        os.environ,
        HS_COORDINATOR=f"127.0.0.1:{_free_port()}",
        HS_NUM_PROCESSES="2",
        OMP_NUM_THREADS="1",
    )
    procs = []
    for pid in range(2):
        env = dict(env_base, HS_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, str(worker), REPO], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid in range(2):
        assert f"WORKER{pid} OK" in outs[pid]


def test_initialize_noop_without_config(monkeypatch):
    """Single-process mode: no environment, no process group; the same
    entry point works, and ``shutdown`` tears down nothing it did not
    start."""
    from hyperspace_tpu_torch.parallel import distributed

    monkeypatch.delenv("HS_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("HS_PROCESS_ID", raising=False)
    assert distributed.configured_from_env() is False
    assert distributed.initialize_from_env() is False
    distributed.shutdown()
    monkeypatch.setenv("HS_NUM_PROCESSES", "2")
    assert distributed.configured_from_env() is False  # no HS_PROCESS_ID
    with pytest.raises(ValueError, match="HS_PROCESS_ID"):
        distributed.initialize_from_env()
