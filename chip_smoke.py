#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hyperspace_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--rows N] [--files N] [--reps N] [--baseline-csrc DIR]

Phases, each printed with its time (the filter query's phases are 5, 10
and 13, the join's 6, 11 and 14, the aggregates' 7, 12 and 15, out-of-core
execution's 7b, 12b, 15b and 17, the index lifecycle's 7c and 12c, scan
pruning's 7d and 12d, hybrid scan's 7e and 12e, the other sources' 7f and
12f):

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the port's CUDA kernels from ``hyperspace_tpu_torch/csrc``;
3. kernels: holds each kernel against its plain torch version on the card
   (exact: both are integer results) at the build's shapes and at the inputs
   each design finds hard, then times kernel, plain version and the nearest
   single PyTorch library call with CUDA events, beside the launch floor
   (one ``torch.zeros(1)``), each kernel's fixed cost (a tiny input), the
   same kernel behind fill launches that initialise its outputs, and K2 at
   the host driver's two call-cap shapes; with ``--baseline-csrc`` an
   earlier tree's kernels are timed in turns with this tree's;
4. small: builds one covering index over a small lake on the CPU (plain
   versions) and on the GPU (kernels) and requires identical bucket files;
5. query-small: a 60 000-row lake with NaN, -0.0, ±inf, nulls, dates,
   strings and int64 keys above 2^53, indexed in a CPU and a GPU session
   (``deviceMinRows=0``); a dozen filter queries (every compare, strings
   present and absent, IS NULL, Kleene NOT/AND/OR, IN, int ``/`` and ``%``
   by zero, a date range, a float literal above 2^53) must give the GPU
   result equal to the CPU port's byte for byte and in order, equal to
   hyperspace off as a multiset, and ``filter: device`` in every trace;
6. join-small: a two-table lake (a fact side with duplicate keys, nullable
   payloads, dates and strings; a dimension side), indexed at 8 buckets in a
   CPU and a GPU session (``deviceMinRows=0``); inner joins on an int, a
   composite, a string and a date key, inner with a Filter on each side,
   left, right and outer, and a self-join must give the GPU result equal to
   the CPU port's byte for byte and in order, equal to hyperspace off (the
   generic merge) as a multiset, and ``join: device-smj`` in every trace;
7. agg-small: eleven aggregates over the query-small and join-small
   indexes of both builds (global with a filter and with one that keeps no
   row; grouped by an int, a float (NaN, -0.0, ±inf), a string (nulls), a
   date (nulls) and two keys, with every function; 54 000 groups, past the
   capacity floor; over the join globally, by the join key and by a left
   key) must give the GPU result equal to the CPU port's over each build
   (keys, order, counts, int sums, min and max exact, float sums, avg and
   stddev at rtol 1e-9), equal to hyperspace off as a multiset of group
   rows, and ``agg: device-fused-scan``, ``agg: device-grouped-scan`` or
   ``agg: fused-bucketed-join`` in every trace;
7b. stream-small: the streamed paths over the join-small and query-small
   lakes through the GPU build, on the GPU against the CPU port: the
   streamed join (``joinMinBytes=1``; J1 and J2 shapes, inner, left, right
   and outer) byte for byte equal to the unstreamed join, an empty streamed
   join typed from the index footers, the streamed aggregate
   (``aggMinBytes=1, chunkBytes=1``: every streamable function, distinct
   forms, int, float, string and date keys with null groups; a chunk and a
   merge above ``maxGroups``) equal to the unstreamed one,
   ``to_local_iterator`` over a scan chain, an index filter and the
   bucketed join (one closed after its first chunk: no decode after the
   close) and the partitioned merge (``spillMinRows=64``);
7c. lifecycle-small: a 60 000-row ``lineitem`` lake indexed three ways
   (covering, covering with lineage, data-skipping) in a CPU and a GPU
   session, then edited (two files of new orders appended, a file dropped)
   while incremental, quick and full refresh, quick and full optimize,
   delete, restore and vacuum run; each phase starts both sessions from a
   copy of the CPU session's indexes, and after every action the GPU's
   bucket files equal the CPU port's byte for byte and the sketches are
   equal (K1 and K2 against their plain versions on the new paths), the
   GPU launching K1 for each covering rewrite and K2 for each
   data-skipping rebuild; after every phase each query equals hyperspace
   off as a multiset;
7d. prune-small: a 60 000-row ``lineitem`` lake rewritten by ship year
   as a hive-partitioned lake of 1024-row row groups; q6 (a projection
   over its filter: no scan takes a pushed-down predicate, in either
   package), q6f (its filter, every column) and q6pf (q6f and
   ``l_shipyear == 1994``) with pruning on and off, in a CPU and a GPU
   session: the same rows, files read and row groups kept on both, pruned
   rows equal to unpruned; a covering index over the partitioned lake (K1)
   serving q6 and q6's aggregate unstreamed and streamed, equal to the CPU
   port and to hyperspace off;
7e. hybrid-small: ``li_h``, ``li_ok_h`` (lineage) and ``o_h`` built on the
   GPU (K1) over a small lake; two new-orders ``lineitem`` files and their
   ``orders`` file appended, one ``lineitem`` file dropped; q6, J1 (inner,
   outer, streamed) and A3 through hybrid scan in a CPU and a GPU session
   over the same indexes: GPU == CPU port == hyperspace off, ``filter:
   device-lineage`` and the ``lineage-antijoin`` program on the GPU, the
   appends re-bucketed once then cached; again after a quick refresh (no
   launch) and after an incremental one (K1, hybrid scan over); then the
   program on the card against its plain version over its edge cases;
7f. sources-small: a Delta table (covering index with lineage and a MinMax
   sketch; a new version and a removed file; hybrid q6; incremental
   refresh on the GPU launching K1 and K2, index files equal to the CPU
   port's byte for byte; time travel to the first index version; the
   sketch pruning), an Iceberg table (covering index on the GPU, a new
   snapshot through hybrid scan) and CSV and ORC lakes (covering index on
   the GPU): every query GPU == CPU port == hyperspace off;
8. generate and slice: generates a TPC-H-shaped SF1 ``lineitem`` lake (6M
   rows in 16 files, from ``--seed``, with TPC-H's return flag and line
   status) and builds three indexes through the public API (``Session`` ->
   ``read_parquet`` -> ``Hyperspace.create_index``) at the default 200
   buckets and 2M batch rows, with the kernel launch counts reset just
   before and read just after, and prints each covering build's host time
   by stage;
9. check: every bucket file (rows hash to their bucket, sorted by the key,
   same rows as the source) and every sketch row (numpy per-file min/max);
10. query: on the session that built them, with ``deviceMinRows=0``, TPC-H
   q6's filter through ``li_shipdate`` and a point lookup on
   ``l_orderkey`` through ``li_orderkey`` (``useBucketSpec``: one bucket),
   with kernel launches and device dispatches reset just before and read
   just after: the optimized plans, the dispatch traces (``filter:
   device``), the rows against hyperspace off over the source (exact, as a
   multiset); then each query cold (caches cleared: decode, upload,
   predicate), warm (the median of ``--reps``), and warm on the host path
   (the default ``deviceMinRows``), each split by the layers those same
   runs add to ``Session.query_stage_seconds`` (rewrite, decode, scan
   identity, upload, predicate launch, wait and mask copy, host predicate,
   ``mask_rows``), and the predicate program's bound;
11. join: on the same session, a TPC-H-shaped SF1 ``orders`` lake (1.5M
   rows in 8 files, every ``l_orderkey`` matching one order) and its
   covering index ``o_orderkey`` at 200 buckets (build time and stages),
   then J1 (``lineitem`` joined to ``orders`` on the order key, 6M output
   rows) and J2 (the same with a Filter over each side's index scan) on the
   device (``deviceMinRows=0``, ``deviceMaterializeMaxBytes`` 2 GiB), with
   device dispatches reset just before and read just after: the plans (two
   IndexScans), the traces (``join: device-smj``, ``scan: index-bucketed
   x2``), the rows against hyperspace off (as a multiset) and the host-span
   path (byte for byte); each join cold (IO, key and device caches
   cleared), warm (the median of ``--reps`` for J1, a third of that for
   J2), warm on the host-span path (the default ``deviceMinRows``) and with
   hyperspace off, each split by its ``Session.query_stage_seconds``
   layers; then each device program of a warm J1 timed alone with CUDA
   events beside its bound; at ``--seed 0`` and SF1 the row counts of q6,
   J1 and J2 must be those of the lake before its flag columns;
12. agg: on the same session, the covering index ``li_q1`` (on
   ``l_shipdate`` with q1's columns; build time, stages and K1 launches),
   then A1 (TPC-H q1 over plain columns through ``li_q1``: 4 groups of
   about 5.9M rows), A2 (q6's global aggregate through ``li_shipdate``),
   A3 (a global aggregate over J1) and A4 (J2 grouped by order key and
   order date, the q3 class), with device dispatches reset just before:
   the plans, the traces (``agg: device-grouped-scan``, ``agg:
   device-fused-scan``, ``agg: fused-bucketed-join``), the groups against
   hyperspace off (as multisets) and the host path (in order; A3 and A4
   also against the aggregate over the materialized join); each cold,
   warm (the median of ``--reps`` for A1 and A2, a third of that for A3
   and A4), warm on the host path (the default ``deviceMinRows``) and with
   hyperspace off, each split by its layers; then the ``fused-agg`` program
   of a warm A2 and the ``grouped-agg-chunk`` program of a warm A1 timed
   alone with CUDA events beside their bounds;
12b. stream: J1 and J2 streamed (``joinMinBytes=1``) with the join
   pipeline on and off, byte for byte equal to the unstreamed join and to
   hyperspace off as a multiset; A1 and A2 streamed (``aggMinBytes=1``,
   ``chunkBytes`` an eighth of ``li_q1``'s index bytes: at least 8 chunks)
   with the scan pipeline on and off, equal to the materialized aggregate,
   and A1's pipelined and serial partial tables bit for bit (deterministic
   algorithms); warm medians and layers of every run, the launches of
   ``grouped-agg-chunk`` and ``grouped-merge`` per streamed A1; the
   partitioned merge of J1 with hyperspace off (``spillMinRows=2^20``);
   ``grouped-merge`` alone on A1's last partial tables beside its bound;
12c. lifecycle: the SF1 ``lineitem`` files hard-linked into a mutable
   lake; ``li_mut`` (covering on ``l_shipdate`` with q6's columns),
   ``li_lin`` (the same with lineage) and ``li_skip_mut`` (MinMax on
   ``l_orderkey`` and ``l_extendedprice``) built; two files of new orders
   shipped in the month after the lake's range appended, then one
   original file dropped; incremental (the delta), incremental with
   lineage (every row rewritten), full, quick, quick and full optimize
   (``NoChangesException``), delete, restore and vacuum, each timed with
   its rows/s, build stages and K1/K2 launches (at least one per rewrite);
   after each rewrite q6 through the rewritten index equal to hyperspace
   off, and after the lineage rewrite and the compaction ``check_covering``
   against the current source; once the
   data-skipping index is fresh, a query on the new orders pruned to the
   two new files, equal to off, warm beside off;
12d. prune: the SF1 ``lineitem`` rewritten by ship year into 14 files of
   131072-row row groups in ship-date order; q6, q6f and q6pf with
   hyperspace off, pruning on and off: files and row groups read, rows
   equal, cold and warm times; then ``li_part`` (K1) serving q6 and q6's
   aggregate unstreamed and streamed, cold, warm and off with layers;
12e. hybrid: the SF1 ``lineitem`` and ``orders`` hard-linked into a
   mutable lake; ``li_h``, ``li_ok_h`` (lineage) and ``o_h`` (K1); two
   new-orders files (keys from 1500000) and their ``orders`` file
   appended, one original ``lineitem`` file dropped; q6, J1 (both sides
   ``BucketUnion``) and A3 through hybrid scan: traces (``filter:
   device-lineage``, ``rebucket: computed`` then ``cached``), cold, warm
   and off with layers, equal to off and to the same queries after a full
   refresh (K1); the lineage-antijoin program alone on q6's index side
   with CUDA events, beside its bound, ``torch.isin`` and numpy;
12f. delta: the SF1 ``lineitem`` written as a Delta table (one version per
   file); ``ld_cov`` (lineage; K1) and ``ld_skip`` (MinMax on
   ``l_orderkey``; K2); a version of new orders and one that removes a
   file; q6 through hybrid scan, incremental refresh of both (K1, K2), q6
   again and a time-travel q6 of the table before the edits (served by
   the index's first version), each action's seconds, rows/s and
   launches, each query cold, warm and off;
13. profile-query: one warm q6 under ``torch.profiler``: device busy time
   against the query's wall time, and the device time by op;
14. profile-join: the same for one warm J1;
15. profile-agg: the same for one warm A1;
15b. profile-stream: the same for one warm streamed A1;
16. profile: one more covering build under ``torch.profiler``: the device's
   busy time (the union of its kernel and copy intervals) against the
   build's wall time, and the device time by kernel;
17. scale: the gates at their defaults. Each SF1 index's bytes, then the
   fewest ``lineitem`` rows (the SF1 lake's columns, distributions and rows
   per file; ``orders`` at a quarter) that put J1's two covering indexes
   (TPC-H q3's ``lineitem`` and ``orders`` columns) together, and ``li_q1``
   alone, above 1.2 GiB, sized from those indexes' SF1 bytes per row;
   the lake generated on worker processes and indexed (K1 launches), the
   gates' crossing asserted from the bytes; J1 (the streamed join) and A1
   (the streamed aggregate) cold and warm, against hyperspace off (J1 by
   row count and an order-free digest of the rows, A1 at the aggregates'
   tolerances), with no ``stream-fallback`` in any trace.

The third line from the end is a JSON object with the queries', the
joins' (under ``"join"``), the aggregates' (under ``"agg"``), the
lifecycle's (under ``"lifecycle"``), pruning's (``"prune"``), hybrid
scan's (``"hybrid"``) and the Delta table's (``"delta"``) results and
times, the line before the last one with an entry per kernel (its launches
on the build's main path, and per path under ``launches_by_path``); the
last line
is ``{"ok": true, "device": {...}}``. Any failed check raises, so
the script exits non-zero and prints no result. It exits non-zero as well
when no CUDA device is present or the port is not beside it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: device-memory rate by card name (bytes/s; NVIDIA data sheets)
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
    "NVIDIA H100 PCIe": 2.0e12,
}
#: CUDA-core (non-tensor) peak of an H100 SXM, used for the integer
#: compares and min/max of both kernels (ops/s)
CORE_OPS_PER_S = 67e12

LINEITEM_ROWS_SF1 = 6_000_000
ORDERS_ROWS_SF1 = 1_500_000
BATCH_ROWS = 2_000_000  # the build's default hyperspace.tpu.build.batchRows


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


#: TPC-H's "current date" (spec 4.2.3): a line shipped after it is open
#: (``l_linestatus`` 'O'); one received by it may be returned ('R' or 'A')
CURRENT_DATE = "1995-06-17"


def gen_lineitem(root: str, rows_total: int, num_files: int, seed: int) -> str:
    """TPC-H-shaped ``lineitem`` (the repo's benchmarks/datagen.py columns
    and value ranges): ``rows_total`` rows over ``num_files`` parquet files.
    ``l_returnflag`` and ``l_linestatus`` follow TPC-H's rule from the ship
    date and a receipt 1-30 days later, drawn from a second generator so
    every other column is the same as without them."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    sf = rows_total / LINEITEM_ROWS_SF1
    d = os.path.join(root, "lineitem")
    os.makedirs(d, exist_ok=True)
    per = max(1, rows_total // num_files)
    rng = np.random.default_rng(seed)
    flags_rng = np.random.default_rng(seed + 1)
    for i in range(num_files):
        rows = per if i < num_files - 1 else rows_total - per * (num_files - 1)
        pq.write_table(pa.table(lineitem_columns(rng, flags_rng, rows, sf)), os.path.join(d, f"part-{i:05d}.parquet"))
    return d


def lineitem_columns(rng, flags_rng, rows: int, sf: float) -> dict:
    """One ``lineitem`` file's columns at scale factor ``sf``: every column
    from ``rng``, the flags from ``flags_rng``."""
    import numpy as np

    base = np.datetime64("1992-01-01")
    current = np.datetime64(CURRENT_DATE)
    n_orders = max(1, int(ORDERS_ROWS_SF1 * sf))
    cols = {
        "l_orderkey": rng.integers(0, n_orders, rows).astype(np.int64),
        "l_partkey": rng.integers(0, int(200_000 * max(sf, 0.01)), rows).astype(np.int64),
        "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105000.0, rows), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, rows), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, rows), 2),
        "l_shipdate": base + rng.integers(0, 2526, rows).astype("timedelta64[D]"),
    }
    receipt = cols["l_shipdate"] + flags_rng.integers(1, 31, rows).astype("timedelta64[D]")
    returned = flags_rng.choice(np.array(["R", "A"]), rows)
    cols["l_returnflag"] = np.where(receipt <= current, returned, "N")
    cols["l_linestatus"] = np.where(cols["l_shipdate"] > current, "O", "F")
    return cols


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between two
    CUDA events. A long sleep kernel queued first keeps the card busy while
    the host enqueues every call, so host overhead stays out of the gaps."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(bytes_moved: int, ops: int, hbm: float):
    t_bytes = bytes_moved / hbm * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_segments(rng, per: int, n_seg: int):
    """``n_seg`` segments of ``per`` values of mixed magnitude, 1% NaN."""
    import numpy as np

    segs = []
    for _ in range(n_seg):
        v = rng.standard_normal(per) * 10.0 ** rng.integers(-3, 9)
        v[rng.random(per) < 0.01] = np.nan
        segs.append(v)
    return segs


def kernel_segments(rng, per: int, n_seg: int):
    """Segments for the min/max kernel: NaN, signed zeros, infinities, an
    empty and an all-NaN segment, and int64 values above 2**53."""
    import numpy as np

    segs = random_segments(rng, per, n_seg)
    segs[1][:] = 0.0
    segs[1][rng.random(per) < 0.5] = -0.0
    segs[2][::1000] = np.inf
    segs[2][1::1000] = -np.inf
    segs[3] = np.empty(0)
    segs[4][:] = np.nan
    big = rng.integers(2**53, 2**62, per, dtype=np.int64)
    big[::2] *= -1
    segs[5] = np.asarray(big, dtype=np.float64)
    segs[6][:] = -0.0
    return segs


def check_histogram(ids, nb: int):
    """K1 against its plain version on the card tensor ``ids`` (exact)."""
    import torch

    from hyperspace_tpu_torch.ops import kernels as K

    got, want = K.bucket_histogram(ids, nb), K.bucket_histogram_plain(ids, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"bucket_histogram disagrees with its plain version ({ids.numel()} ids, {nb} buckets)"
    assert int(want.sum()) == int(((ids >= 0) & (ids < nb)).sum())
    return float((got - want).abs().max())


def offset_view(t):
    """``t``'s float64 values in a tensor whose storage starts one element
    in, so its base address is off the 16-byte grid the kernels load on."""
    import torch

    v = torch.cat([t[:1], t])[1:]
    assert v.storage_offset() == 1 and torch.equal(v.view(torch.int64), t.view(torch.int64))
    return v


def check_minmax(segs, unaligned: bool = False):
    import numpy as np
    import torch

    from hyperspace_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    offsets_np = np.zeros(len(segs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in segs], out=offsets_np[1:])
    values = torch.from_numpy(np.concatenate(segs)).to(dev)
    if unaligned:
        values = offset_view(values)
    offsets = torch.from_numpy(offsets_np).to(dev)
    got = K.segment_min_max_keys(values, offsets)
    want = K.segment_min_max_keys_plain(values, offsets)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("min keys", "max keys", "empty flags")):
        assert torch.equal(g, w), f"segmented_min_max {what} disagree with the plain version"
    # the host driver end to end: card vs CPU, bit for bit (NaN included)
    mn_gpu, mx_gpu = K.segmented_min_max(segs, dev)
    mn_cpu, mx_cpu = K.segmented_min_max(segs, torch.device("cpu"))
    assert np.array_equal(mn_gpu.view(np.int64), mn_cpu.view(np.int64))
    assert np.array_equal(mx_gpu.view(np.int64), mx_cpu.view(np.int64))
    empty = got[2].cpu().numpy()
    for i, s in enumerate(segs):
        ok = s[~np.isnan(s)]
        assert bool(empty[i]) == (len(ok) == 0), f"segment {i} empty flag"
        if len(ok):
            assert mn_gpu[i] == ok.min() and mx_gpu[i] == ok.max(), f"segment {i} min/max"
    err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want))
    return values, offsets, err


def minmax_bound(n_vals: int, n_seg: int, hbm: float):
    return bound(n_vals * 8 + (n_seg + 1) * 8 + n_seg * 17, 3 * n_vals, hbm)


def library_minmax(values, offsets):
    """K2's function as PyTorch library calls: two ``scatter_reduce_`` (amin,
    amax) of the order keys of the non-NaN values into their segments."""
    import torch

    from hyperspace_tpu_torch.ops import kernels as K

    n_seg = offsets.numel() - 1
    ok_mask = ~torch.isnan(values)
    keys = K.order_keys(values)[ok_mask]
    seg_ids = torch.repeat_interleave(torch.arange(n_seg, device=values.device), offsets[1:] - offsets[:-1])[ok_mask]

    def run():
        mn = torch.full((n_seg,), K.I64_MAX, dtype=torch.int64, device=values.device)
        mx = torch.full((n_seg,), K.I64_MIN, dtype=torch.int64, device=values.device)
        mn.scatter_reduce_(0, seg_ids, keys, "amin")
        mx.scatter_reduce_(0, seg_ids, keys, "amax")

    return run


def build_baseline(csrc: str):
    """The kernels of an earlier tree (``csrc``: a copy of its
    ``hyperspace_tpu_torch/csrc``), built with the same flags, as callables
    with the current wrappers' signatures: PR 1's launchers, K1 adding into
    counts zeroed by the caller. Returns (histogram, min_max)."""
    import ctypes

    import torch

    from hyperspace_tpu_torch.ops import cuda_build

    out = tempfile.mkdtemp(prefix="hs_baseline_")
    procs = {
        src: subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", os.path.join(out, src + ".so"),
                               os.path.join(csrc, src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in cuda_build.SOURCES
    }
    for src, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"baseline {src} does not build:\n{log}"
    P = ctypes.c_void_p
    hist = ctypes.CDLL(os.path.join(out, "bucket_histogram.cu.so")).hs_bucket_histogram
    hist.argtypes, hist.restype = [P, ctypes.c_longlong, ctypes.c_int, P, P], ctypes.c_int
    mm = ctypes.CDLL(os.path.join(out, "segmented_min_max.cu.so")).hs_segmented_min_max
    mm.argtypes, mm.restype = [P, P, ctypes.c_int, P, P, P, P], ctypes.c_int
    shutil.rmtree(out)  # loaded; the files are no longer needed

    def stream():
        return P(torch.cuda.current_stream().cuda_stream)

    def histogram(ids, nb):
        counts = torch.zeros(nb, dtype=torch.int32, device=ids.device)
        assert hist(ids.data_ptr(), ids.numel(), nb, counts.data_ptr(), stream()) == 0
        return counts

    def min_max(values, offsets):
        n_seg = offsets.numel() - 1
        mins = torch.empty(n_seg, dtype=torch.int64, device=values.device)
        maxs = torch.empty_like(mins)
        empty = torch.empty(n_seg, dtype=torch.bool, device=values.device)
        assert mm(values.data_ptr(), offsets.data_ptr(), n_seg, mins.data_ptr(), maxs.data_ptr(),
                  empty.data_ptr(), stream()) == 0
        return mins, maxs, empty

    return histogram, min_max


def in_turns(old, new, reps: int):
    """Old and new timed in turns on one card (old, new, new, old), each
    checked equal to the other first: (old ms, new ms, the four medians)."""
    import torch

    a, b = old(), new()
    for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
        assert torch.equal(x, y), "the earlier kernel and the new one disagree"
    turns = [time_ms(f, reps) for f in (old, new, new, old)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def check_kernels(args, hbm: float):
    """Each kernel against its plain version on the card — at the hard
    inputs of each design and at the shapes the SF1 build gives it — then
    timed: K1 at one chunk of sorted bucket ids (whole files grouped up to
    the 2M batch rows), K2 at one segment per source file and at the two
    shapes of the host driver's call cap (8 pieces of 2^20 values, 8192
    files of 1024). With ``--baseline-csrc`` the earlier tree's kernels are
    timed beside the new ones in the same run."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    per_file = args.rows // args.files
    chunk = (BATCH_ROWS // per_file) * per_file if per_file <= BATCH_ROWS else BATCH_ROWS
    baseline = build_baseline(args.baseline_csrc) if args.baseline_csrc else None
    # the harness's floor: one small launch between two events
    launch_floor = time_ms(lambda: torch.zeros(1, device=dev), args.reps)
    print(f"launch floor (one torch.zeros(1) on the card): {launch_floor} ms", flush=True)
    results = {}

    # --- K1: ids over 200 buckets with the -1 padding id and the build's
    # sentinel id 200 mixed in, random and sorted; then one long run, ids
    # that count nowhere, an unaligned view of odd length, one bucket, and
    # 65 536 buckets (past the shared-memory limit: the global path)
    nb = 200
    for n in (1 << 21, chunk):
        ids_np = rng.integers(-1, nb + 1, n).astype(np.int32)
        check_histogram(torch.from_numpy(ids_np).to(dev), nb)
        ids = torch.from_numpy(np.sort(ids_np)).to(dev)
        err = check_histogram(ids, nb)
    n_hard = chunk + 3
    for nb_hard in (nb, 1, 65_536):
        for fill in (nb_hard // 2, -1, nb_hard, None):
            hard = (torch.full((n_hard,), fill, dtype=torch.int32, device=dev) if fill is not None
                    else torch.from_numpy(rng.integers(-1, nb_hard + 1, n_hard).astype(np.int32)).to(dev))
            for view in (hard, hard[1:], hard.sort().values[1:]):
                check_histogram(view, nb_hard)
    print(f"kernel bucket_histogram: 2^21 and {chunk} ids, {nb} buckets, random and sorted; {n_hard} ids and "
          f"their [1:] views at 200, 1 and 65536 buckets, all equal, all -1, all nb, random, sorted: "
          f"equal to plain; timed at {chunk} sorted ids", flush=True)
    valid = ids[(ids >= 0) & (ids < nb)].to(torch.int64)
    k1_bound, k1_by = bound(chunk * 4 + nb * 4, chunk, hbm)
    k1_ms = time_ms(lambda: K.bucket_histogram(ids, nb), args.reps)
    tiny_ids = ids[:4].clone()
    _, launch = K._launcher("bucket_histogram.cu", "hs_bucket_histogram", None)

    def with_fill():
        """The same kernel on counts zeroed by a fill launch of their own."""
        counts = torch.zeros(nb, dtype=torch.int32, device=dev)
        assert launch(ids.data_ptr(), ids.numel(), nb, counts.data_ptr(), None, K._sm_count(dev), K._stream()) == 0
        return counts

    fill_ms, _, fill_turns = in_turns(with_fill, lambda: K.bucket_histogram(ids, nb), args.reps)
    print(f"kernel bucket_histogram: with a zeroing fill launch {fill_ms} ms, zeroing the next call's counts "
          f"in the kernel {k1_ms} ms (turns {fill_turns})", flush=True)
    results["bucket_histogram"] = {
        "name": "bucket_histogram",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/bucket_histogram.cu",
        "replaces": "hyperspace_tpu/ops/kernels.py:275",
        "max_abs_err": err,
        "ms": k1_ms,
        "plain_ms": time_ms(lambda: K.bucket_histogram_plain(ids, nb), args.reps),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": time_ms(lambda: torch.bincount(valid, minlength=nb), args.reps),
        "launch_floor_ms": launch_floor,
        "fixed_ms": time_ms(lambda: K.bucket_histogram(tiny_ids, nb), args.reps),
        "with_fill_ms": fill_ms,
        "share_of_bound": k1_bound / k1_ms,
    }
    if baseline:
        old, new, turns = in_turns(lambda: baseline[0](ids, nb), lambda: K.bucket_histogram(ids, nb), args.reps)
        results["bucket_histogram"].update(pr1_ms=old, pr1_turns_ms=turns)
        print(f"kernel bucket_histogram: earlier tree {old} ms, this tree {new} ms (turns {turns})", flush=True)

    # --- K2: 16 segments of 375 000 values (one of them empty), then one
    # segment of l_extendedprice-like values per source file, as the SF1
    # build gives them; then the hard layouts: the call cap's two shapes,
    # wildly unequal lengths with empty segments first, in the middle and
    # last, and an unaligned view of odd total length
    segs = kernel_segments(rng, 375_000, 16)
    check_minmax(segs)
    mn, mx = K.segmented_min_max(segs, dev)
    assert np.signbit(mn[1]) and not np.signbit(mx[1]), "-0.0 must order below +0.0"
    uneven = [np.empty(0), *random_segments(rng, 5_000_000, 1),
              *(rng.standard_normal(int(k)) for k in rng.integers(1, 4, 10)), np.empty(0),
              *(rng.standard_normal(int(k)) for k in rng.integers(1, 4, 10)), np.array([np.nan, -0.0]), np.empty(0)]
    if sum(map(len, uneven)) % 2 == 0:
        uneven[-2] = np.array([np.nan, -0.0, 0.0])
    for unaligned in (False, True):
        check_minmax(uneven, unaligned)
    cap_shapes = []
    for n_seg_cap, length in ((8, 1 << 20), (8192, 1024)):
        cap_segs = random_segments(rng, length, n_seg_cap)
        for unaligned in (True, False):  # timed below aligned, as the host driver uploads them
            cap_values, cap_offsets, _ = check_minmax(cap_segs, unaligned)
        cap_shapes.append((cap_values, cap_offsets))
    prices = [np.round(rng.uniform(900.0, 105000.0, per_file), 2) for _ in range(args.files)]
    values, offsets, err = check_minmax(prices)
    print(f"kernel segmented_min_max: 16 adversarial segments, {len(uneven)} uneven segments (5M values, "
          f"twenty of 1-3, empties first, in the middle and last; aligned and not), 8 x 2^20 and 8192 x 1024 "
          f"(aligned and not) and {args.files} x {per_file} prices: equal to plain; timed at {values.numel()} "
          f"values and at the cap shapes", flush=True)
    n_vals, n_seg = values.numel(), args.files
    k2_bound, k2_by = minmax_bound(n_vals, n_seg, hbm)
    k2_ms = time_ms(lambda: K.segment_min_max_keys(values, offsets), args.reps)
    _, launch_mm = K._launcher("segmented_min_max.cu", "hs_segmented_min_max", None)

    def minmax_with_fill():
        """The same kernel on outputs set to the identities by fill launches of their own."""
        outs = (torch.full((n_seg,), K.I64_MAX, dtype=torch.int64, device=dev),
                torch.full((n_seg,), K.I64_MIN, dtype=torch.int64, device=dev),
                torch.ones(n_seg, dtype=torch.bool, device=dev))
        assert launch_mm(values.data_ptr(), n_vals, offsets.data_ptr(), n_seg, *(t.data_ptr() for t in outs),
                         None, None, None, 0, K._sm_count(dev), K._stream()) == 0
        return outs

    k2_fill_ms, _, k2_fill_turns = in_turns(minmax_with_fill, lambda: K.segment_min_max_keys(values, offsets),
                                            args.reps)
    print(f"kernel segmented_min_max: with fill launches {k2_fill_ms} ms, initialising the next call's outputs "
          f"in the kernel {k2_ms} ms (turns {k2_fill_turns})", flush=True)
    shapes = []
    for v, o in ((values, offsets), *cap_shapes):
        b_ms, b_by = minmax_bound(v.numel(), o.numel() - 1, hbm)
        ms = k2_ms if v is values else time_ms(lambda: K.segment_min_max_keys(v, o), args.reps)
        shape = {"shape": f"{o.numel() - 1}x{v.numel() // (o.numel() - 1)}", "values": v.numel(), "ms": ms,
                 "plain_ms": time_ms(lambda: K.segment_min_max_keys_plain(v, o), args.reps),
                 "library_ms": time_ms(library_minmax(v, o), args.reps),
                 "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms}
        if baseline:
            old, new, turns = in_turns(lambda: baseline[1](v, o), lambda: K.segment_min_max_keys(v, o), args.reps)
            shape.update(pr1_ms=old, pr1_turns_ms=turns)
            print(f"kernel segmented_min_max {shape['shape']}: earlier tree {old} ms, this tree {new} ms "
                  f"(turns {turns})", flush=True)
        shapes.append(shape)
    results["segmented_min_max"] = {
        "name": "segmented_min_max",
        "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/segmented_min_max.cu",
        "replaces": "hyperspace_tpu/ops/kernels.py:139",
        "max_abs_err": err,
        "ms": k2_ms,
        "plain_ms": shapes[0]["plain_ms"],
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": shapes[0]["library_ms"],
        "launch_floor_ms": launch_floor,
        "fixed_ms": time_ms(lambda: K.segment_min_max_keys(values[:1], offsets[:2].clamp(max=1)), args.reps),
        "with_fill_ms": k2_fill_ms,
        "share_of_bound": k2_bound / k2_ms,
        "shapes": shapes,
    }
    if baseline:
        results["segmented_min_max"]["pr1_ms"] = shapes[0]["pr1_ms"]
    return results


def bucket_runs(entry):
    """{bucket: [table, ...]} of a covering index's files."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.indexes.covering import bucket_of_file

    runs = {}
    for f in sorted(entry.content.files):
        runs.setdefault(bucket_of_file(f), []).append(pq.read_table(f))
    return runs


def check_small(tmp: str, seed: int) -> None:
    """A small covering build on the CPU (plain versions) and on the GPU
    (kernels) must write the same bucket files: same rows, same order."""
    import hyperspace_tpu_torch as ht

    src = gen_lineitem(os.path.join(tmp, "small"), 60_000, 3, seed + 1)
    runs = []
    for device in ("cpu", "cuda"):
        sess = ht.Session(
            conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, f"small-{device}"), ht.keys.NUM_BUCKETS: 16,
                  ht.keys.BUILD_BATCH_ROWS: 25_000},
            device=device,
        )
        cfg = ht.CoveringIndexConfig("small", ["l_orderkey", "l_extendedprice"], ["l_shipdate"])
        runs.append(bucket_runs(ht.Hyperspace(sess).create_index(sess.read_parquet(src), cfg)))
    cpu, gpu = runs
    assert cpu.keys() == gpu.keys()
    for b in cpu:
        # a bucket's runs (one per chunk) carry random file-name tags, so
        # they are compared as a set of whole files
        want = sorted(repr(t.to_pydict()) for t in cpu[b])
        assert sorted(repr(t.to_pydict()) for t in gpu[b]) == want, f"bucket {b}: GPU build differs from the CPU build"
    print("small: 60000 rows, 16 buckets: GPU bucket files equal the CPU build's", flush=True)


def check_covering(entry, src_files, key: str, columns, num_buckets: int) -> int:
    """Every row of every bucket file hashes to its bucket and files are
    sorted by the key; the rows, as a multiset, are the source's."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.ops import encode, hashing

    tables = []
    for b, files in bucket_runs(entry).items():
        assert 0 <= b < num_buckets
        for t in files:
            k = t.column(key).to_numpy()
            got = hashing.bucket_ids_np([encode.hash_input_uint32(k)], num_buckets)
            assert np.all(got == b), f"{entry.name}: rows outside bucket {b}"
            sk = encode.sort_key_int64(k)
            assert np.all(sk[1:] >= sk[:-1]), f"{entry.name}: bucket {b} not sorted by {key}"
            tables.append(t.select(columns))
    idx = pa.concat_tables(tables)
    src = pa.concat_tables([pq.read_table(f, columns=columns) for f in src_files])
    assert idx.num_rows == src.num_rows, f"{entry.name}: {idx.num_rows} rows, source has {src.num_rows}"

    def canonical(t):
        cols = [encode.sort_key_int64(t.column(c).to_numpy()) for c in columns]
        order = np.lexsort(cols[::-1])
        return [c[order] for c in cols]

    for a, s, c in zip(canonical(idx), canonical(src), columns):
        assert np.array_equal(a, s), f"{entry.name}: column {c} differs from the source rows"
    return idx.num_rows


def check_sketches(entry, index) -> None:
    import numpy as np
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.indexes.dataskipping import _restore_bound

    table = index.read_sketch_table(entry).to_pydict()
    by_id = {fi.file_id: fi.name for fi in entry.source_file_infos()}
    assert len(table["_data_file_id"]) == len(by_id)
    for i, fid in enumerate(table["_data_file_id"]):
        data = pq.read_table(by_id[fid])
        for s in index.sketches:
            v = data.column(s.expr).to_numpy()
            lo_name, hi_name = s.output_names()
            want_lo = _restore_bound(float(np.nanmin(v)), v.dtype, lower=True)
            want_hi = _restore_bound(float(np.nanmax(v)), v.dtype, lower=False)
            assert table[lo_name][i] == want_lo and table[hi_name][i] == want_hi, (
                f"sketch of {s.expr} for {by_id[fid]}: {table[lo_name][i]}..{table[hi_name][i]}"
                f" != {want_lo}..{want_hi}"
            )


#: chrome-trace categories of work on the device itself
DEVICE_EVENT_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_profile(label: str, run, tmp: str, highlight=()) -> dict:
    """``run()`` once under torch.profiler, tracing the device only. Device
    busy time is the union of the trace's kernel and copy intervals, so
    nothing counts twice, set against ``run``'s wall time; the device time
    by kernel follows (the ten largest, and names containing any of
    ``highlight`` wherever they rank). A short profile first starts the
    tracer, so its start-up stays out of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    path = os.path.join(tmp, "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATEGORIES]
    if not events:
        print(f"profile {label}: the profiler saw no device work; device busy share not measured", flush=True)
        return {"wall_ms": wall_ms, "busy_ms": None}
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy_ms = busy_us / 1e3
    by_name = {}
    for e in events:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + float(e["dur"]) / 1e3, count + 1)
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.3f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.3f}%)", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (ms, count)) in enumerate(ranked):
        if rank < 10 or any(h in name for h in highlight):
            print(f"profile   {ms:9.3f} ms  x{count:<4d} #{rank + 1:<3d} {name[:100]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def profile_build(hs, df, cfg, tmp: str) -> None:
    """One more covering build under torch.profiler (``device_profile``)."""
    device_profile(cfg.index_name, lambda: hs.create_index(df, cfg), tmp,
                   highlight=("bucket_histogram", "segmented_min_max"))


# --- the filter query ---------------------------------------------------------


def gen_query_lake(root: str, rows_total: int, num_files: int, seed: int) -> str:
    """A small lake for the query checks: an int64 key ``id`` (some values
    around 2^53), an int64 ``z`` in [-3, 3] (zero divisors), a float64 ``f``
    with NaN, -0.0 and ±inf, a nullable int64 ``n``, a date ``d`` with nulls
    and a string ``s`` with nulls."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = os.path.join(root, "qsmall")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = rows_total // num_files
    for i in range(num_files):
        n = per if i < num_files - 1 else rows_total - per * (num_files - 1)
        ids = np.arange(i * per, i * per + n, dtype=np.int64)
        ids[::997] = 2**53 + rng.integers(-2, 4, ids[::997].size)
        f = np.round(rng.standard_normal(n) * 4, 1)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.05] = -0.0
        f[::1009] = np.inf
        f[1::1013] = -np.inf
        pq.write_table(pa.table({
            "id": ids,
            "z": rng.integers(-3, 4, n),
            "f": f,
            "n": pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.1),
            "d": pa.array(np.datetime64("1996-01-01") + rng.integers(0, 900, n).astype("timedelta64[D]"),
                          mask=rng.random(n) < 0.05),
            "s": pa.array([f"s{x}" for x in rng.integers(0, 60, n)], mask=rng.random(n) < 0.05),
        }), os.path.join(d, f"part-{i:05d}.parquet"))
    return d


def small_queries():
    """{name: (predicate of ``col``, selected columns)}: every predicate
    names the index's first column ``id``, so FilterIndexRule applies."""
    import numpy as np

    return {
        "compare_ops": (lambda c: (c("id") > 1000) & (c("id") <= 40000) & (c("f") >= -0.0) & (c("f") != 1.5),
                        ["id", "f"]),
        "eq_lt": (lambda c: ((c("id") < 30000) & (c("f") == 0.0)) | (c("id") == 7), ["id", "f", "s"]),
        "string_present": (lambda c: (c("id") >= 0) & (c("s") == "s17"), ["id", "s"]),
        "string_absent": (lambda c: (c("id") < 50000) & ((c("s") == "s17x") | (c("s") != "zzz")), ["id", "s"]),
        "is_null": (lambda c: (c("id") < 20000) & c("n").is_null(), ["id", "n"]),
        "not_over_null": (lambda c: (c("id") > 100) & ~(c("s") == "s3"), ["id", "s"]),
        "kleene": (lambda c: (c("id") < 100) | ((c("f") > 1.0) & (c("s") == "s5"))
                   | ~(c("d") < np.datetime64("1997-06-01")), ["id", "f", "s", "d"]),
        "in_numeric": (lambda c: c("id").isin(1, 2, 3, 500, 59999, 2**53 + 1), ["id", "z"]),
        "in_string": (lambda c: (c("id") > 10) & c("s").isin("s1", "s2", "nope"), ["id", "s"]),
        "div_mod_zero": (lambda c: (c("id") >= 0) & ((c("id") % c("z")) == 0) & ((c("id") / c("z")) > 100.5),
                         ["id", "z"]),
        "div_mod_lit": (lambda c: ((c("id") % 7) == 3) & ((c("id") / 2) < 20000.5), ["id"]),
        "date_range": (lambda c: (c("id") >= 0) & (c("d") >= np.datetime64("1996-06-01"))
                       & (c("d") < np.datetime64("1997-01-01")), ["id", "d"]),
        "above_2p53": (lambda c: c("id") >= 9007199254740993.0, ["id"]),
    }


def same_objects(g, w) -> bool:
    """Equal object columns, element by element; a NaN equals a NaN (the
    generic merge fills each null-extended string with its own NaN)."""
    return len(g) == len(w) and all(x is y or x == y or (x != x and y != y) for x, y in zip(g.tolist(), w.tolist()))


def same_batch(got, want) -> bool:
    """Equal columns, dtypes and bytes, in order."""
    if list(got) != list(want):
        return False
    for k in want:
        g, w = got[k], want[k]
        if g.dtype != w.dtype:
            return False
        if not same_objects(g, w) if w.dtype == object else (g.tobytes() != w.tobytes()):
            return False
    return True


def canonical(batch):
    """The batch's rows in one canonical order (a multiset's form)."""
    import numpy as np

    from hyperspace_tpu_torch.ops import encode

    cols = list(batch)
    keys = [encode.sort_key_int64(batch[c]) for c in cols]
    order = np.lexsort(keys[::-1]) if cols else np.zeros(0, dtype=np.int64)
    return {c: batch[c][order] for c in cols}


def as_multiset(batch):
    """``canonical`` with datetimes at one unit: the generic merge hands key
    columns back through pandas, which keeps dates at second resolution."""
    return canonical({k: v.astype("datetime64[us]") if v.dtype.kind == "M" else v for k, v in batch.items()})


def plan_index_scans(plan):
    from hyperspace_tpu_torch.plan import logical as L

    return L.collect(plan, lambda p: isinstance(p, L.IndexScan))


def traced_collect(df):
    """(result, dispatch-trace summary) of ``df.collect()``."""
    from hyperspace_tpu_torch.exec import trace

    with trace.recording() as events:
        got = df.collect()
    return got, trace.summarize(events)


def check_query_small(tmp: str, seed: int) -> dict:
    """The small lake's filter queries on the GPU against the CPU port (byte
    for byte, in order) and against hyperspace off (as a multiset)."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    src = gen_query_lake(tmp, 60_000, 3, seed + 2)
    sessions = {}
    for device in ("cpu", "cuda"):
        sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, f"qsmall-{device}"), ht.keys.NUM_BUCKETS: 16,
                                ht.keys.DEVICE_MIN_ROWS: 0}, device=device)
        ht.Hyperspace(sess).create_index(sess.read_parquet(src),
                                         ht.CoveringIndexConfig("qsmall", ["id"], ["z", "f", "n", "d", "s"]))
        sess.enable_hyperspace()
        sessions[device] = sess
    queries = small_queries()
    kernels.reset_launches()
    D.reset_dispatches()
    rows = {}
    for name, (pred, cols) in queries.items():
        got = {}
        for device, sess in sessions.items():
            df = sess.read_parquet(src).filter(pred(ht.col)).select(*cols)
            scans = plan_index_scans(df.optimized_plan())
            assert len(scans) == 1 and scans[0].entry.name == "qsmall", f"{name}: {df.optimized_plan().pretty()}"
            got[device], summary = traced_collect(df)
            assert "filter: device x1" in summary.splitlines(), f"{name} on {device}: {summary}"
        assert same_batch(got["cuda"], got["cpu"]), f"{name}: the GPU result differs from the CPU port's"
        with sessions["cpu"].hyperspace_scope(False):
            off, summary = traced_collect(sessions["cpu"].read_parquet(src).filter(pred(ht.col)).select(*cols))
        assert "filter: host x1" in summary.splitlines(), summary
        assert same_batch(canonical(got["cuda"]), canonical(off)), f"{name}: differs from hyperspace off"
        rows[name] = len(next(iter(off.values())))
        print(f"query-small {name}: {rows[name]} rows; GPU equals the CPU port byte for byte and hyperspace off "
              f"as a multiset; filter: device", flush=True)
    # each query ran once per session: the CPU session's run is a
    # dispatch of the same program on the CPU device
    assert D.dispatches["fused-filter"] == 2 * len(queries), dict(D.dispatches)
    assert not any(kernels.launches.values()), dict(kernels.launches)
    assert all(rows.values()), rows
    return {"queries": len(queries), "rows": rows, "dispatches": dict(D.dispatches)}


def median_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn()`` over ``reps`` calls, each ending
    with the device synchronised."""
    import statistics

    import torch

    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def layer_ms(sess, fn, reps: int) -> dict:
    """Median host milliseconds of ``fn()`` (``total``, each run ending with
    the device synchronised) and of each query layer that the run itself
    added to ``sess.query_stage_seconds``, over ``reps`` runs; ``rest`` is a
    run's total less its layers (result assembly and the executor's own
    walk), not counting the ``prefetch_*`` layers, whose time the scan
    pipeline's threads spent beside the consumer's."""
    import statistics

    import torch

    runs = []
    for _ in range(reps):
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        run = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        run["rest"] = total - sum(v for k, v in run.items() if not k.startswith("prefetch_"))
        run["total"] = total
        runs.append(run)
    return {k: statistics.median(r.get(k, 0.0) for r in runs) for k in runs[0]}


def program_bound(plan, rows: int, hbm: float):
    """The predicate program's bound: each referenced column read once as
    the device holds it (int32 codes for strings, 8 bytes otherwise), the
    bool mask written once, two operations per column and row."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.plan import logical as L

    (node,) = L.collect(plan, lambda p: isinstance(p, L.Filter))
    schema = pq.read_schema(node.child.files[0])
    refs = sorted(node.condition.references())
    width = sum(4 if pa.types.is_string(schema.field(r).type) else 8 for r in refs)
    return bound(width * rows + rows, 2 * len(refs) * rows, hbm)


def q6_filter(df):
    """TPC-H q6's filter over ``lineitem``."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    c = ht.col
    return df.filter(
        (c("l_shipdate") >= np.datetime64("1994-01-01")) & (c("l_shipdate") < np.datetime64("1995-01-01"))
        & (c("l_discount") >= 0.05) & (c("l_discount") <= 0.07) & (c("l_quantity") < 24)
    )


def q6_query(df):
    """TPC-H q6's filter, selecting what q6 sums."""
    return q6_filter(df).select("l_extendedprice", "l_discount")


def run_queries(sess, src: str, args, smi: str, hbm: float) -> dict:
    """TPC-H q6's filter and a point lookup through the SF1 indexes, on the
    device (``deviceMinRows=0``), against hyperspace off; then timed."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.ops import kernels

    c = ht.col
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    sess.conf.set(ht.keys.FILTER_RULE_USE_BUCKET_SPEC, "true")
    df = sess.read_parquet(src)
    q6 = q6_query(df)
    first = sorted(os.path.join(src, f) for f in os.listdir(src))[0]
    key = int(pq.read_table(first, columns=["l_orderkey"]).column(0)[0].as_py())
    lookup = df.filter(c("l_orderkey") == key).select("l_orderkey", "l_extendedprice")
    queries = {"q6": (q6, "li_shipdate", None, "index"),
               "lookup": (lookup, "li_orderkey", 1, "index-bucket-pruned(1 buckets)")}

    sess.enable_hyperspace()
    torch.cuda.synchronize()
    kernels.reset_launches()
    D.reset_dispatches()
    out = {}
    for name, (q, index, n_buckets, scan_line) in queries.items():
        plan = q.optimized_plan()
        print(f"plan {name}:\n{plan.pretty()}", flush=True)
        scans = plan_index_scans(plan)
        assert len(scans) == 1 and scans[0].entry.name == index, f"{name}: {plan.pretty()}"
        if n_buckets is not None:
            assert scans[0].pruned_buckets is not None and len(scans[0].pruned_buckets) == n_buckets
        IO.clear_io_cache()
        D.clear_device_cache()
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        cold_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        cold_layers.update(rest=cold - sum(cold_layers.values()), total=cold)
        print(f"trace {name}: " + "; ".join(summary.splitlines()), flush=True)
        lines = summary.splitlines()
        assert "filter: device x1" in lines and f"scan: {scan_line} x1" in lines, summary
        with sess.hyperspace_scope(False):
            off, off_summary = traced_collect(q)
            off_ms = median_ms(q.collect, min(args.reps, 5))
        assert "filter: host x1" in off_summary.splitlines(), off_summary
        n_rows = len(next(iter(got.values())))
        assert n_rows > 0 and same_batch(canonical(got), canonical(off)), f"{name}: differs from hyperspace off"
        warm_layers = layer_ms(sess, q.collect, args.reps)
        warm = warm_layers["total"]
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 1 << 25)
        _, host_summary = traced_collect(q)
        assert "filter: host x1" in host_summary.splitlines(), host_summary
        host_layers = layer_ms(sess, q.collect, args.reps)
        host_warm = host_layers["total"]
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
        scanned = sum(pq.ParquetFile(f).metadata.num_rows for f in scans[0].files)
        p_bound, p_by = program_bound(plan, scanned, hbm)
        out[name] = {"name": name, "index": index, "rows": n_rows, "rows_scanned": scanned,
                     "files": len(scans[0].files), "cold_ms": cold, "warm_ms": warm, "host_warm_ms": host_warm,
                     "off_ms": off_ms, "rows_scanned_per_s": scanned / (warm / 1e3),
                     "program_bound_ms": p_bound, "program_bound_by": p_by,
                     "layers_ms": {"cold": cold_layers, "warm": warm_layers, "host_warm": host_layers}}
        print(f"query {name}: {n_rows} rows of {scanned} scanned ({len(scans[0].files)} files), equal to hyperspace "
              f"off; cold {cold:.3f} ms, warm {warm:.3f} ms ({scanned / (warm / 1e3):.0f} rows/s), warm on the host "
              f"path {host_warm:.3f} ms, hyperspace off {off_ms:.3f} ms ({smi})", flush=True)
        for run, layers in out[name]["layers_ms"].items():
            print(f"layers {name} ({run}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in layers.items())
                  + f" ({smi})", flush=True)
    torch.cuda.synchronize()
    dispatches, launches = dict(D.dispatches), dict(kernels.launches)
    print(f"query path: dispatches {dispatches}, kernel launches {launches}", flush=True)
    assert dispatches.get("fused-filter", 0) > 0, "the query path never reached the device"
    return {"queries": list(out.values()), "dispatches": dispatches, "launches": launches}


# --- the join -----------------------------------------------------------------


def gen_join_lake(root: str, seed: int):
    """A small two-table lake for the join checks: ``fact`` (40 000 rows in
    3 files) with duplicate int keys ``k``, a second key ``k2``, a string key
    ``s`` and a date key ``d`` (no nulls in keys), a float payload ``v`` and
    nullable int, string and date payloads; ``dim`` (5 000 rows in 2 files)
    with the matching keys ``dk``/``dk2``/``ds``/``dd``, some absent on the
    fact side and some fact keys absent here, and payloads ``w``, ``dn``,
    ``dstr``. Returns (fact dir, dim dir)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    base = np.datetime64("1996-01-01")
    dirs = []
    for name, files, rows, keys, payload in (
        ("fact", 3, 40_000, ("k", "k2", "s", "d"), ("v", "n", "str", "nd")),
        ("dim", 2, 5_000, ("dk", "dk2", "ds", "dd"), ("w", "dn", "dstr", None)),
    ):
        d = os.path.join(root, "join", name)
        os.makedirs(d, exist_ok=True)
        per = rows // files
        for i in range(files):
            n = per if i < files - 1 else rows - per * (files - 1)
            lo = 0 if name == "fact" else 500
            cols = {
                keys[0]: rng.integers(lo, lo + 6_000, n).astype(np.int64),
                keys[1]: rng.integers(0, 3, n).astype(np.int64),
                keys[2]: np.array([f"s{x}" for x in rng.integers(lo // 2, lo // 2 + 3_000, n)], dtype=object),
                keys[3]: base + rng.integers(lo // 4, lo // 4 + 1_500, n).astype("timedelta64[D]"),
                payload[0]: np.round(rng.standard_normal(n), 3),
                payload[1]: pa.array(rng.integers(-(2**40), 2**40, n), mask=rng.random(n) < 0.1),
                payload[2]: pa.array([f"p{x}" for x in rng.integers(0, 100, n)], mask=rng.random(n) < 0.05),
            }
            if payload[3]:
                cols[payload[3]] = pa.array(base + rng.integers(0, 900, n).astype("timedelta64[D]"),
                                            mask=rng.random(n) < 0.05)
            pq.write_table(pa.table(cols), os.path.join(d, f"part-{i:05d}.parquet"))
        dirs.append(d)
    return tuple(dirs)


#: the join-small indexes: (side, name, indexed, included)
JOIN_SMALL_INDEXES = (
    ("fact", "f_k", ["k"], ["v", "n", "str", "nd"]),
    ("dim", "d_k", ["dk"], ["w", "dn", "dstr"]),
    ("fact", "f_k2", ["k", "k2"], ["v"]),
    ("dim", "d_k2", ["dk", "dk2"], ["w"]),
    ("fact", "f_s", ["s"], ["v", "n"]),
    ("dim", "d_s", ["ds"], ["w"]),
    ("fact", "f_d", ["d"], ["v"]),
    ("dim", "d_d", ["dd"], ["w", "dstr"]),
)


def small_joins(f, d, c):
    """{name: (DataFrame, the two indexes its plan must scan)} over the
    fact and dim frames ``f`` and ``d``; ``c`` is ``col``."""
    on_k = c("k") == c("dk")
    wide = ("k", "v", "n", "str", "nd", "dk", "w", "dn", "dstr")
    return {
        "inner_int": (f.join(d, on_k).select(*wide), {"f_k", "d_k"}),
        "inner_filtered": (f.filter(c("v") > 0).join(d.filter(c("w") < 0.5), on_k).select("k", "v", "n", "w"),
                           {"f_k", "d_k"}),
        "left": (f.join(d, on_k, how="left").select(*wide), {"f_k", "d_k"}),
        "right": (f.join(d, on_k, how="right").select(*wide), {"f_k", "d_k"}),
        "outer": (f.join(d, on_k, how="outer").select(*wide), {"f_k", "d_k"}),
        "composite": (f.join(d, (c("k") == c("dk")) & (c("k2") == c("dk2"))).select("k", "k2", "v", "dk2", "w"),
                      {"f_k2", "d_k2"}),
        "string_key": (f.join(d, c("s") == c("ds")).select("s", "v", "n", "ds", "w"), {"f_s", "d_s"}),
        "date_key": (f.join(d, c("d") == c("dd")).select("d", "v", "dd", "w", "dstr"), {"f_d", "d_d"}),
        "self_join": (f.join(f, on=["k"]).select("k", "v", "v#r", "nd#r"), {"f_k"}),
    }


def check_join_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """The small lake's joins on the GPU against the CPU port (byte for
    byte, in order, the same ``join:`` trace) and against hyperspace off,
    the generic merge (as a multiset). The indexes are built in a CPU and in
    a GPU session, and each device queries both builds: rows with equal keys
    come in the order of their bucket's runs, which differs between two
    builds (run files carry random names), so results compare per build."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    fact, dim = gen_join_lake(tmp, seed + 3)

    def session(owner, device):
        return ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, f"jsmall-{owner}"), ht.keys.NUM_BUCKETS: 8,
                                ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES: 1 << 31,
                                ht.keys.BUILD_BATCH_ROWS: 15_000}, device=device)

    for owner in devices:
        sess = session(owner, owner)
        for side, name, indexed, included in JOIN_SMALL_INDEXES:
            ht.Hyperspace(sess).create_index(sess.read_parquet(fact if side == "fact" else dim),
                                             ht.CoveringIndexConfig(name, indexed, included))
    sessions = {(owner, device): session(owner, device).enable_hyperspace() for owner in devices for device in devices}
    kernels.reset_launches()
    D.reset_dispatches()
    rows = {}
    names = list(small_joins(*(sessions[devices[0], devices[0]].read_parquet(p) for p in (fact, dim)), ht.col))
    for name in names:
        for owner in devices:
            got, lines = {}, {}
            for device in devices:
                sess = sessions[owner, device]
                df, indexes = small_joins(sess.read_parquet(fact), sess.read_parquet(dim), ht.col)[name]
                scans = plan_index_scans(df.optimized_plan())
                assert len(scans) == 2 and {s.entry.name for s in scans} == indexes, \
                    f"{name}: {df.optimized_plan().pretty()}"
                got[device], summary = traced_collect(df)
                lines[device] = [ln for ln in summary.splitlines() if ln.startswith(("join:", "scan:"))]
                assert lines[device] == ["join: device-smj x1", "scan: index-bucketed x2"], \
                    f"{name} on {device}: {summary}"
            assert same_batch(got[devices[-1]], got[devices[0]]), \
                f"{name} over the {owner} build: the GPU result differs from the CPU port's"
        cpu = sessions[devices[0], devices[0]]
        with cpu.hyperspace_scope(False):
            off_df = small_joins(cpu.read_parquet(fact), cpu.read_parquet(dim), ht.col)[name][0]
            off, summary = traced_collect(off_df)
        assert "join: generic-merge x1" in summary.splitlines(), summary
        assert same_batch(as_multiset(got[devices[-1]]), as_multiset(off)), f"{name}: differs from hyperspace off"
        rows[name] = len(next(iter(off.values())))
        print(f"join-small {name}: {rows[name]} rows; over either build, GPU equals the CPU port byte for byte and "
              f"hyperspace off as a multiset; join: device-smj", flush=True)
    assert not any(kernels.launches.values()), dict(kernels.launches)
    assert all(rows.values()), rows
    # each join ran once per (build, device) pair (the CPU runs are the same
    # programs on the CPU device); the three outer joins expand on the host
    runs = len(devices) ** 2
    assert D.dispatches["bucketed-smj-span"] == runs * len(names), dict(D.dispatches)
    assert D.dispatches["join-expand-gather"] == runs * (len(names) - 3), dict(D.dispatches)
    return {"joins": len(names), "rows": rows, "dispatches": dict(D.dispatches)}


def gen_orders(root: str, rows_total: int, num_files: int, seed: int) -> str:
    """TPC-H-shaped ``orders`` (the repo's benchmarks/datagen.py columns and
    value ranges): ``o_orderkey`` is ``arange(rows_total)``, so every
    ``l_orderkey`` of ``gen_lineitem`` matches exactly one order."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    sf = rows_total / ORDERS_ROWS_SF1
    d = os.path.join(root, "orders")
    os.makedirs(d, exist_ok=True)
    per = max(1, rows_total // num_files)
    rng = np.random.default_rng(seed)
    for i in range(num_files):
        rows = per if i < num_files - 1 else rows_total - per * (num_files - 1)
        pq.write_table(pa.table(orders_columns(rng, i * per, rows, sf)), os.path.join(d, f"part-{i:05d}.parquet"))
    return d


def orders_columns(rng, first_key: int, rows: int, sf: float) -> dict:
    """One ``orders`` file's columns: order keys ``first_key`` on."""
    import numpy as np

    base = np.datetime64("1992-01-01")
    return {
        "o_orderkey": np.arange(first_key, first_key + rows, dtype=np.int64),
        "o_custkey": rng.integers(0, int(150_000 * max(sf, 0.01)), rows).astype(np.int64),
        "o_totalprice": np.round(rng.uniform(800.0, 600000.0, rows), 2),
        "o_orderdate": base + rng.integers(0, 2406, rows).astype("timedelta64[D]"),
        "o_shippriority": rng.integers(0, 2, rows).astype(np.int64),
    }


def join_queries(li, orders):
    """J1: BASELINE config [2]'s lineitem-orders join on the order key; J2:
    the same with a Filter over each side (q06_join_filter's shape)."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    c = ht.col
    cols = ("l_orderkey", "l_extendedprice", "o_orderdate", "o_totalprice")
    return {
        "J1": li.join(orders, c("l_orderkey") == c("o_orderkey")).select(*cols),
        "J2": li.filter(c("l_extendedprice") > 50000)
        .join(orders.filter(c("o_orderdate") < np.datetime64("1995-03-15")), c("l_orderkey") == c("o_orderkey"))
        .select(*cols),
    }


def clear_query_caches() -> None:
    """Empty every cache a query fills: decoded files, device columns and
    rectangles, join key encodings."""
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.exec import join as J

    IO.clear_io_cache()
    D.clear_device_cache()
    J.clear_rank_cache()


def capture_programs(run):
    """Run ``run()`` with the join's device programs wrapped to record their
    inputs: {program: (function, args)} of their last calls."""
    from hyperspace_tpu_torch.exec import join as J

    seen = {}
    real = {n: getattr(J, n) for n in ("bucketed_span", "bucket_pair_totals", "expand_gather")}

    def wrap(n):
        def f(*a):
            seen[n] = (real[n], a)
            return real[n](*a)

        return f

    for n in real:
        setattr(J, n, wrap(n))
    try:
        run()
    finally:
        for n, fn in real.items():
            setattr(J, n, fn)
    return seen


def program_times(seen, reps: int, hbm: float) -> dict:
    """Each join program of a warm run timed alone (CUDA events, median of
    ``reps``) beside its bound: every input read once and every output
    written once over the card's memory rate, or its operations (the span
    search's compares) over the core rate."""
    import math

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = {}
    fn, (lmat, rmat) = seen["bucketed_span"]
    nb, wl = lmat.shape
    wr = rmat.shape[1]
    b_ms, b_by = bound(nbytes(lmat, rmat) + 2 * lmat.numel() * 8, 2 * nb * wl * math.ceil(math.log2(max(wr, 2))), hbm)
    out["bucketed-smj-span"] = {"shape": f"lmat {nb}x{wl}, rmat {nb}x{wr} int64", "ms": time_ms(lambda: fn(lmat, rmat), reps),
                                "bound_ms": b_ms, "bound_by": b_by}
    fn, args = seen["bucket_pair_totals"]
    lo, hi, llens, rlens = args
    b_ms, b_by = bound(nbytes(lo, hi, llens, rlens) + nb * 8, 3 * lo.numel(), hbm)
    out["bucket-pair-totals"] = {"shape": f"lo, hi {nb}x{wl} int64", "ms": time_ms(lambda: fn(*args), reps),
                                 "bound_ms": b_ms, "bound_by": b_by}
    fn, args = seen["expand_gather"]
    lo, hi, llens, rlens, lmats, rmats, total = args
    b_ms, b_by = bound(nbytes(lo, hi, llens, rlens, *lmats, *rmats) + total * 8 * (len(lmats) + len(rmats) + 3),
                       total * (2 * math.ceil(math.log2(lo.numel())) + 8), hbm)
    out["join-expand-gather"] = {"shape": f"{total} pairs, {len(lmats)} left and {len(rmats)} right columns",
                                 "ms": time_ms(lambda: fn(*args), reps), "bound_ms": b_ms, "bound_by": b_by}
    for v in out.values():
        v["share_of_bound"] = v["bound_ms"] / v["ms"]
    return out


def run_joins(sess, li_src: str, tmp: str, args, smi: str, hbm: float) -> dict:
    """The SF1 ``orders`` lake and its index, then J1 and J2 on the device,
    against hyperspace off and the host-span path; then timed."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    t = time.perf_counter()
    o_src = gen_orders(tmp, ORDERS_ROWS_SF1, 8, args.seed + 1)
    print(f"lake: {ORDERS_ROWS_SF1} orders rows in 8 files ({time.perf_counter() - t:.3f} s)", flush=True)
    orders = sess.read_parquet(o_src)
    torch.cuda.synchronize()
    kernels.reset_launches()
    sess.build_stage_seconds.clear()
    t = time.perf_counter()
    ht.Hyperspace(sess).create_index(
        orders, ht.CoveringIndexConfig("o_orderkey", ["o_orderkey"], ["o_orderdate", "o_totalprice"]))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    build_launches = dict(kernels.launches)
    assert build_launches.get("bucket_histogram", 0) > 0, build_launches
    print(f"build o_orderkey: {build_s:.3f} s, {ORDERS_ROWS_SF1 / build_s:.0f} rows/s, launches {build_launches} "
          f"({smi})", flush=True)
    print("stages o_orderkey: " + ", ".join(f"{k} {v:.3f} s" for k, v in sess.build_stage_seconds.items()), flush=True)

    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    sess.conf.set(ht.keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES, 2 << 30)
    sess.enable_hyperspace()
    queries = join_queries(sess.read_parquet(li_src), orders)
    torch.cuda.synchronize()
    D.reset_dispatches()
    out = {}
    for name, q in queries.items():
        reps = args.reps if name == "J1" else max(3, args.reps // 3)
        plan = q.optimized_plan()
        print(f"plan {name}:\n{plan.pretty()}", flush=True)
        scans = plan_index_scans(plan)
        assert sorted(s.entry.name for s in scans) == ["li_orderkey", "o_orderkey"], plan.pretty()
        clear_query_caches()
        before = dict(D.dispatches)
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        cold_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        cold_layers.update(rest=cold - sum(cold_layers.values()), total=cold)
        print(f"trace {name}: " + "; ".join(summary.splitlines()), flush=True)
        lines = summary.splitlines()
        assert "join: device-smj x1" in lines and "scan: index-bucketed x2" in lines, summary
        for program in ("bucketed-smj-span", "join-expand-gather"):
            assert D.dispatches[program] == before.get(program, 0) + 1, (program, dict(D.dispatches))
        n_rows = len(next(iter(got.values())))
        warm_layers = layer_ms(sess, q.collect, reps)
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 1 << 25)
        host, host_summary = traced_collect(q)
        assert "join: host-span-smj x1" in host_summary.splitlines(), host_summary
        assert same_batch(host, got), f"{name}: the host-span path differs from the device path"
        del host
        host_layers = layer_ms(sess, q.collect, max(3, reps // 3))
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
        with sess.hyperspace_scope(False):
            off, off_summary = traced_collect(q)
            assert "join: generic-merge x1" in off_summary.splitlines(), off_summary
            assert n_rows > 0 and same_batch(as_multiset(got), as_multiset(off)), f"{name}: differs from hyperspace off"
            del off
            off_layers = layer_ms(sess, q.collect, 3)
        out[name] = {"name": name, "rows": n_rows, "files": [len(s.files) for s in scans],
                     "cold_ms": cold, "warm_ms": warm_layers["total"], "host_warm_ms": host_layers["total"],
                     "off_ms": off_layers["total"], "reps": reps,
                     "layers_ms": {"cold": cold_layers, "warm": warm_layers, "host_warm": host_layers,
                                   "off": off_layers}}
        print(f"join {name}: {n_rows} rows, equal to hyperspace off and to the host-span path; cold {cold:.3f} ms, "
              f"warm {warm_layers['total']:.3f} ms, warm on the host-span path {host_layers['total']:.3f} ms, "
              f"hyperspace off {off_layers['total']:.3f} ms ({smi})", flush=True)
        for run, layers in out[name]["layers_ms"].items():
            print(f"layers {name} ({run}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in layers.items())
                  + f" ({smi})", flush=True)
    torch.cuda.synchronize()
    dispatches = dict(D.dispatches)
    print(f"join path: dispatches {dispatches}", flush=True)
    seen = capture_programs(queries["J1"].collect)
    programs = program_times(seen, args.reps, hbm)
    for name, p in programs.items():
        print(f"program {name} ({p['shape']}): {p['ms']} ms, bound {p['bound_ms']} ms ({p['bound_by']}), "
              f"{100 * p['share_of_bound']:.1f}% of bound ({smi})", flush=True)
    return {"joins": list(out.values()), "dispatches": dispatches, "programs": programs,
            "o_orderkey_build_s": build_s, "o_orderkey_build_launches": build_launches}, queries["J1"], o_src


# --- aggregates -----------------------------------------------------------------


def same_groups(got, want, float_aggs, ordered: bool) -> bool:
    """Equal aggregate results: the same columns and dtypes, keys, counts,
    int sums, min and max exact, float sums, avg and stddev (``float_aggs``)
    at rtol 1e-9 (and atol 1e-9: a sum that cancels to about zero keeps an
    absolute error of its summation order); in order, or (``ordered=False``) as multisets of group
    rows, compared sorted by every exact column with dates at one unit (the
    generic merge keeps them at second resolution) and float keys by value
    (a group's -0.0 or +0.0 key is its first row's)."""
    import numpy as np

    from hyperspace_tpu_torch.ops import encode

    if list(got) != list(want):
        return False
    if not ordered:
        def norm(batch):
            batch = {k: v.astype("datetime64[us]") if v.dtype.kind == "M" else v for k, v in batch.items()}
            exact = [k for k in batch if k not in float_aggs]
            if not exact or not len(batch[exact[0]]):
                return batch
            order = np.lexsort([encode.sort_key_int64(batch[k] + 0.0 if batch[k].dtype.kind == "f" else batch[k])
                                for k in exact][::-1])
            return {k: v[order] for k, v in batch.items()}

        got, want = norm(got), norm(want)
    for k in want:
        g, w = got[k], want[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if w.dtype == object:
            # a null string key is None on the fused join path and NaN on
            # the host (pandas) path, in both packages
            def null(x):
                return x is None or x != x

            if not all(x == y or (null(x) and null(y)) for x, y in zip(g.tolist(), w.tolist())):
                return False
        elif k in float_aggs or (not ordered and w.dtype.kind == "f"):
            if not np.allclose(g, w, rtol=1e-9, atol=1e-9, equal_nan=True):
                return False
        elif g.tobytes() != w.tobytes():
            return False
    return True


def float_aggs_of(df) -> set:
    """Output names of a DataFrame's float-valued sums, averages and
    standard deviations (the ones that add floats in a varying order)."""
    from hyperspace_tpu_torch.plan import logical as L

    (agg,) = L.collect(df.plan, lambda p: isinstance(p, L.Aggregate))
    return {name for name, fn, _ in agg.aggs if fn in ("sum", "avg", "stddev_samp")}


def small_aggregates(q, f, d, c):
    """{name: (DataFrame, the ``agg:`` trace line)} over the query-small
    lake ``q`` (index ``qsmall`` on ``id``) and the join-small frames ``f``
    and ``d``; ``c`` is ``col``."""
    every = dict(rows=("*", "count"), nf=("f", "count"), sid=("id", "sum"), sf=("f", "sum"), mnz=("z", "min"),
                 mxf=("f", "max"), aid=("id", "avg"), af=("f", "avg"), mnid=("id", "min"), mxid=("id", "max"),
                 sdf=("f", "stddev_samp"), sn=("n", "sum"), mnn=("n", "min"))
    scan = "agg: device-grouped-scan x1"
    joined = f.join(d, c("k") == c("dk"))
    return {
        "global": (q.filter(c("id") > 100).agg(**{k: v for k, v in every.items() if k != "sdf"}),
                   "agg: device-fused-scan x1"),
        "global_no_match": (q.filter(c("id") < 0).agg(rows=("*", "count"), sf=("f", "sum"), mnz=("z", "min")),
                            "agg: device-fused-scan x1"),
        "by_int": (q.filter(c("id") >= 0).group_by("z").agg(**every), scan),
        "by_float": (q.filter(c("id") > 10).group_by("f").agg(rows=("*", "count"), sid=("id", "sum"),
                                                              sn=("n", "sum")), scan),
        "by_string": (q.filter(c("id") < 50_000).group_by("s").agg(**every), scan),
        "by_date": (q.filter(c("id") >= 0).group_by("d").agg(rows=("*", "count"), af=("f", "avg"),
                                                             mxid=("id", "max")), scan),
        "by_two_keys": (q.filter(c("id") >= 5).group_by("s", "z").agg(rows=("*", "count"), sf=("f", "sum"),
                                                                      sdf=("f", "stddev_samp")), scan),
        "many_groups": (q.filter(c("id") >= 0).group_by("n").agg(rows=("*", "count"), sf=("f", "sum")), scan),
        "join_global": (joined.agg(rows=("*", "count"), sv=("v", "sum"), sw=("w", "sum"), av=("v", "avg"),
                                   mnv=("v", "min"), mxk=("k", "max")), "agg: fused-bucketed-join x1"),
        "join_by_key": (joined.group_by("k").agg(rows=("*", "count"), sv=("v", "sum"), sw=("w", "sum")),
                        "agg: fused-bucketed-join x1"),
        "join_by_left": (joined.group_by("str").agg(rows=("*", "count"), sv=("v", "sum"), an=("n", "avg")),
                         "agg: fused-bucketed-join x1"),
    }


def check_agg_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """Aggregates over the query-small and join-small lakes, through the
    indexes those phases built in a CPU and in a GPU session: on the GPU
    against the CPU port over each build (in order; rows with equal keys
    follow their bucket's run files, whose names differ between builds)
    and against hyperspace off (as multisets of group rows)."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    q_src = os.path.join(tmp, "qsmall")
    fact, dim = os.path.join(tmp, "join", "fact"), os.path.join(tmp, "join", "dim")

    def frames(owner, device, enabled=True):
        """The query-small frame and the two join-small frames, read in
        sessions over ``owner``'s indexes."""
        out = []
        for kind, paths in (("qsmall", (q_src,)), ("jsmall", (fact, dim))):
            sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, f"{kind}-{owner}"),
                                    ht.keys.DEVICE_MIN_ROWS: 0}, device=device)
            sess.hyperspace_enabled = enabled
            out.extend(sess.read_parquet(p) for p in paths)
        return out

    kernels.reset_launches()
    D.reset_dispatches()
    groups = {}
    names = list(small_aggregates(*frames(devices[0], devices[0]), ht.col))
    for name in names:
        for owner in devices:
            got = {}
            for device in devices:
                df, line = small_aggregates(*frames(owner, device), ht.col)[name]
                assert plan_index_scans(df.optimized_plan()), f"{name}: {df.optimized_plan().pretty()}"
                got[device], summary = traced_collect(df)
                assert line in summary.splitlines(), f"{name} on {device} over the {owner} build: {summary}"
            assert same_groups(got[devices[-1]], got[devices[0]], float_aggs_of(df), ordered=True), \
                f"{name} over the {owner} build: the GPU result differs from the CPU port's"
        df = small_aggregates(*frames(devices[0], devices[0], enabled=False), ht.col)[name][0]
        off, summary = traced_collect(df)
        assert not any(ln.startswith("agg:") for ln in summary.splitlines()), summary
        assert same_groups(got[devices[-1]], off, float_aggs_of(df), ordered=False), \
            f"{name}: differs from hyperspace off"
        groups[name] = len(next(iter(off.values())))
        print(f"agg-small {name}: {groups[name]} groups; over either build, GPU equals the CPU port and hyperspace "
              f"off; {line.rsplit(' ', 1)[0]}", flush=True)
    assert not any(kernels.launches.values()), dict(kernels.launches)
    assert groups["many_groups"] > 256, groups  # past the capacity floor: one right-sized re-run
    # each scan aggregate ran once per (build, device) pair
    runs = len(devices) ** 2
    assert D.dispatches["fused-agg"] == runs * 2, dict(D.dispatches)
    assert D.dispatches["grouped-agg-chunk"] >= runs * 6, dict(D.dispatches)
    return {"aggregates": len(names), "groups": groups, "dispatches": dict(D.dispatches)}


def q1_query(df):
    """TPC-H q1 over plain columns (its two computed sums wait for computed
    columns): shipped by 1998-09-02, grouped by return flag and status."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    return (df.filter(ht.col("l_shipdate") <= np.datetime64("1998-09-02"))
            .group_by("l_returnflag", "l_linestatus")
            .agg(sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
                 avg_qty=("l_quantity", "avg"), avg_price=("l_extendedprice", "avg"),
                 avg_disc=("l_discount", "avg"), count_order=("*", "count"),
                 sd_price=("l_extendedprice", "stddev_samp")))


def agg_queries(li, orders):
    """A1: TPC-H q1 over plain columns; A2: q6's global aggregate; A3: a
    global aggregate over J1; A4: J2 grouped by order (the TPC-H q3 class)."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    c = ht.col
    j1 = li.join(orders, c("l_orderkey") == c("o_orderkey"))
    j2 = li.filter(c("l_extendedprice") > 50000).join(
        orders.filter(c("o_orderdate") < np.datetime64("1995-03-15")), c("l_orderkey") == c("o_orderkey"))
    return {
        "A1": (q1_query(li), ["li_q1"], "agg: device-grouped-scan x1"),
        "A2": (q6_filter(li).agg(revenue=("l_extendedprice", "sum"), n=("*", "count"),
                                 avg_disc=("l_discount", "avg"), min_qty=("l_quantity", "min"),
                                 max_qty=("l_quantity", "max")),
               ["li_shipdate"], "agg: device-fused-scan x1"),
        "A3": (j1.agg(n=("*", "count"), sum_price=("l_extendedprice", "sum"), sum_total=("o_totalprice", "sum"),
                      avg_price=("l_extendedprice", "avg"), min_price=("l_extendedprice", "min"),
                      max_price=("l_extendedprice", "max")),
               ["li_orderkey", "o_orderkey"], "agg: fused-bucketed-join x1"),
        "A4": (j2.group_by("l_orderkey", "o_orderdate").agg(revenue=("l_extendedprice", "sum"), n=("*", "count")),
               ["li_orderkey", "o_orderkey"], "agg: fused-bucketed-join x1"),
    }


def capture_agg_programs(run):
    """Run ``run()`` with the aggregate programs wrapped to record their
    inputs: {program: (program, args)} of their last calls."""
    from hyperspace_tpu_torch.exec import aggregate as A

    seen = {}
    real = {"fused-agg": A.fused_agg_program, "grouped-agg-chunk": A.grouped_chunk_program}

    def wrap(name):
        def make(*a):
            program = real[name](*a)

            def call(*args):
                seen[name] = (program, args)
                return program(*args)

            return call

        return make

    A.fused_agg_program, A.grouped_chunk_program = wrap("fused-agg"), wrap("grouped-agg-chunk")
    try:
        run()
    finally:
        A.fused_agg_program, A.grouped_chunk_program = real["fused-agg"], real["grouped-agg-chunk"]
    return seen


def agg_program_times(seen, reps: int, hbm: float) -> dict:
    """Each aggregate program of a warm run timed alone (CUDA events, median
    of ``reps``) beside its bound: the columns it reads, once each, and the
    outputs it writes, once, over the card's memory rate."""
    out = {}
    for name, (program, args) in seen.items():
        cols = args[0]
        read = sum(t.numel() * t.element_size() for t in cols.values())
        got = program(*args)
        written = 0
        for t in (got[1:] if name == "grouped-agg-chunk" else got):
            for x in (t if isinstance(t, tuple) else (t,)):
                written += x.numel() * x.element_size()
        b_ms, b_by = bound(read + written, 0, hbm)
        ms = time_ms(lambda: program(*args), reps)
        n = args[2]
        out[name] = {"shape": f"{n} rows, {len(cols)} columns ({', '.join(sorted(cols))})", "ms": ms,
                     "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms, "bytes": read + written}
    return out


def run_aggregates(sess, li_src: str, o_src: str, tmp: str, args, smi: str, hbm: float) -> dict:
    """The ``li_q1`` build, then A1-A4 on the device path against hyperspace
    off and the host path; then timed, and the two programs alone."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    li = sess.read_parquet(li_src)
    torch.cuda.synchronize()
    kernels.reset_launches()
    sess.build_stage_seconds.clear()
    t = time.perf_counter()
    ht.Hyperspace(sess).create_index(li, ht.CoveringIndexConfig(
        "li_q1", ["l_shipdate"],
        ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax"]))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    build_launches = dict(kernels.launches)
    assert build_launches.get("bucket_histogram", 0) > 0, build_launches
    build_stages = dict(sess.build_stage_seconds)
    print(f"build li_q1: {build_s:.3f} s, {args.rows / build_s:.0f} rows/s, launches {build_launches} ({smi})",
          flush=True)
    print("stages li_q1: " + ", ".join(f"{k} {v:.3f} s" for k, v in build_stages.items()), flush=True)

    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    sess.enable_hyperspace()
    queries = agg_queries(li, sess.read_parquet(o_src))
    torch.cuda.synchronize()
    D.reset_dispatches()
    out = {}
    for name, (q, indexes, line) in queries.items():
        reps = args.reps if name in ("A1", "A2") else max(3, args.reps // 3)
        floats = float_aggs_of(q)
        plan = q.optimized_plan()
        print(f"plan {name}:\n{plan.pretty()}", flush=True)
        assert sorted(s.entry.name for s in plan_index_scans(plan)) == indexes, plan.pretty()
        clear_query_caches()
        before = dict(D.dispatches)
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        cold_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        cold_layers.update(rest=cold - sum(cold_layers.values()), total=cold)
        print(f"trace {name}: " + "; ".join(summary.splitlines()), flush=True)
        assert line in summary.splitlines(), summary
        if name in ("A1", "A2"):
            program = "grouped-agg-chunk" if name == "A1" else "fused-agg"
            assert D.dispatches[program] == before.get(program, 0) + 1, (program, dict(D.dispatches))
        groups = len(next(iter(got.values())))
        warm_layers = layer_ms(sess, q.collect, reps)
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 1 << 25)
        host, host_summary = traced_collect(q)
        if name in ("A1", "A2"):
            assert not any(ln.startswith("agg:") for ln in host_summary.splitlines()), host_summary
        assert same_groups(got, host, floats, ordered=True), f"{name}: the host path differs from the device path"
        del host
        host_layers = layer_ms(sess, q.collect, max(3, reps // 3))
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
        extra = {}
        if name in ("A3", "A4"):
            # the aggregate over the materialized join (the device tiers off:
            # the generic merge, then the host aggregate)
            sess.conf.set(ht.keys.DEVICE_EXECUTION, "false")
            t = time.perf_counter()
            mat, mat_summary = traced_collect(q)
            extra["materialized_ms"] = (time.perf_counter() - t) * 1e3
            sess.conf.set(ht.keys.DEVICE_EXECUTION, "true")
            assert "join: generic-merge x1" in mat_summary.splitlines(), mat_summary
            assert same_groups(got, mat, floats, ordered=False), f"{name}: differs from the materialized join's"
            del mat
        with sess.hyperspace_scope(False):
            off, off_summary = traced_collect(q)
            assert not any(ln.startswith("agg:") for ln in off_summary.splitlines()), off_summary
            assert groups > 0 and same_groups(got, off, floats, ordered=False), f"{name}: differs from hyperspace off"
            del off
            off_layers = layer_ms(sess, q.collect, 3)
        out[name] = {"name": name, "groups": groups, "cold_ms": cold, "warm_ms": warm_layers["total"],
                     "host_warm_ms": host_layers["total"], "off_ms": off_layers["total"], "reps": reps, **extra,
                     "layers_ms": {"cold": cold_layers, "warm": warm_layers, "host_warm": host_layers,
                                   "off": off_layers}}
        if name == "A1":
            out[name]["result"] = {k: v.tolist() for k, v in got.items()}
        print(f"agg {name}: {groups} groups, equal to hyperspace off and to the host path; cold {cold:.3f} ms, "
              f"warm {warm_layers['total']:.3f} ms, warm on the host path {host_layers['total']:.3f} ms, "
              f"hyperspace off {off_layers['total']:.3f} ms"
              + (f", over the materialized join {extra['materialized_ms']:.3f} ms" if extra else "") + f" ({smi})",
              flush=True)
        for run, layers in out[name]["layers_ms"].items():
            print(f"layers {name} ({run}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in layers.items())
                  + f" ({smi})", flush=True)
    torch.cuda.synchronize()
    dispatches = dict(D.dispatches)
    print(f"agg path: dispatches {dispatches}", flush=True)
    seen = {}
    for name in ("A1", "A2"):
        seen.update(capture_agg_programs(queries[name][0].collect))
    programs = agg_program_times(seen, args.reps, hbm)
    for name, p in programs.items():
        print(f"program {name} ({p['shape']}): {p['ms']} ms, bound {p['bound_ms']} ms ({p['bound_by']}), "
              f"{100 * p['share_of_bound']:.2f}% of bound ({smi})", flush=True)
    return {"aggregates": list(out.values()), "dispatches": dispatches, "programs": programs,
            "li_q1_build_s": build_s, "li_q1_build_stages": build_stages,
            "li_q1_build_launches": build_launches}, queries["A1"][0]


# --- out-of-core execution ------------------------------------------------------

#: the streamed aggregate's gates lowered: every index file its own chunk
AGG_STREAM_SMALL = {"hyperspace.exec.stream.aggMinBytes": 1, "hyperspace.exec.stream.chunkBytes": 1}


def index_bytes(system: str, name: str) -> int:
    """On-disk bytes of index ``name``'s data files under ``system``."""
    total = 0
    for dirpath, _, names in os.walk(os.path.join(system, name)):
        if "_hyperspace_log" not in dirpath:
            total += sum(os.path.getsize(os.path.join(dirpath, n)) for n in names if n.endswith(".parquet"))
    return total


def trace_lines(summary: str, prefixes=("agg:", "join:")) -> list:
    return [ln for ln in summary.splitlines() if ln.startswith(prefixes)]


def assert_no_fallback(summary: str, what: str) -> None:
    assert "stream-fallback" not in summary, f"{what}: the streamed path fell back: {summary}"


class ReadSpy:
    """Counts parquet decodes started and finished through the port's
    reader while installed (``with ReadSpy() as spy``)."""

    def __enter__(self):
        from hyperspace_tpu_torch.exec import io as IO

        self.real = IO.read_parquet_batch
        self.started = self.finished = 0

        def spy(files, columns, predicate=None):
            self.started += 1
            out = self.real(files, columns, predicate=predicate)
            self.finished += 1
            return out

        IO.read_parquet_batch = spy
        return self

    def __exit__(self, *exc):
        from hyperspace_tpu_torch.exec import io as IO

        IO.read_parquet_batch = self.real


def small_stream_aggregates(q, c):
    """{name: (DataFrame, conf beyond AGG_STREAM_SMALL, the ``agg:`` lines)}
    over the query-small lake ``q``: every streamable function, the
    distinct forms, string (nulls), float (NaN, -0.0, ±inf), date (nulls)
    and int keys, and two spills: a chunk above ``maxGroups``, and a merge
    above it."""
    every = dict(rows=("*", "count"), nf=("f", "count"), sid=("id", "sum"), sf=("f", "sum"), mnz=("z", "min"),
                 mxf=("f", "max"), aid=("id", "avg"), af=("f", "avg"), mnid=("id", "min"), mxid=("id", "max"),
                 sdf=("f", "stddev_samp"), sn=("n", "sum"), mnn=("n", "min"))
    distinct = dict(nds=("s", "count_distinct"), sdz=("z", "sum_distinct"), adf=("f", "avg_distinct"))
    dev = ["agg: device-grouped-stream x1", "agg: streamed-partial x1"]
    host = ["agg: streamed-partial x1"]
    return {
        "global": (q.filter(c("id") > 100).agg(**every, **distinct), {}, host),
        "by_int": (q.filter(c("id") >= 0).group_by("z").agg(**every), {}, dev),
        # not over ``f`` itself: its stddev is 0 in every group, and the
        # (n, sum, sum of squares) form cancels to noise of order
        # sqrt(eps) * |f| that another summation order changes (ROADMAP C)
        "by_float": (q.filter(c("id") > 10).group_by("f").agg(**{k: v for k, v in every.items() if v[0] != "f"}),
                     {}, dev),
        "by_string": (q.filter(c("id") < 50_000).group_by("s").agg(**every), {}, dev),
        "by_date": (q.filter(c("id") >= 0).group_by("d").agg(**every), {}, dev),
        "by_two_keys": (q.filter(c("id") >= 5).group_by("s", "z").agg(rows=("*", "count"), sf=("f", "sum"),
                                                                      sdf=("f", "stddev_samp")), {}, dev),
        "distinct": (q.filter(c("id") >= 0).group_by("z").agg(rows=("*", "count"), **distinct), {}, host),
        "spill_chunk": (q.filter(c("id") >= 0).group_by("z").agg(**every), {"hyperspace.exec.agg.maxGroups": 5},
                        host),
        "spill_merge": (q.filter(c("id") >= 0).group_by("n").agg(rows=("*", "count"), sf=("f", "sum")),
                        {"hyperspace.exec.agg.maxGroups": 5000}, host),
    }


def check_stream_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """The streamed paths over the join-small and query-small lakes, through
    the GPU build of their indexes (rows with equal keys follow their
    bucket's run files, whose names differ between builds), on the GPU
    against the CPU port: the streamed join (inner, left, right, outer; J1
    and J2 shapes), its typed empty result, the streamed aggregates, two
    spills, ``to_local_iterator`` (one abandoned after a chunk) and the
    partitioned merge."""
    import numpy as np

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import pipeline as P
    from hyperspace_tpu_torch.ops import kernels

    fact, dim = os.path.join(tmp, "join", "fact"), os.path.join(tmp, "join", "dim")
    q_src = os.path.join(tmp, "qsmall")
    owner = devices[-1]
    c = ht.col

    def session(kind, device, enabled=True, **conf):
        sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, f"{kind}-{owner}"), ht.keys.DEVICE_MIN_ROWS: 0,
                                ht.keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES: 1 << 31, **conf}, device=device)
        sess.hyperspace_enabled = enabled
        return sess

    kernels.reset_launches()
    D.reset_dispatches()
    out = {"joins": {}, "aggregates": {}, "iterators": {}, "partitioned": {}}

    # the streamed join: J1 and J2 shapes, every join type, and the empty join
    names = ("inner_int", "inner_filtered", "left", "right", "outer")
    for name in names + ("empty",):
        got = {}
        for device in devices:
            results = {}
            for streamed in (False, True):
                sess = session("jsmall", device, **({ht.keys.STREAM_JOIN_MIN_BYTES: 1} if streamed else {}))
                f, d = sess.read_parquet(fact), sess.read_parquet(dim)
                if name == "empty":
                    df = f.filter(c("k") < 400).join(d, c("k") == c("dk")).select("k", "v", "n", "str", "nd", "w",
                                                                                  "dstr")
                else:
                    df = small_joins(f, d, c)[name][0]
                results[streamed], summary = traced_collect(df)
                if streamed:
                    assert "join: host-span-smj-stream x1" in summary.splitlines(), f"{name} on {device}: {summary}"
            got[device] = results[True]
            n = len(next(iter(results[True].values())))
            if name == "empty":
                assert n == 0 and len(next(iter(results[False].values()))) == 0
                streamed_dt = {k: v.dtype for k, v in results[True].items()}
                plain_dt = {k: v.dtype for k, v in results[False].items()}
                # typed from the index footers: a nullable int column is
                # int64 here, float64 in the unstreamed (decoded) empty
                # result, as in the JAX package (ROADMAP C)
                diff = {k: (str(streamed_dt[k]), str(plain_dt[k])) for k in plain_dt if streamed_dt[k] != plain_dt[k]}
                assert list(streamed_dt) == list(plain_dt) and diff == {"n": ("int64", "float64")}, diff
                print(f"stream-small empty join on {device}: 0 rows, typed from the footers; dtypes equal the "
                      f"unstreamed empty result's but for the nullable int column: {diff}", flush=True)
            else:
                assert n > 0 and same_batch(results[True], results[False]), \
                    f"{name} on {device}: the streamed join differs from the unstreamed one"
        assert same_batch(got[devices[-1]], got[devices[0]]), f"{name}: the GPU streamed join differs from the CPU's"
        out["joins"][name] = len(next(iter(got[devices[-1]].values())))
        print(f"stream-small join {name}: {out['joins'][name]} rows; streamed equals unstreamed byte for byte, GPU "
              f"equals the CPU port; join: host-span-smj-stream", flush=True)

    # the streamed aggregate
    probe = session("qsmall", devices[0])
    agg_names = list(small_stream_aggregates(probe.read_parquet(q_src), c))
    for name in agg_names:
        got = {}
        for device in devices:
            plain, conf, lines = small_stream_aggregates(session("qsmall", device).read_parquet(q_src), c)[name]
            df = small_stream_aggregates(session("qsmall", device, **AGG_STREAM_SMALL, **conf).read_parquet(q_src),
                                         c)[name][0]
            got[device], summary = traced_collect(df)
            assert trace_lines(summary, ("agg:",)) == lines, f"{name} on {device}: {summary}"
            assert_no_fallback(summary, f"{name} on {device}")
            want, mine = plain.collect(), got[device]
            if name == "global":
                # inherited (ROADMAP C): the host fold adds the chunks' partial
                # sums skipping NaN, so a chunk holding +inf and -inf drops out
                # of sum(f), and the stddev's negative variance clips to 0,
                # where the one-pass aggregate gives NaN
                for k in ("sf", "sdf"):
                    assert np.isnan(want[k][0]) and not np.isnan(mine[k][0]), (k, want[k], mine[k])
                want = {k: v for k, v in want.items() if k not in ("sf", "sdf")}
                mine = {k: v for k, v in mine.items() if k not in ("sf", "sdf")}
            # a spill hands the device partial to the host fold, whose group
            # order is the partial's and then the later chunks'
            assert same_groups(mine, want, float_aggs_of(df), ordered=not name.startswith("spill")), \
                f"{name} on {device}: the streamed aggregate differs from the unstreamed one"
        assert same_groups(got[devices[-1]], got[devices[0]], float_aggs_of(df), ordered=True), \
            f"{name}: the GPU streamed aggregate differs from the CPU port's"
        out["aggregates"][name] = len(next(iter(got[devices[-1]].values())))
        print(f"stream-small agg {name}: {out['aggregates'][name]} groups; streamed equals unstreamed, GPU equals "
              f"the CPU port; {', '.join(ln.rsplit(' ', 1)[0] for ln in lines)}", flush=True)

    # to_local_iterator: a scan chain (hyperspace off), an index filter chain,
    # the bucketed join; one abandoned after its first chunk
    iterated = {
        "scan_chain": ("qsmall", False, lambda s: s.read_parquet(q_src).filter(c("z") > 0).select("id", "f", "s")),
        "index_filter": ("qsmall", True, lambda s: s.read_parquet(q_src).filter(c("id") >= 100).select("id", "s")),
        "bucketed_join": ("jsmall", True, lambda s: small_joins(s.read_parquet(fact), s.read_parquet(dim), c)
                          ["left"][0]),
    }
    for name, (kind, enabled, make) in iterated.items():
        chunks = {}
        for device in devices:
            sess = session(kind, device, enabled, **{ht.keys.STREAM_CHUNK_BYTES: 1})
            chunks[device] = list(make(sess).to_local_iterator())
            whole = make(sess).collect()
            from hyperspace_tpu_torch.exec import batch as B

            assert same_batch(canonical(B.concat(chunks[device])), canonical(whole)), \
                f"{name} on {device}: the chunks differ from collect()"
        assert len(chunks[devices[-1]]) == len(chunks[devices[0]]) > 1
        assert all(same_batch(g, w) for g, w in zip(chunks[devices[-1]], chunks[devices[0]])), \
            f"{name}: the GPU chunks differ from the CPU port's"
        sess = session(kind, devices[-1], enabled, **{ht.keys.STREAM_CHUNK_BYTES: 1})
        with ReadSpy() as spy:
            it = make(sess).to_local_iterator()
            next(it)
            it.close()
            started = spy.started
            assert spy.started == spy.finished, (spy.started, spy.finished)
            time.sleep(0.2)
            assert spy.started == started, "a decode started after the iterator was closed"
        pool = P._PIPELINE_POOL
        assert pool is None or pool._work_queue.empty(), "queued decodes survived the close"
        out["iterators"][name] = len(chunks[devices[-1]])
        print(f"stream-small to_local_iterator {name}: {len(chunks[devices[-1]])} chunks, GPU equals the CPU port "
              f"chunk by chunk, together equal to collect(); closed after one chunk: {started} decodes started, "
              f"all finished, none after", flush=True)

    # the partitioned generic merge (hyperspace off)
    for how in ("inner", "left", "right", "outer"):
        got = {}
        for device in devices:
            res = {}
            for spill in (64, None):
                sess = session("jsmall", device, False, **({ht.keys.JOIN_SPILL_MIN_ROWS: spill} if spill else {}))
                df = sess.read_parquet(fact).join(sess.read_parquet(dim), c("k") == c("dk"), how=how).select(
                    "k", "v", "n", "str", "dk", "w", "dstr")
                res[spill], summary = traced_collect(df)
                if spill:
                    assert any(ln.startswith("join: generic-merge-partitioned(") for ln in summary.splitlines()), \
                        summary
            assert same_batch(as_multiset(res[64]), as_multiset(res[None])), \
                f"{how} on {device}: the partitioned merge differs from the unpartitioned one"
            got[device] = res[64]
        assert same_batch(got[devices[-1]], got[devices[0]]), f"{how}: the GPU partitioned merge differs from the CPU's"
        out["partitioned"][how] = len(next(iter(got[devices[-1]].values())))
        print(f"stream-small partitioned merge {how}: {out['partitioned'][how]} rows, equal to the unpartitioned "
              f"merge as a multiset, GPU equals the CPU port", flush=True)
    assert not any(kernels.launches.values()), dict(kernels.launches)
    assert D.dispatches["grouped-merge"] > 0 and D.dispatches["grouped-agg-chunk"] > 0, dict(D.dispatches)
    out["dispatches"] = dict(D.dispatches)
    return out


class PartialCapture:
    """Records the running partial table of every GroupedAggStream that
    finalizes while installed (``with PartialCapture() as cap``)."""

    def __enter__(self):
        from hyperspace_tpu_torch.exec import aggregate as A

        self.real = A.GroupedAggStream.finalize
        self.tables = []
        cap = self

        def finalize(stream):
            p = stream._partial
            cap.tables.append([t[: p["n"]].cpu().clone() if hasattr(t, "cpu") else t[: p["n"]].copy()
                               for t in (p["fs"], *p["keys"], *p["slots"])])
            return cap.real(stream)

        A.GroupedAggStream.finalize = finalize
        return self

    def __exit__(self, *exc):
        from hyperspace_tpu_torch.exec import aggregate as A

        A.GroupedAggStream.finalize = self.real


def capture_merge_program(run):
    """Run ``run()`` with ``grouped_merge_program`` wrapped to record its
    last call: (program, args)."""
    from hyperspace_tpu_torch.exec import aggregate as A

    seen = {}
    real = A.grouped_merge_program

    def make(*a):
        program = real(*a)

        def call(*args):
            seen["grouped-merge"] = (program, args)
            return program(*args)

        return call

    A.grouped_merge_program = make
    try:
        run()
    finally:
        A.grouped_merge_program = real
    return seen["grouped-merge"]


def merge_program_time(program, args, reps: int, hbm: float) -> dict:
    """``grouped-merge`` alone on a streamed A1's last pair of partial
    tables (CUDA events, median of ``reps``) beside its bound: both tables
    read once and the merged table written once, over the card's rate."""
    keys_a, keys_b, slots_a, slots_b, fs_a, fs_b, n_a, n_b = args

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    read = nbytes((*keys_a, *keys_b, *slots_a, *slots_b, fs_a, fs_b))
    n_g, fs, keys, slots = program(*args)
    written = nbytes((fs, *keys, *slots))
    b_ms, b_by = bound(read + written, 0, hbm)
    ms = time_ms(lambda: program(*args), reps)
    return {"shape": f"2 x {keys_a[0].shape[0]} rows ({n_a} + {n_b} groups) -> {fs.shape[0]} ({n_g} groups), "
                     f"{len(keys_a)} keys, {len(slots_a)} slots",
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms, "bytes": read + written}


def run_stream(sess, li_src: str, o_src: str, tmp: str, args, smi: str, hbm: float) -> dict:
    """J1 and J2 streamed (``joinMinBytes=1``) and A1 and A2 streamed
    (``aggMinBytes=1``, ``chunkBytes`` an eighth of ``li_q1``'s index
    bytes), with the pipeline on and off, against the unstreamed results and
    hyperspace off; warm medians and layers of every run; the pipelined
    and serial partial tables of A1 bit for bit; ``grouped-merge`` alone."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D

    system = sess.conf.system_path
    li, orders = sess.read_parquet(li_src), sess.read_parquet(o_src)
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    sess.conf.set(ht.keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES, 2 << 30)
    sess.enable_hyperspace()
    reps_join = max(3, args.reps // 10)
    reps_agg = max(3, args.reps // 6)
    out = {"joins": [], "aggregates": []}

    def run_mode(q, conf, reps):
        for k, v in conf.items():
            sess.conf.set(k, v)
        clear_query_caches()
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        cold_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        cold_layers.update(total=cold)
        warm = layer_ms(sess, q.collect, reps)
        return got, summary, cold_layers, warm

    def report(kind, name, mode, layers):
        print(f"layers {name} {mode} (warm): " + ", ".join(f"{k} {v:.3f} ms" for k, v in layers.items())
              + f" ({smi})", flush=True)

    joins = join_queries(li, orders)
    for name, q in joins.items():
        unstreamed, summary, cold_u, warm_u = run_mode(q, {ht.keys.STREAM_JOIN_MIN_BYTES: 1 << 30}, reps_join)
        assert "join: device-smj x1" in summary.splitlines(), summary
        with sess.hyperspace_scope(False):
            off = as_multiset(q.collect())
        entry = {"name": name, "rows": len(next(iter(unstreamed.values()))), "reps": reps_join,
                 "unstreamed": {"cold_ms": cold_u["total"], "warm_ms": warm_u["total"], "layers_ms": warm_u}}
        report("join", name, "unstreamed", warm_u)
        for pipe in (True, False):
            mode = "streamed_pipelined" if pipe else "streamed_serial"
            got, summary, cold, warm = run_mode(q, {ht.keys.STREAM_JOIN_MIN_BYTES: 1,
                                                    ht.keys.JOIN_PIPELINE_ENABLED: pipe}, reps_join)
            assert trace_lines(summary, ("join:",)) == ["join: host-span-smj-stream x1"], summary
            assert_no_fallback(summary, name)
            assert same_batch(got, unstreamed), f"{name} {mode}: differs from the unstreamed join"
            assert same_batch(as_multiset(got), off), f"{name} {mode}: differs from hyperspace off"
            entry[mode] = {"cold_ms": cold["total"], "warm_ms": warm["total"], "layers_ms": warm}
            report("join", name, mode, warm)
            del got
        sess.conf.set(ht.keys.STREAM_JOIN_MIN_BYTES, 1 << 30)
        sess.conf.set(ht.keys.JOIN_PIPELINE_ENABLED, True)
        out["joins"].append(entry)
        print(f"stream {name}: {entry['rows']} rows; streamed (pipelined and serial) equals the unstreamed join byte "
              f"for byte and hyperspace off as a multiset; warm unstreamed {entry['unstreamed']['warm_ms']:.3f} ms, "
              f"streamed pipelined {entry['streamed_pipelined']['warm_ms']:.3f} ms, serial "
              f"{entry['streamed_serial']['warm_ms']:.3f} ms; cold {entry['unstreamed']['cold_ms']:.3f} / "
              f"{entry['streamed_pipelined']['cold_ms']:.3f} / {entry['streamed_serial']['cold_ms']:.3f} ms "
              f"(median of {reps_join}; {smi})", flush=True)
        del unstreamed, off

    q1_bytes = index_bytes(system, "li_q1")
    chunk = q1_bytes // 8
    aggs = agg_queries(li, orders)
    a1 = aggs["A1"][0]
    for name in ("A1", "A2"):
        q = aggs[name][0]
        floats = float_aggs_of(q)
        plain, summary, cold_u, warm_u = run_mode(q, {ht.keys.STREAM_AGG_MIN_BYTES: 1 << 30}, reps_agg)
        entry = {"name": name, "groups": len(next(iter(plain.values()))), "reps": reps_agg, "chunk_bytes": chunk,
                 "unstreamed": {"cold_ms": cold_u["total"], "warm_ms": warm_u["total"], "layers_ms": warm_u}}
        report("agg", name, "unstreamed", warm_u)
        tables = {}
        for pipe in (True, False):
            mode = "streamed_pipelined" if pipe else "streamed_serial"
            before = dict(D.dispatches)
            got, summary, cold, warm = run_mode(q, {ht.keys.STREAM_AGG_MIN_BYTES: 1, ht.keys.STREAM_CHUNK_BYTES: chunk,
                                                    ht.keys.PIPELINE_ENABLED: pipe}, reps_agg)
            runs = 1 + reps_agg
            launches = {p: (D.dispatches[p] - before.get(p, 0)) / runs for p in ("grouped-agg-chunk", "grouped-merge")}
            lines = trace_lines(summary, ("agg:",))
            want = (["agg: device-grouped-stream x1", "agg: streamed-partial x1"] if name == "A1"
                    else ["agg: streamed-partial x1"])
            assert lines == want, summary
            assert_no_fallback(summary, name)
            chunks = int(summary.split("scan: index x")[1].split()[0])
            assert chunks >= (8 if name == "A1" else 2), f"{name}: {chunks} chunks: {summary}"
            entry["chunks"] = chunks
            assert same_groups(got, plain, floats, ordered=True), f"{name} {mode}: differs from the materialized one"
            entry[mode] = {"cold_ms": cold["total"], "warm_ms": warm["total"], "layers_ms": warm,
                           "launches_per_query": launches}
            report("agg", name, mode, warm)
            if name == "A1":
                # the partial tables bit for bit: float sums in a fixed order
                torch.use_deterministic_algorithms(True)
                try:
                    with PartialCapture() as cap:
                        a1.collect()
                finally:
                    torch.use_deterministic_algorithms(False)
                tables[pipe] = cap.tables[-1]
                print(f"stream {name} {mode}: {launches['grouped-agg-chunk']:.0f} grouped-agg-chunk and "
                      f"{launches['grouped-merge']:.0f} grouped-merge launches per query", flush=True)
        if name == "A1":
            assert all(a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()
                       for a, b in zip(tables[True], tables[False])), "A1: pipelined and serial partial tables differ"
            entry["partials_bit_equal"] = True
        out["aggregates"].append(entry)
        print(f"stream {name}: {entry['groups']} groups; streamed (pipelined and serial, chunks of {chunk} bytes) "
              f"equals the materialized aggregate" + ("; pipelined and serial partial tables bit-equal"
                                                      if name == "A1" else "")
              + f"; warm unstreamed {entry['unstreamed']['warm_ms']:.3f} ms, streamed pipelined "
              f"{entry['streamed_pipelined']['warm_ms']:.3f} ms, serial {entry['streamed_serial']['warm_ms']:.3f} ms "
              f"(median of {reps_agg}; {smi})", flush=True)

    # the partitioned generic merge at SF1, hyperspace off
    with sess.hyperspace_scope(False):
        q = joins["J1"]
        whole = as_multiset(q.collect())
        sess.conf.set(ht.keys.JOIN_SPILL_MIN_ROWS, 1 << 20)
        t = time.perf_counter()
        got, summary = traced_collect(q)
        part_ms = (time.perf_counter() - t) * 1e3
        sess.conf.set(ht.keys.JOIN_SPILL_MIN_ROWS, 1 << 26)
        parts = [ln for ln in summary.splitlines() if ln.startswith("join: generic-merge-partitioned(")]
        assert parts, summary
        assert same_batch(as_multiset(got), whole), "J1: the partitioned merge differs from the unpartitioned one"
        del got, whole
    out["partitioned_J1_off_ms"] = part_ms
    print(f"stream J1 off, spillMinRows 2^20: {parts[0].split()[1]}, equal to the unpartitioned merge as a "
          f"multiset; {part_ms:.3f} ms ({smi})", flush=True)

    sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1)
    sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, chunk)
    program, pargs = capture_merge_program(a1.collect)
    out["grouped_merge"] = merge_program_time(program, pargs, args.reps, hbm)
    p = out["grouped_merge"]
    print(f"program grouped-merge ({p['shape']}): {p['ms']} ms, bound {p['bound_ms']} ms ({p['bound_by']}), "
          f"{100 * p['share_of_bound']:.2f}% of bound ({smi})", flush=True)
    return out, a1, chunk


#: the scale lake's rows per source file (as SF1's: 6M over 16 files)
SCALE_ROWS_PER_FILE = LINEITEM_ROWS_SF1 // 16
GATE_BYTES = 1 << 30
SCALE_TARGET_BYTES = int(1.2 * GATE_BYTES)


def _write_lineitem_file(path: str, seed: int, i: int, rows: int, sf: float, edit=None) -> None:
    """One ``lineitem`` file from its own generators; ``edit``, if given,
    changes the columns before they are written."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng([seed, i])
    flags_rng = np.random.default_rng([seed, i, 1])
    cols = lineitem_columns(rng, flags_rng, rows, sf)
    if edit is not None:
        edit(cols)
    pq.write_table(pa.table(cols), path)


def _write_orders_file(path: str, seed: int, i: int, first_key: int, rows: int, sf: float) -> None:
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table(orders_columns(np.random.default_rng([seed, i]), first_key, rows, sf)), path)


def gen_scale_lake(root: str, rows_total: int, seed: int):
    """The SF1 lake's tables at ``rows_total`` lineitem rows (orders at a
    quarter, every ``l_orderkey`` matching one order): the same columns,
    value ranges and rows per file, each file from its own generator, on
    a pool of worker processes. Returns (lineitem dir, orders dir)."""
    import concurrent.futures
    import multiprocessing

    sf = rows_total / LINEITEM_ROWS_SF1
    n_orders = max(1, int(ORDERS_ROWS_SF1 * sf))
    li_dir, o_dir = os.path.join(root, "lineitem"), os.path.join(root, "orders")
    os.makedirs(li_dir, exist_ok=True)
    os.makedirs(o_dir, exist_ok=True)
    jobs = []
    for i, first in enumerate(range(0, rows_total, SCALE_ROWS_PER_FILE)):
        rows = min(SCALE_ROWS_PER_FILE, rows_total - first)
        jobs.append((_write_lineitem_file, os.path.join(li_dir, f"part-{i:05d}.parquet"), seed, i, rows, sf))
    per_orders = ORDERS_ROWS_SF1 // 8
    for i, first in enumerate(range(0, n_orders, per_orders)):
        rows = min(per_orders, n_orders - first)
        jobs.append((_write_orders_file, os.path.join(o_dir, f"part-{i:05d}.parquet"), seed + 1, i, first, rows, sf))
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(fn, *a) for fn, *a in jobs]:
            f.result()
    return li_dir, o_dir


def row_digest(batch, columns) -> int:
    """Order-free digest of a batch's rows: the sum mod 2^64 of a 64-bit mix
    of each row's column bit patterns (dates as int64 days)."""
    import numpy as np

    n = len(batch[columns[0]])
    total = np.uint64(0)
    step = 1 << 22
    with np.errstate(over="ignore"):
        for lo in range(0, n, step):
            h = np.zeros(min(step, n - lo), dtype=np.uint64)
            for i, c in enumerate(columns):
                v = batch[c][lo: lo + step]
                if v.dtype.kind == "M":
                    v = v.astype("datetime64[D]").view(np.int64)
                bits = np.ascontiguousarray(v.astype(np.float64) if v.dtype.kind == "f" else v.astype(np.int64))
                h = h * np.uint64(0x9E3779B97F4A7C15) + bits.view(np.uint64) + np.uint64(i + 1)
                h ^= h >> np.uint64(30)
                h *= np.uint64(0xBF58476D1CE4E5B9)
                h ^= h >> np.uint64(27)
                h *= np.uint64(0x94D049BB133111EB)
                h ^= h >> np.uint64(31)
            total = total + h.sum(dtype=np.uint64)
    return int(total)


SCALE_Q3_LI = ("l_orderkey", ["l_extendedprice", "l_discount", "l_shipdate"])
SCALE_Q3_O = ("o_orderkey", ["o_orderdate", "o_shippriority"])
SCALE_J1_COLUMNS = ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate", "o_orderdate", "o_shippriority")


def run_scale(main_sess, li_src: str, o_src: str, tmp: str, args, smi: str) -> dict:
    """A lake whose J1 and A1 inputs pass the real 1 GiB gates with the
    defaults untouched (``deviceMinRows`` 0, as in every SF1 phase):
    sized from the SF1 index bytes per row, generated, indexed, then J1 and
    A1 cold and warm against hyperspace off."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    system = main_sess.conf.system_path
    sizes = {name: index_bytes(system, name) for name in ("li_shipdate", "li_orderkey", "o_orderkey", "li_q1")}
    for name, b in sizes.items():
        print(f"scale: SF1 index {name}: {b} bytes on disk", flush=True)
    # the scale indexes' bytes per row, from their SF1 builds
    hs = ht.Hyperspace(main_sess)
    hs.create_index(main_sess.read_parquet(li_src), ht.CoveringIndexConfig("li_q3", [SCALE_Q3_LI[0]], SCALE_Q3_LI[1]))
    hs.create_index(main_sess.read_parquet(o_src), ht.CoveringIndexConfig("o_q3", [SCALE_Q3_O[0]], SCALE_Q3_O[1]))
    for name in ("li_q3", "o_q3"):
        sizes[name] = index_bytes(system, name)
        print(f"scale: SF1 index {name}: {sizes[name]} bytes on disk", flush=True)
    # per lineitem row: the lake's lineitem rows, and a quarter of an order
    # (the scale lake's orders per lineitem row, as SF1's)
    per_row_q1 = sizes["li_q1"] / args.rows
    per_row_j1 = sizes["li_q3"] / args.rows + sizes["o_q3"] / LINEITEM_ROWS_SF1
    need = max(SCALE_TARGET_BYTES / per_row_q1, SCALE_TARGET_BYTES / per_row_j1)
    rows = -(-int(need) // SCALE_ROWS_PER_FILE) * SCALE_ROWS_PER_FILE
    print(f"scale: {per_row_q1:.3f} bytes per row for li_q1, {per_row_j1:.3f} for J1's two indexes: "
          f"{rows} lineitem rows ({rows / LINEITEM_ROWS_SF1:.2f} x SF1) put both above {SCALE_TARGET_BYTES} bytes",
          flush=True)

    root = os.path.join(tmp, "scale")
    t = time.perf_counter()
    li_dir, o_dir = gen_scale_lake(root, rows, args.seed + 7)
    gen_s = time.perf_counter() - t
    print(f"scale lake: {rows} lineitem rows, {max(1, int(ORDERS_ROWS_SF1 * rows / LINEITEM_ROWS_SF1))} orders rows "
          f"({gen_s:.3f} s)", flush=True)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(root, "indexes"), ht.keys.DEVICE_MIN_ROWS: 0},
                      device="cuda")
    hs = ht.Hyperspace(sess)
    li, orders = sess.read_parquet(li_dir), sess.read_parquet(o_dir)
    torch.cuda.synchronize()
    kernels.reset_launches()
    builds = {}
    for name, df, (key, included) in (("li_q3", li, SCALE_Q3_LI), ("o_q3", orders, SCALE_Q3_O),
                                      ("li_q1", li, ("l_shipdate", ["l_returnflag", "l_linestatus", "l_quantity",
                                                                    "l_extendedprice", "l_discount", "l_tax"]))):
        t = time.perf_counter()
        hs.create_index(df, ht.CoveringIndexConfig(name, [key], included))
        torch.cuda.synchronize()
        builds[name] = {"seconds": time.perf_counter() - t, "bytes": index_bytes(sess.conf.system_path, name)}
        print(f"scale build {name}: {builds[name]['seconds']:.3f} s, {builds[name]['bytes']} bytes ({smi})", flush=True)
    launches = dict(kernels.launches)
    print(f"scale builds: kernel launches {launches}", flush=True)
    assert launches.get("bucket_histogram", 0) > 0, launches
    j1_bytes = builds["li_q3"]["bytes"] + builds["o_q3"]["bytes"]
    q1_bytes = builds["li_q1"]["bytes"]
    assert j1_bytes >= sess.conf.stream_join_min_bytes and q1_bytes >= sess.conf.stream_agg_min_bytes, \
        (j1_bytes, q1_bytes)
    print(f"scale gates: J1's indexes {j1_bytes} bytes >= joinMinBytes {sess.conf.stream_join_min_bytes}; li_q1 "
          f"{q1_bytes} bytes >= aggMinBytes {sess.conf.stream_agg_min_bytes}", flush=True)

    sess.enable_hyperspace()
    c = ht.col
    out = {"rows": rows, "generate_s": gen_s, "builds": builds, "launches": launches, "sf1_index_bytes": sizes}
    j1 = li.join(orders, c("l_orderkey") == c("o_orderkey")).select(*SCALE_J1_COLUMNS)
    plan = j1.optimized_plan()
    assert sorted(s.entry.name for s in plan_index_scans(plan)) == ["li_q3", "o_q3"], plan.pretty()
    a1 = q1_query(li)
    assert [s.entry.name for s in plan_index_scans(a1.optimized_plan())] == ["li_q1"], a1.optimized_plan().pretty()
    for name, q, want in (("J1", j1, "join: host-span-smj-stream x1"), ("A1", a1, "agg: device-grouped-stream x1")):
        clear_query_caches()
        D.reset_dispatches()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        print(f"trace scale {name}: " + "; ".join(summary.splitlines()), flush=True)
        assert want in summary.splitlines(), summary
        if name == "A1":
            assert "agg: streamed-partial x1" in summary.splitlines(), summary
        assert_no_fallback(summary, f"scale {name}")
        dispatches = dict(D.dispatches)
        t = time.perf_counter()
        q.collect()
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t) * 1e3
        with sess.hyperspace_scope(False):
            t = time.perf_counter()
            off, off_summary = traced_collect(q)
            off_ms = (time.perf_counter() - t) * 1e3
        print(f"trace scale {name} off: " + "; ".join(off_summary.splitlines()), flush=True)
        n = len(next(iter(got.values())))
        entry = {"rows_out": n, "cold_ms": cold, "warm_ms": warm, "off_ms": off_ms, "dispatches": dispatches}
        if name == "J1":
            digest = row_digest(got, SCALE_J1_COLUMNS)
            assert n == len(off["l_orderkey"]) and digest == row_digest(off, SCALE_J1_COLUMNS), \
                "scale J1: differs from hyperspace off"
            entry["digest"] = digest
        else:
            assert same_groups(got, off, float_aggs_of(q), ordered=False), "scale A1: differs from hyperspace off"
        del got, off
        out[name] = entry
        print(f"scale {name}: {n} rows out, equal to hyperspace off; cold {cold:.3f} ms, warm {warm:.3f} ms, "
              f"hyperspace off {off_ms:.3f} ms; dispatches {dispatches} ({smi})", flush=True)
    return out



# --- the index lifecycle --------------------------------------------------------


def _write_ingest_file(path: str, seed: int, i: int, rows: int, sf: float, first_day, first_key: int) -> None:
    """A ``_write_lineitem_file`` file as a later ingest lands (TPC-H's RF1
    in spirit): new orders, keyed from ``first_key``, shipped in the 30
    days from ``first_day``; still open, so not returned."""
    import numpy as np

    def edit(cols):
        rng = np.random.default_rng([seed, i, 2])
        cols["l_orderkey"] = (first_key + rng.integers(0, max(1, rows // 4), rows)).astype(np.int64)
        cols["l_shipdate"] = np.datetime64(first_day) + rng.integers(0, 30, rows).astype("timedelta64[D]")
        cols["l_returnflag"] = np.full(rows, "N")
        cols["l_linestatus"] = np.full(rows, "O")

    _write_lineitem_file(path, seed, i, rows, sf, edit)


def index_fingerprint(entry):
    """A covering index's bucket files as {bucket: sorted digests of each
    file's bytes}; a data-skipping index's sketch rows; None once vacuumed."""
    import hashlib

    from hyperspace_tpu_torch.indexes.covering import bucket_of_file
    from hyperspace_tpu_torch.indexes.registry import index_of_entry

    if entry is None or entry.state == "DOESNOTEXIST":
        return None
    if entry.kind != "CoveringIndex":
        return repr(index_of_entry(entry).read_sketch_table(entry).to_pydict())
    runs = {}
    for f in entry.content.files:
        with open(f, "rb") as fh:
            runs.setdefault(bucket_of_file(f), []).append(hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(v) for b, v in runs.items()}


K1, K2 = "bucket_histogram", "segmented_min_max"


def same_rows(got, want) -> bool:
    """Equal as multisets; two empty results need only the same columns (a
    scan whose files were all pruned gives dtype-less empty columns, as in
    the JAX package)."""
    if list(got) == list(want) and all(len(v) == 0 for v in list(got.values()) + list(want.values())):
        return True
    return same_batch(as_multiset(got), as_multiset(want))


def lifecycle_outcome(fn):
    """(entry, None) or (None, the exception's class name)."""
    from hyperspace_tpu_torch.actions.base import HyperspaceActionException

    try:
        return fn(), None
    except HyperspaceActionException as e:
        return None, type(e).__name__


def check_lifecycle_small(tmp: str, seed: int) -> dict:
    """The lifecycle on a small lake in a CPU session (plain versions) and a
    GPU session (kernels). Each phase starts both from a copy of the CPU
    session's state, so even the actions that read old index files in the
    content's (random) file-name order get the same input. After every
    action the GPU's bucket files equal the CPU's byte for byte and the
    sketches are equal; the GPU run launches K1 for every covering rewrite
    and K2 for every data-skipping rebuild, and nothing else; after every
    phase each query over the GPU's indexes equals hyperspace off."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.ops import kernels

    rows = 60_000
    src = gen_lineitem(os.path.join(tmp, "lsmall"), rows, 3, seed + 5)
    sf = rows / LINEITEM_ROWS_SF1
    new_key = max(1, int(ORDERS_ROWS_SF1 * sf))
    c = ht.col

    def create(hs, sess):
        df = sess.read_parquet(src)
        hs.create_index(df, ht.CoveringIndexConfig("cov", ["l_orderkey"], ["l_extendedprice", "l_shipdate"]))
        sess.conf.set(ht.keys.LINEAGE_ENABLED, True)
        hs.create_index(df, ht.CoveringIndexConfig("lin", ["l_shipdate"],
                                                   ["l_quantity", "l_extendedprice", "l_discount"]))
        sess.conf.set(ht.keys.LINEAGE_ENABLED, False)
        return hs.create_index(df, ht.DataSkippingIndexConfig(
            "skip", ht.MinMaxSketch("l_orderkey"), ht.MinMaxSketch("l_extendedprice")))

    def append():
        for i in (3, 4):
            _write_ingest_file(os.path.join(src, f"part-{i:05d}.parquet"), seed + 5, i, 10_000, sf,
                               "1999-01-01", new_key)

    covering = {K1}
    phases = [
        ("create", None, [("create", create, {K1, K2}, None)]),
        ("append", append, [
            ("incremental cov", lambda hs, s: hs.refresh_index("cov", "incremental"), covering, None),
            ("incremental skip", lambda hs, s: hs.refresh_index("skip", "incremental"), {K2}, None),
            ("quick lin", lambda hs, s: hs.refresh_index("lin", "quick"), set(), None),
        ]),
        ("optimize", None, [
            ("optimize quick cov", lambda hs, s: hs.optimize_index("cov", "quick"), covering, None),
            ("optimize full cov", lambda hs, s: hs.optimize_index("cov", "full"), set(), "NoChangesException"),
        ]),
        ("drop", lambda: os.remove(os.path.join(src, "part-00000.parquet")), [
            ("incremental cov", lambda hs, s: hs.refresh_index("cov", "incremental"), set(),
             "HyperspaceActionException"),
            ("incremental lin", lambda hs, s: hs.refresh_index("lin", "incremental"), covering, None),
            ("full cov", lambda hs, s: hs.refresh_index("cov", "full"), covering, None),
            ("quick skip", lambda hs, s: hs.refresh_index("skip", "quick"), set(), None),
            ("full skip", lambda hs, s: hs.refresh_index("skip", "full"), {K2}, None),
        ]),
        ("maintenance", None, [
            ("optimize full lin", lambda hs, s: hs.optimize_index("lin", "full"), covering, None),
            ("delete cov", lambda hs, s: hs.delete_index("cov"), set(), None),
            ("restore cov", lambda hs, s: hs.restore_index("cov"), set(), None),
            ("delete cov", lambda hs, s: hs.delete_index("cov"), set(), None),
            ("vacuum cov", lambda hs, s: hs.vacuum_index("cov"), set(), None),
        ]),
    ]
    queries = {
        "cov": lambda df: df.filter(c("l_orderkey") == 77).select("l_orderkey", "l_extendedprice", "l_shipdate"),
        "lin": lambda df: q6_query(df),
        "skip": lambda df: df.filter(c("l_orderkey") >= new_key).select("l_orderkey", "l_tax"),
    }
    state = None
    actions = 0
    launched = collections.Counter()
    for phase, edit, steps in phases:
        if edit is not None:
            edit()
        sessions = {}
        for device in ("cpu", "cuda"):
            system = os.path.join(tmp, f"lsmall-{phase}-{device}")
            if state is not None:
                shutil.copytree(state, system)
            sessions[device] = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 16,
                                                ht.keys.BUILD_BATCH_ROWS: 25_000, ht.keys.DEVICE_MIN_ROWS: 0},
                                          device=device)
        for name, fn, kernels_expected, raises in steps:
            results = {}
            for device, sess in sessions.items():
                hs = ht.Hyperspace(sess)
                torch.cuda.synchronize()
                kernels.reset_launches()
                entry, error = lifecycle_outcome(lambda: fn(hs, sess))
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernels.launches.items() if v}
                assert error == raises, f"lifecycle-small {name} on {device}: raised {error}, expected {raises}"
                if device == "cuda":
                    assert set(launches) == kernels_expected, f"lifecycle-small {name}: launches {launches}"
                    launched.update(launches)
                else:
                    assert not launches, launches
                results[device] = {n: index_fingerprint(sess.index_manager.get_index(n)) for n in ("cov", "lin", "skip")}
            for n in results["cpu"]:
                assert results["cuda"][n] == results["cpu"][n], f"lifecycle-small {name}: {n} differs from the CPU port's"
            actions += 1
            print(f"lifecycle-small {phase}/{name}: GPU index files equal the CPU port's byte for byte; "
                  f"launches {launches or 'none'}" + (f"; raised {raises}" if raises else ""), flush=True)
        sess = sessions["cuda"]
        for qname, make in queries.items():
            q = make(sess.read_parquet(src))
            with sess.hyperspace_scope(True):
                on = q.collect()
            with sess.hyperspace_scope(False):
                off = q.collect()
            assert same_rows(on, off), f"lifecycle-small {phase}: {qname} differs from off"
        state = sessions["cpu"].conf.system_path
    for k in (K1, K2):
        assert launched[k] > 0, f"lifecycle-small never launched {k}"
    return {"actions": actions, "launches": dict(launched)}


def run_lifecycle(li_src: str, tmp: str, args, smi: str) -> dict:
    """The lifecycle at SF1 on a mutable copy of the ``lineitem`` lake (its
    16 files hard-linked, so the generated lake and its row-count guard stay
    as they were): three indexes, an ingest of two new files, a dropped
    file, and every action timed one by one with its build stages and K1/K2
    launches; after each, the rewritten covering index checked against the
    current source, q6 through it equal to hyperspace off, and a range query
    on the new orders pruned by the data-skipping index to the two new
    files, equal to off, warm, beside off."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.indexes.registry import index_of_entry
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.plan import logical as L

    lake = os.path.join(tmp, "lifecycle", "lineitem")
    os.makedirs(lake)
    for f in sorted(os.listdir(li_src)):
        os.link(os.path.join(li_src, f), os.path.join(lake, f))
    originals = sorted(os.listdir(lake))
    sf = args.rows / LINEITEM_ROWS_SF1
    new_key = max(1, int(ORDERS_ROWS_SF1 * sf))
    per_file = args.rows // args.files
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "lifecycle", "indexes"),
                            ht.keys.DEVICE_MIN_ROWS: 0}, device="cuda")
    hs = ht.Hyperspace(sess)
    q6_cols = ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount"]
    c = ht.col

    def source_files():
        return [os.path.join(lake, f) for f in sorted(os.listdir(lake))]

    def source_rows():
        return sum(pq.read_metadata(f).num_rows for f in source_files())

    def new_orders(df):
        return df.filter((c("l_orderkey") >= new_key) & (c("l_shipdate") >= np.datetime64("1999-01-01"))).select(
            "l_orderkey", "l_shipdate", "l_tax")

    out = {"device": smi, "actions": []}

    def timed(label, fn, rows, kernels_expected, raises=None, index=None, ds_ready=False, full_check=False):
        torch.cuda.synchronize()
        sess.build_stage_seconds.clear()
        kernels.reset_launches()
        t = time.perf_counter()
        entry, error = lifecycle_outcome(fn)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: v for k, v in kernels.launches.items() if v}
        assert error == raises, f"lifecycle {label}: raised {error}, expected {raises}"
        for k in kernels_expected:
            assert launches.get(k, 0) >= 1, f"lifecycle {label}: no {k} launch ({launches})"
        assert set(launches) <= set(kernels_expected), f"lifecycle {label}: launches {launches}"
        stages = {k: round(v, 6) for k, v in sess.build_stage_seconds.items()}
        rec = {"action": label, "seconds": seconds, "rows": rows,
               "rows_per_s": rows / seconds if rows else None, "stages": stages, "launches": launches,
               "raised": error}
        print(f"lifecycle {label}: {seconds:.3f} s" + (f", {rows} rows, {rows / seconds:.0f} rows/s" if rows else "")
              + f"; launches {launches or 'none'}" + (f"; raised {error}" if error else "") + f" ({smi})", flush=True)
        if stages:
            # rest: the action's host work outside the device build (reading
            # the old index, the lineage filter, the log)
            print(f"stages lifecycle {label}: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
                  + f", rest {seconds - sum(stages.values()):.3f} s", flush=True)
        if index is not None:
            entry = sess.index_manager.get_index(index)
            t = time.perf_counter()
            # the bucket-file check reads every row: it runs on a sample of
            # the rewrites (lineage deletes, the compaction); q6 checks all
            n = check_covering(entry, source_files(), "l_shipdate", q6_cols, sess.conf.num_buckets) if full_check else None
            q = q6_query(sess.read_parquet(lake))
            with sess.hyperspace_scope(True):
                scans = [s.entry.name for s in plan_index_scans(q.optimized_plan())]
                on = q.collect()
            with sess.hyperspace_scope(False):
                off = q.collect()
            assert scans == [index], f"lifecycle {label}: q6 scans {scans}"
            assert same_rows(on, off), f"lifecycle {label}: q6 differs from off"
            rec["check_rows"] = n
            rec["q6_rows"] = len(on["l_extendedprice"])
            checked = f"{index} {n} rows hash to their buckets, sorted, equal to the source; " if full_check else ""
            print(f"check lifecycle {label}: {checked}q6 through {index} {rec['q6_rows']} rows, equal to off "
                  f"({time.perf_counter() - t:.3f} s)", flush=True)
        if ds_ready:
            q = new_orders(sess.read_parquet(lake))
            with sess.hyperspace_scope(True):
                scans = L.collect(q.optimized_plan(), lambda p: isinstance(p, L.FileScan))
                assert len(scans) == 1 and scans[0].via_index == "li_skip_mut", q.optimized_plan().pretty()
                assert sorted(os.path.basename(f) for f in scans[0].files) == ["part-90000.parquet",
                                                                              "part-90001.parquet"]
                on = q.collect()
                on_ms = median_ms(q.collect, 5)
            with sess.hyperspace_scope(False):
                off = q.collect()
                off_ms = median_ms(q.collect, 5)
            assert same_rows(on, off), f"lifecycle {label}: new-orders query differs"
            rec["new_orders"] = {"rows": len(on["l_orderkey"]), "warm_ms": on_ms, "off_ms": off_ms}
            print(f"query lifecycle {label}: new orders {rec['new_orders']['rows']} rows from the 2 new files via "
                  f"li_skip_mut, equal to off; warm {on_ms:.3f} ms, off {off_ms:.3f} ms ({smi})", flush=True)
        out["actions"].append(rec)
        return entry

    df = sess.read_parquet(lake)
    rows = source_rows()
    timed("create li_mut", lambda: hs.create_index(df, ht.CoveringIndexConfig(
        "li_mut", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"])), rows, {K1})
    sess.conf.set(ht.keys.LINEAGE_ENABLED, True)
    timed("create li_lin", lambda: hs.create_index(df, ht.CoveringIndexConfig(
        "li_lin", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"])), rows, {K1})
    sess.conf.set(ht.keys.LINEAGE_ENABLED, False)
    timed("create li_skip_mut", lambda: hs.create_index(df, ht.DataSkippingIndexConfig(
        "li_skip_mut", ht.MinMaxSketch("l_orderkey"), ht.MinMaxSketch("l_extendedprice"))), rows, {K2})

    t = time.perf_counter()
    for i in (0, 1):
        _write_ingest_file(os.path.join(lake, f"part-{90000 + i:05d}.parquet"), args.seed + 9, i, per_file, sf,
                           "1999-01-01", new_key)
    print(f"lifecycle ingest: 2 files of {per_file} rows (new orders from {new_key}, shipped 1999-01), "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    timed("incremental li_mut (append)", lambda: hs.refresh_index("li_mut", "incremental"), 2 * per_file, {K1},
          index="li_mut")
    timed("incremental li_skip_mut (append)", lambda: hs.refresh_index("li_skip_mut", "incremental"),
          source_rows(), {K2}, ds_ready=True)

    os.remove(os.path.join(lake, originals[0]))
    rows = source_rows()
    timed("incremental li_lin (drop)", lambda: hs.refresh_index("li_lin", "incremental"), rows, {K1},
          index="li_lin", full_check=True)
    timed("full li_mut (drop)", lambda: hs.refresh_index("li_mut", "full"), rows, {K1}, index="li_mut")
    timed("quick li_skip_mut", lambda: hs.refresh_index("li_skip_mut", "quick"), 0, set())
    timed("full li_skip_mut", lambda: hs.refresh_index("li_skip_mut", "full"), rows, {K2}, ds_ready=True)
    check_sketches(sess.index_manager.get_index("li_skip_mut"),
                   index_of_entry(sess.index_manager.get_index("li_skip_mut")))
    files_before = len(sess.index_manager.get_index("li_mut").content.files)
    entry = timed("optimize quick li_mut", lambda: hs.optimize_index("li_mut", "quick"), rows, {K1},
                  index="li_mut", ds_ready=True, full_check=True)
    files_after = len(entry.content.files)
    assert files_after == sess.conf.num_buckets < files_before, (files_after, files_before)
    timed("optimize full li_mut", lambda: hs.optimize_index("li_mut", "full"), 0, set(), raises="NoChangesException")
    for label, fn in (("delete li_lin", hs.delete_index), ("restore li_lin", hs.restore_index),
                      ("delete li_lin again", hs.delete_index), ("vacuum li_lin", hs.vacuum_index)):
        timed(label, lambda fn=fn: fn("li_lin"), 0, set())
    listed = hs.indexes()
    assert sorted(listed["name"]) == ["li_mut", "li_skip_mut"], listed
    assert not os.path.exists(os.path.join(tmp, "lifecycle", "indexes", "li_lin", "v__=0"))
    print(f"lifecycle: li_lin vacuumed, indexes {sorted(listed['name'])}; {files_before} li_mut files "
          f"compacted to {files_after}", flush=True)
    return out


# --------------------------------------------------------------------------
# scan pruning, hybrid scan and the other sources
# --------------------------------------------------------------------------


def q6_condition():
    """TPC-H q6's predicate over ``lineitem``."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    c = ht.col
    return ((c("l_shipdate") >= np.datetime64("1994-01-01")) & (c("l_shipdate") < np.datetime64("1995-01-01"))
            & (c("l_discount") >= 0.05) & (c("l_discount") <= 0.07) & (c("l_quantity") < 24))


def prune_queries(df):
    """q6 as written (a projection over its filter), q6f (its filter,
    every column: the shape whose scan takes the pushed-down predicate) and
    q6pf (q6f and ``l_shipyear == 1994``, the conjunct a user of a
    year-partitioned lake adds)."""
    import hyperspace_tpu_torch as ht

    return {
        "q6": df.filter(q6_condition()).select("l_extendedprice", "l_discount"),
        "q6f": df.filter(q6_condition()),
        "q6pf": df.filter(q6_condition() & (ht.col("l_shipyear") == 1994)),
    }


def gen_partitioned_lineitem(src: str, out: str, rg_rows: int, file_rows: int) -> str:
    """``src`` rewritten as a hive-partitioned lake by ship year
    (``l_shipyear=1992`` ...): each partition's rows in ``l_shipdate`` order,
    in files of ``file_rows`` rows with ``rg_rows``-row row groups, as a lake
    clustered by date is laid out."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pa.concat_tables([pq.read_table(os.path.join(src, f)) for f in sorted(os.listdir(src))])
    table = table.sort_by("l_shipdate")
    years = table.column("l_shipdate").to_numpy().astype("datetime64[Y]").astype(np.int64) + 1970
    for y in np.unique(years):
        part = table.filter(pa.array(years == y))
        d = os.path.join(out, f"l_shipyear={int(y)}")
        os.makedirs(d)
        for i, lo in enumerate(range(0, part.num_rows, file_rows)):
            pq.write_table(part.slice(lo, file_rows), os.path.join(d, f"part-{i:05d}.parquet"), row_group_size=rg_rows)
    return out


class PruneSpy:
    """Within the block: the files each scan read (``_read_files``) and the
    row groups each read kept (``prune_row_groups``: a list, or None for
    every group)."""

    def __enter__(self):
        from hyperspace_tpu_torch.exec import executor as E
        from hyperspace_tpu_torch.exec import io as IO

        self.mods = (E, IO)
        self.files, self.kept = [], []
        real_read, real_prune = E._read_files, IO.prune_row_groups
        self.real = (real_read, real_prune)

        def read(files, *a, **k):
            self.files.append(list(files))
            return real_read(files, *a, **k)

        def prune(path, predicate):
            got = real_prune(path, predicate)
            self.kept.append((path, got))
            return got

        E._read_files, IO.prune_row_groups = read, prune
        return self

    def __exit__(self, *exc):
        E, IO = self.mods
        E._read_files, IO.prune_row_groups = self.real

    def counts(self):
        """(files read, row groups decoded, row groups in those files)."""
        import pyarrow.parquet as pq

        files = sorted({f for fs in self.files for f in fs})
        groups = {f: pq.read_metadata(f).num_row_groups for f in files}
        kept = dict(self.kept)
        decoded = sum(groups[f] if kept.get(f) is None else len(kept[f]) for f in files)
        return len(files), decoded, sum(groups.values())


def check_prune_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """Pruning on a small year-partitioned lake, in a CPU and a GPU session:
    q6, q6f and q6pf with pruning on and off give the same rows in order
    (GPU == CPU port, pruned == unpruned == hyperspace off's multiset), read
    the same files and keep the same row groups on both; then a covering
    index over the partitioned lake (built on the GPU: K1) serves q6 and
    q6's aggregate, unstreamed and streamed, equal to the CPU port."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.ops import kernels

    src = gen_lineitem(os.path.join(tmp, "psmall"), 60_000, 3, seed + 11)
    lake = gen_partitioned_lineitem(src, os.path.join(tmp, "psmall", "by_year"), 1024, 4096)
    system = os.path.join(tmp, "psmall-indexes")
    out = {}
    for pruning in (True, False):
        got = {}
        for device in devices:
            sess = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.DEVICE_MIN_ROWS: 0,
                                    "hyperspace.exec.io.rowGroupPruning": pruning}, device=device)
            for name, q in prune_queries(sess.read_parquet(lake)).items():
                IO.clear_io_cache()
                with PruneSpy() as spy:
                    rows = q.collect()
                got[name, device] = (rows, spy.counts())
        for name in ("q6", "q6f", "q6pf"):
            (g, gc), (c, cc) = got[name, devices[-1]], got[name, devices[0]]
            assert same_batch(g, c) and gc == cc, f"prune-small {name}: the GPU differs from the CPU port"
            if not pruning:
                assert same_batch(g, out[name]["rows"]), f"prune-small {name}: pruned rows differ from unpruned"
            else:
                out[name] = {"rows": g, "files_groups": gc}
            print(f"prune-small {name} (pruning {'on' if pruning else 'off'}): {len(next(iter(g.values())))} rows; "
                  f"{gc[0]} files, {gc[1]} of {gc[2]} row groups decoded; GPU equals the CPU port", flush=True)
    n_files = sum(len(fs) for _, _, fs in os.walk(lake))
    assert out["q6"]["files_groups"][0] == n_files and out["q6"]["files_groups"][1] == out["q6"]["files_groups"][2]
    assert out["q6f"]["files_groups"][1] < out["q6f"]["files_groups"][2], out["q6f"]
    assert out["q6pf"]["files_groups"][0] < out["q6f"]["files_groups"][0], out["q6pf"]

    # a covering index over the partitioned lake, built on the GPU
    sessions = {}
    for device in devices:
        sessions[device] = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.DEVICE_MIN_ROWS: 0,
                                            ht.keys.NUM_BUCKETS: 16}, device=device)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ht.Hyperspace(sessions[devices[-1]]).create_index(sessions[devices[-1]].read_parquet(lake), ht.CoveringIndexConfig(
        "lp_small", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]))
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    if devices[-1] == "cuda":
        assert set(launches) == {K1}, launches
    for streamed in (False, True):
        conf = ({"hyperspace.exec.stream.aggMinBytes": 1, "hyperspace.exec.stream.chunkBytes": 1} if streamed
                else {"hyperspace.exec.stream.aggMinBytes": 1 << 30})
        res = {}
        for device, sess in sessions.items():
            for k, v in conf.items():
                sess.conf.set(k, v)
            sess.enable_hyperspace()
            df = sess.read_parquet(lake)
            for name, q in (("q6", df.filter(q6_condition()).select("l_extendedprice", "l_discount")),
                            ("q6 agg", df.filter(q6_condition()).agg(revenue=("l_extendedprice", "sum"),
                                                                     n=("*", "count")))):
                assert plan_index_scans(q.optimized_plan()), q.optimized_plan().pretty()
                res[name, device], summary = traced_collect(q)
                if streamed and name == "q6 agg":
                    assert "agg: streamed-partial x1" in summary.splitlines(), summary
                sess.disable_hyperspace()
                off = q.collect()
                sess.enable_hyperspace()
                assert same_groups(res[name, device], off, {"revenue"}, ordered=False), f"prune-small {name} != off"
        for name in ("q6", "q6 agg"):
            assert same_groups(res[name, devices[-1]], res[name, devices[0]], {"revenue"}, ordered=True), name
        print(f"prune-small lp_small ({'streamed' if streamed else 'unstreamed'}): q6 and q6's aggregate through "
              f"the index over the partitioned lake equal the CPU port and hyperspace off", flush=True)
    return {"launches": launches, **{k: v["files_groups"] for k, v in out.items()}}


def check_lineage_program(device: str) -> dict:
    """The lineage-antijoin program on ``device`` against its plain version
    (numpy ``np.isin``, negated), bit for bit, over its edge cases: duplicate
    and no ids, every id deleted, ids beyond the column's range, an int32
    column, counts at and just past a padding bucket (64, 65), and a
    million rows."""
    import numpy as np

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import lineage as LN

    rng = np.random.default_rng(7)
    big = rng.integers(0, 1000, 1_000_000).astype(np.int64)
    cases = {
        "duplicates": (np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int64), [1, 1, 9, 9, 9]),
        "no ids": (np.arange(10, dtype=np.int64), []),
        "every id": (np.array([0, 1, 2, 2, 1, 0], dtype=np.int64), [0, 1, 2]),
        "beyond range": (np.arange(5, dtype=np.int64), [-(2**40), 7, 2**62, 100]),
        "int32": (np.array([5, 6, 7, 8, 9], dtype=np.int32), [6, 8]),
        "64 ids": (np.arange(200, dtype=np.int64), list(range(0, 128, 2))),
        "65 ids": (np.arange(200, dtype=np.int64), list(range(0, 130, 2))),
        "1M rows": (big, sorted(set(rng.integers(0, 1000, 100).tolist()))),
    }
    sess = ht.Session(device=device)
    for name, (col, ids) in cases.items():
        got = LN.lineage_delete_mask(sess, {"_data_file_id": col}, "_data_file_id", ids)
        want = LN.lineage_keep_mask_plain(col, ids)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f"lineage-antijoin {name} differs"
    print(f"lineage-antijoin on {device}: {len(cases)} cases bit-equal to the plain version", flush=True)
    return {"cases": len(cases)}


def hybrid_queries(li, orders):
    """q6 through the lineage index; J1 (inner and outer) and A3 over
    hybrid sides on both join sides."""
    import hyperspace_tpu_torch as ht

    c = ht.col
    cols = ("l_orderkey", "l_extendedprice", "o_orderdate", "o_totalprice")
    j1 = li.join(orders, c("l_orderkey") == c("o_orderkey"))
    return {
        "q6": q6_query(li),
        "J1": j1.select(*cols),
        "J1 outer": li.join(orders, c("l_orderkey") == c("o_orderkey"), how="outer").select(*cols),
        "A3": j1.agg(n=("*", "count"), sum_price=("l_extendedprice", "sum"), sum_total=("o_totalprice", "sum"),
                     min_price=("l_extendedprice", "min"), max_price=("l_extendedprice", "max")),
    }


HYBRID_CONF = {"hyperspace.index.hybridscan.enabled": True, "hyperspace.lifecycle.deviceLineage.minRows": 0}


def build_hybrid_indexes(sess, li, orders):
    """``li_h`` (q6's columns) and ``li_ok_h`` (J1's) with lineage, ``o_h``."""
    import hyperspace_tpu_torch as ht

    hs = ht.Hyperspace(sess)
    sess.conf.set(ht.keys.LINEAGE_ENABLED, True)
    hs.create_index(li, ht.CoveringIndexConfig("li_h", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]))
    hs.create_index(li, ht.CoveringIndexConfig("li_ok_h", ["l_orderkey"], ["l_extendedprice"]))
    sess.conf.set(ht.keys.LINEAGE_ENABLED, False)
    hs.create_index(orders, ht.CoveringIndexConfig("o_h", ["o_orderkey"], ["o_orderdate", "o_totalprice"]))


def edit_hybrid_lake(li_dir: str, o_dir: str, seed: int, per_file: int, sf: float, new_key: int) -> str:
    """Append the two new-orders ``lineitem`` files and one ``orders`` file
    holding those orders; drop the first original ``lineitem`` file. Returns
    the dropped file's name."""
    first = sorted(os.listdir(li_dir))[0]
    for i in (0, 1):
        _write_ingest_file(os.path.join(li_dir, f"part-{90000 + i:05d}.parquet"), seed + 9, i, per_file, sf,
                           "1999-01-01", new_key)
    _write_orders_file(os.path.join(o_dir, "part-90000.parquet"), seed + 9, 0, new_key, max(1, per_file // 4), sf)
    os.remove(os.path.join(li_dir, first))
    return first


def check_hybrid_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """Hybrid scan on a small lake: three indexes built on the GPU (K1),
    then files appended to both tables and one dropped; a CPU and a GPU
    session over the same indexes run q6, J1 (inner, outer, streamed) and
    A3: GPU == CPU port (byte for byte; A3's float sums at rtol 1e-9) ==
    hyperspace off (as a multiset); the GPU's q6 says ``filter:
    device-lineage`` and launches the lineage-antijoin program; J1
    re-buckets the appends once, then from the cache. A quick refresh
    (no launch) keeps serving through hybrid scan, and an incremental one
    (K1) ends it."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import join as J
    from hyperspace_tpu_torch.ops import kernels

    rows = 60_000
    root = os.path.join(tmp, "hsmall")
    li_dir = gen_lineitem(root, rows, 6, seed + 13)
    sf = rows / LINEITEM_ROWS_SF1
    o_dir = gen_orders(root, max(1, int(ORDERS_ROWS_SF1 * sf)), 2, seed + 14)
    new_key = max(1, int(ORDERS_ROWS_SF1 * sf))
    system = os.path.join(tmp, "hsmall-indexes")
    sessions = {d: ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 16, ht.keys.DEVICE_MIN_ROWS: 0,
                                    ht.keys.BUILD_BATCH_ROWS: 25_000, **HYBRID_CONF}, device=d) for d in devices}
    gpu = sessions[devices[-1]]
    torch.cuda.synchronize()
    kernels.reset_launches()
    build_hybrid_indexes(gpu, gpu.read_parquet(li_dir), gpu.read_parquet(o_dir))
    torch.cuda.synchronize()
    build_launches = {k: v for k, v in kernels.launches.items() if v}
    if devices[-1] == "cuda":
        assert set(build_launches) == {K1}, build_launches
    edit_hybrid_lake(li_dir, o_dir, seed, rows // 8, sf, new_key)
    out = {"build_launches": build_launches}

    def run_all(stage: str, expect_hybrid: bool):
        got = {}
        for device, sess in sessions.items():
            sess.enable_hyperspace()
            qs = hybrid_queries(sess.read_parquet(li_dir), sess.read_parquet(o_dir))
            D.reset_dispatches()
            J.clear_rank_cache()
            for name, q in qs.items():
                plan = q.optimized_plan().pretty()
                assert ("BucketUnion" in plan or "_data_file_id" in plan) == expect_hybrid or name == "q6", plan
                got[name, device], summary = traced_collect(q)
                lines = summary.splitlines()
                if device == "cuda" and expect_hybrid and name == "q6":
                    assert "filter: device-lineage x1" in lines, summary
                if expect_hybrid and name == "J1":
                    assert "rebucket: computed x2" in lines, summary
                    again, summary = traced_collect(q)
                    assert "rebucket: cached x2" in summary.splitlines() and same_batch(again, got[name, device])
            if device == "cuda" and expect_hybrid:
                assert D.dispatches["lineage-antijoin"] >= 1, dict(D.dispatches)
                out.setdefault("dispatches", {})[stage] = dict(D.dispatches)
            sess.conf.set(ht.keys.STREAM_JOIN_MIN_BYTES, 1)
            got["J1 streamed", device], summary = traced_collect(qs["J1"])
            assert "join: host-span-smj-stream x1" in summary.splitlines(), summary
            sess.conf.set(ht.keys.STREAM_JOIN_MIN_BYTES, 1 << 30)
            sess.disable_hyperspace()
            for name, q in qs.items():
                off = q.collect()
                assert same_groups(got[name, device], off, {"sum_price", "sum_total"}, ordered=False), (stage, name)
            assert same_rows(got["J1 streamed", device], qs["J1"].collect())
        for key in {k for k, _ in got}:
            g, c = got[key, devices[-1]], got[key, devices[0]]
            assert same_groups(g, c, {"sum_price", "sum_total"}, ordered=True), f"hybrid-small {stage} {key}: GPU != CPU"
        print(f"hybrid-small {stage}: q6, J1 (inner, outer, streamed) and A3 on the GPU equal the CPU port and "
              f"hyperspace off" + ("; filter: device-lineage, rebucket computed then cached" if expect_hybrid else ""),
              flush=True)

    run_all("appended and dropped", True)
    for label, mode, expected, hybrid in (("quick", "quick", set(), True), ("incremental", "incremental", {K1}, False)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        for name in ("li_h", "li_ok_h"):
            ht.Hyperspace(gpu).refresh_index(name, mode)
        ht.Hyperspace(gpu).refresh_index("o_h", mode)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items() if v}
        if devices[-1] == "cuda":
            assert set(launches) == expected, (label, launches)
        out[f"{label}_launches"] = launches
        for sess in sessions.values():
            sess.index_manager.clear_cache()
        run_all(f"after {label} refresh", hybrid)
    return out


def check_sources_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """Delta, Iceberg and CSV/ORC on small tables. Delta: a covering index
    with lineage and a MinMax sketch built in the CPU session; each session
    from a copy, a new version and a removed file; hybrid scan, then
    incremental refresh (the GPU launching K1 and K2) with index files equal
    to the CPU port's byte for byte; a time-travel read of the first
    version. Iceberg: a covering index on the GPU (K1), a new snapshot,
    hybrid scan. CSV and ORC: a covering index on the GPU (K1) and a
    query. Every query equals the CPU port and hyperspace off."""
    import pyarrow.csv as pacsv
    import pyarrow.orc as orc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.sources import delta, iceberg

    rows = 60_000
    root = os.path.join(tmp, "ssmall")
    src = gen_lineitem(root, rows, 3, seed + 17)
    sf = rows / LINEITEM_ROWS_SF1
    new_key = max(1, int(ORDERS_ROWS_SF1 * sf))
    tables = [pq.read_table(os.path.join(src, f)) for f in sorted(os.listdir(src))]
    c = ht.col
    out = {}

    def conf(system, **extra):
        return {ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 16, ht.keys.DEVICE_MIN_ROWS: 0,
                ht.keys.BUILD_BATCH_ROWS: 25_000, **HYBRID_CONF, **extra}

    def compare(label, make, sessions, float_aggs=(), ordered=True):
        got = {}
        for device, sess in sessions.items():
            q = make(sess)
            with sess.hyperspace_scope(True):
                plan = q.optimized_plan().pretty()
                got[device] = q.collect()
            with sess.hyperspace_scope(False):
                off = q.collect()
            assert same_groups(got[device], off, set(float_aggs), ordered=False), f"sources-small {label} != off"
        assert same_groups(got[devices[-1]], got[devices[0]], set(float_aggs), ordered=ordered), f"{label}: GPU != CPU"
        return plan

    # Delta
    lake = os.path.join(root, "delta")
    for t in tables:  # six versions: a removed file stays under maxDeletedRatio
        half = t.num_rows // 2
        delta.write_delta_table(t.slice(0, half), lake)
        delta.write_delta_table(t.slice(half), lake)
    first_version = delta.list_versions(lake)[-1]
    base = os.path.join(tmp, "ssmall-delta-base")
    cpu = ht.Session(conf=conf(base, **{ht.keys.LINEAGE_ENABLED: True}), device=devices[0])
    ht.Hyperspace(cpu).create_index(cpu.read_delta(lake), ht.CoveringIndexConfig(
        "d_cov", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]))
    ht.Hyperspace(cpu).create_index(cpu.read_delta(lake), ht.DataSkippingIndexConfig(
        "d_skip", ht.MinMaxSketch("l_orderkey")))
    edit = os.path.join(root, "ingest.parquet")
    _write_ingest_file(edit, seed + 17, 0, rows // 6, sf, "1999-01-01", new_key)
    delta.write_delta_table(pq.read_table(edit), lake)
    delta.delete_delta_files(lake, [sorted(delta._replay(lake, 0))[0]])
    sessions = {}
    for i, device in enumerate(devices):
        system = os.path.join(tmp, f"ssmall-delta-{i}-{device}")
        shutil.copytree(base, system)
        sessions[device] = ht.Session(conf=conf(system), device=device)
    plan = compare("delta hybrid q6", lambda s: q6_query(s.read_delta(lake)), sessions)
    assert "BucketUnion" in plan and "_data_file_id" in plan, plan
    for device, sess in sessions.items():
        torch.cuda.synchronize()
        kernels.reset_launches()
        ht.Hyperspace(sess).refresh_index("d_cov", "incremental")
        ht.Hyperspace(sess).refresh_index("d_skip", "incremental")
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items() if v}
        if device == "cuda":
            assert set(launches) == {K1, K2}, launches
            out["delta_refresh_launches"] = launches
    fp = {d: {n: index_fingerprint(s.index_manager.get_index(n)) for n in ("d_cov", "d_skip")}
          for d, s in sessions.items()}
    assert fp[devices[-1]] == fp[devices[0]], "sources-small: delta refresh differs from the CPU port's"
    # each session refreshed its own copy: a bucket's runs carry random file
    # tags, so rows with equal keys may come in another order (ROADMAP C)
    plan = compare("delta q6 after refresh", lambda s: q6_query(s.read_delta(lake)), sessions, ordered=False)
    assert "BucketUnion" not in plan and "LogVersion: 3" in plan, plan
    plan = compare("delta time travel", lambda s: q6_query(s.read_delta(lake, version=first_version)), sessions,
                   ordered=False)
    assert "LogVersion: 1" in plan, plan
    new_orders = compare("delta skipping", lambda s: s.read_delta(lake).filter(c("l_orderkey") >= new_key)
                         .select("l_orderkey", "l_tax"), sessions, ordered=False)
    assert "Type: DS, Name: d_skip" in new_orders, new_orders
    print("sources-small delta: hybrid q6, incremental refresh (K1, K2) with index files equal to the CPU port's, "
          "time travel to the first index version, the sketch's pruning: GPU == CPU port == off", flush=True)

    # Iceberg
    ice = os.path.join(root, "iceberg")
    for t in tables:
        iceberg.write_iceberg_table(t, ice)
    system = os.path.join(tmp, "ssmall-iceberg")
    sessions = {d: ht.Session(conf=conf(system), device=d) for d in devices}
    torch.cuda.synchronize()
    kernels.reset_launches()
    ht.Hyperspace(sessions[devices[-1]]).create_index(sessions[devices[-1]].read_iceberg(ice), ht.CoveringIndexConfig(
        "i_cov", ["l_orderkey"], ["l_extendedprice", "l_shipdate"]))
    torch.cuda.synchronize()
    if devices[-1] == "cuda":
        assert {k for k, v in kernels.launches.items() if v} == {K1}, dict(kernels.launches)
    iceberg.write_iceberg_table(pq.read_table(edit), ice)
    plan = compare("iceberg hybrid", lambda s: s.read_iceberg(ice).filter(c("l_orderkey") >= new_key - 50)
                   .select("l_orderkey", "l_extendedprice"), sessions)
    assert "BucketUnion" in plan, plan
    print("sources-small iceberg: a new snapshot served through hybrid scan: GPU == CPU port == off", flush=True)

    # CSV and ORC
    for fmt in ("csv", "orc"):
        d = os.path.join(root, fmt)
        os.makedirs(d)
        for i, t in enumerate(tables):
            t = t.select(["l_orderkey", "l_extendedprice", "l_quantity"])
            path = os.path.join(d, f"part-{i:05d}.{fmt}")
            if fmt == "csv":
                pacsv.write_csv(t, path)
            else:
                orc.write_table(t, path)
        system = os.path.join(tmp, f"ssmall-{fmt}")
        sessions = {dv: ht.Session(conf=conf(system), device=dv) for dv in devices}
        gpu = sessions[devices[-1]]
        ht.Hyperspace(gpu).create_index(gpu.read(d, fmt), ht.CoveringIndexConfig(
            f"{fmt}_cov", ["l_orderkey"], ["l_extendedprice"]))
        plan = compare(f"{fmt} filter", lambda s, d=d, fmt=fmt: s.read(d, fmt).filter(c("l_orderkey") == 77)
                       .select("l_orderkey", "l_extendedprice"), sessions)
        assert "IndexScan" in plan, plan
    print("sources-small csv, orc: covering index built on the GPU, queries == CPU port == off", flush=True)
    out["first_version"] = first_version
    return out


def time_queries(sess, qs: dict, reps: int, label: str, smi: str):
    """Cold (caches emptied), warm (median of ``reps``, with layers) and
    hyperspace-off times of each query; the results of the cold runs."""
    import torch

    out, results = {}, {}
    for name, q in qs.items():
        clear_query_caches()
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        results[name] = q.collect()
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        warm = layer_ms(sess, q.collect, reps)
        with sess.hyperspace_scope(False):
            off_ms = median_ms(q.collect, max(2, reps // 2))
        out[name] = {"rows": len(next(iter(results[name].values()))), "cold_ms": cold, "warm_ms": warm["total"],
                     "off_ms": off_ms, "layers": warm}
        print(f"{label} {name}: {out[name]['rows']} rows; cold {cold:.3f} ms, warm {warm['total']:.3f} ms, "
              f"off {off_ms:.3f} ms ({smi})", flush=True)
        print(f"layers {label} {name} (warm): " + ", ".join(f"{k} {v:.3f}" for k, v in warm.items() if v >= 0.001),
              flush=True)
    return out, results


def run_prune(li_src: str, tmp: str, args, smi: str) -> dict:
    """Scan pruning at SF1: ``lineitem`` rewritten as a year-partitioned
    lake (131072-row row groups in ship-date order); q6, q6f and q6pf with
    hyperspace off, pruning on and off: files and row groups read, rows
    equal, cold and warm times; then ``li_part`` (K1) serving q6 and q6's
    aggregate, unstreamed and streamed."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.ops import kernels

    t = time.perf_counter()
    lake = gen_partitioned_lineitem(li_src, os.path.join(tmp, "prune", "lineitem"), 131072, 4 * 131072)
    n_files = sum(len(fs) for _, _, fs in os.walk(lake))
    print(f"prune lake: {args.rows} rows by l_shipyear in {n_files} files of 131072-row groups, "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "prune", "indexes"), ht.keys.DEVICE_MIN_ROWS: 0},
                      device="cuda")
    reps = max(3, args.reps // 3)
    out = {"device": smi, "files": n_files, "queries": {}}
    want = {}
    for pruning in (True, False):
        sess.conf.set("hyperspace.exec.io.rowGroupPruning", pruning)
        for name, q in prune_queries(sess.read_parquet(lake)).items():
            IO.clear_io_cache()
            with PruneSpy() as spy:
                t = time.perf_counter()
                got = q.collect()
                cold = (time.perf_counter() - t) * 1e3
            files, decoded, groups = spy.counts()
            warm = median_ms(q.collect, reps)
            if name in want:
                assert same_batch(got, want[name]), f"prune {name}: pruned rows differ from unpruned"
            want[name] = got
            rec = {"rows": len(next(iter(got.values()))), "files": files, "row_groups": decoded,
                   "row_groups_total": groups, "cold_ms": cold, "warm_ms": warm}
            out["queries"][f"{name} pruning {'on' if pruning else 'off'}"] = rec
            print(f"prune {name} (pruning {'on' if pruning else 'off'}): {rec['rows']} rows; {files} of {n_files} "
                  f"files, {decoded} of {groups} row groups decoded; cold {cold:.3f} ms, warm {warm:.3f} ms ({smi})",
                  flush=True)
    q = out["queries"]
    assert q["q6pf pruning on"]["files"] < n_files and q["q6f pruning on"]["row_groups"] < q["q6f pruning off"]["row_groups"]
    assert q["q6 pruning on"]["row_groups"] == q["q6 pruning off"]["row_groups"]
    with sess.hyperspace_scope(False):
        off = q6_query(sess.read_parquet(li_src)).collect()
    assert same_rows(want["q6"], off), "prune q6 differs from the unpartitioned lake's"

    sess.conf.set("hyperspace.exec.io.rowGroupPruning", True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig(
        "li_part", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {k: v for k, v in kernels.launches.items() if v}
    assert set(launches) == {K1}, launches
    out["li_part"] = {"seconds": seconds, "rows_per_s": args.rows / seconds, "launches": launches}
    print(f"build li_part: {seconds:.3f} s, {args.rows / seconds:.0f} rows/s; launches {launches} ({smi})", flush=True)
    sess.enable_hyperspace()
    df = sess.read_parquet(lake)
    qs = {"q6": df.filter(q6_condition()).select("l_extendedprice", "l_discount"),
          "q6 agg": df.filter(q6_condition()).agg(revenue=("l_extendedprice", "sum"), n=("*", "count"))}
    for streamed in (False, True):
        sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1 if streamed else 1 << 30)
        sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, (8 << 20) if streamed else 256 << 20)
        label = "prune li_part" + (" streamed" if streamed else "")
        times, res = time_queries(sess, qs, reps, label, smi)
        with sess.hyperspace_scope(False):
            for name, qq in qs.items():
                assert same_groups(res[name], qq.collect(), {"revenue"}, ordered=False), f"{label} {name} != off"
        out[label] = times
    sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1 << 30)
    return out


def capture_lineage_program(run):
    """Run ``run()`` with the lineage-antijoin program wrapped: its last
    call's inputs."""
    from hyperspace_tpu_torch.exec import lineage as LN

    seen = {}
    real = LN.antijoin_program

    def wrap(*a):
        seen["args"] = a
        return real(*a)

    LN.antijoin_program = wrap
    try:
        run()
    finally:
        LN.antijoin_program = real
    return seen["args"]


def lineage_program_time(args_, reps: int, hbm: float) -> dict:
    """The lineage-antijoin program alone on its inputs (CUDA events), its
    bound (the ids read once, the table once, the mask written once),
    ``torch.isin`` on the same inputs and the plain numpy version."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch.exec import lineage as LN

    col, ids, n_ids = args_
    live = ids[:n_ids]
    mask = LN.antijoin_program(col, ids, n_ids)
    assert torch.equal(mask, torch.isin(col, live, invert=True)), "lineage-antijoin differs from torch.isin"
    host_col, host_ids = col.cpu().numpy(), live.cpu().numpy()
    assert np.array_equal(mask.cpu().numpy(), LN.lineage_keep_mask_plain(host_col, host_ids))
    n = col.numel()
    b_ms, b_by = bound(n * 8 + ids.numel() * 8 + n, n * (int(np.ceil(np.log2(max(ids.numel(), 2)))) + 3), hbm)
    t = time.perf_counter()
    for _ in range(3):
        LN.lineage_keep_mask_plain(host_col, host_ids)
    plain_ms = (time.perf_counter() - t) / 3 * 1e3
    out = {"shape": f"{n} int64 lineage ids, {n_ids} deleted ids in a table of {ids.numel()}",
           "ms": time_ms(lambda: LN.antijoin_program(col, ids, n_ids), reps), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lambda: torch.isin(col, live, invert=True), reps), "plain_ms": plain_ms}
    out["share_of_bound"] = b_ms / out["ms"]
    return out


def run_hybrid(li_src: str, o_src: str, tmp: str, args, smi: str, hbm: float) -> dict:
    """Hybrid scan at SF1: ``lineitem`` and ``orders`` hard-linked into a
    mutable lake; ``li_h``, ``li_ok_h`` (lineage) and ``o_h`` built; two
    new-orders ``lineitem`` files and their ``orders`` file appended, one
    original ``lineitem`` file dropped; q6, J1 and A3 through the hybrid
    plans, cold, warm and off, with layers and traces, equal to off and to
    the same queries after a full refresh; the lineage-antijoin program
    alone on q6's index side."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import join as J
    from hyperspace_tpu_torch.ops import kernels

    li_dir, o_dir = os.path.join(tmp, "hybrid", "lineitem"), os.path.join(tmp, "hybrid", "orders")
    for s, d in ((li_src, li_dir), (o_src, o_dir)):
        os.makedirs(d)
        for f in sorted(os.listdir(s)):
            os.link(os.path.join(s, f), os.path.join(d, f))
    sf = args.rows / LINEITEM_ROWS_SF1
    new_key = max(1, int(ORDERS_ROWS_SF1 * sf))
    per_file = args.rows // args.files
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "hybrid", "indexes"), ht.keys.DEVICE_MIN_ROWS: 0,
                            ht.keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES: 2 << 30, **HYBRID_CONF}, device="cuda")
    out = {"device": smi}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    build_hybrid_indexes(sess, sess.read_parquet(li_dir), sess.read_parquet(o_dir))
    torch.cuda.synchronize()
    out["build"] = {"seconds": time.perf_counter() - t, "launches": {k: v for k, v in kernels.launches.items() if v}}
    assert set(out["build"]["launches"]) == {K1}, out["build"]
    print(f"hybrid build li_h, li_ok_h, o_h: {out['build']['seconds']:.3f} s; launches {out['build']['launches']}",
          flush=True)
    li_bytes = sum(os.path.getsize(os.path.join(li_dir, f)) for f in os.listdir(li_dir))
    dropped = edit_hybrid_lake(li_dir, o_dir, args.seed, per_file, sf, new_key)
    li_now = sum(os.path.getsize(os.path.join(li_dir, f)) for f in os.listdir(li_dir))
    appended = sum(os.path.getsize(os.path.join(li_dir, f)) for f in os.listdir(li_dir) if f.startswith("part-9"))
    out["edit"] = {"dropped": dropped, "appended_share": appended / li_now,
                   "deleted_share": os.path.getsize(os.path.join(li_src, dropped)) / li_bytes}
    print(f"hybrid edit: 2 lineitem files ({per_file} rows each, keys from {new_key}) and 1 orders file appended, "
          f"{dropped} dropped; appended {out['edit']['appended_share']:.4f} of lineitem's bytes, deleted "
          f"{out['edit']['deleted_share']:.4f} of the indexed bytes", flush=True)

    sess.enable_hyperspace()
    qs = hybrid_queries(sess.read_parquet(li_dir), sess.read_parquet(o_dir))
    del qs["J1 outer"]
    for name, q in qs.items():
        plan = q.optimized_plan().pretty()
        assert "_data_file_id" in plan and (name == "q6" or plan.count("BucketUnion") == 2), plan
    clear_query_caches()
    D.reset_dispatches()
    traces = {}
    rebuckets = []
    real_rebucket = J._rebucket

    def timed_rebucket(*a):
        t = time.perf_counter()
        got = real_rebucket(*a)
        rebuckets.append(((time.perf_counter() - t) * 1e3, sum(len(next(iter(v.values()))) for v in got.values())))
        return got

    for name, q in qs.items():
        J._rebucket = timed_rebucket if name == "J1" else real_rebucket
        try:
            _, summary = traced_collect(q)
            _, again = traced_collect(q)
        finally:
            J._rebucket = real_rebucket
        traces[name] = [ln for ln in (summary + "\n" + again).splitlines()
                        if ln.startswith(("filter:", "join:", "agg:", "rebucket:"))]
        print(f"hybrid trace {name}: {'; '.join(traces[name])}", flush=True)
    # J1's first run re-buckets the lineitem side, then the orders side; its
    # second run finds both in the cache
    assert len(rebuckets) == 4, rebuckets
    out["rebucket"] = {side: {"rows": rebuckets[i][1], "computed_ms": rebuckets[i][0], "cached_ms": rebuckets[i + 2][0]}
                       for i, side in enumerate(("lineitem", "orders"))}
    for side, r in out["rebucket"].items():
        print(f"hybrid rebucket {side}: {r['rows']} appended rows, computed {r['computed_ms']:.3f} ms, cached "
              f"{r['cached_ms']:.3f} ms ({smi})", flush=True)
    assert "filter: device-lineage x1" in traces["q6"], traces
    assert "rebucket: computed x2" in traces["J1"] and "rebucket: cached x2" in traces["J1"], traces
    out["dispatches"] = dict(D.dispatches)
    assert D.dispatches["lineage-antijoin"] >= 1, out["dispatches"]
    out["traces"] = traces
    reps = max(3, args.reps // 3)
    times, results = time_queries(sess, qs, reps, "hybrid", smi)
    out["queries"] = times
    for name, q in qs.items():
        with sess.hyperspace_scope(False):
            off = q.collect()
        assert same_groups(results[name], off, {"sum_price", "sum_total"}, ordered=False), f"hybrid {name} != off"
    out["program"] = lineage_program_time(capture_lineage_program(qs["q6"].collect), args.reps, hbm)
    p = out["program"]
    print(f"program lineage-antijoin ({p['shape']}): {p['ms']:.6f} ms, bound {p['bound_ms']:.6f} ms "
          f"({p['bound_by']}), share {p['share_of_bound']:.4f}; torch.isin {p['library_ms']:.6f} ms, "
          f"numpy {p['plain_ms']:.3f} ms ({smi})", flush=True)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    for name in ("li_h", "li_ok_h", "o_h"):
        ht.Hyperspace(sess).refresh_index(name, "full")
    torch.cuda.synchronize()
    out["full_refresh"] = {"seconds": time.perf_counter() - t,
                           "launches": {k: v for k, v in kernels.launches.items() if v}}
    assert set(out["full_refresh"]["launches"]) == {K1}, out["full_refresh"]
    for name, q in qs.items():
        plan = q.optimized_plan().pretty()
        assert "_data_file_id" not in plan and "BucketUnion" not in plan, plan
        assert same_groups(q.collect(), results[name], {"sum_price", "sum_total"}, ordered=False), name
    refreshed, _ = time_queries(sess, qs, reps, "hybrid refreshed", smi)
    out["refreshed"] = refreshed
    print(f"hybrid: full refresh {out['full_refresh']['seconds']:.3f} s (launches {out['full_refresh']['launches']}); "
          f"q6, J1, A3 equal before and after", flush=True)
    return out


def run_delta(li_src: str, tmp: str, args, smi: str) -> dict:
    """A Delta table at SF1: ``lineitem`` written through the port's writer
    (one version per source file); a covering index with lineage (K1) and a
    MinMax sketch on ``l_orderkey`` (K2); a version of new orders and a
    version that removes a file; q6 through hybrid scan, incremental refresh
    of both indexes (K1, K2), q6 again, and a time-travel read of the table
    before the edits, which picks the index version recorded for it."""
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.sources import delta

    lake = os.path.join(tmp, "delta", "lineitem")
    t = time.perf_counter()
    for f in sorted(os.listdir(li_src)):
        delta.write_delta_table(pq.read_table(os.path.join(li_src, f)), lake)
    first = delta.list_versions(lake)[-1]
    out = {"device": smi, "write_seconds": time.perf_counter() - t, "actions": [], "queries": {}}
    print(f"delta write: {args.rows} rows in {first + 1} versions, {out['write_seconds']:.3f} s", flush=True)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "delta", "indexes"), ht.keys.DEVICE_MIN_ROWS: 0,
                            **HYBRID_CONF}, device="cuda")
    hs = ht.Hyperspace(sess)
    sf = args.rows / LINEITEM_ROWS_SF1
    per_file = args.rows // args.files
    reps = max(3, args.reps // 3)

    def action(label, fn, rows, expected):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: v for k, v in kernels.launches.items() if v}
        assert set(launches) == expected, (label, launches)
        out["actions"].append({"action": label, "seconds": seconds, "rows": rows, "rows_per_s": rows / seconds,
                               "launches": launches})
        print(f"delta {label}: {seconds:.3f} s, {rows} rows, {rows / seconds:.0f} rows/s; launches {launches} ({smi})",
              flush=True)

    def q6_run(label, version=None):
        q = q6_query(sess.read_delta(lake, version=version))
        with sess.hyperspace_scope(True):
            plan = q.optimized_plan().pretty()
            times, res = time_queries(sess, {label: q}, reps, "delta", smi)
        with sess.hyperspace_scope(False):
            assert same_rows(res[label], q.collect()), f"delta {label} differs from off"
        out["queries"][label] = times[label]
        return plan

    sess.enable_hyperspace()
    sess.conf.set(ht.keys.LINEAGE_ENABLED, True)
    action("create ld_cov", lambda: hs.create_index(sess.read_delta(lake), ht.CoveringIndexConfig(
        "ld_cov", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"])), args.rows, {K1})
    sess.conf.set(ht.keys.LINEAGE_ENABLED, False)
    action("create ld_skip", lambda: hs.create_index(sess.read_delta(lake), ht.DataSkippingIndexConfig(
        "ld_skip", ht.MinMaxSketch("l_orderkey"))), args.rows, {K2})
    edit = os.path.join(tmp, "delta", "ingest.parquet")
    _write_ingest_file(edit, args.seed + 21, 0, per_file, sf, "1999-01-01", max(1, int(ORDERS_ROWS_SF1 * sf)))
    delta.write_delta_table(pq.read_table(edit), lake)
    delta.delete_delta_files(lake, [sorted(delta._replay(lake, 0))[0]])
    print(f"delta edit: version {first + 1} adds {per_file} rows of new orders, version {first + 2} removes a file",
          flush=True)
    plan = q6_run("q6 hybrid")
    assert "BucketUnion" in plan and "_data_file_id" in plan, plan
    rows_now = sum(pq.read_metadata(f).num_rows for f in delta.DeltaLakeRelation(lake).arrow_dataset().files)
    action("incremental ld_cov", lambda: hs.refresh_index("ld_cov", "incremental"), rows_now, {K1})
    action("incremental ld_skip", lambda: hs.refresh_index("ld_skip", "incremental"), rows_now, {K2})
    plan = q6_run("q6 refreshed")
    assert "BucketUnion" not in plan, plan
    plan = q6_run("q6 time travel", version=first)
    assert "LogVersion: 1" in plan, plan
    print(f"delta time travel: version {first} served by ld_cov's first log version", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=LINEITEM_ROWS_SF1, help="lineitem rows (6M = SF1)")
    ap.add_argument("--files", type=int, default=16)
    ap.add_argument("--reps", type=int, default=12, help="timed runs per kernel and warm query")
    ap.add_argument("--baseline-csrc", help="a copy of an earlier tree's hyperspace_tpu_torch/csrc: its "
                    "kernels are built and timed in turns with this tree's")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    if not os.path.isdir(os.path.join(HERE, "hyperspace_tpu_torch", "csrc")):
        sys.exit("chip_smoke: the hyperspace_tpu_torch package is not beside this script")
    sys.path.insert(0, HERE)

    t = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if kind not in HBM_BYTES_PER_S:
        sys.exit(f"chip_smoke: no memory rate on record for {kind!r}")
    hbm = HBM_BYTES_PER_S[kind]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    print(smi, flush=True)
    phase("device", t)

    t = time.perf_counter()
    from hyperspace_tpu_torch.ops import cuda_build, kernels

    libs = cuda_build.build_all()
    for source, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"nvcc {source}: {line.strip()}", flush=True)
    print(f"built: {', '.join(os.path.basename(p) for p in libs.values())}", flush=True)
    phase("build", t)

    t = time.perf_counter()
    results = check_kernels(args, hbm)
    phase("kernels", t)

    import hyperspace_tpu_torch as ht

    tmp = tempfile.mkdtemp(prefix="hs_chip_smoke_")
    try:
        t = time.perf_counter()
        check_small(tmp, args.seed)
        phase("small", t)

        t = time.perf_counter()
        small = check_query_small(tmp, args.seed)
        phase("query-small", t)

        t = time.perf_counter()
        join_small = check_join_small(tmp, args.seed)
        phase("join-small", t)

        t = time.perf_counter()
        agg_small = check_agg_small(tmp, args.seed)
        phase("agg-small", t)

        t = time.perf_counter()
        stream_small = check_stream_small(tmp, args.seed)
        phase("stream-small", t)

        t = time.perf_counter()
        lifecycle_small = check_lifecycle_small(tmp, args.seed)
        phase("lifecycle-small", t)

        t = time.perf_counter()
        prune_small = check_prune_small(tmp, args.seed)
        phase("prune-small", t)

        t = time.perf_counter()
        hybrid_small = check_hybrid_small(tmp, args.seed)
        hybrid_small["program"] = check_lineage_program("cuda")
        phase("hybrid-small", t)

        t = time.perf_counter()
        sources_small = check_sources_small(tmp, args.seed)
        phase("sources-small", t)

        t = time.perf_counter()
        src = gen_lineitem(tmp, args.rows, args.files, args.seed)
        print(f"lake: {args.rows} lineitem rows in {args.files} files", flush=True)
        phase("generate", t)

        sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "indexes")}, device="cuda")
        hs = ht.Hyperspace(sess)
        df = sess.read_parquet(src)
        configs = [
            ht.CoveringIndexConfig("li_shipdate", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]),
            ht.CoveringIndexConfig("li_orderkey", ["l_orderkey"], ["l_extendedprice"]),
            ht.DataSkippingIndexConfig("li_skip", ht.MinMaxSketch("l_extendedprice"), ht.MinMaxSketch("l_orderkey")),
        ]
        entries, seconds = {}, {}
        torch.cuda.synchronize()
        kernels.reset_launches()
        stages = {}
        t = time.perf_counter()
        for cfg in configs:
            sess.build_stage_seconds.clear()
            t_i = time.perf_counter()
            entries[cfg.index_name] = hs.create_index(df, cfg)
            seconds[cfg.index_name] = time.perf_counter() - t_i
            stages[cfg.index_name] = dict(sess.build_stage_seconds)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        phase("slice", t)
        for name, s in seconds.items():
            print(f"build {name}: {s:.3f} s, {args.rows / s:.0f} rows/s ({smi})", flush=True)
            if stages[name]:
                print(f"stages {name}: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages[name].items()),
                      flush=True)
        print(f"launches on the main path: {launches}", flush=True)
        for name in results:
            assert launches.get(name, 0) > 0, f"the main path never launched {name}"
            results[name]["launches"] = launches[name]

        t = time.perf_counter()
        src_files = [fi.name for fi in entries["li_shipdate"].source_file_infos()]
        for (name, key, cols) in (
            ("li_shipdate", "l_shipdate", ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount"]),
            ("li_orderkey", "l_orderkey", ["l_orderkey", "l_extendedprice"]),
        ):
            n = check_covering(entries[name], src_files, key, cols, sess.conf.num_buckets)
            print(f"check {name}: {n} rows hash to their buckets, sorted by {key}, equal to the source", flush=True)
        from hyperspace_tpu_torch.indexes.registry import index_of_entry

        check_sketches(entries["li_skip"], index_of_entry(entries["li_skip"]))
        print("check li_skip: sketch rows equal numpy per-file min/max", flush=True)
        listed = hs.indexes()
        assert sorted(listed["name"]) == sorted(entries) and set(listed["state"]) == {"ACTIVE"}, listed
        print(f"indexes: {sorted(listed['name'])} ACTIVE", flush=True)
        phase("check", t)

        t = time.perf_counter()
        queries = run_queries(sess, src, args, smi, hbm)
        queries["small"] = small
        queries["device"] = smi
        phase("query", t)

        t = time.perf_counter()
        queries["join"], j1, o_src = run_joins(sess, src, tmp, args, smi, hbm)
        queries["join"]["small"] = join_small
        phase("join", t)

        if (args.seed, args.rows, args.files) == (0, LINEITEM_ROWS_SF1, 16):
            # the lake's added columns left every other column as it was:
            # the counts of the runs before them
            rows = {q["name"]: q["rows"] for q in queries["queries"] + queries["join"]["joins"]}
            assert (rows["q6"], rows["J1"], rows["J2"]) == (119660, 6000000, 1542231), rows
            print(f"lake guard: q6 {rows['q6']}, J1 {rows['J1']}, J2 {rows['J2']} rows, as before the flag "
                  f"columns", flush=True)

        t = time.perf_counter()
        queries["agg"], a1 = run_aggregates(sess, src, o_src, tmp, args, smi, hbm)
        queries["agg"]["small"] = agg_small
        phase("agg", t)

        t = time.perf_counter()
        queries["stream"], a1_streamed, chunk = run_stream(sess, src, o_src, tmp, args, smi, hbm)
        queries["stream"]["small"] = stream_small
        phase("stream", t)

        t = time.perf_counter()
        queries["lifecycle"] = run_lifecycle(src, tmp, args, smi)
        queries["lifecycle"]["small"] = lifecycle_small
        phase("lifecycle", t)

        t = time.perf_counter()
        queries["prune"] = run_prune(src, tmp, args, smi)
        queries["prune"]["small"] = prune_small
        phase("prune", t)

        t = time.perf_counter()
        queries["hybrid"] = run_hybrid(src, o_src, tmp, args, smi, hbm)
        queries["hybrid"]["small"] = hybrid_small
        phase("hybrid", t)

        t = time.perf_counter()
        queries["delta"] = run_delta(src, tmp, args, smi)
        queries["delta"]["small"] = sources_small
        phase("delta", t)
        for name in results:
            results[name]["launches_by_path"] = {
                "build": results[name]["launches"],
                "prune": queries["prune"]["li_part"]["launches"].get(name, 0),
                "hybrid": queries["hybrid"]["build"]["launches"].get(name, 0)
                + queries["hybrid"]["full_refresh"]["launches"].get(name, 0),
                "delta": sum(a["launches"].get(name, 0) for a in queries["delta"]["actions"]),
            }

        t = time.perf_counter()
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
        q6 = q6_query(sess.read_parquet(src))
        q6.collect()  # warm: both caches hold its columns
        queries["q6_profile"] = device_profile("q6 (warm)", q6.collect, tmp)
        phase("profile-query", t)

        t = time.perf_counter()
        j1.collect()  # warm: decoded buckets and device rectangles resident
        queries["J1_profile"] = device_profile("J1 (warm)", j1.collect, tmp)
        phase("profile-join", t)

        t = time.perf_counter()
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
        sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1 << 30)
        a1.collect()  # warm: the scan decoded, its columns resident
        queries["A1_profile"] = device_profile("A1 (warm)", a1.collect, tmp)
        phase("profile-agg", t)

        t = time.perf_counter()
        sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1)
        sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, chunk)
        a1_streamed.collect()  # warm: the chunks decoded, their columns resident
        queries["A1_stream_profile"] = device_profile("A1 streamed (warm)", a1_streamed.collect, tmp,
                                                      highlight=("index_add", "scatter", "sort"))
        sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1 << 30)
        phase("profile-stream", t)

        t = time.perf_counter()
        profile_build(hs, df, ht.CoveringIndexConfig(
            "li_shipdate_profiled", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]), tmp)
        phase("profile", t)

        t = time.perf_counter()
        print(f"scale: {shutil.disk_usage(tmp).free} bytes free on the lake's disk", flush=True)
        queries["scale"] = run_scale(sess, src, o_src, tmp, args, smi)
        phase("scale", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps(queries))
    print(json.dumps({"kernels": [results[k] for k in ("bucket_histogram", "segmented_min_max")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
