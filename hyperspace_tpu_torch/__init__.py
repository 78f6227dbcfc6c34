"""hyperspace_tpu_torch — the PyTorch/CUDA port of hyperspace_tpu.

The same data-lake indexing framework, written in PyTorch for one NVIDIA
H100: index data and the versioned operation log live on storage next to the
data, laid out exactly as the JAX package lays them out, so either package
reads what the other wrote. The JAX package (``hyperspace_tpu``) is the
reference each part of the port is held against; the port imports nothing
from it.

The port grows slice by slice. It has the index build — covering and
data-skipping ``create_index``, with the two device kernels of that path
written by hand in CUDA (``csrc/``; ``ops/kernels.py``) — the filter query
over a covering index: ``Session.enable_hyperspace()``, then
``read_parquet(...).filter(...).select(...).collect()`` rewrites the scan
to the index (``rules/``) and evaluates the predicate on the device
(``exec/device.py``) — and the equi-join, which JoinIndexRule rewrites to
two bucketed index scans that join as a shuffle-free sort-merge join with
its span search and pair expansion on the device (``exec/join.py``) — and
aggregation: ``group_by(...).agg(...)``, global ``agg(...)`` and
``distinct()`` over a (filtered) index scan run as one device program
(``exec/aggregate.py``), and over the bucketed join as span-weighted
reductions that never expand the pairs — and the index lifecycle: full,
incremental and quick refresh, quick and full optimize, delete, restore,
vacuum and cancel (``actions/``; every rewrite runs the device build), with
the lineage build and the data-skipping rule that prunes source files by
their sketches (``rules/dataskipping_rule.py``) — and scan pruning (hive
partitions, and parquet row groups by their footer statistics:
``exec/io.py``), hybrid scan, which serves an index over a source that
gained or lost files as the index minus the deleted files' rows
(``exec/lineage.py``, on the device) plus the appended files re-bucketed
on the fly, and the Delta, Iceberg, CSV, JSON, ORC, Avro and text
sources (``Session.read_delta``, ``read_iceberg``, ``read_*``) — and the
SQL front end: ``Session.sql`` over views registered with
``DataFrame.create_or_replace_temp_view`` (``plan/sql.py``, with
``CASE``/``LIKE``/``CAST``, scalar functions, subqueries and their
decorrelation, windows, set operations, ``ORDER BY`` and ``LIMIT``) — and
the serving runtime: ``QueryServer(session)`` admits concurrent requests,
pins each to a snapshot of the index roster, caches compiled plans,
results, decoded buckets and broadcast build sides, and micro-batches
same-shape requests into one shared scan (``serving/``), with per-request
query profiles, the fingerprint history and SLO accounting (``obs/``) and
the background ``RefreshManager`` (``lifecycle/``).

Layer map (the JAX package's layout, module for module):
  - ``models/``    metadata model + operation-log persistence
  - ``sources/``   source providers (parquet and the other file formats,
                   Delta Lake, Iceberg)
  - ``plan/``      logical plan, expression language, column resolution,
                   the SQL front end
  - ``indexes/``   covering and data-skipping index builds
  - ``actions/``   create, refresh, optimize and the maintenance actions
  - ``rules/``     ApplyHyperspace + JoinIndexRule + FilterIndexRule +
                   the data-skipping rule
  - ``exec/``      executor, scan IO and pruning, the device filter, the
                   bucketed join, the device aggregates, the lineage
                   anti-join
  - ``ops/``       hashing, encode, device sort, kernel wrappers
  - ``csrc/``      the CUDA kernels
  - ``serving/``   QueryServer: admission, scheduling, the plan, result,
                   bucket and join build caches, micro-batching
  - ``lifecycle/`` snapshot pins, the commit bus, the refresh manager
  - ``obs/``       spans, metrics, query profiles, history, SLO, the
                   HTTP telemetry endpoint
  - ``fabric/``    multi-process serving over one lake: commit records and
                   their watcher, the coherence sidecar, the fenced refresh
                   lease, FrontDoor over worker endpoints, health, fsck
  - ``telemetry/`` events and the conf-chosen event sink
"""

from hyperspace_tpu_torch.version import __version__
from hyperspace_tpu_torch.config import HyperspaceConf, keys
from hyperspace_tpu_torch.session import Session, get_session, set_session
from hyperspace_tpu_torch.plan.expr import col, lit, input_file_name
from hyperspace_tpu_torch.plan.dataframe import DataFrame
from hyperspace_tpu_torch.indexes.covering import CoveringIndexConfig
from hyperspace_tpu_torch.indexes.dataskipping import (
    DataSkippingIndexConfig,
    MinMaxSketch,
    BloomFilterSketch,
    ValueListSketch,
)
from hyperspace_tpu_torch.hyperspace import Hyperspace
from hyperspace_tpu_torch.serving import AdmissionRejected, QueryServer, RequestTimeout

__all__ = [
    "__version__",
    "HyperspaceConf",
    "keys",
    "Session",
    "get_session",
    "set_session",
    "col",
    "lit",
    "input_file_name",
    "DataFrame",
    "CoveringIndexConfig",
    "DataSkippingIndexConfig",
    "MinMaxSketch",
    "BloomFilterSketch",
    "ValueListSketch",
    "Hyperspace",
    "QueryServer",
    "AdmissionRejected",
    "RequestTimeout",
]
