#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hyperspace_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--rows N] [--files N] [--reps N] [--baseline-csrc DIR]

"SF1" in the phases below names the main lake: ``--rows`` TPC-H-shaped
``lineitem`` rows in ``--files`` files beside 1.5M ``orders`` rows. Its
default is ``DEFAULT_ROWS``, 3M (SF 0.5), cut from 6M so that the whole
script stays well inside its 1200 s limit on a slow host; ``--rows
6000000`` runs SF1 itself. The ``sql`` phase's TPC-H lake is SF 0.5
(``SQL_SF``, cut from SF1 for the same limit); the ``scale`` lake (sized
past the real 1 GiB gate) keeps its size.

Phases, each printed with its time (the filter query's phases are 5, 10
and 13, the join's 6, 11 and 14, the aggregates' 7, 12 and 15, out-of-core
execution's 7b, 12b, 15b and 17, the index lifecycle's 7c and 12c, scan
pruning's 7d and 12d, hybrid scan's 7e and 12e, the other sources' 7f and
12f, the SQL front end's 7g and 12g, the broadcast hash join's 7h, 11 (J3)
and 12g, ORDER BY ... LIMIT's 7i and 12h, the reference API surface's 7j,
explain and whyNot's 7k and 12g, nested columns' 7l and 12i, whole-stage
fusion's 7m and 12j, native decode and the reliability layer's 7n and 12k,
the serving runtime's 7o and 12l, the fabric's 7p and 12m, the mesh-sharded
path's 7q and 12n; every phase decodes through the port's native reader, as
the JAX package does):

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
7g. sql-small: the shaped 8-table TPC-H fixture of the JAX package's SQL
   suite (tests/test_tpch_queries.py's schemas, rows, generator, shaping
   and index roster at 4 buckets, copied here) indexed in a CPU and a GPU
   session (``deviceMinRows=0``; K1 for each GPU build); the 22 texts of
   tests/tpch_queries.py through ``Session.sql``: the GPU rows equal the
   CPU port's in order (floats at rtol 1e-9) and hyperspace off as a
   multiset, the optimized plan equals tests/approved_plans/tpch_sql/qN.txt,
   no result is empty, and the trace, from cleared caches, equals
   qN.dispatch.txt line for line, ``decode:`` lines included; the GPU runs
   ``hash-build`` and ``hash-probe``;
7h. bcast-small: the shapes of tests/test_join_stream.py's broadcast cases
   (inner, left, right and outer on a float key with NaN and on a
   composite key; a join whose keys never meet, typed empty; a build side
   over ``broadcastMaxBytes``, which takes the generic merge; Filter ->
   Project over the join; a left join's Filter after the null extension; a
   q3-shaped chain of two broadcast joins) in a CPU and a GPU session: GPU
   rows equal the CPU port's byte for byte and in order (collected and,
   for the last three, chunk by chunk through ``execute_stream``), equal the
   generic merge (``broadcastMaxBytes=0``) as a multiset, and every trace
   shows its tier; ``hash-build``, ``hash-probe`` and ``fused-postjoin`` run
   on the GPU; then the three programs on the card against their plain
   versions (numpy's combine and stable argsort, ``np.searchsorted``, the
   host ``eval``): an empty build, a one-row build, collisions forced by
   equal planes, random composite planes, a probe with no hit;
7i. topk-small: the lakes of tests/test_topk.py (NaN floats, None strings,
   tie keys; dates with NaT, -0.0 and ±inf; files of disjoint sorted keys
   in 250-row groups) in a CPU and a GPU session: ORDER BY ... LIMIT on
   int, float, string and date keys, one key and two, both directions,
   ties, a limit above the rows, k at ``maxK`` and above it (the host
   sort), a covered order (``sort: index-order-merge`` and ``-limit``) and
   the running threshold with pushdown on (at least 20 row groups skipped)
   and off (none): the GPU rows equal the CPU port's and the host sort and
   slice's (``topk.enabled=false``) byte for byte, with the same ``topk:``
   lines; a bare Limit through ``to_local_iterator`` stops decoding; then
   ``topk-chunk`` and ``topk-merge`` on the card against ``np.lexsort``;
7j. api-small: tests/test_reference_api_compat.py's camelCase lifecycle
   (``CoveringIndexConfig.builder()``, ``createIndex``, ``refreshIndex``,
   ``optimizeIndex``, ``whyNot``, ``deleteIndex``, ``restoreIndex``,
   ``vacuumIndex``) and a ``refreshIndex`` of a data-skipping index in a
   CPU and a GPU session, each action from a copy of one state: the same
   log entries and bucket files (byte for byte), K1 for each covering build
   and K2 for each sketch rebuild on the GPU; ``createIndex`` and
   ``refreshIndex`` over a DataFrame another index covers read no index
   (the dispatch trace); ``hyperspace.parallel.enabled`` below
   ``parallel.minRows`` builds and filters as without it;
7k. explain-small: tests/test_golden_explain.py's fixtures rebuilt on the
   GPU: every explain mode and whyNot report equals ``tests/golden`` (only
   read) after its root normalization, and the CPU port's string;
7l. nested-small: tests/test_nested_columns.py's shapes (filter, select of
   a struct leaf, bucket pruning, the join on a nested key, full and
   incremental refresh, hybrid scan) in a CPU and a GPU session: the same
   rows in order and trace, equal to hyperspace off; K1 for every build;
7m. fusion-small: tests/test_fusion.py's q1, q3 and top-k lakes in a CPU
   and a GPU session with ``hyperspace.exec.fusion.enabled`` on and off
   and ``...fusion.donation`` on and off: the GPU's fused rows equal the
   CPU port's and the GPU's fusion-off rows (keys, counts, int sums, min
   and max exact, float sums at rtol 1e-9; top-k byte for byte), donation
   on and off byte for byte (deterministic algorithms), each fused program
   dispatched once a chunk; the q3 chain dispatches at least 3x fewer
   programs than the per-family device fold over the same chunks; a q1
   whose first chunk overflows the state's capacity redoes that chunk
   per-family and folds the rest fused, equal to fusion off;
7n. native-small: the port's libhs_native (its path, compiler and the
   codecs built or dropped; a failed build fails the script), then two
   files per cell of a matrix (NONE, SNAPPY, GZIP, ZSTD x int32, int64,
   float64, date, a dictionary string and a plain one x nulls or none x
   whole or row-group pruned) read by a GPU session (pinned decode
   buffers) and a CPU one: equal to each other and to pyarrow byte for
   byte, ``decode: native-rg`` for every codec the build has, the same
   dictionary codes; the staged host tensors of the pinned columns are
   the decode buffers and pinned; ``dict-expand`` on the card equal to the
   factorize path (dense: the same tensor and codec; with nulls the same
   strings), to its staged copy and to its plain version; a corrupt index
   decode (a seeded fault) raises ``CorruptDataError`` and quarantines the
   index, whose query then reads the source with the same rows; a
   transient one falls back to the per-file decode with the same rows;
7o. serving-small: the query-small lake (a copy) with a covering and a
   MinMax data-skipping index built on the GPU (K1, K2) and the join-small
   lake, served by a CPU and a GPU session over the same index files, each
   under ``QueryServer(workers=4)`` with the plan cache, micro-batching,
   the bucket, result and build caches, the scheduler and span tracing on:
   16 literal variants of an indexed filter, bursts of 32 grouped
   aggregates until one micro-batch forms, a broadcast join at two
   post-join literals (the second build a ``hs_join_build_cache`` hit),
   an ``ORDER BY ... LIMIT`` and a query over a deleted file (it fails
   alone, the next request is served); every served result equals the
   same session's ``collect()`` byte for byte and in order, and the GPU's
   equal the CPU port's; traces from span events; the shared-scan
   aggregate run directly traces ``agg: device-grouped-batch``; then a
   pin, an appended file and ``RefreshManager.poll_once()``: K1 once for
   the covering rewrite and K2 once for the sketch rebuild, each equal to
   its plain version on its inputs; requests admitted against the pin and
   after the commit equal ``collect()`` under the same pin, GPU == CPU,
   the appended rows whole wherever the listing holds them (0 stale, 0
   torn);
7p. fabric-small: one small lake (20 000 rows of the query-small
   columns, a copy each), the fabric on, through the CPU port and then on
   the GPU: a writer builds a covering and a MinMax index (K1, K2), a file
   lands and ``RefreshManager.refresh_index`` refreshes both under the lake
   lease (K1 and K2 equal to their plain versions); a second session's
   watcher replays the four commit records and its query sees the new
   rows, equal to the writer's; a zombie whose lease a third node took over
   at a fixed clock gets ``LeaseLostError`` at ``write_log`` and lands no
   entry; fsck. The commit records, lease tokens and holders, the fenced
   tokens, log ids, rows and the fsck report must be equal in both runs;
7q. mesh-small: the sharded path (``hyperspace.parallel.enabled``,
   ``minRows`` 0) over 4-shard meshes (4 x cpu in the CPU port, 4 x
   cuda:0 on the card; a test mesh, no conf key reaches it): a 60 000-row
   ``lineitem`` lake's ``li_sd`` and ``li_q1`` built through the exchange,
   their bucket files equal byte for byte between the two and to the
   card's single-device build; q6, A1, A1 streamed, T1, FA1d and FT1: the
   GPU rows equal the CPU port's and the single-device run's, each through
   its sharded family (``fused-filter`` with ``filter: device-sharded``,
   ``sharded-grouped``, ``sharded-topk``, ``fused-stage-agg-sharded``,
   ``fused-stage-topk-sharded``), no fallback;
8. generate and slice: generates a TPC-H-shaped SF1 ``lineitem`` lake (6M
   rows in 16 files, from ``--seed``, with TPC-H's return flag and line
   status) and builds three indexes through the public API (``Session`` ->
   ``read_parquet`` -> ``Hyperspace.create_index``) at the default 200
   buckets and 2M batch rows, with the kernel launch counts reset just
   before and read just after, and prints each covering build's host time
   by stage;
9. index-check: every bucket file (rows hash to their bucket, sorted by
   the key, same rows as the source) and every sketch row (numpy per-file
   min/max);
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
   J1 and J2 must be those of the lake before its flag columns. Hyperspace
   off takes the tier the port's ``broadcast_spec`` picks (``orders`` is
   under ``broadcastMaxBytes``: the broadcast join), asserted per join, and
   each join also runs off with ``broadcastMaxBytes=0`` (the generic merge);
   then J3 (J1 with a Filter on ``o_totalprice`` above the join, hyperspace
   off, through ``to_local_iterator``): the broadcast probe with the
   ``fused-postjoin`` program on every chunk, equal to the materialized
   query, and the program alone on its largest chunk;
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
12b. stream: J1 streamed (``joinMinBytes=1``; J2's shape runs in 7b
   and in ``join``, cut here for the script's time limit) with the join
   pipeline on and off, byte for byte equal to the unstreamed join and to
   hyperspace off as a multiset; A1 and A2 streamed (``aggMinBytes=1``,
   ``chunkBytes`` an eighth of ``li_q1``'s index bytes: at least 8 chunks)
   with the scan pipeline on and off, equal to the materialized aggregate,
   and A1's pipelined and serial partial tables bit for bit (deterministic
   algorithms); warm medians and layers of every run (cold for the
   unstreamed and pipelined ones; the serial one's first run keeps the
   caches), the launches of ``grouped-agg-chunk`` and ``grouped-merge`` per
   streamed A1; the partitioned merge of J1 with hyperspace off
   (``spillMinRows=2^20``, ``broadcastMaxBytes=0``);
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
   refresh (K1), timed warm; the lineage-antijoin program alone on q6's index side
   with CUDA events, beside its bound, ``torch.isin`` and numpy;
12f. delta: the SF1 ``lineitem`` written as a Delta table (one version per
   file); ``ld_cov`` (lineage; K1) and ``ld_skip`` (MinMax on
   ``l_orderkey``; K2); a version of new orders and one that removes a
   file; q6 through hybrid scan, incremental refresh of both (K1, K2), q6
   again and a time-travel q6 of the table before the edits (served by
   the index's first version), each action's seconds, rows/s and
   launches, each query cold, warm and off;
12g. sql: all 8 TPC-H tables at ``SQL_SF`` (0.5) from ``benchmarks/tpch_full.py``'s
   ``gen_all`` (``--seed``), the suite's roster at 200 buckets (each
   build's seconds and K1 launches); three of the nine queries that
   rewrite in benchmarks/RESULTS.md's 22-query table (q3, q6, q19;
   ``SQL_TIMED``): the time of ``Session.sql()`` plus
   ``optimized_plan()``, the plan and the trace, the rows against
   hyperspace off (a multiset), cold, warm (the median of ``--reps``/4)
   and off, each split by its layers; then ``li_q1`` (K1) and q6 and q1
   through SQL beside A2 and A1 (the DataFrame API) on the same lake,
   warm, with the aggregate tier each takes (SQL's ``Aggregate ->
   Compute`` takes the host aggregate, as in the JAX package); then the
   other nineteen once on and once off, rows equal, over a lake and roster
   of their own at SF 0.1 and 16 buckets (cut from SF1 and 200 buckets to
   keep the script inside its time limit). Every query prints its ``join: broadcast-hash-stream``
   count; each timed one also runs off with ``broadcastMaxBytes=0`` (the
   generic merge, PR 9's "off"), and its layers include the broadcast
   join's ``join_build``, ``join_probe`` (program and copy-back),
   ``join_verify``, ``join_postjoin`` and ``join_gather``; then
   ``hash-build`` and ``hash-probe`` alone on the largest table the timed
   queries broadcast and its largest probe chunk;
12k. native: q6 and J1 on the main session (q12 and q19 through
   ``Session.sql`` went for the script's time limit; ``sql`` times q19 at
   SF1 with native decode on), cold and warm (2), with native
   decode on and off (``hyperspace.exec.io.native.enabled``), rows equal,
   with ``decode``/``join_decode`` layers, ``hs_native_decode_total`` by
   codec, ``hs_native_decode_bytes_total`` and no dialect or io-error
   fallback over index files; q6 cold and ``li_shipdate``'s columns decoded
   and staged, pinned against pageable in turns, and the caching host
   allocator's bytes; ``l_returnflag == 'R'`` over the source (hyperspace
   off, ``deviceMinRows=0``, one file per chunk) equal to the host, with
   ``dict-expand`` timed alone beside its bound; ``li_skip_native`` built
   from native decode (K2), K2 on natively decoded values against its
   plain version and K1 on a natively decoded key against numpy;
12h. topk: on the main session and lake (16 files), T1 (the 100 dearest
   lines) and T2 (T1 under q6's filter) over the source with
   ``stream.chunkBytes`` set so the 16 files make 8 chunks (the streaming
   device top-k, 8 ``topk-chunk`` dispatches), T3 (a month of
   ``l_shipdate`` in ship-date order, limit 1000, through ``li_shipdate``:
   the sorted-run merge), each cold, warm (the median of ``--reps``) and
   with ``topk.enabled=false`` (rows equal byte for byte), with the row
   groups pruning kept and the cold run's dispatches; T4 (``limit(10)``
   through ``to_local_iterator``) with the files it decoded of 16; then
   ``topk-chunk`` and ``topk-merge`` alone on T1's inputs;
12i. nested: the first ``NESTED_FILES`` of SF1's 16 ``lineitem`` files
   and all of ``orders`` written again with struct columns (``l_ship``,
   ``l_key``, ``o_key``); ``li_ship_nested``, ``li_key_nested`` and
   ``o_key_nested`` built (stages, rows/s, K1); NQ6 (q6's filter over the
   ``l_ship`` leaves, ``filter: device``) and NJ1 (J1 on the nested order
   keys, nested-small's join tier) cold, warm and off (one run) with
   layers, equal to off and as many rows as their flat twins q6 and J1
   over the same files. Within 12g, ``explain``: ``Hyperspace.explain`` and
   ``why_not`` of all 22 texts over the SF1 lake and roster, each timed and
   equal to a CPU session's;
12j. fusion: at SF1, fusion on against off (warm medians of a third of
   ``--reps``, at least 2; cold; dispatches per query; fusion fallbacks;
   rows equal, floats at rtol 1e-9): FA1 (the streamed A1; its string keys
   stay per-family), FA1d (A1 grouped by ``l_discount`` at A1's chunks),
   FA4 (A1's filter and aggregates by ``l_partkey``, 200 000 groups, over
   the source in 8 chunks), FJ3 (count, sum, avg, min and max over J3's
   chain, hyperspace off, by ``o_shippriority`` and by ``l_partkey``) and
   FT1 (T1); then one warm run with each fused program between CUDA events
   and one with the per-family programs it replaces (FJ3's through the
   per-family device fold over the same probe chunks), printed per chunk;
   and one warm FA4 under ``torch.profiler`` with fusion on and off (the
   grouped programs' device time by kernel at many groups);
12n. mesh: the sharded path at SF1 over the main session's indexes under
   the card's own mesh (one device) and a 4-shard mesh on cuda:0: q6, A1
   (``li_q1``), A1 streamed (12b's chunks), T1 (8 chunks), FA1d and FT1
   (fused), each a first run, a warm run and one with the parallel path
   off: rows equal (floats at rtol 1e-9), the sharded family dispatched,
   no fallback; per query the sharded programs' time (CUDA events) and
   dispatches; each sharded program alone beside its single-device twin
   and its bound; then ``li_shipdate`` built under each mesh, the card's
   one device with K1 and a MinMax sketch with K2 (each call against its
   plain version), the 4-shard mesh through the exchange (its overflow
   rows, the exchange alone beside its bound), every bucket file equal to
   the main build's byte for byte;
12o. check: static analysis and program contracts. The port's lint
   (``python -m hyperspace_tpu_torch.check``'s ``main([])``) must find
   nothing. Then ``hyperspace.check.hlo.enabled`` on the card over the SF1
   lake and indexes above, under ``torch.cuda.set_sync_debug_mode("warn")``
   with the scan pipeline off: q6 (``fused-filter``), a string filter over
   the dictionary-encoded source (``dict-expand``), A1 and A1 streamed
   (``grouped-agg-chunk``, ``grouped-merge``), A2 (``fused-agg``), J1
   (``bucketed-smj-span``), J3 streamed (``hash-build``, ``hash-probe``,
   ``fused-postjoin``), T1 (``topk-chunk``, ``topk-merge``), FA1d, FT1 and
   FJ3 (``fused-stage-agg``, ``-topk``, ``-join-agg``) and the
   ``lineage-antijoin`` program on a million rows; on a 4-shard mesh over
   cuda:0, q6, A1 (``sharded-grouped``), T1 (``sharded-topk``), FA1d and
   FT1 (the sharded fused folds), a re-bucketing of a million rows
   (``index-rebucket``), and ``li_shipdate`` built through the exchange
   (``index-build-exchange``); on a 2 x 2 ``(dcn, ici)`` mesh over cuda:0
   (``make_mesh_2d(2, 2, devices=...)``) the hierarchical exchange
   (``hierarchical-exchange``, two all-to-alls) of 1 048 576 rows from
   ``--seed`` (``li_shipdate``'s widths: an int64 key, int64 and f64
   payload, 200 buckets) at a capacity that holds them and one that
   cannot: all 22 families, each verified at least once; then every query
   with the check off, its rows equal. The same run in a CPU session over
   a 60 000-row lake (and its 4 x cpu and 2 x 2 cpu meshes), each
   family's verified count and findings beside the card's, and the
   synchronisations CUDA reported in each window (with the Python line
   that caused each) beside the window's recorded ``host-callback`` ops,
   and the syncs per family on one line. The phase fails if any recorded
   window, on the card or the CPU, reports a finding, if a registered
   family was never verified, and if a window of the grouped families or
   the three exchanges (``SYNC_FREE_FAMILIES``) reports a
   synchronisation; and unless each hierarchical exchange called two
   all-to-alls (``ici``, then ``dcn``), put every row on its owner shard
   (``b % 4``), gave each shard the CPU port's rows and, at the roomy
   capacity, the flat ``rebucket``'s on the 4-shard mesh (multisets), with
   overflow 0 there and the CPU port's count at the tight one. Then the
   exchange's CUDA-event time beside ``index-rebucket``'s on the same rows,
   warm q6 and A1 with the check on (each program already verified)
   against off; last, on one line, the grouped programs' times the earlier
   phases measured (``agg``, ``stream``, ``fusion``, ``mesh``);
13. profile-query: one warm q6 under ``torch.profiler``: device busy time
   against the query's wall time, and the device time by op;
14. profile-join: the same for one warm J1;
15. profile-agg: the same for one warm A1;
15b. profile-stream: the same for one warm streamed A1;
16. profile: one more covering build under ``torch.profiler``: the device's
   busy time (the union of its kernel and copy intervals) against the
   build's wall time, and the device time by kernel;
17. scale: the aggregate's gate at its default. ``li_q1``'s SF1 bytes, then
   the fewest ``lineitem`` rows (the SF1 lake's columns, distributions and
   rows per file) that put ``li_q1`` above 1.1 GiB, sized from its SF1
   bytes per row; the lake generated on worker processes and indexed (K1
   launches), the gate's crossing asserted from the bytes; A1 (the
   streamed aggregate) cold, against hyperspace off at the aggregates'
   tolerances, with no ``stream-fallback`` in its trace (the warm run went,
   and then J1 over the join's two indexes at 35.6M rows, for the
   script's time limit);
12l. serving: ``QueryServer(workers=4)`` at its defaults (no result cache,
   no scheduler) over the SF1 lake and the indexes built above
   (``deviceMinRows=0``, hybrid scan on, row-group pruning on), fed by 8
   closed-loop client threads 40 requests a run: 50% q6 (16
   ``l_quantity`` literals), 20% A1-shaped grouped aggregates (4
   cut-offs), 20% J3-shaped broadcast joins (a month of ``lineitem`` to
   ``orders``, 2 ``o_totalprice`` literals) and 10% T1, each over a fresh
   listing of the lake; first each distinct request's direct ``collect()``
   (in a second session, row-group pruning off) and dispatch trace; then
   one server for a warm-up (each distinct request once), a quiesced run
   under ``torch.profiler`` (the device's busy share; its repeat, run B,
   went for the script's time limit), and a run while a background
   ``RefreshManager`` (mode incremental) refreshes every ``lineitem``
   index after an SF1-sized file of new orders lands once a tenth of the
   requests are served (K1 and K2 launches, each call equal to its plain
   version; each client cycles its share until the commit and sends a
   quarter of it more after, so none waits), split before, during and
   after the refresh; then a new server with the result cache on, its
   hits' and misses' latencies apart. Per run queries/s, latency p50 and
   p99 (also per request kind), the plan-, result-, bucket- and
   build-cache hit rates, bucket-cache evictions and the micro-batches,
   beside the host's core count; every fifth served result equal to a
   direct ``collect()`` (quiesced in order, A1's floats at rtol 1e-9;
   under the refresh as multisets of the data version the request could
   see: 0 stale, 0 torn; a request that started before the commit may
   see either version whole: it may have been admitted against the old
   index version);
12m. fabric: two worker processes (``FABRIC_WORKER``), each with a CUDA
   context of its own on the card, a ``QueryServer`` behind a
   ``WorkerEndpoint``, the commit watcher (25 ms polls) and the sidecar;
   a ``FrontDoor`` here, health on, routes 24 SQL requests of 12l's mix
   (five distinct texts) from 4 client threads over 8 tenants; an SF1
   ``lineitem`` file lands and this process refreshes ``li_shipdate``
   (K1) and ``li_skip`` (K2) under the lake lease, each call equal to its
   plain version; both
   workers replay both commit records, and the mix routed again sees the
   new rows (0 stale, 0 torn). Every routed result equals a direct
   ``collect()`` here through the same JSON wire; the merged ``/metrics``
   parses and carries both workers' ``server`` series. Prints queries/s
   and latency p50 and p99 through the FrontDoor, each worker's replay lag
   and the refresh's seconds.

The third line from the end is a JSON object with the queries', the
joins' (under ``"join"``), the aggregates' (under ``"agg"``), the
lifecycle's (under ``"lifecycle"``), pruning's (``"prune"``), hybrid
scan's (``"hybrid"``), the Delta table's (``"delta"``), SQL's (``"sql"``,
with ``bcast-small`` under ``"bcast_small"`` and explain under
``"explain"``), the top-k's (``"topk"``) and the nested columns' (``"nested"``,
with api-small and explain-small), fusion's (``"fusion"``, with
fusion-small), native decode's (``"native"``, with native-small),
serving's (``"serving"``, with serving-small), the fabric's
(``"fabric"``, with fabric-small), the sharded path's (``"mesh"``, with
mesh-small) and the check phase's (``"check"``) results and times, the line before the last one with an entry per kernel (its launches
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
#: the main lake's default ``lineitem`` rows: SF 0.5 (SF1 ran 913-1204 s of
#: the 1200 s limit on the card's hosts, which differ up to 2x in host work)
DEFAULT_ROWS = LINEITEM_ROWS_SF1 // 2
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
        order = canonical_order(cols)
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


def canonical_order(keys):
    """An order of the rows given by their int64 ``keys`` (one array per
    column) that depends only on the multiset of rows: by a 64-bit hash of
    each row, which sorts far faster than a lexsort of many columns. Rows
    whose hashes tie must be equal, so their order does not matter; if two
    different rows share a hash, the lexsort is taken instead. Either way
    equal multisets get equal forms and different ones different forms."""
    import numpy as np

    if not keys:
        return np.zeros(0, dtype=np.int64)

    def mix(z):  # splitmix64's finalizer, in place (uint64 arithmetic wraps)
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
        return z

    h = np.zeros(len(keys[0]), dtype=np.uint64)
    for k in keys:
        h ^= k.view(np.uint64) if k.dtype == np.int64 else k.astype(np.uint64)
        h = mix(h)
    order = np.argsort(h)
    h = h[order]
    tie = np.flatnonzero(h[1:] == h[:-1])
    if tie.size and any(not np.array_equal(k[order[tie]], k[order[tie + 1]]) for k in keys):
        return np.lexsort(keys[::-1])
    return order


def canonical(batch):
    """The batch's rows in one canonical order (a multiset's form)."""
    from hyperspace_tpu_torch.ops import encode

    cols = list(batch)
    order = canonical_order([encode.sort_key_int64(batch[c]) for c in cols])
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
        off_df = small_joins(cpu.read_parquet(fact), cpu.read_parquet(dim), ht.col)[name][0]
        with cpu.hyperspace_scope(False):
            off, summary = traced_collect(off_df)
        off_lines = off_join_lines(cpu, off_df)
        assert trace_lines(summary, ("join:",)) == off_lines, (summary, off_lines)
        assert same_batch(as_multiset(got[devices[-1]]), as_multiset(off)), f"{name}: differs from hyperspace off"
        rows[name] = len(next(iter(off.values())))
        print(f"join-small {name}: {rows[name]} rows; over either build, GPU equals the CPU port byte for byte and "
              f"hyperspace off ({'; '.join(off_lines)}) as a multiset; join: device-smj", flush=True)
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
        off_lines = off_join_lines(sess, q)
        with sess.hyperspace_scope(False):
            off, off_summary = traced_collect(q)
            assert trace_lines(off_summary, ("join:",)) == off_lines, (off_summary, off_lines)
            assert n_rows > 0 and same_batch(as_multiset(got), as_multiset(off)), f"{name}: differs from hyperspace off"
            del off
            off_layers = layer_ms(sess, q.collect, 2)
            # the generic merge, the off baseline before the broadcast tier
            sess.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 0)
            generic, generic_summary = traced_collect(q)
            assert "join: generic-merge x1" in generic_summary.splitlines(), generic_summary
            assert same_batch(as_multiset(got), as_multiset(generic)), f"{name}: differs from the generic merge"
            del generic
            generic_layers = layer_ms(sess, q.collect, 1)
            sess.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 64 << 20)
        out[name] = {"name": name, "rows": n_rows, "files": [len(s.files) for s in scans],
                     "cold_ms": cold, "warm_ms": warm_layers["total"], "host_warm_ms": host_layers["total"],
                     "off_ms": off_layers["total"], "off_tier": off_lines, "generic_ms": generic_layers["total"],
                     "reps": reps,
                     "layers_ms": {"cold": cold_layers, "warm": warm_layers, "host_warm": host_layers,
                                   "off": off_layers, "generic": generic_layers}}
        print(f"join {name}: {n_rows} rows, equal to hyperspace off ({'; '.join(off_lines)}), to the generic merge "
              f"and to the host-span path; cold {cold:.3f} ms, "
              f"warm {warm_layers['total']:.3f} ms, warm on the host-span path {host_layers['total']:.3f} ms, "
              f"hyperspace off {off_layers['total']:.3f} ms, off with broadcastMaxBytes=0 (the generic merge) "
              f"{generic_layers['total']:.3f} ms ({smi})", flush=True)
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
    out["J3"] = run_fused_postjoin(sess, sess.read_parquet(li_src), orders, smi, hbm, args.reps)
    return {"joins": list(out.values()), "dispatches": dispatches, "programs": programs,
            "o_orderkey_build_s": build_s, "o_orderkey_build_launches": build_launches}, queries["J1"], o_src


def run_fused_postjoin(sess, li, orders, smi: str, hbm: float, reps: int) -> dict:
    """J3: J1's join with a Filter above it (``o_totalprice > 300000``),
    hyperspace off, streamed through ``to_local_iterator``: the broadcast
    probe of the 6M ``lineitem`` rows against the 1.5M ``orders`` with the
    post-join filter as the ``fused-postjoin`` program; the rows equal the
    materialized query's as a multiset; then the program alone on the
    largest chunk's pairs."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import batch as B
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import trace

    c = ht.col
    q = li.join(orders, c("l_orderkey") == c("o_orderkey")).filter(c("o_totalprice") > 300000.0).select(
        "l_orderkey", "l_extendedprice", "o_orderdate", "o_totalprice")
    with sess.hyperspace_scope(False):
        want = as_multiset(q.collect())
        D.reset_dispatches()
        sess.query_stage_seconds.clear()
        with ProgramCapture() as cap, trace.recording() as events:
            t = time.perf_counter()
            chunks = list(q.to_local_iterator())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
    assert ("join", "broadcast-hash-stream") in events, trace.summarize(events)
    assert D.dispatches["fused-postjoin"] == D.dispatches["hash-probe"] > 0, dict(D.dispatches)
    got = B.concat(chunks)
    assert same_batch(as_multiset(got), want), "J3: the streamed chunks differ from the materialized query"
    rows = len(next(iter(got.values())))
    programs = new_program_times({"fused-postjoin": cap.seen["fused-postjoin"]}, reps, hbm)
    print(f"join J3 (hyperspace off, streamed): {rows} rows in {len(chunks)} chunks, equal to the materialized "
          f"query as a multiset; dispatches {dict(D.dispatches)}; {ms:.3f} ms ({smi})", flush=True)
    print("layers J3 (streamed): " + ", ".join(f"{k} {v:.3f} ms" for k, v in layers.items()) + f" ({smi})",
          flush=True)
    print_programs(programs, smi)
    return {"name": "J3", "rows": rows, "chunks": len(chunks), "streamed_ms": ms, "layers_ms": layers,
            "dispatches": dict(D.dispatches), "programs": programs}


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
            off_layers = layer_ms(sess, q.collect, 2)
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
    reader while installed (``with ReadSpy() as spy``). The prefetch
    threads decode side by side, so the counts move under a lock: an
    unguarded ``+=`` from two threads can lose one."""

    def __enter__(self):
        import threading

        from hyperspace_tpu_torch.exec import io as IO

        self.real = IO.read_parquet_batch
        self.started = self.finished = 0
        lock = threading.Lock()

        def spy(files, columns, predicate=None):
            with lock:
                self.started += 1
            out = self.real(files, columns, predicate=predicate)
            with lock:
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

    # the partitioned generic merge (hyperspace off; broadcastMaxBytes=0,
    # since the dimension side would take the broadcast join)
    for how in ("inner", "left", "right", "outer"):
        got = {}
        for device in devices:
            res = {}
            for spill in (64, None):
                sess = session("jsmall", device, False, **{ht.keys.JOIN_BROADCAST_MAX_BYTES: 0},
                               **({ht.keys.JOIN_SPILL_MIN_ROWS: spill} if spill else {}))
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
        print(f"stream-small partitioned merge {how} (broadcastMaxBytes=0: the generic merge): "
              f"{out['partitioned'][how]} rows, equal to the unpartitioned merge as a multiset, GPU equals the CPU "
              f"port", flush=True)
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
    return {"shape": f"2 x {keys_a[0].shape[0]} rows ({n_a} + {n_b} groups) -> {fs.shape[0]} ({int(n_g)} groups), "
                     f"{len(keys_a)} keys, {len(slots_a)} slots",
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms, "bytes": read + written}


def run_stream(sess, li_src: str, o_src: str, tmp: str, args, smi: str, hbm: float) -> dict:
    """J1 streamed (``joinMinBytes=1``) and A1 and A2 streamed
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
    reps_join = reps_agg = 2
    out = {"joins": [], "aggregates": []}

    def run_mode(q, conf, reps, cold_caches=True):
        for k, v in conf.items():
            sess.conf.set(k, v)
        if cold_caches:
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

    joins = {"J1": join_queries(li, orders)["J1"]}
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
                                                    ht.keys.JOIN_PIPELINE_ENABLED: pipe}, reps_join,
                                                cold_caches=pipe)
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
              f"{entry['streamed_pipelined']['cold_ms']:.3f} ms, serial first run (caches kept) "
              f"{entry['streamed_serial']['cold_ms']:.3f} ms (median of {reps_join}; {smi})", flush=True)
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
                                                    ht.keys.PIPELINE_ENABLED: pipe}, reps_agg, cold_caches=pipe)
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
        sess.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 0)  # orders would broadcast
        t = time.perf_counter()
        got, summary = traced_collect(q)
        part_ms = (time.perf_counter() - t) * 1e3
        sess.conf.set(ht.keys.JOIN_SPILL_MIN_ROWS, 1 << 26)
        sess.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 64 << 20)
        parts = [ln for ln in summary.splitlines() if ln.startswith("join: generic-merge-partitioned(")]
        assert parts, summary
        assert same_batch(as_multiset(got), whole), "J1: the partitioned merge differs from the unpartitioned one"
        del got, whole
    out["partitioned_J1_off_ms"] = part_ms
    print(f"stream J1 off, spillMinRows 2^20, broadcastMaxBytes=0 (the generic merge): {parts[0].split()[1]}, "
          f"equal to the unpartitioned merge as a multiset; {part_ms:.3f} ms ({smi})", flush=True)

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
SCALE_TARGET_BYTES = int(1.1 * GATE_BYTES)


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


def gen_scale_lake(root: str, rows_total: int, seed: int) -> str:
    """The SF1 lake's ``lineitem`` at ``rows_total`` rows: the same
    columns, value ranges and rows per file, each file from its own
    generator, on a pool of worker processes. Returns its directory."""
    import concurrent.futures
    import multiprocessing

    sf = rows_total / LINEITEM_ROWS_SF1
    li_dir = os.path.join(root, "lineitem")
    os.makedirs(li_dir, exist_ok=True)
    jobs = []
    for i, first in enumerate(range(0, rows_total, SCALE_ROWS_PER_FILE)):
        rows = min(SCALE_ROWS_PER_FILE, rows_total - first)
        jobs.append((os.path.join(li_dir, f"part-{i:05d}.parquet"), seed, i, rows, sf))
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(_write_lineitem_file, *a) for a in jobs]:
            f.result()
    return li_dir


def run_scale(main_sess, tmp: str, args, smi: str) -> dict:
    """A lake whose A1 input passes the real 1 GiB gate with the defaults
    untouched (``deviceMinRows`` 0, as in every SF1 phase): sized from
    ``li_q1``'s SF1 bytes per row, generated, indexed, then A1 cold against
    hyperspace off."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    system = main_sess.conf.system_path
    q1_sf1 = index_bytes(system, "li_q1")
    per_row = q1_sf1 / args.rows
    rows = -(-int(SCALE_TARGET_BYTES / per_row) // SCALE_ROWS_PER_FILE) * SCALE_ROWS_PER_FILE
    print(f"scale: SF1 index li_q1: {q1_sf1} bytes on disk, {per_row:.3f} bytes per row: {rows} lineitem rows "
          f"({rows / LINEITEM_ROWS_SF1:.2f} x SF1) put it above {SCALE_TARGET_BYTES} bytes", flush=True)

    root = os.path.join(tmp, "scale")
    t = time.perf_counter()
    li_dir = gen_scale_lake(root, rows, args.seed + 7)
    gen_s = time.perf_counter() - t
    print(f"scale lake: {rows} lineitem rows ({gen_s:.3f} s)", flush=True)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(root, "indexes"), ht.keys.DEVICE_MIN_ROWS: 0},
                      device="cuda")
    li = sess.read_parquet(li_dir)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    ht.Hyperspace(sess).create_index(li, ht.CoveringIndexConfig(
        "li_q1", ["l_shipdate"], ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
                                  "l_tax"]))
    torch.cuda.synchronize()
    build = {"seconds": time.perf_counter() - t, "bytes": index_bytes(sess.conf.system_path, "li_q1")}
    launches = dict(kernels.launches)
    print(f"scale build li_q1: {build['seconds']:.3f} s, {build['bytes']} bytes, kernel launches {launches} ({smi})",
          flush=True)
    assert launches.get("bucket_histogram", 0) > 0, launches
    assert build["bytes"] >= sess.conf.stream_agg_min_bytes, build
    print(f"scale gate: li_q1 {build['bytes']} bytes >= aggMinBytes {sess.conf.stream_agg_min_bytes}", flush=True)

    sess.enable_hyperspace()
    out = {"rows": rows, "generate_s": gen_s, "builds": {"li_q1": build}, "launches": launches,
           "sf1_index_bytes": {"li_q1": q1_sf1}}
    a1 = q1_query(li)
    assert [s.entry.name for s in plan_index_scans(a1.optimized_plan())] == ["li_q1"], a1.optimized_plan().pretty()
    clear_query_caches()
    D.reset_dispatches()
    t = time.perf_counter()
    got, summary = traced_collect(a1)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t) * 1e3
    print("trace scale A1: " + "; ".join(summary.splitlines()), flush=True)
    for want in ("agg: device-grouped-stream x1", "agg: streamed-partial x1"):
        assert want in summary.splitlines(), summary
    assert_no_fallback(summary, "scale A1")
    dispatches = dict(D.dispatches)
    with sess.hyperspace_scope(False):
        t = time.perf_counter()
        off, off_summary = traced_collect(a1)
        off_ms = (time.perf_counter() - t) * 1e3
    print("trace scale A1 off: " + "; ".join(off_summary.splitlines()), flush=True)
    n = len(next(iter(got.values())))
    assert same_groups(got, off, float_aggs_of(a1), ordered=False), "scale A1: differs from hyperspace off"
    out["A1"] = {"rows_out": n, "cold_ms": cold, "off_ms": off_ms, "dispatches": dispatches}
    print(f"scale A1: {n} rows out, equal to hyperspace off; cold {cold:.3f} ms, hyperspace off {off_ms:.3f} ms; "
          f"dispatches {dispatches} ({smi})", flush=True)
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


def time_queries(sess, qs: dict, reps: int, label: str, smi: str, cold_and_off: bool = True, offs=None):
    """Cold (caches emptied), warm (median of ``reps``, with layers) and
    hyperspace-off (one run) times of each query; the results of the
    first runs (and of the off runs, into ``offs`` where given).
    ``cold_and_off=False`` keeps the caches and times warm only."""
    import torch

    out, results = {}, {}
    for name, q in qs.items():
        if cold_and_off:
            clear_query_caches()
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        results[name] = q.collect()
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        warm = layer_ms(sess, q.collect, reps)
        off_ms = None
        if cold_and_off:
            with sess.hyperspace_scope(False):
                t = time.perf_counter()
                off = q.collect()
                torch.cuda.synchronize()
                off_ms = (time.perf_counter() - t) * 1e3
            if offs is not None:
                offs[name] = off
            del off
        out[name] = {"rows": len(next(iter(results[name].values()))), "warm_ms": warm["total"], "layers": warm,
                     **({"cold_ms": cold, "off_ms": off_ms} if cold_and_off else {})}
        print(f"{label} {name}: {out[name]['rows']} rows; "
              + (f"cold {cold:.3f} ms, warm {warm['total']:.3f} ms, off {off_ms:.3f} ms" if cold_and_off
                 else f"warm {warm['total']:.3f} ms") + f" ({smi})", flush=True)
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
    reps = max(2, args.reps // 3)
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
    reps = max(2, args.reps // 3)
    offs = {}
    times, results = time_queries(sess, qs, reps, "hybrid", smi, offs=offs)
    out["queries"] = times
    for name in qs:
        assert same_groups(results[name], offs.pop(name), {"sum_price", "sum_total"}, ordered=False), (
            f"hybrid {name} != off")
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
    refreshed, after = time_queries(sess, qs, reps, "hybrid refreshed", smi, cold_and_off=False)
    for name in qs:
        assert same_groups(after[name], results[name], {"sum_price", "sum_total"}, ordered=False), name
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
    reps = max(2, args.reps // 3)

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


# --- the SQL front end ------------------------------------------------------------

#: TPC-H's 22 query texts (tests/tpch_queries.py holds only strings)
TPCH_QUERIES_FILE = os.path.join(HERE, "tests", "tpch_queries.py")
#: the approved plans and dispatch traces of the JAX package's SQL suite
TPCH_APPROVED_DIR = os.path.join(HERE, "tests", "approved_plans", "tpch_sql")

# The shaped 8-table fixture of tests/test_tpch_queries.py (that file imports
# the JAX package, so its schemas, row counts, generator, shaping and index
# roster are kept here as a copy).
# column name -> generator kind; I=key int, F=money, S=string-ish, D=date
TPCH_SCHEMAS = {
    "region": {"r_regionkey": "I", "r_name": "RN", "r_comment": "S"},
    "nation": {"n_nationkey": "I", "n_name": "NN", "n_regionkey": "RK", "n_comment": "S"},
    "supplier": {
        "s_suppkey": "I", "s_name": "S", "s_address": "S", "s_nationkey": "NK",
        "s_phone": "PH", "s_acctbal": "F", "s_comment": "S",
    },
    "customer": {
        "c_custkey": "I", "c_name": "S", "c_address": "S", "c_nationkey": "NK",
        "c_phone": "PH", "c_acctbal": "F", "c_mktsegment": "SEG", "c_comment": "S",
    },
    "part": {
        "p_partkey": "I", "p_name": "PN", "p_mfgr": "S", "p_brand": "BR",
        "p_type": "PT", "p_size": "SZ", "p_container": "CT", "p_retailprice": "F",
        "p_comment": "S",
    },
    "partsupp": {
        "ps_partkey": "I", "ps_suppkey": "I", "ps_availqty": "Q",
        "ps_supplycost": "F", "ps_comment": "S",
    },
    "orders": {
        "o_orderkey": "I", "o_custkey": "I", "o_orderstatus": "ST",
        "o_totalprice": "F", "o_orderdate": "D", "o_orderpriority": "PR",
        "o_clerk": "S", "o_shippriority": "SZ", "o_comment": "SC",
    },
    "lineitem": {
        "l_orderkey": "I", "l_partkey": "I", "l_suppkey": "I", "l_linenumber": "SZ",
        "l_quantity": "Q", "l_extendedprice": "F", "l_discount": "DISC", "l_tax": "DISC",
        "l_returnflag": "RF", "l_linestatus": "LS", "l_shipdate": "D",
        "l_commitdate": "D", "l_receiptdate": "D", "l_shipinstruct": "SI",
        "l_shipmode": "SM", "l_comment": "S",
    },
}
TPCH_SMALL_ROWS = {"region": 3, "nation": 6, "supplier": 40, "customer": 60, "part": 80,
                   "partsupp": 300, "orders": 600, "lineitem": 2400}
_TPCH_NATIONS = ["FRANCE", "GERMANY", "BRAZIL", "CANADA", "ASIAN1", "ASIAN2"]
_TPCH_REGIONS = ["EUROPE", "AMERICA", "ASIA"]
# foreign-key domains: values land inside the referenced table's key range
_TPCH_FK_DOMAIN = {"l_orderkey": "orders", "l_partkey": "part", "l_suppkey": "supplier",
                   "ps_partkey": "part", "ps_suppkey": "supplier", "o_custkey": "customer"}
#: (table, index, indexed columns, included columns): the suite's roster
TPCH_INDEXES = [
    ("lineitem", "li_ok", ["l_orderkey"],
     ["l_extendedprice", "l_discount", "l_quantity", "l_tax", "l_shipdate",
      "l_commitdate", "l_receiptdate", "l_shipmode", "l_returnflag",
      "l_linestatus", "l_suppkey", "l_partkey"]),
    ("lineitem", "li_sd", ["l_shipdate"],
     ["l_extendedprice", "l_discount", "l_quantity", "l_orderkey"]),
    ("lineitem", "li_pk", ["l_partkey"],
     ["l_extendedprice", "l_discount", "l_quantity", "l_shipdate",
      "l_shipmode", "l_shipinstruct"]),
    ("orders", "o_ok", ["o_orderkey"],
     ["o_custkey", "o_orderdate", "o_totalprice", "o_orderpriority",
      "o_orderstatus", "o_shippriority"]),
    ("orders", "o_ck", ["o_custkey"],
     ["o_orderkey", "o_orderdate", "o_totalprice", "o_shippriority",
      "o_comment"]),
    ("customer", "c_ck", ["c_custkey"],
     ["c_name", "c_acctbal", "c_mktsegment", "c_nationkey", "c_phone",
      "c_address", "c_comment"]),
    ("part", "p_pk", ["p_partkey"],
     ["p_name", "p_mfgr", "p_brand", "p_type", "p_size", "p_container",
      "p_retailprice"]),
    ("supplier", "s_sk", ["s_suppkey"],
     ["s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal",
      "s_comment"]),
    ("partsupp", "ps_pk", ["ps_partkey"],
     ["ps_suppkey", "ps_availqty", "ps_supplycost"]),
]
#: the queries timed at ``SQL_SF``: q6, q3 (a bucketed join and broadcasts off)
#: and q19 (a join with a residual disjunction), of those that rewrite onto the roster in
#: benchmarks/RESULTS.md's 22-query table; q1 (the unindexed scan), q5,
#: q12 and the other four (q10, q14, q17, q18) run with the other twelve at
#: ``SQL_OTHER_SF``, to keep the script inside its time limit (six were
#: timed until the check phase came)
SQL_TIMED = ("q3", "q6", "q19")
#: the scale factors of the ``sql`` phase's lakes: the timed queries' (SF1
#: until the hierarchical exchange joined the check phase), and the other
#: sixteen's (both cut to keep the script inside its time limit)
SQL_SF = 0.5
SQL_OTHER_SF = 0.1
#: the other sixteen's roster buckets (the default 200 gave every cold
#: bucketed scan 200 files a side at SF 0.1; cut for the time limit)
SQL_OTHER_BUCKETS = 16


def _tpch_gen(cname, kind, n, rng):
    """One column of the small fixture (tests/test_tpch_queries.py::_gen)."""
    import numpy as np

    if kind == "I":
        dom = TPCH_SMALL_ROWS.get(_TPCH_FK_DOMAIN.get(cname, ""), n)
        return rng.integers(0, dom, n).astype(np.int64)
    if kind == "F":
        return np.round(rng.uniform(0, 2000, n), 2)
    if kind == "Q":
        return rng.integers(1, 60, n).astype(np.int64)
    if kind == "DISC":
        return np.round(rng.integers(0, 11, n) / 100.0, 2)
    if kind == "D":
        return np.datetime64("1992-01-01") + rng.integers(0, 2500, n).astype("timedelta64[D]")
    if kind == "SZ":
        return np.array([[1, 5, 15, 23, 36, 45, 9, 14][i % 8] for i in range(n)], dtype=np.int64)
    if kind == "RN":
        return np.array([_TPCH_REGIONS[i % len(_TPCH_REGIONS)] for i in range(n)], dtype=object)
    if kind == "NN":
        return np.array([_TPCH_NATIONS[i % len(_TPCH_NATIONS)] for i in range(n)], dtype=object)
    if kind == "RK":
        return np.array([[0, 0, 1, 1, 2, 2][i % 6] for i in range(n)], dtype=np.int64)
    if kind == "NK":
        return np.array([i % 6 for i in range(n)], dtype=np.int64)
    if kind == "PH":
        return np.array([f"{13 + (i % 20)}-{i % 997:03d}-55" for i in range(n)], dtype=object)
    if kind == "SEG":
        segs = ["BUILDING", "AUTOMOBILE", "MACHINERY"]
        return np.array([segs[i % 3] for i in range(n)], dtype=object)
    if kind == "PN":
        words = ["forest", "green", "lavender", "blue"]
        return np.array([f"{words[i % 4]} part {i}" for i in range(n)], dtype=object)
    if kind == "BR":
        return np.array([f"Brand#{[12, 23, 34, 45][i % 4]}" for i in range(n)], dtype=object)
    if kind == "PT":
        kinds = ["ECONOMY ANODIZED STEEL", "MEDIUM POLISHED BRASS", "SMALL BRASS", "PROMO STEEL"]
        return np.array([kinds[i % 4] for i in range(n)], dtype=object)
    if kind == "CT":
        cts = ["SM CASE", "MED BOX", "LG PACK", "JUMBO JAR"]
        return np.array([cts[i % 4] for i in range(n)], dtype=object)
    if kind == "ST":
        return np.array([["F", "O", "P"][i % 3] for i in range(n)], dtype=object)
    if kind == "PR":
        return np.array([["1-URGENT", "2-HIGH", "3-MEDIUM"][i % 3] for i in range(n)], dtype=object)
    if kind == "RF":
        return np.array([["R", "A", "N"][i % 3] for i in range(n)], dtype=object)
    if kind == "LS":
        return np.array([["O", "F"][i % 2] for i in range(n)], dtype=object)
    if kind == "SI":
        return np.array([["DELIVER IN PERSON", "COLLECT COD"][i % 2] for i in range(n)], dtype=object)
    if kind == "SM":
        return np.array([["AIR", "MAIL", "SHIP", "AIR REG"][i % 4] for i in range(n)], dtype=object)
    if kind == "SC":
        return np.array([("special requests" if i % 9 == 0 else f"note {i}") for i in range(n)], dtype=object)
    return np.array([f"{cname[:5]}_{i % 37}" for i in range(n)], dtype=object)


def _tpch_shape(name, cols, n, rng) -> None:
    """The fixture's shaping (tests/test_tpch_queries.py::_shape_table):
    heavy orders for q18, commit and receipt dates derived from the ship
    date with about 20% lateness, orderless customers for q22."""
    import numpy as np

    if name == "lineitem":
        heavy = n // 6
        cols["l_orderkey"][:heavy] = rng.integers(0, 20, heavy)
        cols["l_shipdate"] = np.datetime64("1993-01-01") + rng.integers(0, 1460, n).astype("timedelta64[D]")
        ship = cols["l_shipdate"]
        commit = ship + rng.integers(7, 30, n).astype("timedelta64[D]")
        late = rng.random(n) < 0.2
        receipt = commit + np.where(late, rng.integers(1, 6, n), rng.integers(-5, 1, n)).astype("timedelta64[D]")
        cols["l_commitdate"] = commit
        cols["l_receiptdate"] = receipt
    if name == "orders":
        cols["o_custkey"] = rng.integers(0, int(TPCH_SMALL_ROWS["customer"] * 0.85), n).astype(np.int64)
    if name == "customer":
        lo = int(TPCH_SMALL_ROWS["customer"] * 0.85)
        cols["c_acctbal"][lo:] = cols["c_acctbal"][lo:] + 1500.0


def gen_tpch_small(root: str) -> dict:
    """The suite's shaped 8-table lake, one parquet file per table, each
    table's generator seeded from its name as the suite seeds it (its
    approved plans and dispatch traces are of this data); {table: dir}."""
    import zlib

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    dirs = {}
    for name, schema in TPCH_SCHEMAS.items():
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        n = TPCH_SMALL_ROWS[name]
        cols = {c: _tpch_gen(c, k, n, rng) for c, k in schema.items()}
        if name in ("region", "nation", "supplier", "customer", "part", "orders"):
            cols[list(schema)[0]] = np.arange(n, dtype=np.int64)  # unique primary keys
        _tpch_shape(name, cols, n, rng)
        d = dirs[name] = os.path.join(root, name)
        os.makedirs(d)
        pq.write_table(pa.table(cols), os.path.join(d, "part-00000.parquet"))
    return dirs


def tpch_texts() -> dict:
    """{qN: text} of tests/tpch_queries.py (a file of string literals)."""
    ns: dict = {}
    with open(TPCH_QUERIES_FILE, encoding="utf-8") as f:
        exec(compile(f.read(), TPCH_QUERIES_FILE, "exec"), ns)
    return dict(sorted(ns["TPCH_QUERIES"].items(), key=lambda kv: int(kv[0][1:])))


def open_tpch(dirs: dict, system: str, device: str, num_buckets=None):
    """A session over the lake with every table registered as a view and
    the roster built (hyperspace on, ``deviceMinRows=0``); the seconds and
    kernel launches of each build."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.ops import kernels

    conf = {ht.keys.SYSTEM_PATH: system, ht.keys.DEVICE_MIN_ROWS: 0}
    if num_buckets is not None:
        conf[ht.keys.NUM_BUCKETS] = num_buckets
    sess = ht.Session(conf=conf, device=device)
    for name, d in dirs.items():
        sess.read_parquet(d).create_or_replace_temp_view(name)
    hs = ht.Hyperspace(sess)
    builds = {}
    for table, name, indexed, included in TPCH_INDEXES:
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        hs.create_index(sess._temp_views[table], ht.CoveringIndexConfig(name, indexed, included))
        if device == "cuda":
            torch.cuda.synchronize()
        builds[name] = {"seconds": time.perf_counter() - t, "launches": dict(kernels.launches)}
    return sess.enable_hyperspace(), builds


def approved_dispatch(qname: str) -> list:
    """The approved trace's lines, ``decode:`` lines included."""
    with open(os.path.join(TPCH_APPROVED_DIR, f"{qname}.dispatch.txt"), encoding="utf-8") as f:
        return f.read().splitlines()


def dispatch_lines(summary: str) -> list:
    """A trace summary's lines less its ``decode:`` lines, which depend on
    what earlier runs left in the IO cache (``sql-small`` compares whole
    traces, from cleared caches)."""
    return [ln for ln in summary.splitlines() if not ln.startswith("decode:")]


def broadcast_count(lines) -> int:
    return sum(int(ln.rsplit(" x", 1)[1]) for ln in lines if ln.startswith("join: broadcast-hash-stream"))


def float_columns(batch) -> set:
    return {k for k, v in batch.items() if v.dtype.kind == "f"}


def check_sql_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """The 22 TPC-H texts through ``Session.sql`` over the suite's fixture,
    indexed in a CPU and a GPU session: the GPU rows equal the CPU port's in
    order (floats at rtol 1e-9) and hyperspace off as a multiset, the plan
    equals the approved one, no result is empty, and the trace, from cleared
    caches, equals the approved one line for line, ``decode:`` lines
    included (the native decode); on the GPU the broadcast join's programs
    run."""
    from hyperspace_tpu_torch.exec import device as D

    import hyperspace_tpu_torch as ht

    root = os.path.join(tmp, "sql-small")
    dirs = gen_tpch_small(root)
    texts = tpch_texts()
    assert len(texts) == 22, sorted(texts)
    sessions, builds = {}, {}
    for device in devices:
        sessions[device], builds[device] = open_tpch(dirs, os.path.join(root, f"_indexes-{device}"), device,
                                                     num_buckets=4)
    k1 = sum(b["launches"].get("bucket_histogram", 0) for b in builds[devices[-1]].values())
    if devices[-1] == "cuda":
        assert all(b["launches"].get("bucket_histogram", 0) > 0 for b in builds["cuda"].values()), builds["cuda"]
    print(f"sql-small: 8 tables, {len(TPCH_INDEXES)} covering indexes at 4 buckets in each session; "
          f"K1 launches of the GPU builds {k1}", flush=True)
    out = {}
    gpu_dispatches = collections.Counter()
    for qname, text in texts.items():
        got, traces = {}, {}
        for device, sess in sessions.items():
            q = sess.sql(text)
            plan = q.optimized_plan().pretty().replace(root, "<TPCH>")
            with open(os.path.join(TPCH_APPROVED_DIR, f"{qname}.txt"), encoding="utf-8") as f:
                assert plan == f.read(), f"{qname} on {device}: the plan differs from the approved one:\n{plan}"
            clear_query_caches()
            if device == "cuda":
                D.reset_dispatches()
            got[device], traces[device] = traced_collect(q)
            assert traces[device].splitlines() == approved_dispatch(qname), (
                f"{qname} on {device}: {traces[device]} against {approved_dispatch(qname)}")
            if device == "cuda":
                gpu_dispatches.update(D.dispatches)
        gpu, cpu = got[devices[-1]], got[devices[0]]
        floats = float_columns(cpu)
        assert same_groups(gpu, cpu, floats, ordered=True), f"{qname}: the GPU rows differ from the CPU port's"
        sess = sessions[devices[-1]]
        with sess.hyperspace_scope(False):
            off = sess.sql(text).collect()
        assert same_groups(gpu, off, floats | float_columns(off), ordered=False), (
            f"{qname}: the GPU rows differ from hyperspace off")
        rows = len(next(iter(gpu.values())))
        assert rows > 0, f"{qname} returned no rows"
        lines = traces[devices[-1]].splitlines()
        out[qname] = {"rows": rows, "trace": lines}
        print(f"sql-small {qname}: {rows} rows; plan and trace as approved; GPU equals the CPU port in order and "
              f"hyperspace off as a multiset; " + "; ".join(lines), flush=True)
    if devices[-1] == "cuda":
        assert gpu_dispatches["hash-build"] > 0 and gpu_dispatches["hash-probe"] > 0, dict(gpu_dispatches)
    print(f"sql-small GPU dispatches: {dict(gpu_dispatches)}", flush=True)
    return {"queries": out, "k1_launches": k1, "gpu_dispatches": dict(gpu_dispatches)}


def sql_layers(sess, q, reps: int) -> dict:
    """Cold (caches emptied) and warm (median of ``reps``) layers of one
    query, with its trace and result."""
    import torch

    clear_query_caches()
    sess.query_stage_seconds.clear()
    t = time.perf_counter()
    got, summary = traced_collect(q)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t) * 1e3
    cold_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
    cold_layers.update(rest=cold - sum(v for k, v in cold_layers.items() if not k.startswith("prefetch_")),
                       total=cold)
    return {"cold": cold_layers, "warm": layer_ms(sess, q.collect, reps)}, got, summary


def run_sql(tmp: str, args, smi: str, hbm: float):
    """TPC-H at ``SQL_SF`` through ``Session.sql``: all 8 tables from
    ``benchmarks/tpch_full.py::gen_all``, the suite's roster at 200 buckets,
    the timed queries cold, warm, off and generic (off with
    ``broadcastMaxBytes=0``), the broadcast programs alone on their largest
    inputs, q6 and q1 beside their DataFrame forms (A2, A1); then the other
    sixteen once on and once off over a lake and roster of their own at
    ``SQL_OTHER_SF``. Returns the results."""
    import torch

    import hyperspace_tpu_torch as ht
    from benchmarks import tpch_full  # numpy and pyarrow only
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.ops import kernels

    root = os.path.join(tmp, "sql")
    t = time.perf_counter()
    dirs = tpch_full.gen_all(root, SQL_SF, args.seed)
    gen_s = time.perf_counter() - t
    print(f"sql lake: TPC-H SF {SQL_SF}, "
          f"{', '.join(f'{k} {tpch_full._rows(k, SQL_SF)}' for k in tpch_full.ROWS_SF1)} rows ({gen_s:.3f} s)",
          flush=True)
    sess, builds = open_tpch(dirs, os.path.join(root, "_indexes"), "cuda")
    for name, b in builds.items():
        assert b["launches"].get("bucket_histogram", 0) > 0, (name, b)
        print(f"build {name}: {b['seconds']:.3f} s, launches {b['launches']} ({smi})", flush=True)
    texts = tpch_texts()
    reps = max(2, args.reps // 4)
    out = {"sf": SQL_SF, "gen_s": gen_s, "builds": builds, "device": smi, "warm_reps": reps, "timed": {}, "other": {}}

    def plan_ms(text):
        t = time.perf_counter()
        q = sess.sql(text)
        plan = q.optimized_plan()
        return q, plan, (time.perf_counter() - t) * 1e3

    def timed_run(q):
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        ms = (time.perf_counter() - t) * 1e3
        lay = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        lay.update(rest=ms - sum(v for k, v in lay.items() if not k.startswith("prefetch_")), total=ms)
        return got, dispatch_lines(summary), lay

    D.reset_dispatches()
    capture = ProgramCapture().__enter__()
    try:
        for qname in SQL_TIMED:
            q, plan, p_ms = plan_ms(texts[qname])
            print(f"plan {qname} ({p_ms:.3f} ms to parse, resolve and optimize):\n{plan.pretty()}", flush=True)
            before = collections.Counter(D.dispatches)
            layers, got, summary = sql_layers(sess, q, reps)
            per_run = {k: v / (1 + reps) for k, v in (collections.Counter(D.dispatches) - before).items()}
            lines = dispatch_lines(summary)
            print(f"trace {qname}: " + "; ".join(lines), flush=True)
            with sess.hyperspace_scope(False):
                off, off_lines, off_layers = timed_run(q)
                # the generic merge: the off baseline before the broadcast tier
                sess.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 0)
                generic, generic_lines, generic_layers = timed_run(q)
                sess.conf.set(ht.keys.JOIN_BROADCAST_MAX_BYTES, 64 << 20)
            assert not broadcast_count(generic_lines), generic_lines
            floats = float_columns(got) | float_columns(off)
            rows = len(next(iter(got.values())))
            assert rows > 0 and same_groups(got, off, floats, ordered=False), f"{qname}: differs from hyperspace off"
            assert same_groups(got, generic, floats, ordered=False), f"{qname}: differs from the generic merge"
            del off, generic
            out["timed"][qname] = {"rows": rows, "plan_ms": p_ms, "trace": lines,
                                   "indexes": sorted({s.entry.name for s in plan_index_scans(plan)}),
                                   "broadcast": broadcast_count(lines), "off_broadcast": broadcast_count(off_lines),
                                   "dispatches_per_run": per_run,
                                   "cold_ms": layers["cold"]["total"], "warm_ms": layers["warm"]["total"],
                                   "off_ms": off_layers["total"], "generic_ms": generic_layers["total"],
                                   "layers_ms": {"cold": layers["cold"], "warm": layers["warm"], "off": off_layers,
                                                 "generic": generic_layers}}
            r = out["timed"][qname]
            print(f"sql {qname}: {rows} rows, equal to hyperspace off and to the generic merge; indexes "
                  f"{r['indexes']}; join: broadcast-hash-stream x{r['broadcast']} (off x{r['off_broadcast']}); "
                  f"plan {p_ms:.3f} ms, cold {r['cold_ms']:.3f} ms, warm {r['warm_ms']:.3f} ms, off "
                  f"{r['off_ms']:.3f} ms, generic (off, broadcastMaxBytes=0) {r['generic_ms']:.3f} ms; device "
                  f"programs per run {per_run} ({smi})", flush=True)
            for run, lay in r["layers_ms"].items():
                print(f"layers sql {qname} ({run}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in lay.items())
                      + f" ({smi})", flush=True)
    finally:
        capture.__exit__()
    out["dispatches"] = dict(D.dispatches)
    print(f"sql path: dispatches {out['dispatches']}", flush=True)
    seen = {k: v for k, v in capture.seen.items() if k in ("hash-build", "hash-probe", "fused-postjoin")}
    out["programs"] = new_program_times(seen, args.reps, hbm)
    print_programs(out["programs"], smi)
    del capture, seen

    # explain and whyNot of every text over this lake and its roster
    t = time.perf_counter()
    out["explain"] = run_explain(sess, dirs, texts, smi)
    phase("explain", t)

    # Compute beside the DataFrame API: q6 through SQL plans as Aggregate ->
    # Compute -> Filter -> IndexScan and takes the host aggregate (as in the
    # JAX package); A2, q6's aggregate over plain columns, takes fused-agg.
    # q1 likewise beside A1 once li_q1 covers q1's columns.
    li = sess.read_parquet(dirs["lineitem"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    ht.Hyperspace(sess).create_index(li, ht.CoveringIndexConfig(
        "li_q1", ["l_shipdate"],
        ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax"]))
    torch.cuda.synchronize()
    out["li_q1_build"] = {"seconds": time.perf_counter() - t, "launches": dict(kernels.launches)}
    assert out["li_q1_build"]["launches"].get("bucket_histogram", 0) > 0, out["li_q1_build"]
    print(f"build li_q1 (sql lake): {out['li_q1_build']['seconds']:.3f} s, launches "
          f"{out['li_q1_build']['launches']} ({smi})", flush=True)
    pairs = {
        "q6": sess.sql(texts["q6"]),
        "A2": q6_filter(li).agg(revenue=("l_extendedprice", "sum"), n=("*", "count"),
                                avg_disc=("l_discount", "avg"), min_qty=("l_quantity", "min"),
                                max_qty=("l_quantity", "max")),
        "q1": sess.sql(texts["q1"]),
        "A1": q1_query(li),
    }
    out["compute"] = {}
    for name, q in pairs.items():
        got, summary = traced_collect(q)  # warms the caches
        tiers = [ln for ln in summary.splitlines() if ln.startswith(("agg:", "filter:"))]
        warm = layer_ms(sess, q.collect, reps)
        plan = q.optimized_plan()
        out["compute"][name] = {"tiers": tiers, "warm_ms": warm["total"], "layers_ms": warm,
                                "indexes": sorted({s.entry.name for s in plan_index_scans(plan)}),
                                "groups": len(next(iter(got.values())))}
        print(f"compute {name}: {'; '.join(tiers)}; indexes {out['compute'][name]['indexes']}; warm "
              f"{warm['total']:.3f} ms ({smi})", flush=True)
        print(f"layers compute {name} (warm): " + ", ".join(f"{k} {v:.3f} ms" for k, v in warm.items())
              + f" ({smi})", flush=True)
    assert "agg: device-fused-scan x1" in out["compute"]["A2"]["tiers"], out["compute"]["A2"]
    assert "agg: device-grouped-scan x1" in out["compute"]["A1"]["tiers"], out["compute"]["A1"]

    other_root = os.path.join(tmp, "sql-other")
    other_dirs = tpch_full.gen_all(other_root, SQL_OTHER_SF, args.seed)
    sess, builds = open_tpch(other_dirs, os.path.join(other_root, "_indexes"), "cuda", SQL_OTHER_BUCKETS)
    assert all(b["launches"].get("bucket_histogram", 0) > 0 for b in builds.values()), builds
    out["other_sf"], out["other_builds"] = SQL_OTHER_SF, builds
    print(f"sql other lake: TPC-H SF {SQL_OTHER_SF}, roster built at {SQL_OTHER_BUCKETS} buckets, K1 launches "
          f"{sum(b['launches'].get('bucket_histogram', 0) for b in builds.values())} ({smi})", flush=True)
    for qname, text in texts.items():
        if qname in SQL_TIMED:
            continue
        q, plan, p_ms = plan_ms(text)
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        on_ms = (time.perf_counter() - t) * 1e3
        with sess.hyperspace_scope(False):
            t = time.perf_counter()
            off = q.collect()
            off_ms = (time.perf_counter() - t) * 1e3
        rows = len(next(iter(got.values())))
        assert same_groups(got, off, float_columns(got) | float_columns(off), ordered=False), (
            f"{qname}: differs from hyperspace off")
        del off
        lines = dispatch_lines(summary)
        out["other"][qname] = {"rows": rows, "plan_ms": p_ms, "on_ms": on_ms, "off_ms": off_ms, "trace": lines,
                               "broadcast": broadcast_count(lines),
                               "indexes": sorted({s.entry.name for s in plan_index_scans(plan)})}
        print(f"sql {qname} (SF {SQL_OTHER_SF}): {rows} rows, equal to hyperspace off; on {on_ms:.3f} ms "
              f"(first run), off {off_ms:.3f} ms; join: broadcast-hash-stream x{broadcast_count(lines)}; "
              + "; ".join(lines) + f" ({smi})", flush=True)
    return out


# --- the broadcast hash join and ORDER BY ... LIMIT ---------------------------------


def off_join_lines(sess, df) -> list:
    """The ``join:`` lines ``df`` gives with hyperspace off, as the port's
    ``broadcast_spec`` (a verbatim copy of the JAX package's decision)
    picks each join's tier: ``broadcast-hash-stream`` where a side fits
    under ``broadcastMaxBytes``, else ``generic-merge``."""
    from hyperspace_tpu_torch.exec import join_stream as JS
    from hyperspace_tpu_torch.plan import logical as L

    with sess.hyperspace_scope(False):
        plan = df.optimized_plan()
    tiers = collections.Counter(
        "broadcast-hash-stream" if JS.broadcast_spec(sess, j) is not None else "generic-merge"
        for j in L.collect(plan, lambda p: isinstance(p, L.Join)))
    return [f"join: {t} x{n}" for t, n in sorted(tiers.items())]


def gen_bcast_lake(root: str, seed: int) -> dict:
    """The shapes of tests/test_join_stream.py's broadcast cases: ``l``
    (2500 rows in 3 files: float keys with 4% NaN, a string key ``c``, a
    payload) and ``r`` (110 rows: ``k2``, ``c2``, ``w``); a q3-shaped chain
    (``fact`` 3000 rows in 3 files, dimensions ``d1`` of 40 and ``d2`` of
    25 rows); a pair whose keys never meet (``nl``, ``nr``)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    tables = {}
    n, m = 2500, 110
    lk = rng.integers(0, 60, n).astype(np.float64)
    lk[rng.random(n) < 0.04] = np.nan
    tables["l"] = ({"k": lk, "c": np.array([f"g{v}" for v in rng.integers(0, 6, n)]),
                    "v": np.round(rng.standard_normal(n), 4)}, 3)
    rk = rng.integers(0, 70, m).astype(np.float64)
    rk[rng.random(m) < 0.04] = np.nan
    tables["r"] = ({"k2": rk, "c2": np.array([f"g{v}" for v in rng.integers(0, 7, m)]),
                    "w": np.round(rng.standard_normal(m), 4)}, 1)
    f = 3000
    tables["fact"] = ({"fk1": rng.integers(0, 40, f).astype(np.int64), "fk2": rng.integers(0, 25, f).astype(np.int64),
                       "amount": np.round(rng.uniform(0, 100, f), 3)}, 3)
    tables["d1"] = ({"dk1": np.arange(40, dtype=np.int64), "dname": np.array([f"d{i}" for i in range(40)])}, 1)
    tables["d2"] = ({"dk2": np.arange(25, dtype=np.int64), "region": np.array([f"r{i % 5}" for i in range(25)])}, 1)
    tables["nl"] = ({"k": np.arange(50, dtype=np.int64), "v": np.ones(50)}, 1)
    tables["nr"] = ({"k2": np.arange(1000, 1010, dtype=np.int64), "w": np.ones(10)}, 1)
    dirs = {}
    for name, (cols, parts) in tables.items():
        d = dirs[name] = os.path.join(root, "bcast", name)
        os.makedirs(d, exist_ok=True)
        rows = len(next(iter(cols.values())))
        for i in range(parts):
            sl = slice(i * rows // parts, (i + 1) * rows // parts)
            pq.write_table(pa.table({k: v[sl] for k, v in cols.items()}), os.path.join(d, f"part-{i}.parquet"))
    return dirs


def bcast_shapes(c) -> dict:
    """{name: (make(frames) -> DataFrame, conf, streamed, the ``join:``
    lines its collect() must show)}; ``c`` is ``col``."""
    bcast = ["join: broadcast-hash-stream x1"]
    out = {}
    for how in ("inner", "left", "right", "outer"):
        out[how] = (lambda t, how=how: t["l"].join(t["r"], c("k") == c("k2"), how=how), {}, False, bcast)
        out[f"composite_{how}"] = (lambda t, how=how: t["l"].join(
            t["r"], (c("k") == c("k2")) & (c("c") == c("c2")), how=how), {}, False, bcast)
    out["no_match"] = (lambda t: t["nl"].join(t["nr"], c("k") == c("k2")), {}, False, bcast)
    out["over_budget"] = (lambda t: t["l"].join(t["r"], c("k") == c("k2"), how="left"),
                          {"hyperspace.exec.join.broadcastMaxBytes": 16}, False, ["join: generic-merge x1"])
    out["filter_project"] = (lambda t: t["l"].join(t["r"], c("k") == c("k2")).filter(c("w") > 0.25).select(
        "k", "v", "w"), {}, True, bcast)
    out["outer_post_filter"] = (lambda t: t["l"].join(t["r"], c("k") == c("k2"), how="left").filter(c("v") > 0.0),
                                {}, True, bcast)
    out["q3_chain"] = (lambda t: t["fact"].join(t["d1"], c("fk1") == c("dk1")).join(t["d2"], c("fk2") == c("dk2"))
                       .filter(c("region") == "r2").select("dname", "region", "amount"),
                       {"hyperspace.exec.stream.chunkBytes": 8 * 1024}, True, ["join: broadcast-hash-stream x2"])
    return out


def check_bcast_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """The broadcast shapes in a CPU and a GPU session: the GPU rows equal
    the CPU port's byte for byte and in order (collected and, for the
    streamed shapes, chunk by chunk through ``execute_stream``), equal the
    generic merge (``broadcastMaxBytes=0``) as a multiset, and every trace
    shows the tier it must; on the GPU ``hash-build``, ``hash-probe`` and
    (Filter -> Project over the join) ``fused-postjoin`` run."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import batch as B
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.exec.executor import Executor

    dirs = gen_bcast_lake(tmp, seed + 10)

    def session(device, conf):
        return ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "bcast-indexes"), **conf}, device=device)

    def frames(sess):
        return {name: sess.read_parquet(d) for name, d in dirs.items()}

    gpu_dispatches = collections.Counter()
    out = {}
    for name, (make, conf, streamed, lines) in bcast_shapes(ht.col).items():
        got, chunks = {}, {}
        for device in devices:
            sess = session(device, conf)
            df = make(frames(sess))
            D.reset_dispatches()
            got[device], summary = traced_collect(df)
            assert trace_lines(summary, ("join:",)) == lines, f"{name} on {device}: {summary}"
            if streamed:
                with trace.recording() as events:
                    chunks[device] = list(Executor(sess).execute_stream(df.optimized_plan()))
                assert trace_lines(trace.summarize(events), ("join:",)) == lines, f"{name} streamed on {device}"
                assert same_batch(canonical(B.concat(chunks[device])), canonical(got[device])), \
                    f"{name} on {device}: the streamed chunks differ from collect()"
            if device == "cuda":
                gpu_dispatches.update(D.dispatches)
                if name == "filter_project":
                    assert D.dispatches["fused-postjoin"] > 0, dict(D.dispatches)
        assert same_batch(got[devices[-1]], got[devices[0]]), f"{name}: the GPU rows differ from the CPU port's"
        if streamed:
            assert len(chunks[devices[-1]]) == len(chunks[devices[0]]) and all(
                same_batch(g, w) for g, w in zip(chunks[devices[-1]], chunks[devices[0]])), \
                f"{name}: the GPU chunks differ from the CPU port's"
        generic, summary = traced_collect(make(frames(session(devices[-1], {
            **conf, "hyperspace.exec.join.broadcastMaxBytes": 0}))))
        assert all(ln.startswith("join: generic-merge") for ln in trace_lines(summary, ("join:",))), summary
        rows = len(next(iter(got[devices[-1]].values())))
        if name == "no_match":
            # typed from the probe side's dtypes: its empty int key comes out
            # float64 (the JAX package's null promotion), the merge's int64
            assert rows == 0 and sorted(got[devices[-1]]) == sorted(generic) == ["k", "k2", "v", "w"], generic
            assert not len(next(iter(generic.values()))), generic
        else:
            assert rows > 0, name
            assert same_batch(as_multiset(got[devices[-1]]), as_multiset(generic)), \
                f"{name}: differs from the generic merge"
        out[name] = rows
        print(f"bcast-small {name}: {rows} rows; GPU equals the CPU port byte for byte"
              + (" (collected and chunk by chunk)" if streamed else "")
              + ("; typed empty like the generic merge (broadcastMaxBytes=0)" if name == "no_match"
                 else "; equal to the generic merge (broadcastMaxBytes=0) as a multiset")
              + "; " + "; ".join(lines), flush=True)
    if devices[-1] == "cuda":
        for program in ("hash-build", "hash-probe", "fused-postjoin"):
            assert gpu_dispatches[program] > 0, (program, dict(gpu_dispatches))
    return {"rows": out, "gpu_dispatches": dict(gpu_dispatches)}


def plain_hash_build(planes):
    """The plain version of ``hash-build``: numpy's combine, then a stable
    argsort."""
    import numpy as np

    from hyperspace_tpu_torch.ops.hashing import combine_hashes_np

    h = combine_hashes_np(planes)
    order = np.argsort(h, kind="stable")
    return h[order].astype(np.int64), order


def plain_hash_probe(table, n_build: int, planes):
    """The plain version of ``hash-probe``: numpy's combine, then
    ``np.searchsorted`` left and right, clamped to the live table."""
    import numpy as np

    from hyperspace_tpu_torch.ops.hashing import combine_hashes_np

    h = combine_hashes_np(planes)
    return (np.minimum(np.searchsorted(table, h, side="left"), n_build),
            np.minimum(np.searchsorted(table, h, side="right"), n_build))


def check_bcast_programs(device: str) -> dict:
    """``hash-build``, ``hash-probe`` and ``fused-postjoin`` on ``device``
    against their plain versions: an empty build, a build of one row, hash
    collisions forced by equal planes, two random key planes, and a probe
    with no hit; the post-join predicate against the host ``eval`` of the
    gathered pairs. All results are integers or masks: exact."""
    import numpy as np
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import join_stream as JS
    from hyperspace_tpu_torch.plan.expr import as_bool_mask

    dev = torch.device(device)
    rng = np.random.default_rng(17)

    def planes(n, k, lo=0, hi=2**32):
        return [rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32) for _ in range(k)]

    cases = {
        "empty build": (planes(0, 1), planes(300, 1)),
        "one-row build": (planes(1, 1), None),
        "equal planes (collisions)": ([np.full(500, 7, dtype=np.uint32)] * 2, None),
        "two random key planes": (planes(5000, 2, 0, 900), None),
        "probe with no hit": (planes(2000, 1, 0, 1000), planes(700, 1, 5000, 9000)),
    }
    out = {}
    for name, (bp, pp) in cases.items():
        if pp is None:  # probes drawn from the build's rows plus fresh ones
            take = rng.integers(0, len(bp[0]), 600)
            pp = [np.concatenate([p[take], q]) for p, q in zip(bp, planes(200, len(bp)))]
        table, order = JS.hash_build_program(JS._upload_hash_planes(bp, dev))
        want_t, want_o = plain_hash_build(bp)
        assert np.array_equal(table.cpu().numpy(), want_t) and np.array_equal(order.cpu().numpy(), want_o), \
            f"hash-build ({name}) differs from its plain version"
        lo, hi = JS.hash_probe_program(table, len(bp[0]), JS._upload_hash_planes(pp, dev))
        want_lo, want_hi = plain_hash_probe(want_t, len(bp[0]), pp)
        assert np.array_equal(lo.cpu().numpy(), want_lo) and np.array_equal(hi.cpu().numpy(), want_hi), \
            f"hash-probe ({name}) differs from its plain version"
        out[name] = {"build_rows": len(bp[0]), "probe_rows": len(pp[0]), "hits": int((want_hi - want_lo).sum())}
    assert out["probe with no hit"]["hits"] == 0, out
    # fused-postjoin over random pairs, against the host eval
    n_p, n_b, pairs = 4000, 300, 20000
    probe = {"k": rng.integers(0, 9, n_p).astype(np.int64), "v": rng.standard_normal(n_p),
             "c": np.array([f"g{x}" for x in rng.integers(0, 5, n_p)], dtype=object)}
    probe["v"][::17] = np.nan
    build_batch = {"k2": np.arange(n_b, dtype=np.int64), "w": rng.standard_normal(n_b),
                   "d": np.arange(n_b).astype("datetime64[D]")}
    table, order = JS.hash_build_program(JS._upload_hash_planes([JS.hash_input_uint32(build_batch["k2"])], dev))
    build = JS.BuildSide(build_batch, n_b, table, order.cpu().numpy(), {"k2": np.dtype(np.int64)}, 0)
    pidx = rng.integers(0, n_p, pairs).astype(np.int64)
    bidx = rng.integers(0, n_b, pairs).astype(np.int64)
    c = ht.col
    sess = ht.Session(conf={}, device=device)
    for cond in ((c("w") > 0.25) & (c("v") < 0.5), (c("c") == "g2") | c("v").is_null(),
                 c("d") >= np.datetime64("1970-03-01"), ~(c("k") + c("k2") > 150)):
        refs = sorted(cond.references())
        sources = {r: JS._join_column_source(r, list(probe), list(build_batch)) for r in refs}
        got = JS._device_postjoin_mask(sess, cond, probe, build, pidx, bidx, refs, sources, True)
        gathered = JS._gather_pairs(refs, sources, probe, build_batch, pidx, bidx, {}, {})
        want = np.broadcast_to(np.asarray(as_bool_mask(cond.eval(gathered)), dtype=bool), (pairs,))
        assert np.array_equal(got, want), f"fused-postjoin ({cond!r}) differs from the host eval"
    out["fused-postjoin"] = {"pairs": pairs, "predicates": 4}
    print(f"bcast programs on {device}: hash-build, hash-probe and fused-postjoin equal their plain versions "
          f"exactly: {out}", flush=True)
    return out


def gen_topk_lake(root: str, seed: int) -> dict:
    """The lakes of tests/test_topk.py: ``data`` (6 files of 800 rows: int
    ``k``, float ``v`` with NaN, string ``name`` with None, tie key
    ``grp``), ``typed`` (4 files of 300 rows: dates with NaT, floats with
    NaN, -0.0 and ±inf, strings with None) and ``sorted`` (6 files of
    disjoint ascending ``k`` in 250-row groups)."""
    import datetime

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, "topk", k) for k in ("data", "typed", "sorted")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(6):
        n = 800
        v = np.round(rng.uniform(-100, 100, n), 3)
        v[rng.choice(n, 20, replace=False)] = np.nan
        name = np.array([f"name_{j % 31:02d}" for j in range(n)], dtype=object)
        name[rng.choice(n, 15, replace=False)] = None
        pq.write_table(pa.table({"k": rng.integers(0, 10_000, n).astype(np.int64), "v": v, "name": name,
                                 "grp": rng.integers(0, 5, n).astype(np.int64)}),
                       os.path.join(dirs["data"], f"part-{i:05d}.parquet"))
        k = np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64)
        pq.write_table(pa.table({"k": k, "v": k.astype(np.float64) / 3}),
                       os.path.join(dirs["sorted"], f"part-{i:05d}.parquet"), row_group_size=250)
    for i in range(4):
        n = 300
        f = np.round(rng.uniform(-5, 5, n), 1)
        f[rng.choice(n, 30, replace=False)] = rng.choice([np.nan, -0.0, 0.0, np.inf, -np.inf], 30)
        day = rng.integers(0, 400, n)
        dt = [datetime.date(1995, 1, 1) + datetime.timedelta(days=int(x)) for x in day]
        for j in rng.choice(n, 10, replace=False):
            dt[j] = None
        s = np.array([f"s{x:03d}" for x in rng.integers(0, 50, n)], dtype=object)
        s[rng.choice(n, 12, replace=False)] = None
        pq.write_table(pa.table({"f": f, "d": pa.array(dt, type=pa.date32()), "s": s,
                                 "i": rng.integers(-3, 3, n)}), os.path.join(dirs["typed"], f"part-{i}.parquet"))
    return dirs


def topk_small_queries(c) -> dict:
    """{name: (lake, make(df) -> DataFrame, conf, the ``topk:`` and
    ``sort:`` lines its trace must show)}; ``c`` is ``col``."""
    dev = ["topk: device-topk-stream x1"]
    out = {}
    for keys, asc in ((("k",), (True,)), (("k",), (False,)), (("v",), (False,)), (("v", "k"), (False, True)),
                      (("name", "k"), (True, True)), (("name", "v"), (False, True))):
        out["-".join(keys) + "".join("a" if a else "d" for a in asc)] = (
            "data", lambda df, keys=keys, asc=asc: df.order_by(*keys, ascending=list(asc)).limit(25), {}, dev)
    for keys, asc in ((("d",), (True,)), (("d",), (False,)), (("f", "i"), (False, True)), (("s", "d"), (False, True))):
        out["typed " + "-".join(keys) + "".join("a" if a else "d" for a in asc)] = (
            "typed", lambda df, keys=keys, asc=asc: df.order_by(*keys, ascending=list(asc)).limit(70), {}, dev)
    out["ties"] = ("data", lambda df: df.order_by("grp").limit(1200), {}, dev)
    out["limit above rows"] = ("typed", lambda df: df.order_by("i", "f").limit(3000), {}, dev)
    out["k at maxK"] = ("data", lambda df: df.order_by("v", "k").limit(4096), {}, dev)
    out["k above maxK"] = ("data", lambda df: df.order_by("v", "k").limit(4097), {}, [])
    for pushdown in (True, False):
        out[f"threshold pushdown {'on' if pushdown else 'off'}"] = (
            "sorted", lambda df: df.order_by("k").limit(10),
            {"hyperspace.exec.pipeline.enabled": False, "hyperspace.exec.topk.thresholdPushdown": pushdown}, dev)
    out["covered order"] = ("index", lambda df: df.filter(c("k") > 50).select("k", "v").order_by("k"), {},
                            ["sort: index-order-merge x1"])
    out["covered order, limit"] = ("index", lambda df: df.filter(c("k") > 50).select("k", "v").order_by("k").limit(17),
                                   {}, ["sort: index-order-merge-limit x1"])
    return out


class PruneCount:
    """Row groups kept by the port's row-group pruning while installed:
    ``kept`` and ``total`` over the files it judged."""

    def __enter__(self):
        import pyarrow.parquet as pq

        from hyperspace_tpu_torch.exec import io as IO

        self.real = IO.prune_row_groups
        self.kept = self.total = 0

        def spy(path, predicate):
            got = self.real(path, predicate)
            n = pq.ParquetFile(path).metadata.num_row_groups
            self.total += n
            self.kept += n if got is None else len(got)
            return got

        IO.prune_row_groups = spy
        return self

    def __exit__(self, *exc):
        from hyperspace_tpu_torch.exec import io as IO

        IO.prune_row_groups = self.real


def check_topk_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """ORDER BY ... LIMIT over the top-k lakes in a CPU and a GPU session:
    the GPU rows equal the CPU port's and the host sort and slice's
    (``topk.enabled=false``) byte for byte, the ``topk:`` and ``sort:``
    trace lines are the expected ones on both; the threshold skips row
    groups only with pushdown on; a bare Limit stops decoding; on the GPU
    ``topk-chunk`` and ``topk-merge`` run."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D

    dirs = gen_topk_lake(tmp, seed + 20)
    dirs["index"] = dirs["data"]
    base = {ht.keys.NUM_BUCKETS: 8, "hyperspace.exec.stream.chunkBytes": 1}

    def session(device, conf, owner="topk-indexes"):
        return ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, owner), **base, **conf}, device=device)

    builder = session(devices[-1], {})
    ht.Hyperspace(builder).create_index(builder.read_parquet(dirs["data"]),
                                        ht.CoveringIndexConfig("ordIdx", ["k"], ["v", "grp"]))
    gpu_dispatches = collections.Counter()
    out = {}
    for name, (lake, make, conf, lines) in topk_small_queries(ht.col).items():
        got, pruned = {}, {}
        for device in devices:
            sess = session(device, conf)
            if lake == "index":
                sess.enable_hyperspace()
            clear_query_caches()
            D.reset_dispatches()
            with PruneCount() as pc:
                got[device], summary = traced_collect(make(sess.read_parquet(dirs[lake])))
            pruned[device] = (pc.kept, pc.total)
            assert trace_lines(summary, ("topk:", "sort: index-order")) == lines, f"{name} on {device}: {summary}"
            if device == "cuda":
                gpu_dispatches.update(D.dispatches)
        host_sess = session(devices[-1], {**conf, "hyperspace.exec.topk.enabled": False})
        host, summary = traced_collect(make(host_sess.read_parquet(dirs["data" if lake == "index" else lake])))
        assert not trace_lines(summary, ("topk:",)), summary
        assert same_batch(got[devices[-1]], got[devices[0]]), f"{name}: the GPU rows differ from the CPU port's"
        assert same_batch(got[devices[-1]], host), f"{name}: the GPU rows differ from the host sort and slice"
        if name.startswith("threshold"):
            kept, total = pruned[devices[-1]]
            assert (total - kept >= 20) if name.endswith("on") else (kept == total), (name, kept, total)
        rows = len(next(iter(host.values())))
        out[name] = {"rows": rows, "row_groups_kept": pruned[devices[-1]]}
        print(f"topk-small {name}: {rows} rows; GPU equals the CPU port and the host sort and slice byte for byte; "
              + ("; ".join(lines) or "host sort") + f"; row groups kept {pruned[devices[-1]][0]} of "
              f"{pruned[devices[-1]][1]} judged", flush=True)
    # a bare Limit: the first chunks give its rows, the later files are
    # never decoded
    for device in devices:
        sess = session(device, {"hyperspace.exec.pipeline.depth": 1})
        clear_query_caches()
        from hyperspace_tpu_torch.exec import trace

        with ReadSpy() as spy, trace.recording() as events:
            chunks = list(sess.read_parquet(dirs["data"]).limit(700).to_local_iterator())
        assert ("limit", "early-stop-stream") in events and sum(len(b["k"]) for b in chunks) == 700
        assert spy.started < 6, spy.started
        out[f"bare limit ({device})"] = {"files_decoded": spy.started, "of": 6}
        print(f"topk-small bare limit on {device}: 700 rows in {len(chunks)} chunks, {spy.started} of 6 files "
              f"decoded; limit: early-stop-stream", flush=True)
    if devices[-1] == "cuda":
        assert gpu_dispatches["topk-chunk"] > 0 and gpu_dispatches["topk-merge"] > 0, dict(gpu_dispatches)
    return {"queries": out, "gpu_dispatches": dict(gpu_dispatches)}


def plain_topk(mat, cap: int):
    """The plain version of ``topk-chunk`` / ``topk-merge``: ``np.lexsort``
    over the planes (the first most significant), then the first ``cap``
    columns, sentinel-extended."""
    import numpy as np

    order = np.lexsort(mat[::-1])
    out = mat[:, order][:, :cap]
    if out.shape[1] < cap:
        out = np.concatenate([out, np.full((mat.shape[0], cap - out.shape[1]), np.iinfo(np.int64).max)], axis=1)
    return out


def check_topk_programs(device: str) -> dict:
    """``topk-chunk`` and ``topk-merge`` on ``device`` against
    ``np.lexsort``: one to three key planes with sentinel (missing) keys
    and sentinel padding, capacities below and above the chunk's width.
    Exact."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch.ops import sort as S

    rng = np.random.default_rng(23)
    sent = np.iinfo(np.int64).max
    n = 0
    for nk in (1, 2, 3):
        for cap in (1, 64, 4096, 9000):
            a = np.stack([rng.integers(-50, 50, 6000) for _ in range(nk)] + [np.arange(6000) + 10])
            a[0, rng.random(6000) < 0.05] = sent
            a = np.concatenate([a, np.full((nk + 1, 300), sent)], axis=1)
            b = np.stack([rng.integers(-50, 50, 4000) for _ in range(nk)] + [np.arange(4000) + 7000])
            ga = S.topk_chunk_fn(nk, cap)(torch.from_numpy(a).to(device))
            gb = S.topk_chunk_fn(nk, cap)(torch.from_numpy(b).to(device))
            assert np.array_equal(ga.cpu().numpy(), plain_topk(a, cap)), f"topk-chunk ({nk} keys, cap {cap})"
            merged = S.topk_merge_fn(nk, cap)(ga, gb).cpu().numpy()
            assert np.array_equal(merged, plain_topk(np.concatenate([a, b], axis=1), cap)), \
                f"topk-merge ({nk} keys, cap {cap})"
            n += 1
    print(f"topk programs on {device}: topk-chunk and topk-merge equal np.lexsort exactly in {n} cases", flush=True)
    return {"cases": n}


class ProgramCapture:
    """The broadcast join's and the top-k's programs wrapped while installed,
    keeping the inputs of the largest call of each: ``hash-build`` (most
    build rows), ``hash-probe`` (the largest table, then the most probe
    rows), ``fused-postjoin`` (the most pairs), ``topk-chunk`` (the widest
    chunk) and ``topk-merge``."""

    def __enter__(self):
        from hyperspace_tpu_torch.exec import join_stream as JS
        from hyperspace_tpu_torch.ops import sort as S

        self.seen = {}
        self.real = {"build": JS.hash_build_program, "probe": JS.hash_probe_program,
                     "postjoin": JS._postjoin_program, "chunk": S.topk_chunk_fn, "merge": S.topk_merge_fn}
        seen, real = self.seen, self.real

        def keep(name, size, entry):
            if name not in seen or size >= seen[name][0]:
                seen[name] = (size, entry)

        def build(planes):
            keep("hash-build", planes[0].numel(), planes)
            return real["build"](planes)

        def probe(table, n_build, planes):
            keep("hash-probe", (table.numel(), planes[0].numel()), (table, n_build, planes))
            return real["probe"](table, n_build, planes)

        def postjoin(cache_key, refs, ref_on_probe, fn):
            prog = real["postjoin"](cache_key, refs, ref_on_probe, fn)

            def run(pcols, bcols, pidx, bidx, lits):
                keep("fused-postjoin", pidx.numel(), (prog, (pcols, bcols, pidx, bidx, lits)))
                return prog(pcols, bcols, pidx, bidx, lits)

            return run

        def chunk(nk, cap):
            fn = real["chunk"](nk, cap)

            def run(planes):
                keep("topk-chunk", planes.shape[1], (fn, planes, cap))
                return fn(planes)

            return run

        def merge(nk, cap):
            fn = real["merge"](nk, cap)

            def run(a, b):
                keep("topk-merge", a.shape[1], (fn, a, b))
                return fn(a, b)

            return run

        JS.hash_build_program, JS.hash_probe_program, JS._postjoin_program = build, probe, postjoin
        S.topk_chunk_fn, S.topk_merge_fn = chunk, merge
        return self

    def __exit__(self, *exc):
        from hyperspace_tpu_torch.exec import join_stream as JS
        from hyperspace_tpu_torch.ops import sort as S

        JS.hash_build_program, JS.hash_probe_program = self.real["build"], self.real["probe"]
        JS._postjoin_program = self.real["postjoin"]
        S.topk_chunk_fn, S.topk_merge_fn = self.real["chunk"], self.real["merge"]


def new_program_times(seen: dict, reps: int, hbm: float) -> dict:
    """Each captured program alone with CUDA events (median of ``reps``),
    its plain version's time on the same inputs (numpy on the host, one
    run on the host clock), its bound (each input read once, each output
    written once over the memory rate; or its compares over the core rate)
    and the nearest single library call: ``torch.searchsorted`` alone for
    ``hash-probe``, ``torch.topk`` on the primary key plane for
    ``topk-chunk``."""
    import math

    import numpy as np
    import torch

    from hyperspace_tpu_torch.exec import join_stream as JS
    from hyperspace_tpu_torch.ops.hashing import combine_hashes_torch

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def host_ms(fn):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    out = {}
    if "hash-build" in seen:
        planes = seen["hash-build"][1]
        n = planes[0].numel()
        host = [p.cpu().numpy().view(np.uint32) for p in planes]
        b_ms, b_by = bound(nbytes(*planes) + 16 * n, n * max(1, math.ceil(math.log2(max(n, 2)))), hbm)
        out["hash-build"] = {"shape": f"{n} build rows, {len(planes)} key planes (int32)",
                             "ms": time_ms(lambda: JS.hash_build_program(planes), reps),
                             "plain_ms": host_ms(lambda: plain_hash_build(host)),
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if "hash-probe" in seen:
        table, n_build, planes = seen["hash-probe"][1]
        n = planes[0].numel()
        host = [p.cpu().numpy().view(np.uint32) for p in planes]
        table_np = table.cpu().numpy()
        h = combine_hashes_torch(planes)
        b_ms, b_by = bound(nbytes(table, *planes) + 16 * n, 2 * n * max(1, math.ceil(math.log2(max(n_build, 2)))), hbm)
        out["hash-probe"] = {"shape": f"{n} probe rows against {n_build} build rows, {len(planes)} key planes",
                             "ms": time_ms(lambda: JS.hash_probe_program(table, n_build, planes), reps),
                             "plain_ms": host_ms(lambda: plain_hash_probe(table_np, n_build, host)),
                             "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": time_ms(lambda: torch.searchsorted(table, h), reps),
                             "library": "torch.searchsorted (one walk, on the combined hashes)"}
    if "fused-postjoin" in seen:
        prog, (pcols, bcols, pidx, bidx, lits) = seen["fused-postjoin"][1]
        n = pidx.numel()
        cols = {**pcols, **bcols}
        host_cols = {k: v.cpu().numpy() for k, v in cols.items()}
        pidx_np, bidx_np = pidx.cpu().numpy(), bidx.cpu().numpy()
        b_ms, b_by = bound(nbytes(pidx, bidx, *cols.values()) + n, 2 * n * max(1, len(cols)), hbm)
        out["fused-postjoin"] = {"shape": f"{n} pairs, {len(cols)} referenced columns",
                                 "ms": time_ms(lambda: prog(pcols, bcols, pidx, bidx, lits), reps),
                                 "plain_ms": host_ms(lambda: [host_cols[k][pidx_np if k in pcols else bidx_np]
                                                              for k in host_cols]),
                                 "plain": "the gather alone (the host eval varies by predicate)",
                                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if "topk-chunk" in seen:
        fn, planes, cap = seen["topk-chunk"][1]
        k1, p = planes.shape
        host = planes.cpu().numpy()
        b_ms, b_by = bound(nbytes(planes) + k1 * cap * 8, k1 * p * max(1, math.ceil(math.log2(max(p, 2)))), hbm)
        out["topk-chunk"] = {"shape": f"({k1}, {p}) int64 planes, cap {cap}", "ms": time_ms(lambda: fn(planes), reps),
                             "plain_ms": host_ms(lambda: plain_topk(host, cap)),
                             "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": time_ms(lambda: torch.topk(planes[0], min(cap, p), largest=False), reps),
                             "library": "torch.topk on the primary key plane"}
    if "topk-merge" in seen:
        fn, a, b = seen["topk-merge"][1]
        host = np.concatenate([a.cpu().numpy(), b.cpu().numpy()], axis=1)
        k1, cap = a.shape
        b_ms, b_by = bound(nbytes(a, b) + k1 * cap * 8, 2 * k1 * cap * max(1, math.ceil(math.log2(2 * cap))), hbm)
        out["topk-merge"] = {"shape": f"2 x ({k1}, {cap}) int64 candidates", "ms": time_ms(lambda: fn(a, b), reps),
                             "plain_ms": host_ms(lambda: plain_topk(host, cap)),
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    for v in out.values():
        v["share_of_bound"] = v["bound_ms"] / v["ms"]
    return out


def print_programs(programs: dict, smi: str) -> None:
    for name, p in programs.items():
        lib = f", library {p['library_ms']} ms ({p['library']})" if p.get("library_ms") is not None else ""
        print(f"program {name} ({p['shape']}): {p['ms']} ms, bound {p['bound_ms']} ms ({p['bound_by']}), "
              f"{100 * p['share_of_bound']:.2f}% of bound; plain {p['plain_ms']} ms{lib} ({smi})", flush=True)


def topk_queries(li, c) -> dict:
    """T1-T3 over the SF1 ``lineitem`` (T4 is the streamed bare Limit):
    T1 the 100 dearest lines, T2 the same under q6's filter, T3 an
    ``l_shipdate`` range in ship-date order (the order ``li_shipdate``
    keeps)."""
    import numpy as np

    return {
        "T1": li.order_by("l_extendedprice", ascending=[False]).limit(100),
        "T2": q6_filter(li).order_by("l_extendedprice", ascending=[False]).limit(100),
        "T3": li.filter((c("l_shipdate") >= np.datetime64("1994-01-01"))
                        & (c("l_shipdate") < np.datetime64("1994-02-01")))
        .select("l_shipdate", "l_extendedprice").order_by("l_shipdate").limit(1000),
    }


def run_topk(sess, li_src: str, args, smi: str, hbm: float) -> dict:
    """ORDER BY ... LIMIT at SF1 (the main lake, 16 files): T1 and T2 over
    the source with ``stream.chunkBytes`` set so the 16 files make 8 chunks
    (the streaming device top-k), T3 through ``li_shipdate`` (the sorted-run
    merge), each cold, warm (median of ``--reps``) and with
    ``topk.enabled=false`` (rows equal byte for byte), with the row groups
    kept by pruning and the dispatches of the cold run; T4, ``limit(10)``
    through ``to_local_iterator``, with the files it decoded; then
    ``topk-chunk`` and ``topk-merge`` alone on T1's inputs."""
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec.executor import _chunk_files_by_bytes

    files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src))
    chunk = 2 * max(os.path.getsize(f) for f in files)
    assert len(_chunk_files_by_bytes([(f, None, os.path.getsize(f)) for f in files], chunk)) == 8, chunk
    row_groups = sum(pq.ParquetFile(f).metadata.num_row_groups for f in files)
    saved = {k: sess.conf.get(k) for k in (ht.keys.STREAM_CHUNK_BYTES, ht.keys.DEVICE_MIN_ROWS)}
    sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, chunk)
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    sess.enable_hyperspace()
    li = sess.read_parquet(li_src)
    out = {"chunk_bytes": chunk, "chunks": 8, "row_groups": row_groups, "queries": {}}
    expect = {"T1": "topk: device-topk-stream x1", "T2": "topk: device-topk-stream x1",
              "T3": "sort: index-order-merge-limit x1"}
    try:
        for name, q in topk_queries(li, ht.col).items():
            clear_query_caches()
            D.reset_dispatches()
            sess.query_stage_seconds.clear()
            with PruneCount() as pc:
                t = time.perf_counter()
                got, summary = traced_collect(q)
                torch.cuda.synchronize()
                cold = (time.perf_counter() - t) * 1e3
            cold_dispatches = dict(D.dispatches)
            lines = trace_lines(summary, ("topk:", "sort: index-order"))
            assert expect[name] in lines and "topk: host-candidate-fallback x1" not in lines, summary
            assert "topk: stream-fallback x1" not in lines, summary
            if name in ("T1", "T2"):
                assert cold_dispatches.get("topk-chunk", 0) == 8, cold_dispatches
            warm = layer_ms(sess, q.collect, args.reps)
            sess.conf.set(ht.keys.EXEC_TOPK_ENABLED, False)
            t = time.perf_counter()
            host, host_summary = traced_collect(q)
            host_ms = (time.perf_counter() - t) * 1e3
            sess.conf.set(ht.keys.EXEC_TOPK_ENABLED, True)
            assert same_batch(got, host), f"{name}: differs from the host sort and slice"
            rows = len(next(iter(got.values())))
            assert rows == (1000 if name == "T3" else 100), rows
            kept = f"{pc.kept} of {pc.total} judged" if pc.total else "none judged (no pushed predicate)"
            out["queries"][name] = {"rows": rows, "trace": lines, "cold_ms": cold, "warm_ms": warm["total"],
                                    "topk_disabled_ms": host_ms, "dispatches": cold_dispatches,
                                    "row_groups_kept": [pc.kept, pc.total], "layers_ms": warm}
            print(f"topk {name}: {rows} rows, equal to topk.enabled=false byte for byte; {'; '.join(lines)}; cold "
                  f"{cold:.3f} ms, warm {warm['total']:.3f} ms, topk.enabled=false {host_ms:.3f} ms; row groups "
                  f"kept {kept} (of {row_groups} in the lake); dispatches {cold_dispatches} ({smi})", flush=True)
            print(f"layers topk {name} (warm): " + ", ".join(f"{k} {v:.3f} ms" for k, v in warm.items())
                  + f" ({smi})", flush=True)
        clear_query_caches()
        decoded = []
        from hyperspace_tpu_torch.exec import io as IO

        real = IO.read_parquet_batch

        def spy(fs, columns, predicate=None):
            decoded.extend(fs)
            return real(fs, columns, predicate=predicate)

        IO.read_parquet_batch = spy
        try:
            t = time.perf_counter()
            it = li.limit(10).to_local_iterator()
            first = next(it)
            it.close()
            t4_ms = (time.perf_counter() - t) * 1e3
        finally:
            IO.read_parquet_batch = real
        assert len(next(iter(first.values()))) == 10
        out["queries"]["T4"] = {"rows": 10, "files_decoded": len(set(decoded)), "of": len(files), "cold_ms": t4_ms}
        print(f"topk T4: limit(10) through to_local_iterator: 10 rows, {len(set(decoded))} of {len(files)} files "
              f"decoded, cold {t4_ms:.3f} ms ({smi})", flush=True)
        with ProgramCapture() as cap:
            topk_queries(li, ht.col)["T1"].collect()
        out["programs"] = new_program_times(cap.seen, args.reps, hbm)
        print_programs(out["programs"], smi)
    finally:
        for k, v in saved.items():
            sess.conf.set(k, v)
    return out


# --- whole-stage fusion ----------------------------------------------------------------


def _fusion_q1_lake(d: str, seed: int, num_files: int = 4, rows: int = 700) -> str:
    """tests/test_fusion.py's q1 lake (``_write_q1``, copied: the test module
    imports the JAX package): ``g`` (9 groups), ``qty``, ``price``."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(num_files):
        n = rows + 37 * i
        pq.write_table(pa.table({
            "g": rng.integers(0, 9, n).astype(np.int64),
            "qty": rng.integers(0, 500, n).astype(np.int64),
            "price": np.round(rng.uniform(0, 1000, n), 3),
        }), os.path.join(d, f"p{i}.parquet"))
    return d


def _fusion_q3_lake(d: str, seed: int):
    """tests/test_fusion.py's q3 lake (``_write_q3``): a probe side of four
    files and a 120-row build side."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    probe, build = os.path.join(d, "probe"), os.path.join(d, "build")
    os.makedirs(probe, exist_ok=True)
    os.makedirs(build, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(4):
        pq.write_table(pa.table({
            "k": rng.integers(0, 80, 900).astype(np.int64),
            "g": rng.integers(0, 12, 900).astype(np.int64),
            "v": np.round(rng.standard_normal(900), 4),
        }), os.path.join(probe, f"p{i}.parquet"))
    pq.write_table(pa.table({
        "k2": rng.integers(0, 90, 120).astype(np.int64),
        "w": np.round(rng.standard_normal(120), 4),
    }), os.path.join(build, "b.parquet"))
    return probe, build


def _fusion_topk_lake(d: str, seed: int) -> str:
    """tests/test_fusion.py's top-k lake (``_write_topk``): five files with
    NaN floats and a string column."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(5):
        v = np.round(rng.uniform(-100, 100, 600), 3)
        v[rng.choice(600, 10, replace=False)] = np.nan
        pq.write_table(pa.table({
            "k": rng.integers(0, 5000, 600).astype(np.int64),
            "v": v,
            "name": np.array([f"n{j % 17:02d}" for j in range(600)], dtype=object),
        }), os.path.join(d, f"p{i}.parquet"))
    return d


FUSED_FAMILIES = ("fused-stage-agg", "fused-stage-topk", "fused-stage-join-agg")


def _fusion_conf(ht, fusion: bool, donation: bool = True, **extra) -> dict:
    return {ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.STREAM_AGG_MIN_BYTES: 1, ht.keys.STREAM_CHUNK_BYTES: 1,
            ht.keys.FUSION_ENABLED: fusion, ht.keys.FUSION_DONATION: donation, **extra}


def check_fusion_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """tests/test_fusion.py's q1, q3 and top-k lakes in CPU and GPU
    sessions with fusion on and off and donation on and off: the GPU's
    fused rows equal the CPU port's fused rows and the GPU's fusion-off
    rows (keys, counts, int sums, min and max byte for byte, float sums,
    averages and deviations at rtol 1e-9; top-k byte for byte); donation on
    and off give the same bytes (deterministic algorithms: CUDA float sums
    add in a varying order otherwise); the fused q3 dispatches at least 3x
    fewer programs than the per-family sequence over the same chunks; a q1
    whose first chunk overflows the state's capacity redoes that chunk
    per-family and folds the others fused."""
    import numpy as np
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import aggregate as A
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.exec.executor import Executor

    cpu, gpu = devices
    root = os.path.join(tmp, "fusion_small")
    q1_dir = _fusion_q1_lake(os.path.join(root, "q1"), seed + 7)
    probe_dir, build_dir = _fusion_q3_lake(os.path.join(root, "q3"), seed + 3)
    tk_dir = _fusion_topk_lake(os.path.join(root, "tk"), seed + 13)
    c = ht.col

    def session(device, fusion, donation=True, **extra):
        return ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(root, "idx"),
                                **_fusion_conf(ht, fusion, donation, **extra)}, device=device)

    aggs_q3 = dict(n=("*", "count"), s=("v", "sum"), a=("w", "avg"), mn=("v", "min"), mx=("w", "max"))
    shapes = {
        "q1": (lambda s: s.read_parquet(q1_dir).filter(c("qty") > 40).group_by("g").agg(
            n=("*", "count"), sq=("qty", "sum"), sp=("price", "sum"), aq=("qty", "avg"), lo=("price", "min"),
            hi=("qty", "max"), sd=("price", "stddev_samp")), "fused-stage-agg", "agg: device-grouped-stream x1"),
        "q3": (lambda s: s.read_parquet(probe_dir).join(s.read_parquet(build_dir), on=c("k") == c("k2"))
               .filter(c("v") > -0.5).group_by("g").agg(**aggs_q3),
               "fused-stage-join-agg", "agg: fused-join-agg-stream x1"),
        "topk": (lambda s: s.read_parquet(tk_dir).order_by("v", "k", ascending=[False, True]).limit(25),
                 "fused-stage-topk", "topk: device-topk-stream x1"),
    }
    out = {}
    for name, (make, family, line) in shapes.items():
        runs = {}
        for device, fusion, donation in ((gpu, True, True), (gpu, True, False), (cpu, True, True), (gpu, False, True)):
            D.reset_dispatches()
            q = make(session(device, fusion, donation))
            torch.use_deterministic_algorithms(device == gpu and fusion)
            try:
                got, summary = traced_collect(q)
            finally:
                torch.use_deterministic_algorithms(False)
            runs[(device, fusion, donation)] = got
            if fusion:
                assert line in summary.splitlines(), (name, device, summary)
                assert D.dispatches[family] >= 3, (name, device, dict(D.dispatches))
            else:
                assert not any(D.dispatches[f] for f in FUSED_FAMILIES), (name, dict(D.dispatches))
            if device == gpu and fusion and donation:
                out[name] = {"rows": len(next(iter(got.values()))), "dispatches": dict(D.dispatches)}
        got = runs[(gpu, True, True)]
        floats = set() if name == "topk" else float_aggs_of(make(session(cpu, True)))
        check = (lambda g, w: same_batch(g, w)) if name == "topk" else (
            lambda g, w: same_groups(g, w, floats, ordered=True))
        assert check(got, runs[(cpu, True, True)]), f"fusion-small {name}: the GPU differs from the CPU port"
        assert check(got, runs[(gpu, False, True)]), f"fusion-small {name}: fusion on differs from off"
        assert same_batch(got, runs[(gpu, True, False)]), f"fusion-small {name}: donation on and off differ"
        print(f"fusion-small {name}: {out[name]['rows']} rows; GPU fused == CPU port fused == GPU fusion off; "
              f"donation on == off byte for byte; dispatches {out[name]['dispatches']}", flush=True)

    # the q3 chain's dispatches against the per-family sequence over the same chunks
    sess = session(gpu, False)
    D.reset_dispatches()
    gs = A.GroupedAggStream(sess, ["g"], [(k, fn, col if col != "*" else None) for k, (col, fn) in aggs_q3.items()],
                            max_groups=sess.conf.agg_max_groups, cap_floor=sess.conf.agg_capacity_floor)
    joined = sess.read_parquet(probe_dir).join(sess.read_parquet(build_dir), on=c("k") == c("k2")).filter(
        c("v") > -0.5)
    for chunk in Executor(sess).execute_stream(joined.plan):
        gs.update({k: np.asarray(v) for k, v in chunk.items()}, None)
    per_family = sum(D.dispatches.values())
    per_family_programs = dict(D.dispatches)
    per_family_rows = gs.finalize()
    D.reset_dispatches()
    fused_rows = shapes["q3"][0](session(gpu, True)).collect()
    fused = sum(D.dispatches.values())
    assert same_groups(fused_rows, per_family_rows, float_aggs_of(shapes["q3"][0](sess)), ordered=True), (
        "fusion-small q3: the per-family device fold differs")
    assert per_family >= 3 * fused, (per_family_programs, dict(D.dispatches))
    out["q3_dispatches"] = {"per_family": per_family_programs, "fused": dict(D.dispatches)}
    print(f"fusion-small q3 dispatches: per-family {per_family} {per_family_programs}, fused {fused} "
          f"{dict(D.dispatches)}: {per_family / fused:.2f}x fewer", flush=True)

    # a first chunk above the state's capacity: redone per-family, then fused
    ov_dir = _fusion_q1_lake(os.path.join(root, "q1_overflow"), seed + 8, rows=1200)
    fb0 = trace.fallbacks[("fusion", "grouped-overflow")]
    D.reset_dispatches()

    def q1_over(s):
        return s.read_parquet(ov_dir).filter(c("qty") > 40).group_by("g").agg(
            n=("*", "count"), sq=("qty", "sum"), sp=("price", "sum"), lo=("price", "min"))

    got = q1_over(session(gpu, True, True, **{ht.keys.AGG_CAPACITY_FLOOR: 2})).collect()
    redone = trace.fallbacks[("fusion", "grouped-overflow")] - fb0
    ov_dispatches = dict(D.dispatches)
    want = q1_over(session(gpu, False)).collect()
    assert redone == 1 and ov_dispatches["fused-stage-agg"] >= 4 and ov_dispatches["grouped-agg-chunk"] >= 1, (
        redone, ov_dispatches)
    assert same_groups(got, want, {"sp"}, ordered=True), "fusion-small overflow: differs from fusion off"
    out["overflow"] = {"redone_chunks": redone, "dispatches": ov_dispatches}
    print(f"fusion-small overflow: capacity floor 2, {redone} chunk redone per-family, dispatches {ov_dispatches}; "
          f"equal to fusion off", flush=True)
    return out


class FusionTimer:
    """While installed, every fused program (``stage_ir.compile_stage``'s)
    and, with ``per_family``, every per-family program the fused ones
    replace (``grouped_chunk_program``, ``grouped_merge_program``,
    ``hash_probe_program``, ``_postjoin_program``, ``topk_chunk_fn``,
    ``topk_merge_fn``) runs between two CUDA events; ``calls`` lists
    (family, start, end, bytes) in call order, ``bytes`` the tensors it read
    and wrote. (A cached stage program runs the closure its caller built
    last, so a timed one does not outlive the timer.)"""

    def __init__(self, per_family: bool):
        self.per_family = per_family

    @staticmethod
    def _bytes(obj) -> int:
        import torch

        if isinstance(obj, torch.Tensor):
            return obj.numel() * obj.element_size()
        if isinstance(obj, dict):
            return sum(FusionTimer._bytes(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(FusionTimer._bytes(v) for v in obj)
        return 0

    def _timed(self, family, fn):
        import torch

        def run(*args):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            got = fn(*args)
            e.record()
            self.calls.append((family, s, e, self._bytes(args) + self._bytes(got)))
            return got

        return run

    def __enter__(self):
        from hyperspace_tpu_torch.exec import aggregate as A
        from hyperspace_tpu_torch.exec import join_stream as JS
        from hyperspace_tpu_torch.exec import stage_ir
        from hyperspace_tpu_torch.ops import sort as S

        self.calls = []
        self.real = {"compile": (stage_ir, "compile_stage", stage_ir.compile_stage)}
        real_compile = stage_ir.compile_stage

        def compile_stage(skeleton, fn, *, donate_argnums=()):
            family = ("fused-stage-agg" if skeleton.startswith("gaggfused") else
                      "fused-stage-topk" if skeleton.startswith("fuse[T") else "fused-stage-join-agg")
            return real_compile(skeleton, self._timed(family, fn), donate_argnums=donate_argnums)

        stage_ir.compile_stage = compile_stage
        if self.per_family:
            for mod, attr, family in ((A, "grouped_chunk_program", "grouped-agg-chunk"),
                                      (A, "grouped_merge_program", "grouped-merge"),
                                      (JS, "_postjoin_program", "fused-postjoin"),
                                      (S, "topk_chunk_fn", "topk-chunk"), (S, "topk_merge_fn", "topk-merge")):
                builder = getattr(mod, attr)
                self.real[attr] = (mod, attr, builder)
                setattr(mod, attr, (lambda b, f: lambda *a: self._timed(f, b(*a)))(builder, family))
            self.real["probe"] = (JS, "hash_probe_program", JS.hash_probe_program)
            JS.hash_probe_program = self._timed("hash-probe", JS.hash_probe_program)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.real.values():
            setattr(mod, attr, fn)

    def chunks(self, first: str) -> list:
        """The calls as per-chunk lists of (family, ms, bytes), a chunk
        starting at each call of ``first``."""
        import torch

        torch.cuda.synchronize()
        out = []
        for family, s, e, nbytes in self.calls:
            if family == first or not out:
                out.append([])
            out[-1].append((family, s.elapsed_time(e), nbytes))
        return out


def _fusion_run(sess, q, conf: dict, reps: int):
    """(rows, trace summary, cold ms, warm layers) of ``q`` under ``conf``;
    the cold run starts with every query cache empty."""
    import torch

    for k, v in conf.items():
        sess.conf.set(k, v)
    clear_query_caches()
    t = time.perf_counter()
    got, summary = traced_collect(q)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t) * 1e3
    warm = layer_ms(sess, q.collect, reps)
    return got, summary, cold, warm


def run_fusion(sess, li_src: str, o_src: str, a1_streamed, a1_chunk: int, args, smi: str, hbm: float) -> dict:
    """Fusion on against off at SF1, warm medians, the rows equal: FA1 (the
    streamed A1 through ``li_q1``, ``a1_chunk`` bytes a chunk), FA4 (A1's
    filter and aggregates grouped by ``l_partkey``, 200 000 groups, over the
    source in 8 chunks), FJ3 (count, sum, avg, min and max over J3's chain,
    ``o_totalprice > 300000`` over the broadcast ``lineitem`` join
    ``orders``, hyperspace off, grouped by ``o_shippriority`` and by
    ``l_partkey``) and FT1 (T1 in 8 chunks). Then one warm run of each with
    every fused program between CUDA events, and one with the per-family
    programs they replace (FJ3's through the per-family device fold over
    the same chunks, as tests/test_fusion.py's q3 baseline): per chunk the
    fused program's time beside the sum of the per-family programs'.
    A1's group keys are strings, which stay per-family in both packages:
    FA1 runs no fused program, and FA1d (A1 grouped by ``l_discount``, 11
    float keys, at A1's chunks) is the fused fold at A1's shape."""
    import statistics

    import numpy as np
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import aggregate as A
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.exec.executor import Executor

    c = ht.col
    reps = max(2, args.reps // 3)
    files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src))
    src_chunk = 2 * max(os.path.getsize(f) for f in files)
    li, orders = sess.read_parquet(li_src), sess.read_parquet(o_src)
    saved = {k: sess.conf.get(k) for k in (ht.keys.STREAM_CHUNK_BYTES, ht.keys.STREAM_AGG_MIN_BYTES,
                                           ht.keys.DEVICE_MIN_ROWS, ht.keys.FUSION_ENABLED)}
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    q1_aggs = dict(sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
                   avg_qty=("l_quantity", "avg"), avg_price=("l_extendedprice", "avg"),
                   avg_disc=("l_discount", "avg"), count_order=("*", "count"),
                   sd_price=("l_extendedprice", "stddev_samp"))
    j3_aggs = dict(n=("*", "count"), revenue=("l_extendedprice", "sum"), avg_qty=("l_quantity", "avg"),
                   min_disc=("l_discount", "min"), max_total=("o_totalprice", "max"))
    j3 = li.join(orders, c("l_orderkey") == c("o_orderkey")).filter(c("o_totalprice") > 300000.0)
    fa4 = li.filter(c("l_shipdate") <= np.datetime64("1998-09-02")).group_by("l_partkey").agg(**q1_aggs)
    fa1d = li.filter(c("l_shipdate") <= np.datetime64("1998-09-02")).group_by("l_discount").agg(**q1_aggs)
    queries = {
        # name: (DataFrame, hyperspace on, chunk bytes, the fused family, per-family families, trace line);
        # A1's string group keys stay per-family in both packages: FA1 runs
        # no fused program, FA1d (A1 grouped by its 11 discounts, a float
        # key) takes fused-stage-agg at A1's chunks
        "FA1": (a1_streamed, True, a1_chunk, None, ("grouped-agg-chunk", "grouped-merge"),
                "agg: device-grouped-stream x1"),
        "FA1d": (fa1d, True, a1_chunk, "fused-stage-agg", ("grouped-agg-chunk", "grouped-merge"),
                 "agg: device-grouped-stream x1"),
        "FA4": (fa4, True, src_chunk, "fused-stage-agg", ("grouped-agg-chunk", "grouped-merge"),
                "agg: device-grouped-stream x1"),
        "FJ3-shippriority": (j3.group_by("o_shippriority").agg(**j3_aggs), False, src_chunk,
                             "fused-stage-join-agg",
                             ("hash-probe", "fused-postjoin", "grouped-agg-chunk", "grouped-merge"),
                             "agg: fused-join-agg-stream x1"),
        "FJ3-partkey": (j3.group_by("l_partkey").agg(**j3_aggs), False, src_chunk, "fused-stage-join-agg",
                        ("hash-probe", "fused-postjoin", "grouped-agg-chunk", "grouped-merge"),
                        "agg: fused-join-agg-stream x1"),
        "FT1": (li.order_by("l_extendedprice", ascending=[False]).limit(100), True, src_chunk,
                "fused-stage-topk", ("topk-chunk", "topk-merge"), "topk: device-topk-stream x1"),
    }
    out = {}
    try:
        for name, (q, hs_on, chunk, family, per_family, line) in queries.items():
            sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, chunk)
            sess.conf.set(ht.keys.STREAM_AGG_MIN_BYTES, 1)
            entry = {"chunk_bytes": chunk}
            with sess.hyperspace_scope(hs_on):
                results = {}
                for fusion in (False, True):
                    D.reset_dispatches()
                    fb0 = sum(v for (op, _), v in trace.fallbacks.items() if op == "fusion")
                    got, summary, cold, warm = _fusion_run(sess, q, {ht.keys.FUSION_ENABLED: fusion}, reps)
                    runs = 1 + reps
                    dispatches = {k: v / runs for k, v in D.dispatches.items()}
                    fallbacks = sum(v for (op, _), v in trace.fallbacks.items() if op == "fusion") - fb0
                    lines = summary.splitlines()
                    if fusion or family != "fused-stage-join-agg":  # off, the join aggregate is the host one
                        assert line in lines, (name, summary)
                    if fusion and family is not None:
                        assert dispatches.get(family, 0) > 0, (name, dispatches)
                    else:
                        assert not any(dispatches.get(f, 0) for f in FUSED_FAMILIES), (name, dispatches)
                    assert "agg: stream-fallback x1" not in lines and "topk: stream-fallback x1" not in lines, summary
                    results[fusion] = got
                    entry["on" if fusion else "off"] = {
                        "cold_ms": cold, "warm_ms": warm["total"], "layers_ms": warm,
                        "dispatches_per_query": dispatches, "fusion_fallbacks": fallbacks,
                        "trace": [ln for ln in lines if ln.startswith(("agg:", "join:", "topk:"))]}
                if name == "FT1":
                    assert same_batch(results[True], results[False]), f"{name}: fusion on differs from off"
                else:
                    assert same_groups(results[True], results[False], float_aggs_of(q), ordered=True), (
                        f"{name}: fusion on differs from off")
                rows = len(next(iter(results[True].values())))
                entry["rows"] = rows
                fused_rows = results[True]
                del results
                # one warm run of each path with its programs between CUDA events
                fused_chunks = []
                if family is not None:
                    sess.conf.set(ht.keys.FUSION_ENABLED, True)
                    q.collect()  # settle the capacity hint
                    with FusionTimer(per_family=False) as fused_t:
                        q.collect()
                    fused_chunks = fused_t.chunks(family)
                sess.conf.set(ht.keys.FUSION_ENABLED, False)
                sess.query_stage_seconds.clear()
                with FusionTimer(per_family=True) as pf_t:
                    if family == "fused-stage-join-agg":
                        # the per-family device fold over the same probe chunks
                        (agg,) = [p for p in _plan_nodes(q.plan) if type(p).__name__ == "Aggregate"]
                        inputs = list(dict.fromkeys(list(agg.keys) + [col for _, _, col in agg.aggs if col]))
                        gs = A.GroupedAggStream(sess, list(agg.keys), list(agg.aggs),
                                                max_groups=sess.conf.agg_max_groups,
                                                cap_floor=sess.conf.agg_capacity_floor)
                        t = time.perf_counter()
                        for ch in Executor(sess).execute_stream(j3.select(*inputs).plan):
                            gs.update({k: np.asarray(v) for k, v in ch.items()}, None)
                        pf_rows = gs.finalize()
                        torch.cuda.synchronize()
                        entry["per_family_fold_ms"] = (time.perf_counter() - t) * 1e3
                        assert same_groups(pf_rows, fused_rows, float_aggs_of(q), ordered=True), (
                            f"{name}: the per-family device fold differs from the fused one")
                        entry["per_family_verify_ms"] = sess.query_stage_seconds.get("join_verify", 0.0) * 1e3
                    else:
                        q.collect()
                pf_chunks = pf_t.chunks(per_family[0])
            fused_ms = [sum(ms for f, ms, _ in ch if f == family) for ch in fused_chunks]
            fused_bytes = [sum(b for f, _, b in ch if f == family) for ch in fused_chunks]
            pf_ms = [sum(ms for f, ms, _ in ch if f in per_family) for ch in pf_chunks]
            pf_by_family = {f: sum(ms for ch in pf_chunks for g, ms, _ in ch if g == f) for f in per_family}
            entry["fused"] = {"family": family, "chunks": len(fused_chunks), "ms_per_chunk": fused_ms,
                              "bytes_per_chunk": fused_bytes, "ms": sum(fused_ms),
                              "bound_ms": sum(b / hbm * 1e3 for b in fused_bytes)}
            entry["fused"]["share_of_bound"] = (entry["fused"]["bound_ms"] / entry["fused"]["ms"]
                                                if fused_ms else None)
            entry["per_family"] = {"families": list(per_family), "chunks": len(pf_chunks), "ms_per_chunk": pf_ms,
                                   "ms": sum(pf_ms), "ms_by_family": pf_by_family}
            if family != "fused-stage-join-agg" and family != "fused-stage-topk":
                chunk_calls = [(ms, b) for ch in pf_chunks for f, ms, b in ch if f == "grouped-agg-chunk"]
                entry["grouped_agg_chunk"] = {"calls": len(chunk_calls), "ms": statistics.median(m for m, _ in chunk_calls),
                                              "bytes": statistics.median(b for _, b in chunk_calls)}
                entry["grouped_agg_chunk"]["bound_ms"] = entry["grouped_agg_chunk"]["bytes"] / hbm * 1e3
            out[name] = entry
            on, off = entry["on"], entry["off"]
            print(f"fusion {name}: {rows} rows, fusion on == off; warm on {on['warm_ms']:.3f} ms, off "
                  f"{off['warm_ms']:.3f} ms, cold on {on['cold_ms']:.3f} / off {off['cold_ms']:.3f} ms (median of "
                  f"{reps}); dispatches per query on {on['dispatches_per_query']}, off {off['dispatches_per_query']}; "
                  f"fusion fallbacks {on['fusion_fallbacks']} ({smi})", flush=True)
            # the top-k's first chunk has no state to merge into: it runs
            # topk-chunk alone, fused or not
            skip = len(pf_chunks) - len(fused_chunks)
            for i, ms in enumerate(fused_ms):
                seq = pf_chunks[i + skip] if 0 <= i + skip < len(pf_chunks) else []
                print(f"fusion {name} chunk {i + max(skip, 0)}: {family} x1 {ms:.3f} ms ({fused_bytes[i]} bytes); "
                      f"per-family " + " + ".join(f"{f} {m:.3f}" for f, m, _ in seq)
                      + f" = {sum(m for _, m, _ in seq):.3f} ms ({smi})", flush=True)
            fused_text = (f"{family} {entry['fused']['ms']:.3f} ms over {len(fused_chunks)} chunks (bound "
                          f"{entry['fused']['bound_ms']:.3f} ms, {100 * entry['fused']['share_of_bound']:.2f}%)"
                          if fused_ms else "no fused program (string group keys stay per-family)")
            print(f"fusion {name} programs: {fused_text}, per-family {entry['per_family']['ms']:.3f} ms over "
                  f"{len(pf_chunks)} chunks {pf_by_family}"
                  + (f", host verify {entry['per_family_verify_ms']:.3f} ms, per-family device fold "
                     f"{entry['per_family_fold_ms']:.3f} ms" if "per_family_verify_ms" in entry else "")
                  + (f"; grouped-agg-chunk median {entry['grouped_agg_chunk']['ms']:.3f} ms, bound "
                     f"{entry['grouped_agg_chunk']['bound_ms']:.4f} ms" if "grouped_agg_chunk" in entry else "")
                  + f" ({smi})", flush=True)
            if name == "FA4":
                # where the grouped programs' device time goes at many groups,
                # fused and per-family, kernel by kernel
                with sess.hyperspace_scope(hs_on):
                    for fusion in (True, False):
                        sess.conf.set(ht.keys.FUSION_ENABLED, fusion)
                        q.collect()
                        entry[f"profile_fusion_{'on' if fusion else 'off'}"] = device_profile(
                            f"FA4 (warm, fusion {'on' if fusion else 'off'})", q.collect, os.path.dirname(li_src),
                            highlight=("indexFunc", "RadixSort", "radixSort", "scatter"))
    finally:
        for k, v in saved.items():
            sess.conf.set(k, v)
    return out


def _plan_nodes(plan):
    from hyperspace_tpu_torch.plan import logical as L

    return L.collect(plan, lambda p: True)


# --- the reference API surface, nested columns, explain and whyNot ---------------


def entry_digest(entry, root: str):
    """What two sessions' log entries of one index must share: name, state,
    log id, kind and properties, the source signature and files, and the
    index's bucket files by content (their names are random), with the
    session's system path written as ``<SYSTEM>``."""
    import re

    if entry is None:
        return None
    d = entry.to_dict()
    d.pop("content", None)
    text = json.dumps(d, sort_keys=True, default=str).replace(root, "<SYSTEM>")
    text = re.sub(r'"timestamp": \d+', '"timestamp": 0', text)
    return entry.state, entry.id, text, index_fingerprint(entry)


def check_api_small(tmp: str, seed: int) -> dict:
    """tests/test_reference_api_compat.py's camelCase lifecycle, and a
    ``refreshIndex`` of a data-skipping index, in a CPU and a GPU session,
    each action from a copy of one state: the same outcome, log entry and
    bucket files (byte for byte) on both, K1 for every covering build and
    K2 for the sketch rebuilds on the GPU, none on the CPU. With hyperspace
    on and ``camelIdx`` covering the DataFrame, ``createIndex`` and
    ``refreshIndex`` of another index read no index (no ``scan:`` event).
    Under ``hyperspace.parallel.enabled`` below ``parallel.minRows`` a
    build and a filter give the same bucket files, rows and trace as
    without it."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.ops import kernels

    data = os.path.join(tmp, "api", "d")
    os.makedirs(data)
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({"k": rng.integers(0, 50, 500).astype(np.int64), "v": rng.standard_normal(500)}),
                   os.path.join(data, "p.parquet"))
    c = ht.col

    def append():
        r = np.random.default_rng(seed + 1)
        pq.write_table(pa.table({"k": r.integers(0, 50, 100).astype(np.int64), "v": r.standard_normal(100)}),
                       os.path.join(data, "p2.parquet"))

    def optimize(hs, s):
        try:
            return hs.optimizeIndex("camelIdx")
        except Exception as e:  # the reference test's allowance: nothing to compact
            assert "No index files" in str(e) or "NoChanges" in type(e).__name__, e
            return None

    cfg = lambda: ht.CoveringIndexConfig.builder().indexName("camelIdx").indexBy("k").include("v").create()  # noqa: E731
    steps = [
        (None, "createIndex", lambda hs, s: hs.createIndex(s.read_parquet(data), cfg()), {K1}),
        (None, "createIndex skip", lambda hs, s: hs.createIndex(
            s.read_parquet(data), ht.DataSkippingIndexConfig("skipIdx", ht.MinMaxSketch("v"))), {K2}),
        (append, "refreshIndex full", lambda hs, s: hs.refreshIndex("camelIdx", "full"), {K1}),
        (None, "refreshIndex skip", lambda hs, s: hs.refreshIndex("skipIdx", "full"), {K2}),
        (None, "optimizeIndex", optimize, set()),
        (None, "deleteIndex", lambda hs, s: hs.deleteIndex("camelIdx"), set()),
        (None, "restoreIndex", lambda hs, s: hs.restoreIndex("camelIdx"), set()),
        (None, "deleteIndex", lambda hs, s: hs.deleteIndex("camelIdx"), set()),
        (None, "vacuumIndex", lambda hs, s: hs.vacuumIndex("camelIdx"), set()),
    ]
    state, launched, n = None, collections.Counter(), 0
    for edit, name, fn, expected in steps:
        if edit is not None:
            edit()
        got, prev = {}, state
        for device in ("cpu", "cuda"):
            system = os.path.join(tmp, "api", f"{n}-{device}")
            if prev is not None:
                shutil.copytree(prev, system)
            sess = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 4,
                                    ht.keys.DEVICE_MIN_ROWS: 0}, device=device)
            torch.cuda.synchronize()
            kernels.reset_launches()
            fn(ht.Hyperspace(sess), sess)
            torch.cuda.synchronize()
            launches = {k for k, v in kernels.launches.items() if v}
            if device == "cuda":
                assert launches == expected, f"api-small {name}: launches {launches}"
                launched.update({k: v for k, v in kernels.launches.items() if v})
            else:
                assert not launches, launches
            got[device] = {i: entry_digest(sess.index_manager.get_index(i), system) for i in ("camelIdx", "skipIdx")}
            if device == "cpu":
                state = system
            else:
                gpu = sess
        assert got["cuda"] == got["cpu"], f"api-small {name}: the GPU's log entries or files differ from the CPU's"
        print(f"api-small {name}: GPU log entries and bucket files equal the CPU port's; launches "
              f"{sorted(launches) or 'none'}", flush=True)
        if name == "refreshIndex full":
            text = {}
            for device in ("cpu", "cuda"):
                s = ht.Session(conf=dict(gpu.conf._conf), device=device).enableHyperspace()
                assert s.isHyperspaceEnabled()
                hs = ht.Hyperspace(s)
                qq = s.read_parquet(data).filter(c("k") == 7).select("v")
                on = qq.collect()
                s.disableHyperspace()
                assert same_rows(on, qq.collect()), "api-small: the query differs from hyperspace off"
                s.enableHyperspace()
                text[device] = hs.whyNot(qq)
            assert text["cuda"] == text["cpu"] and "camelIdx" in text["cuda"], text
        n += 1

    # lifecycle actions over a DataFrame another index covers read the source
    system = os.path.join(tmp, "api", "covered")
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 4, ht.keys.DEVICE_MIN_ROWS: 0},
                      device="cuda")
    hs = ht.Hyperspace(sess)
    df = sess.read_parquet(data)
    hs.createIndex(df, cfg())
    sess.enableHyperspace()
    with trace.recording() as events:
        second = hs.createIndex(df, ht.CoveringIndexConfig("second", ["v"], ["k"]))
        pq.write_table(pq.read_table(os.path.join(data, "p2.parquet")).slice(0, 10), os.path.join(data, "p3.parquet"))
        hs.refreshIndex("second", "incremental")
    assert not [e for e in events if e[0] in ("scan", "filter", "join")], events
    assert sess.isHyperspaceEnabled() and second.state == "ACTIVE"
    print("api-small: createIndex and refreshIndex over a DataFrame camelIdx covers read no index "
          f"(trace: {trace.summarize(events) if events else 'no dispatch events'})", flush=True)

    # C3: parallel.enabled below parallel.minRows is the single-device path
    digests, traces = {}, {}
    for label, extra in (("plain", {}), ("parallel", {"hyperspace.parallel.enabled": "true"})):
        system = os.path.join(tmp, "api", f"c3-{label}")
        s = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 4, ht.keys.DEVICE_MIN_ROWS: 0,
                             **extra}, device="cuda")
        entry = ht.Hyperspace(s).createIndex(s.read_parquet(data), cfg())
        digests[label] = index_fingerprint(entry)
        s.enableHyperspace()
        got, summary = traced_collect(s.read_parquet(data).filter(c("k") == 7).select("v"))
        traces[label] = (canonical(got), dispatch_lines(summary))
    assert digests["parallel"] == digests["plain"], "api-small: parallel.enabled changed the bucket files"
    assert same_batch(traces["parallel"][0], traces["plain"][0]) and traces["parallel"][1] == traces["plain"][1]
    assert "filter: device x1" in traces["parallel"][1], traces
    print(f"api-small: parallel.enabled below minRows: bucket files, rows and trace as without it "
          f"({'; '.join(traces['parallel'][1])})", flush=True)
    for k in (K1, K2):
        assert launched[k] > 0, f"api-small never launched {k}"
    return {"actions": n, "launches": dict(launched)}


GOLDEN_DIR = os.path.join(HERE, "tests", "golden")


def check_explain_small(tmp: str) -> dict:
    """tests/test_golden_explain.py's fixtures rebuilt on the GPU (the same
    seeds, files and indexes): each explain mode and whyNot report equals
    its ``tests/golden/*.txt`` after the suite's root normalization, and a
    CPU session over the same lake and indexes gives the same string. The
    golden files are only read."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.sources.iceberg import write_iceberg_table

    c = ht.col
    golden = {}
    for f in sorted(os.listdir(GOLDEN_DIR)):
        with open(os.path.join(GOLDEN_DIR, f), encoding="utf-8") as fh:
            golden[f] = fh.read()
    checked = {}

    def sessions(root, indexes):
        """(GPU session, CPU session) over ``root``'s system path, each
        with hyperspace on; the GPU one builds ``indexes`` first."""
        out = []
        for device in ("cuda", "cpu"):
            s = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(root, "indexes"), ht.keys.NUM_BUCKETS: 8},
                           device=device)
            if device == "cuda":
                indexes(s)
            out.append(s.enable_hyperspace())
        return out

    def check(name, root, each):
        """``each(session)`` -> report, in both sessions."""
        texts = [each(s).replace(root, "<ROOT0>") for s in pair]
        assert texts[0] == texts[1], f"explain-small {name}: the GPU's string differs from the CPU port's"
        assert texts[0] == golden[name], f"explain-small {name}: differs from tests/golden/{name}"
        checked[name] = len(texts[0])

    def golden_env(root):
        rng = np.random.default_rng(12345)
        n = 1000
        table = pa.table({
            "clicks": rng.integers(0, 100, n).astype(np.int64),
            "imprs": rng.integers(0, 1000, n).astype(np.int64),
            "score": np.round(rng.standard_normal(n), 6),
            "query": np.array([f"q{i % 23}" for i in range(n)]),
        })
        os.makedirs(os.path.join(root, "data"))
        os.makedirs(os.path.join(root, "indexes"))
        for i in range(4):
            pq.write_table(table.slice(i * 250, 250), os.path.join(root, "data", f"part-{i:05d}.parquet"))

        def indexes(s):
            hs = ht.Hyperspace(s)
            df = s.read_parquet(os.path.join(root, "data"))
            hs.create_index(df, ht.CoveringIndexConfig("filterIndex", ["clicks"], ["query"]))
            hs.create_index(df, ht.CoveringIndexConfig("joinIndex", ["imprs"], ["clicks"]))
        return indexes

    root = os.path.join(tmp, "golden")
    pair = sessions(root, golden_env(root))
    data = os.path.join(root, "data")
    fq = lambda s: s.read_parquet(data).filter(c("clicks") == 7).select("query")  # noqa: E731
    hs = lambda s: ht.Hyperspace(s)  # noqa: E731
    check("filter.txt", root, lambda s: hs(s).explain(fq(s), verbose=True))
    check("filter_console.txt", root, lambda s: hs(s).explain(fq(s), mode="console"))
    check("filter_html.txt", root, lambda s: hs(s).explain(fq(s), mode="html"))
    check("selfJoin.txt", root, lambda s: hs(s).explain(
        s.read_parquet(data).join(s.read_parquet(data), on=["imprs"]).select("clicks"), verbose=True))

    def subquery(s):
        df = s.read_parquet(data)
        scalar = df.filter(c("clicks") == 3).limit(1).select("query").as_scalar()
        return hs(s).explain(df.filter(c("query") == scalar).select("imprs"), verbose=True)

    check("subquery.txt", root, subquery)
    sq = lambda s: s.read_parquet(data).filter(c("score") > 0).select("query")  # noqa: E731
    check("whyNot_allIndex.txt", root, lambda s: hs(s).why_not(sq(s)))
    check("whyNot_indexName.txt", root, lambda s: hs(s).why_not(sq(s), index_name="filterIndex", extended=True))
    for s in pair:
        s.conf.set(ht.keys.FILTER_RULE_USE_BUCKET_SPEC, True)
    check("filter_bucket_pruned.txt", root, lambda s: hs(s).explain(fq(s), verbose=True))
    for s in pair:
        s.conf.set(ht.keys.FILTER_RULE_USE_BUCKET_SPEC, False)
    rng = np.random.default_rng(54321)
    n = 100
    pq.write_table(pa.table({
        "clicks": rng.integers(0, 100, n).astype(np.int64),
        "imprs": rng.integers(0, 1000, n).astype(np.int64),
        "score": np.round(rng.standard_normal(n), 6),
        "query": np.array([f"q{i % 23}" for i in range(n)]),
    }), os.path.join(data, "part-00004.parquet"))
    for s in pair:
        s.conf.set(ht.keys.HYBRID_SCAN_ENABLED, True)
    check("filter_hybrid_scan.txt", root, lambda s: hs(s).explain(fq(s), verbose=True))

    root = os.path.join(tmp, "golden-priority")
    os.makedirs(os.path.join(root, "pdata"))
    os.makedirs(os.path.join(root, "indexes"))
    rng = np.random.default_rng(777)
    n = 800
    table = pa.table({"clicks": rng.integers(0, 40, n).astype(np.int64),
                      "imprs": rng.integers(0, 200, n).astype(np.int64)})
    for i in range(4):
        pq.write_table(table.slice(i * 200, 200), os.path.join(root, "pdata", f"part-{i:05d}.parquet"))
    pdata = os.path.join(root, "pdata")

    def priority_indexes(s):
        df = s.read_parquet(pdata)
        hs(s).create_index(df, ht.CoveringIndexConfig("fIdx", ["clicks"], ["imprs"]))
        hs(s).create_index(df, ht.CoveringIndexConfig("jIdx", ["imprs"], ["clicks"]))

    pair = sessions(root, priority_indexes)

    def priority(s):
        df = s.read_parquet(pdata)
        return hs(s).why_not(df.filter(c("clicks") == 7).join(df, on=["imprs"]).select("clicks"))

    check("whyNot_priority.txt", root, priority)

    root = os.path.join(tmp, "golden-iceberg")
    os.makedirs(os.path.join(root, "indexes"))
    rng = np.random.default_rng(12345)
    n = 500
    write_iceberg_table(pa.table({"k": rng.integers(0, 50, n).astype(np.int64),
                                  "v": rng.integers(0, 500, n).astype(np.int64)}), os.path.join(root, "ice"))
    ice = os.path.join(root, "ice")
    pair = sessions(root, lambda s: hs(s).create_index(s.read_iceberg(ice),
                                                       ht.CoveringIndexConfig("iceJoinIndex", ["k"], ["v"])))
    check("selfJoin_Iceberg.txt", root, lambda s: hs(s).explain(
        s.read_iceberg(ice).join(s.read_iceberg(ice), on=["k"]).select("v"), verbose=True))
    assert sorted(checked) == sorted(golden), (sorted(checked), sorted(golden))
    for f, text in golden.items():
        with open(os.path.join(GOLDEN_DIR, f), encoding="utf-8") as fh:
            assert fh.read() == text, f"explain-small: tests/golden/{f} changed"
    print(f"explain-small: {len(checked)} explain and whyNot strings on the GPU equal tests/golden and the CPU "
          f"port's: {', '.join(sorted(checked))}", flush=True)
    return {"golden": sorted(checked)}


def gen_nested_small(root: str, seed: int) -> tuple:
    """tests/test_nested_columns.py's lake (two files of ``id`` and
    ``nested: struct<leaf: struct<cnt>, name>``) and its right table."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    d, r = os.path.join(root, "nested"), os.path.join(root, "r")
    os.makedirs(d)
    os.makedirs(r)
    rng = np.random.default_rng(seed)
    for i in range(2):
        n = 200
        pq.write_table(pa.table({
            "id": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
            "nested": pa.array([{"leaf": {"cnt": int(v % 9)}, "name": f"n{v % 4}"} for v in rng.integers(0, 100, n)]),
        }), os.path.join(d, f"p{i}.parquet"))
    pq.write_table(pa.table({"cnt": np.arange(9, dtype=np.int64),
                             "label": np.array([f"L{i}" for i in range(9)])}), os.path.join(r, "p.parquet"))
    return d, r


def append_nested(d: str, name: str, seed: int, n: int) -> None:
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "id": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        "nested": pa.array([{"leaf": {"cnt": int(v % 9)}, "name": f"n{v % 4}"} for v in rng.integers(0, 100, n)]),
    }), os.path.join(d, name))


def check_nested_small(tmp: str, seed: int) -> dict:
    """tests/test_nested_columns.py's shapes in a CPU and a GPU session, each
    over its own copy of one seeded lake (``deviceMinRows=0``, 4 buckets):
    a filter, the select of a struct leaf, bucket pruning, the join on a
    nested key, full and incremental refresh after an append, and hybrid
    scan. The GPU's rows equal the CPU port's in order, with the same
    dispatch trace; both equal hyperspace off as a multiset; the GPU
    launches K1 for every nested build."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.plan import logical as L

    c = ht.col
    results = {}
    launched = collections.Counter()
    for device in ("cpu", "cuda"):
        root = os.path.join(tmp, f"nested-small-{device}")
        d, r = gen_nested_small(root, seed)
        sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(root, "indexes"), ht.keys.NUM_BUCKETS: 4,
                                ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.NESTED_COLUMN_ENABLED: True}, device=device)
        hs = ht.Hyperspace(sess)
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        df, rdf = sess.read_parquet(d), sess.read_parquet(r)
        hs.create_index(df, ht.CoveringIndexConfig("nQ", ["nested.leaf.cnt"], ["id"]))
        hs.create_index(df, ht.CoveringIndexConfig("nSel", ["nested.leaf.cnt"], ["nested.name"]))
        hs.create_index(rdf, ht.CoveringIndexConfig("nJR", ["cnt"], ["label"]))
        if device == "cuda":
            torch.cuda.synchronize()
            assert kernels.launches.get(K1, 0) >= 3, kernels.launches
            launched.update(kernels.launches)
        else:
            assert not any(kernels.launches.values()), kernels.launches
        sess.enable_hyperspace()
        out = {}

        def run(name, q, expect_plan=None):
            plan = q.optimized_plan()
            if expect_plan is not None:
                assert expect_plan(plan), f"nested-small {name}: {plan.pretty()}"
            got, summary = traced_collect(q)
            with sess.hyperspace_scope(False):
                off = q.collect()
            assert len(next(iter(got.values()))) > 0, name
            # a struct's string leaf extracted on the host path is a numpy
            # string array, the index's column an object array (as in the
            # JAX package): compare the values
            off = {k: v.astype(object) if v.dtype.kind == "U" else v for k, v in off.items()}
            assert same_rows(got, off), f"nested-small {name} on {device}: differs from hyperspace off"
            out[name] = (got, dispatch_lines(summary))

        scans = lambda plan: L.collect(plan, lambda p: isinstance(p, L.IndexScan))  # noqa: E731
        run("filter", sess.read_parquet(d).filter(c("nested.leaf.cnt") == 3).select("id"), lambda p: scans(p))
        run("select", sess.read_parquet(d).filter(c("nested.leaf.cnt") > 5).select("nested.name"),
            lambda p: scans(p))
        sess.conf.set(ht.keys.FILTER_RULE_USE_BUCKET_SPEC, True)
        run("bucket-pruned", sess.read_parquet(d).filter(c("nested.leaf.cnt") == 3).select("id"),
            lambda p: scans(p) and scans(p)[0].pruned_buckets is not None)
        sess.conf.set(ht.keys.FILTER_RULE_USE_BUCKET_SPEC, False)
        hs.create_index(df, ht.CoveringIndexConfig("nJL", ["nested.leaf.cnt"], ["id"]))
        run("join", sess.read_parquet(d).join(sess.read_parquet(r), on=c("nested.leaf.cnt") == c("cnt"))
            .select("id", "label"), lambda p: len(scans(p)) == 2)
        for mode in ("full", "incremental"):
            hs.create_index(sess.read_parquet(d), ht.CoveringIndexConfig(f"nRef_{mode}", ["nested.leaf.cnt"], ["id"]))
        append_nested(d, "app.parquet", seed + 4, 60)
        for mode in ("full", "incremental"):
            kernels.reset_launches()
            hs.refresh_index(f"nRef_{mode}", mode)
            if device == "cuda":
                torch.cuda.synchronize()
                assert kernels.launches.get(K1, 0) > 0, (mode, kernels.launches)
                launched.update(kernels.launches)
        for name in ("nQ", "nSel", "nJL"):
            hs.delete_index(name)
        run("refreshed", sess.read_parquet(d).filter(c("nested.leaf.cnt") == 3).select("id"), lambda p: scans(p))
        hs.create_index(sess.read_parquet(d), ht.CoveringIndexConfig("nHy", ["nested.leaf.cnt"], ["id"]))
        for name in ("nRef_full", "nRef_incremental"):
            hs.delete_index(name)
        append_nested(d, "appended.parquet", seed + 9, 50)
        sess.conf.set(ht.keys.HYBRID_SCAN_ENABLED, True)
        run("hybrid", sess.read_parquet(d).filter(c("nested.leaf.cnt") == 3).select("id"),
            lambda p: L.collect(p, lambda x: isinstance(x, L.BucketUnion)))
        results[device] = out
    for name, (got, lines) in results["cuda"].items():
        want, want_lines = results["cpu"][name]
        assert same_batch(got, want), f"nested-small {name}: the GPU's rows differ from the CPU port's"
        assert lines == want_lines, (name, lines, want_lines)
        print(f"nested-small {name}: GPU == CPU port (in order) == hyperspace off; " + "; ".join(lines), flush=True)
    join_tier = [ln for ln in results["cuda"]["join"][1] if ln.startswith("join:")]
    filter_tier = [ln for ln in results["cuda"]["filter"][1] if ln.startswith("filter:")]
    assert filter_tier == ["filter: device x1"], filter_tier
    assert launched[K1] > 0
    return {"shapes": sorted(results["cuda"]), "join_tier": join_tier, "launches": dict(launched)}


#: the SF1 ``lineitem`` files the nested lake writes again (a quarter of
#: 16: its off runs decode the structs row by row, the script's time limit)
NESTED_FILES = 4


def gen_nested_lake(root: str, li_src: str, o_src: str, seed: int) -> tuple:
    """The first ``NESTED_FILES`` SF1 ``lineitem`` files and every
    ``orders`` file written again with struct columns:
    ``l_ship: struct<shipdate, quantity, discount, extendedprice>`` and
    ``l_key: struct<orderkey, linenumber>`` (line numbers from ``seed``)
    beside the other columns, ``o_key: struct<orderkey>`` beside the
    other orders columns; file for file."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    li, od = os.path.join(root, "lineitem_nested"), os.path.join(root, "orders_nested")
    os.makedirs(li)
    os.makedirs(od)
    rng = np.random.default_rng(seed + 7)
    for f in sorted(os.listdir(li_src))[:NESTED_FILES]:
        t = pq.read_table(os.path.join(li_src, f))
        ship = pa.StructArray.from_arrays(
            [t.column(c).combine_chunks() for c in ("l_shipdate", "l_quantity", "l_discount", "l_extendedprice")],
            ["shipdate", "quantity", "discount", "extendedprice"])
        key = pa.StructArray.from_arrays(
            [t.column("l_orderkey").combine_chunks(), pa.array(rng.integers(1, 8, t.num_rows).astype(np.int64))],
            ["orderkey", "linenumber"])
        rest = [c for c in t.column_names
                if c not in ("l_shipdate", "l_quantity", "l_discount", "l_extendedprice", "l_orderkey")]
        pq.write_table(pa.table({"l_key": key, "l_ship": ship, **{c: t.column(c) for c in rest}}),
                       os.path.join(li, f))
    for f in sorted(os.listdir(o_src)):
        t = pq.read_table(os.path.join(o_src, f))
        key = pa.StructArray.from_arrays([t.column("o_orderkey").combine_chunks()], ["orderkey"])
        pq.write_table(pa.table({"o_key": key, **{c: t.column(c) for c in t.column_names if c != "o_orderkey"}}),
                       os.path.join(od, f))
    return li, od


def nested_queries(li, od):
    """NQ6: q6's filter over the ``l_ship`` leaves; NJ1: J1 on the nested
    order keys."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    c = ht.col
    nq6 = li.filter(
        (c("l_ship.shipdate") >= np.datetime64("1994-01-01")) & (c("l_ship.shipdate") < np.datetime64("1995-01-01"))
        & (c("l_ship.discount") >= 0.05) & (c("l_ship.discount") <= 0.07) & (c("l_ship.quantity") < 24)
    ).select("l_ship.extendedprice", "l_ship.discount")
    nj1 = li.join(od, c("l_key.orderkey") == c("o_key.orderkey")).select(
        "l_key.orderkey", "l_ship.extendedprice", "o_orderdate", "o_totalprice")
    return {"NQ6": nq6, "NJ1": nj1}


def run_nested(li_src: str, o_src: str, tmp: str, args, smi: str, join_tier) -> dict:
    """The nested lake (``gen_nested_lake``); ``li_ship_nested`` (on
    ``l_ship.shipdate`` with the other three leaves), ``li_key_nested`` and
    ``o_key_nested`` (on the nested order keys with the columns NJ1 reads),
    each build's stages, rows/s and K1 launches; NQ6 and NJ1 cold, warm (the
    median of ``--reps``) and hyperspace off (one run: the source path
    decodes the structs row by row), with layers; NQ6 on ``filter:
    device``, NJ1 on ``join_tier`` (nested-small's), both equal to off
    and as many rows as their flat twins q6 and J1 over the same source
    files (hyperspace off)."""
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.ops import kernels

    t = time.perf_counter()
    li_dir, o_dir = gen_nested_lake(os.path.join(tmp, "nested"), li_src, o_src, args.seed)
    gen_s = time.perf_counter() - t
    rows = {"lineitem": sum(pq.read_metadata(os.path.join(li_dir, f)).num_rows for f in os.listdir(li_dir)),
            "orders": sum(pq.read_metadata(os.path.join(o_dir, f)).num_rows for f in os.listdir(o_dir))}
    print(f"nested lake: lineitem {rows['lineitem']} rows in {len(os.listdir(li_dir))} files, orders "
          f"{rows['orders']} in {len(os.listdir(o_dir))}, with struct columns ({gen_s:.3f} s)", flush=True)
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(tmp, "nested", "_indexes"),
                            ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.NESTED_COLUMN_ENABLED: True,
                            ht.keys.JOIN_DEVICE_MATERIALIZE_MAX_BYTES: 2 << 30}, device="cuda")
    hs = ht.Hyperspace(sess)
    li, od = sess.read_parquet(li_dir), sess.read_parquet(o_dir)
    out = {"gen_s": gen_s, "rows": rows, "device": smi, "builds": {}, "queries": {}}
    for df, cfg, n in (
        (li, ht.CoveringIndexConfig("li_ship_nested", ["l_ship.shipdate"],
                                    ["l_ship.quantity", "l_ship.discount", "l_ship.extendedprice"]), rows["lineitem"]),
        (li, ht.CoveringIndexConfig("li_key_nested", ["l_key.orderkey"], ["l_ship.extendedprice"]), rows["lineitem"]),
        (od, ht.CoveringIndexConfig("o_key_nested", ["o_key.orderkey"], ["o_orderdate", "o_totalprice"]),
         rows["orders"]),
    ):
        sess.build_stage_seconds.clear()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        entry = hs.create_index(df, cfg)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        launches = dict(kernels.launches)
        assert launches.get(K1, 0) > 0, (cfg.index_name, launches)
        assert entry.derived_dataset.properties["indexedColumns"][0].startswith("__hs_nested."), entry.name
        out["builds"][cfg.index_name] = {"seconds": s, "rows_per_s": n / s, "launches": launches,
                                         "stages": dict(sess.build_stage_seconds)}
        print(f"build {cfg.index_name}: {s:.3f} s, {n / s:.0f} rows/s, launches {launches} ({smi})", flush=True)
        print(f"stages {cfg.index_name}: " + ", ".join(f"{k} {v:.3f} s" for k, v in sess.build_stage_seconds.items()),
              flush=True)
    # the flat twins: q6 and J1 over the SF1 files the nested lake rewrote
    flat_li, flat_o = os.path.join(tmp, "nested", "lineitem_flat"), os.path.join(tmp, "nested", "orders_flat")
    for src, d, names in ((li_src, flat_li, os.listdir(li_dir)), (o_src, flat_o, os.listdir(o_dir))):
        os.makedirs(d)
        for f in names:
            os.link(os.path.join(src, f), os.path.join(d, f))
    flat = {"NQ6": q6_query(sess.read_parquet(flat_li)),
            "NJ1": join_queries(sess.read_parquet(flat_li), sess.read_parquet(flat_o))["J1"]}
    sess.enable_hyperspace()
    for name, q in nested_queries(li, od).items():
        plan = q.optimized_plan()
        print(f"plan {name}:\n{plan.pretty()}", flush=True)
        assert len(plan_index_scans(plan)) == (1 if name == "NQ6" else 2), plan.pretty()
        IO.clear_io_cache()
        D.clear_device_cache()
        clear_query_caches()
        sess.query_stage_seconds.clear()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t) * 1e3
        cold_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
        cold_layers.update(rest=cold - sum(cold_layers.values()), total=cold)
        lines = dispatch_lines(summary)
        print(f"trace {name}: " + "; ".join(lines), flush=True)
        if name == "NQ6":
            assert "filter: device x1" in lines, lines
        else:
            assert [ln for ln in lines if ln.startswith("join:")] == join_tier, (lines, join_tier)
        warm = layer_ms(sess, q.collect, args.reps)
        with sess.hyperspace_scope(False):
            sess.query_stage_seconds.clear()
            t = time.perf_counter()
            off, off_summary = traced_collect(q)
            off_ms = (time.perf_counter() - t) * 1e3
            off_layers = {k: v * 1e3 for k, v in sess.query_stage_seconds.items()}
            off_layers.update(rest=off_ms - sum(off_layers.values()), total=off_ms)
        n_rows = len(next(iter(got.values())))
        # every value is a copy of a source value (no arithmetic): exact, as
        # a multiset (the index path and the source path order rows apart)
        assert n_rows > 0 and same_batch(as_multiset(got), as_multiset(off)), f"{name}: differs from hyperspace off"
        del off
        with sess.hyperspace_scope(False):
            t = time.perf_counter()
            twin_rows = len(next(iter(flat[name].collect().values())))
            twin = {"name": "q6" if name == "NQ6" else "J1", "rows": twin_rows,
                    "off_ms": (time.perf_counter() - t) * 1e3}
        out["queries"][name] = {"rows": n_rows, "trace": lines, "off_trace": dispatch_lines(off_summary),
                                "cold_ms": cold, "warm_ms": warm["total"], "off_ms": off_ms,
                                "layers_ms": {"cold": cold_layers, "warm": warm, "off": off_layers},
                                "flat_twin": twin}
        print(f"nested {name}: {n_rows} rows, equal to hyperspace off; cold {cold:.3f} ms, warm {warm['total']:.3f} "
              f"ms, off {off_ms:.3f} ms; flat twin {twin['name']} over the same files: {twin['rows']} rows, off "
              f"{twin['off_ms']:.3f} ms ({smi})", flush=True)
        for run, lay in out["queries"][name]["layers_ms"].items():
            print(f"layers {name} ({run}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in lay.items()) + f" ({smi})",
                  flush=True)
        assert n_rows == twin["rows"], (name, n_rows, twin)
    return out


def run_explain(sess, dirs: dict, texts: dict, smi: str) -> dict:
    """``Hyperspace.explain`` (plaintext) and ``why_not`` of all 22 TPC-H
    texts over the ``sql`` phase's SF1 lake and roster, each timed, each
    equal to a CPU session's string over the same lake and system path."""
    import hyperspace_tpu_torch as ht

    cpu = ht.Session(conf=dict(sess.conf._conf), device="cpu")
    for name, d in dirs.items():
        cpu.read_parquet(d).create_or_replace_temp_view(name)
    cpu.enable_hyperspace()
    out = {}
    for qname, text in texts.items():
        row = {}
        strings = {}
        for label, s in (("gpu", sess), ("cpu", cpu)):
            df = s.sql(text)
            hs = ht.Hyperspace(s)
            t = time.perf_counter()
            e = hs.explain(df)
            e_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            w = hs.why_not(df)
            w_ms = (time.perf_counter() - t) * 1e3
            strings[label] = (e, w)
            if label == "gpu":
                row = {"explain_ms": e_ms, "why_not_ms": w_ms, "explain_chars": len(e), "why_not_chars": len(w),
                       "indexes_used": sorted(ln.split(":")[0].strip() for ln in
                                              e.split("Indexes used:\n", 1)[1].splitlines()
                                              if ln.startswith("  ") and ":" in ln)}
        assert strings["gpu"] == strings["cpu"], f"explain {qname}: the GPU session's strings differ from the CPU's"
        assert strings["gpu"][0].startswith("=" * 64) and "whyNot report" in strings["gpu"][1], qname
        out[qname] = row
        print(f"explain {qname}: explain {row['explain_ms']:.3f} ms, whyNot {row['why_not_ms']:.3f} ms, equal to the "
              f"CPU port's; indexes used {row['indexes_used'] or 'none'} ({smi})", flush=True)
    return out


# --- native Parquet decode and the reliability layer ------------------------------

NATIVE_CODECS = ("NONE", "SNAPPY", "GZIP", "ZSTD")


def native_small_table(seed: int, n: int, nulls: bool):
    """Every column type the native decoder reads: a sorted int64 key (the
    pruning column), int32, int64, float64, date32, a dictionary string
    column and a plain one; with ``nulls``, holes in the int64, float,
    date and dictionary string columns."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)

    def holes(values, period):
        mask = (rng.integers(0, period, n) == 0) if nulls else np.zeros(n, dtype=bool)
        return pa.array([None if m else v for m, v in zip(mask.tolist(), values.tolist())])

    days = (np.datetime64("1995-01-01") + rng.integers(0, 2500, n).astype("timedelta64[D]")).astype("datetime64[D]")
    strings = np.array([f"flag-{int(v) % 23:02d}" for v in rng.integers(0, 10**6, n)], dtype=object)
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "i32": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
        "i64": holes(rng.integers(-(10**12), 10**12, n).astype(np.int64), 9),
        "f64": holes(rng.standard_normal(n), 7),
        "d": holes(days, 5),
        "s": holes(strings, 11),
        "u": pa.array([f"row-{seed}-{i}" for i in range(n)]),
    })


def same_decoded(got, want, what: str) -> None:
    """Byte for byte: numeric buffers by their bytes, strings and nulls by
    value; the same dictionary codes and entries where both are
    dictionary-backed."""
    import numpy as np

    from hyperspace_tpu_torch.exec import batch as B

    assert list(got) == list(want), (what, list(got), list(want))
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, c, g.dtype, w.dtype, g.shape, w.shape)
        if w.dtype == object:
            assert all((x is None and y is None) or x == y for x, y in zip(g.tolist(), w.tolist())), (what, c)
        else:
            assert g.tobytes() == w.tobytes(), (what, c)
        if isinstance(got[c], B.DictBackedArray) and isinstance(want[c], B.DictBackedArray):
            assert got[c].hs_dict_codes.tobytes() == want[c].hs_dict_codes.tobytes(), (what, c)
            assert list(got[c].hs_dict_uniques) == list(want[c].hs_dict_uniques), (what, c)


def counter_values(name: str) -> dict:
    """{labels (sorted tuple): value} of one registry counter."""
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    series = REGISTRY.snapshot().get(name, {}).get("series", [])
    return {tuple(sorted(s["labels"].items())): s["value"] for s in series}


def counter_delta(after: dict, before: dict) -> dict:
    return {",".join(f"{k}={v}" for k, v in key) or "total": after[key] - before.get(key, 0.0)
            for key in after if after[key] != before.get(key, 0.0)}


def check_native_small(tmp: str, seed: int) -> dict:
    """The port's build of libhs_native (no silent pyarrow: a failed build
    fails here); a codec matrix decoded by a GPU session (pinned buffers)
    and a CPU one, equal to each other and to pyarrow byte for byte; the
    pinned handoff; ``dict-expand`` against the factorize path and its
    plain version; a corrupt decode that quarantines an index (the query
    then reads the source, with the same rows) and a transient one that
    falls back to the per-file decode (same rows)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.exec import batch as B
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.reliability import errors as rerr
    from hyperspace_tpu_torch.reliability.degrade import QUARANTINE
    from hyperspace_tpu_torch.reliability.faults import FaultRule, fault_scope

    assert native.is_available(), "libhs_native did not build or load"
    info = native.build_info()
    print(f"native-small: libhs_native {os.path.relpath(info['path'], HERE)} "
          f"({'built by this run' if info['built'] else 'built earlier'}); {info['compiler']}; codecs "
          f"{', '.join(info['codecs'])}; dropped: {', '.join(info['dropped']) if info['dropped'] else 'none'}",
          flush=True)
    cuda = torch.device("cuda", torch.cuda.current_device())
    root = os.path.join(tmp, "native-small")
    ht.Session(device="cuda")  # a CUDA session: decode buffers pinned
    cols = ["k", "i32", "i64", "f64", "d", "s", "u"]
    matrix = {}
    pinned_checked = 0
    for codec in NATIVE_CODECS:
        native_codec = "uncompressed" if codec == "NONE" else codec.lower()
        for nulls in (False, True):
            d = os.path.join(root, f"{codec}-{int(nulls)}")
            os.makedirs(d)
            files = []
            for i in range(2):
                f = os.path.join(d, f"part-{i:05d}.parquet")
                pq.write_table(native_small_table(seed + 31 * i + int(nulls), 6000, nulls), f, compression=codec,
                               row_group_size=1000, use_dictionary=["s"])
                files.append(f)
            for pruned in (False, True):
                pred = ht.col("k") < 2500 if pruned else None  # row groups 0-2 of 6 per file
                got, kinds = {}, {}
                for device in ("cuda", "cpu"):
                    IO.set_pinned_decode(device == "cuda")
                    IO.clear_io_cache()
                    with trace.recording() as events:
                        got[device] = IO.read_parquet_batch(files, cols, predicate=pred)
                    kinds[device] = sorted({detail for kind, detail in events if kind == "decode"})
                IO.set_pinned_decode(True)
                what = f"{codec} nulls={nulls} pruned={pruned}"
                same_decoded(got["cuda"], got["cpu"], what + " GPU vs CPU port")
                if native_codec in info["codecs"]:
                    assert kinds["cuda"] == kinds["cpu"] == ["native-rg"], (what, kinds)
                want = pa.concat_tables([pq.ParquetFile(f).read_row_groups([0, 1, 2] if pruned else list(range(6)),
                                                                           columns=cols) for f in files])
                pa_batch = {c: want[c].to_numpy(zero_copy_only=False) for c in cols}
                same_decoded(got["cuda"], pa_batch, what + " GPU vs pyarrow")
                assert isinstance(got["cuda"]["s"], B.DictBackedArray), what
                if not nulls and not pruned:
                    for c in ("k", "i64", "f64", "d"):
                        enc, _codec = D.encode_column(got["cuda"][c])
                        host = D._staging_host(enc, cuda)
                        assert host.data_ptr() == got["cuda"][c].ctypes.data and host.is_pinned(), (what, c)
                        pinned_checked += 1
                matrix[what] = {"rows": len(got["cuda"]["k"]), "decode": kinds["cuda"]}
                print(f"native-small {what}: {len(got['cuda']['k'])} rows, GPU == CPU port == pyarrow byte for "
                      f"byte; decode {kinds['cuda']}", flush=True)
    print(f"native-small pinned: {pinned_checked} staged host tensors are the decode buffers and pinned", flush=True)

    # dict-expand: the dictionary column staged on the card against the
    # factorize path, its staging twin and its plain version
    IO.clear_io_cache()
    dense = IO.read_parquet_batch([os.path.join(root, "SNAPPY-0", "part-00000.parquet")], ["s"])["s"]
    holed = IO.read_parquet_batch([os.path.join(root, "SNAPPY-1", "part-00000.parquet")], ["s"])["s"]
    D.reset_dispatches()
    expand = {}
    for label, arr in (("dense", dense), ("nulls", holed)):
        assert isinstance(arr, B.DictBackedArray), label
        plain = np.asarray(arr).view(np.ndarray).copy()
        dev, codec, _ = D._put_encoded(arr, cuda)
        want, want_codec, _ = D._put_encoded(plain, cuda)
        staged, s_codec, _, ready = D._stage_encoded(arr, cuda)
        torch.cuda.current_stream().wait_event(ready)
        assert torch.equal(staged, dev) and list(s_codec.uniques) == list(codec.uniques), label
        if label == "dense":
            assert torch.equal(dev, want) and list(codec.uniques) == list(want_codec.uniques), label
        decoded = lambda t, u: [None if c < 0 else u[c] for c in t.cpu().tolist()]  # noqa: E731
        assert decoded(dev, codec.uniques) == decoded(want, want_codec.uniques) == plain.tolist(), label
        codes, remap, _ = D._dict_plan(arr)
        prog = D.dict_expand_program(torch.from_numpy(codes).to(cuda), torch.from_numpy(remap).to(cuda))
        assert prog.cpu().numpy().tobytes() == D.dict_expand_plain(codes, remap).tobytes(), label
        expand[label] = {"rows": len(arr), "entries": len(codec.uniques), "nulls": int((codes < 0).sum())}
    assert D.dispatches["dict-expand"] == 4, dict(D.dispatches)  # two uploads and two stagings
    print(f"native-small dict-expand: {expand}; equal to the factorize path (dense: the same tensor and codec; "
          f"with nulls: the same strings), the staged copy and the plain version; dispatches "
          f"{D.dispatches['dict-expand']}", flush=True)

    # faults: a corrupt index decode quarantines the index; a transient one
    # falls back to the per-file decode
    lake = os.path.join(root, "lake")
    os.makedirs(lake)
    rng = np.random.default_rng(seed + 5)
    for i in range(3):
        pq.write_table(pa.table({"c1": rng.integers(0, 100, 4000).astype(np.int64),
                                 "c2": np.round(rng.uniform(0, 100, 4000), 3)}),
                       os.path.join(lake, f"part-{i:05d}.parquet"))
    system = os.path.join(root, "_indexes")
    conf = {ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 4, ht.keys.DEVICE_MIN_ROWS: 0}
    sess = ht.Session(conf={**conf, ht.keys.RELIABILITY_QUARANTINE_ENABLED: True,
                            ht.keys.RELIABILITY_QUARANTINE_THRESHOLD: 1,
                            ht.keys.RELIABILITY_QUARANTINE_COOLDOWN_SECONDS: 3600.0}, device="cuda")
    ht.Hyperspace(sess).create_index(sess.read_parquet(lake), ht.CoveringIndexConfig("nidx", ["c1"], ["c2"]))
    sess.enable_hyperspace()

    def query(s):
        return s.read_parquet(lake).filter(ht.col("c1") < 50).select("c1", "c2")

    with sess.hyperspace_scope(False):
        want = canonical(query(sess).collect())
    assert plan_index_scans(query(sess).optimized_plan())
    clear_query_caches()
    raised = counter_values("hs_io_errors_total")
    with fault_scope(FaultRule("io.decode", "corrupt", path_glob=os.path.join(system, "*"))):
        try:
            query(sess).collect()
            raise AssertionError("a corrupt index decode did not raise")
        except rerr.CorruptDataError as exc:
            assert isinstance(exc, rerr.FaultInjected), exc
    assert QUARANTINE.state_of("nidx") == "open", QUARANTINE.state_of("nidx")
    fallback_q = query(sess)
    assert not plan_index_scans(fallback_q.optimized_plan()), fallback_q.optimized_plan().pretty()
    assert same_batch(canonical(fallback_q.collect()), want), "the quarantined query differs from the source"
    corrupt = counter_delta(counter_values("hs_io_errors_total"), raised)
    print(f"native-small corrupt: CorruptDataError raised, nidx quarantined, the query re-planned against the "
          f"source with the same rows; hs_io_errors_total {corrupt}", flush=True)

    sess = ht.Session(conf=conf, device="cuda").enable_hyperspace()  # quarantine off again
    clear_query_caches()
    before = counter_values("hs_native_fallback_total")
    with fault_scope(FaultRule("io.decode", "transient", nth=1)):
        with trace.recording() as events:
            got = query(sess).collect()
    assert plan_index_scans(query(sess).optimized_plan())
    assert same_batch(canonical(got), want), "the transient fault changed the rows"
    fell = counter_delta(counter_values("hs_native_fallback_total"), before)
    assert fell.get("reason=io-error") == 1.0, fell
    decode = sorted({detail for kind, detail in events if kind == "decode"})
    assert "native" in decode, decode  # the per-file path answered natively
    print(f"native-small transient: the fault fell back to the per-file decode ({decode}), same rows; "
          f"hs_native_fallback_total {fell}", flush=True)
    return {"build": {k: v for k, v in info.items() if k != "path"}, "matrix": matrix, "pinned_checked": pinned_checked,
            "dict_expand": expand, "corrupt_io_errors": corrupt, "transient_fallbacks": fell}


def set_native(ht, on: bool) -> None:
    """``hyperspace.exec.io.native.enabled`` as a user sets it: a session
    built with the key applies it to the process-global decode path."""
    ht.Session(conf={ht.keys.EXEC_IO_NATIVE_ENABLED: on}, device="cuda")


def run_native(sess, hs, df, li_src: str, j1, args, smi: str, hbm: float) -> dict:
    """Native decode at SF1: cold and warm q6 and J1 on the main session,
    native on and off (``hyperspace.exec.io.native.enabled``), rows equal; decode
    counters; no dialect or io-error fallback over index files; the pinned
    decode against pageable decode plus ``.pin_memory()``; a string filter
    over the source that runs ``dict-expand`` (timed beside its bound); and
    ``li_skip`` rebuilt from native decode, with K2 on natively decoded
    values against its plain version and K1 on a natively decoded key."""
    import numpy as np
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.indexes.registry import index_of_entry
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.ops.hashing import bucket_ids_np, numeric_hash32
    from hyperspace_tpu_torch.ops.sort import bucket_sort_build

    cuda = torch.device("cuda", torch.cuda.current_device())
    sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    queries = {"q6": q6_query(sess.read_parquet(li_src)), "J1": j1}
    out = {"device": smi, "queries": {}}
    rows_on = {}
    index_fallbacks = {}
    for mode in ("on", "off"):
        set_native(ht, mode == "on")
        for name, q in queries.items():
            before = {n: counter_values(n) for n in ("hs_native_decode_total", "hs_native_decode_bytes_total",
                                                     "hs_native_fallback_total")}
            layers, got, summary = sql_layers(sess, q, 2)
            delta = {n: counter_delta(counter_values(n), b) for n, b in before.items()}
            decode = [ln for ln in summary.splitlines() if ln.startswith("decode:")]
            if mode == "on":  # both read index files only
                rows_on[name] = got
                index_fallbacks[name] = delta["hs_native_fallback_total"]
                assert not any(k in ("reason=dialect", "reason=io-error")
                               for k in delta["hs_native_fallback_total"]), (name, delta)
                assert decode and not any("pyarrow" in ln for ln in decode), (name, decode)
            else:
                assert same_batch(got, rows_on[name]), f"native {name}: rows differ with native decode off"
            r = out["queries"].setdefault(name, {})
            r[mode] = {"cold_ms": layers["cold"]["total"], "warm_ms": layers["warm"]["total"],
                       "decode_ms": {"cold": layers["cold"].get("decode", 0.0),
                                     "warm": layers["warm"].get("decode", 0.0)},
                       "join_decode_ms": {"cold": layers["cold"].get("join_decode", 0.0),
                                          "warm": layers["warm"].get("join_decode", 0.0)},
                       "trace_decode": decode, "counters": delta, "layers_ms": layers}
            print(f"native {name} ({mode}): cold {layers['cold']['total']:.3f} ms (decode "
                  f"{layers['cold'].get('decode', 0.0):.3f}, join_decode {layers['cold'].get('join_decode', 0.0):.3f}),"
                  f" warm {layers['warm']['total']:.3f} ms; {'; '.join(decode)}; counters {delta} ({smi})", flush=True)
        del got
    set_native(ht, True)
    del rows_on
    out["index_fallbacks"] = index_fallbacks

    # the pinned decode against pageable decode plus .pin_memory(): q6 cold,
    # and its index columns decoded and staged alone, in turns
    q6 = queries["q6"]
    files = list(sess.index_manager.get_index("li_shipdate").content.files)
    cols = ["l_shipdate", "l_quantity", "l_discount", "l_extendedprice"]
    pin = {"q6_cold": {True: [], False: []}, "stage": {True: [], False: []}}
    for pinned in (True, False, True, False):
        IO.set_pinned_decode(pinned)
        layers, _got, _summary = sql_layers(sess, q6, 1)
        pin["q6_cold"][pinned].append({k: layers["cold"].get(k, 0.0) for k in ("decode", "upload", "total")})
        IO.clear_io_cache()
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = IO.read_parquet_batch(files, cols)
        t1 = time.perf_counter()
        for c in cols:
            _dev, _codec, _n, ready = D._stage_encoded(batch[c], cuda)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pin["stage"][pinned].append({"decode": (t1 - t) * 1e3, "stage": (t2 - t1) * 1e3,
                                     "bytes": int(sum(batch[c].nbytes for c in cols))})
        del batch
    IO.set_pinned_decode(True)
    out["pinned_vs_pageable"] = {("pinned" if k else "pageable"): v for k, v in pin["q6_cold"].items()}
    out["stage_pinned_vs_pageable"] = {("pinned" if k else "pageable"): v for k, v in pin["stage"].items()}
    for label, runs in (("q6 cold", out["pinned_vs_pageable"]), ("stage li_shipdate", out["stage_pinned_vs_pageable"])):
        print(f"native pinned vs pageable, {label}: {runs} ({smi})", flush=True)
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    out["host_memory"] = {k: v for k, v in (host_stats() if host_stats else {}).items() if "bytes" in k}
    print(f"native pinned host memory (torch's caching host allocator): {out['host_memory'] or 'not reported'}",
          flush=True)

    # dict-expand: a string filter over the dictionary-encoded source lake,
    # hyperspace off, deviceMinRows=0, streamed one file per chunk
    src_files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src) if f.endswith(".parquet"))
    sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, os.path.getsize(src_files[0]))
    q = sess.read_parquet(li_src).filter(ht.col("l_returnflag") == "R")
    D.reset_dispatches()
    with sess.hyperspace_scope(False):
        with trace.recording() as events:
            n_dev = sum(len(ch["l_orderkey"]) for ch in q.to_local_iterator())
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 1 << 25)
        n_host = len(q.collect()["l_orderkey"])
        sess.conf.set(ht.keys.DEVICE_MIN_ROWS, 0)
    sess.conf.set(ht.keys.STREAM_CHUNK_BYTES, 128 << 20)
    expands = D.dispatches["dict-expand"]
    assert n_dev == n_host > 0 and expands > 0 and ("filter", "device") in events, (n_dev, n_host, dict(D.dispatches))
    arr = IO.read_parquet_batch([src_files[0]], ["l_returnflag"])["l_returnflag"]
    codes, remap, _codec = D._dict_plan(arr)
    codes_dev, remap_dev = torch.from_numpy(codes).to(cuda), torch.from_numpy(remap).to(cuda)
    got = D.dict_expand_program(codes_dev, remap_dev)
    t = time.perf_counter()
    want = D.dict_expand_plain(codes, remap)
    plain_ms = (time.perf_counter() - t) * 1e3
    assert got.cpu().numpy().tobytes() == want.tobytes()
    b_ms, by = bound(codes.nbytes * 2 + remap.nbytes, codes.size, hbm)
    prog_ms = time_ms(lambda: D.dict_expand_program(codes_dev, remap_dev), args.reps)
    out["dict_expand"] = {"rows": n_dev, "launches": expands, "shape": f"{codes.size} int32 codes, remap {remap.size}",
                          "ms": prog_ms, "bound_ms": b_ms, "bound_by": by, "plain_ms": plain_ms}
    print(f"native dict-expand: l_returnflag == 'R' over the source (hyperspace off, deviceMinRows=0): {n_dev} rows "
          f"== host; {expands} dispatches; program {prog_ms:.6f} ms on {codes.size} codes, bound {b_ms:.6f} ms "
          f"({by}), plain {plain_ms:.3f} ms ({smi})", flush=True)

    # li_skip rebuilt from native decode (K2), K2 and K1 on natively decoded
    # values against their plain versions
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    with trace.recording() as events:
        entry = hs.create_index(df, ht.DataSkippingIndexConfig(
            "li_skip_native", ht.MinMaxSketch("l_extendedprice"), ht.MinMaxSketch("l_orderkey")))
    torch.cuda.synchronize()
    skip_s = time.perf_counter() - t
    launches = dict(kernels.launches)
    decode = sorted({detail for kind, detail in events if kind == "decode"})
    assert launches.get("segmented_min_max", 0) > 0 and "native-rg" in decode, (launches, decode)
    check_sketches(entry, index_of_entry(entry))
    IO.clear_io_cache()
    segs = [np.asarray(IO.read_parquet_batch([f], ["l_extendedprice"])["l_extendedprice"]) for f in src_files]
    _values, _offsets, k2_err = check_minmax(segs)
    keys = np.asarray(IO.read_parquet_batch([src_files[0]], ["l_orderkey"])["l_orderkey"])
    _perm, counts = bucket_sort_build([torch.from_numpy(keys).to(cuda)], [], ("i",), 200, len(keys))
    want_counts = np.bincount(bucket_ids_np([numeric_hash32(keys)], 200), minlength=200)
    assert np.array_equal(counts.cpu().numpy(), want_counts), "K1 on a natively decoded key"
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    out["launches"] = launches
    out["li_skip_native"] = {"seconds": skip_s, "decode": decode, "k2_max_abs_err": k2_err}
    print(f"native li_skip rebuilt from native decode ({decode}) in {skip_s:.3f} s; sketches equal numpy; K2 on "
          f"natively decoded values equals its plain version; K1 on a natively decoded key equals numpy's "
          f"bincount; launches {launches} ({smi})", flush=True)
    return out


# --- serving (7o, 12l) ----------------------------------------------------------


class KernelCapture:
    """K1 and K2 wrapped while installed, keeping every call's inputs and
    outputs (``ops/sort.bucket_histogram``, which the build calls, and
    ``ops/kernels.segment_min_max_keys``, which ``segmented_min_max``
    calls), so each call can be held against its plain version on the same
    tensors afterwards (``check``)."""

    def __enter__(self):
        from hyperspace_tpu_torch.ops import kernels
        from hyperspace_tpu_torch.ops import sort as S

        self.calls = {K1: [], K2: []}
        self.real = (S.bucket_histogram, kernels.segment_min_max_keys)
        real_hist, real_minmax = self.real
        calls = self.calls

        def hist(ids, num_buckets):
            out = real_hist(ids, num_buckets)
            calls[K1].append(((ids.clone(), num_buckets), out.clone()))
            return out

        def minmax(values, offsets):
            out = real_minmax(values, offsets)
            calls[K2].append(((values.clone(), offsets.clone()), tuple(t.clone() for t in out)))
            return out

        S.bucket_histogram, kernels.segment_min_max_keys = hist, minmax
        return self

    def __exit__(self, *exc):
        from hyperspace_tpu_torch.ops import kernels
        from hyperspace_tpu_torch.ops import sort as S

        S.bucket_histogram, kernels.segment_min_max_keys = self.real

    def check(self) -> dict:
        """Each captured call's output against its plain version on the same
        tensors (exact: both are integer results); returns the calls per
        kernel."""
        import torch

        from hyperspace_tpu_torch.ops import kernels

        for (ids, nb), out in self.calls[K1]:
            assert torch.equal(out, kernels.bucket_histogram_plain(ids, nb)), "K1 differs from its plain version"
        for (values, offsets), out in self.calls[K2]:
            want = kernels.segment_min_max_keys_plain(values, offsets)
            assert all(torch.equal(a, b) for a, b in zip(out, want)), "K2 differs from its plain version"
        return {k: len(v) for k, v in self.calls.items()}


def _write_atomic(write, path: str) -> None:
    """``write(tmp_path)`` then one rename onto ``path``, so a concurrent
    listing of the lake never sees a half-written file."""
    part = os.path.join(os.path.dirname(os.path.dirname(path)), "." + os.path.basename(path) + ".part")
    write(part)
    os.replace(part, path)


def span_trace(fut) -> list:
    """The dispatch trace of a served request, from its span tree's events
    (``exec/trace.recording`` refuses while a server runs)."""
    from hyperspace_tpu_torch.exec import trace

    prof = getattr(fut, "profile", None)
    return [] if prof is None else trace.summarize_span_events(prof.root).splitlines()


def check_serving_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """The serving runtime on the small lakes: the query-small lake (a copy
    the phase may append to) with a covering index (K1) and a MinMax
    data-skipping index (K2) built on the GPU, and the join-small lake
    unindexed, served by a CPU and a GPU session over the same index files,
    each under ``QueryServer(workers=4)`` with the plan cache,
    micro-batching, the bucket cache, the result cache, the scheduler and
    span tracing on. The traffic: 16 literal variants of an indexed filter,
    32 of a grouped aggregate (bursts until one micro-batch forms), a
    broadcast join with two post-join literals (the second build a
    ``hs_join_build_cache`` hit), an ``ORDER BY ... LIMIT`` and a query
    over a deleted file. Every served result equals the same session's
    direct ``collect()`` byte for byte and in order, and the GPU's equal
    the CPU port's; the bad query fails alone and the next request is
    served. The shared-scan aggregate's path, run directly, traces ``agg:
    device-grouped-batch``. Then a pin is captured, a file appended and
    ``RefreshManager.poll_once()`` commits both indexes: K1 launches once
    for the covering rewrite and K2 once for the sketch rebuild, each equal
    to its plain version on its inputs; requests admitted against the pin
    and after the commit serve their version's rows, equal to a direct
    ``collect()`` under the same pin, none stale, none torn; one server
    serves the requests over both listings, each its own listing's rows
    (ROADMAP C8, repaired in the port)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.lifecycle import RefreshManager, SnapshotHandle, snapshot_scope
    from hyperspace_tpu_torch.obs.metrics import REGISTRY
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.serving.batcher import execute_shared_scan, shared_scan_ops

    cpu, gpu = devices
    root = os.path.join(tmp, "serving_small")
    lake = os.path.join(root, "q")
    shutil.copytree(os.path.join(tmp, "qsmall"), lake)
    fact, dim = os.path.join(tmp, "join", "fact"), os.path.join(tmp, "join", "dim")
    conf = {ht.keys.SYSTEM_PATH: os.path.join(root, "idx"), ht.keys.NUM_BUCKETS: 16, ht.keys.DEVICE_MIN_ROWS: 0,
            ht.keys.STREAM_CHUNK_BYTES: 1, ht.keys.HYBRID_SCAN_ENABLED: True,
            ht.keys.SERVING_RESULT_CACHE_ENABLED: True, ht.keys.SERVING_SCHED_ENABLED: True,
            ht.keys.OBS_TRACING_ENABLED: True, ht.keys.LIFECYCLE_REFRESH_MODE: "incremental"}
    sessions = {d: ht.Session(conf=dict(conf), device=d) for d in devices}
    owner = sessions[gpu]
    torch.cuda.synchronize()
    kernels.reset_launches()
    hs = ht.Hyperspace(owner)
    hs.create_index(owner.read_parquet(lake), ht.CoveringIndexConfig("serve_id", ["id"], ["z", "f", "n", "d", "s"]))
    hs.create_index(owner.read_parquet(lake), ht.DataSkippingIndexConfig("serve_skip", ht.MinMaxSketch("id")))
    torch.cuda.synchronize()
    build_launches = dict(kernels.launches)
    assert build_launches.get(K1, 0) > 0 and build_launches.get(K2, 0) > 0, build_launches
    for s in sessions.values():
        s.enable_hyperspace()
    c = ht.col

    def filt(s, v):
        return s.read_parquet(lake).filter((c("id") >= 1000 * v) & (c("id") < 1000 * v + 2500) & (c("z") != 0)) \
            .select("id", "z", "f", "s")

    def agg(s, v):
        return s.read_parquet(lake).filter(c("id") < 8000 + 1000 * v).group_by("z").agg(
            n=("*", "count"), sid=("id", "sum"), lo=("f", "min"), hi=("f", "max"))

    def join(s, v):
        return s.read_parquet(fact).join(s.read_parquet(dim), c("k") == c("dk")) \
            .filter(c("v") > 0.5 * v).select("k", "s", "v", "w", "dstr")

    def topk(s):
        return s.read_parquet(lake).filter(c("id") > 5).order_by("f", "id", ascending=[False, True]).limit(20)

    served, traces, stats = {}, {}, {}
    for device, sess in sessions.items():
        doomed = os.path.join(root, f"doomed-{device}.parquet")
        pq.write_table(pa.table({"v": np.arange(50, dtype=np.int64)}), doomed)
        bad = sess.read_parquet(doomed).filter(c("v") > 1).select("v")
        os.remove(doomed)
        got, frames = {}, {}
        fallbacks0 = sum(n for (op, _), n in trace.fallbacks.items() if op == "agg")
        hits0 = REGISTRY.counter("hs_join_build_cache_hits_total", "").value
        with ht.QueryServer(sess, workers=4) as srv:
            futs = {}
            for v in range(16):
                frames[f"filter{v}"] = filt(sess, v)
                futs[f"filter{v}"] = srv.submit(frames[f"filter{v}"], timeout=120)
            batches0, bursts = srv.stats()["batches"], 0
            while True:  # a burst of same-template aggregates: a micro-batch forms once the queue holds two
                bursts += 1
                for v in range(32 * (bursts - 1), 32 * bursts):
                    frames[f"agg{v}"] = agg(sess, v)
                    futs[f"agg{v}"] = srv.submit(frames[f"agg{v}"], timeout=120)
                for name in [n for n in futs if n.startswith("agg")]:
                    futs[name].result(timeout=120)
                if srv.stats()["batches"] > batches0 or bursts == 4:
                    break
            assert srv.stats()["batches"] > batches0, f"serving-small: no micro-batch in {bursts} bursts"
            bad_fut = srv.submit(bad, timeout=120)
            for v in (1, 2):  # one after the other: the second build is the cache's
                frames[f"join{v}"] = join(sess, v)
                futs[f"join{v}"] = srv.submit(frames[f"join{v}"], timeout=120)
                futs[f"join{v}"].result(timeout=120)
            frames["topk"] = topk(sess)
            futs["topk"] = srv.submit(frames["topk"], timeout=120)
            for name, f in futs.items():
                got[name] = f.result(timeout=120)
                traces[device, name] = span_trace(f)
            try:
                bad_fut.result(timeout=120)
                raise AssertionError("serving-small: the query over a deleted file was served")
            except (OSError, RuntimeError, ValueError) as e:
                bad_error = type(e).__name__
            after_bad = srv.query(filt(sess, 3), timeout=120)
            stats[device] = {"serving": srv.stats(), "build_cache": srv.join_build_cache.stats()}
        assert stats[device]["build_cache"]["hits"] >= 1, stats[device]["build_cache"]
        assert REGISTRY.counter("hs_join_build_cache_hits_total", "").value > hits0
        assert sum(n for (op, _), n in trace.fallbacks.items() if op == "agg") == fallbacks0, dict(trace.fallbacks)
        for name in ("join1", "join2"):
            assert "join: broadcast-hash-stream x1" in traces[device, name], (name, traces[device, name])
        assert any(ln.startswith("topk:") or ln.startswith("sort:") for ln in traces[device, "topk"]), \
            traces[device, "topk"]
        for name, df in frames.items():
            assert same_batch(got[name], df.collect()), f"serving-small {name} on {device}: differs from collect()"
        assert same_batch(after_bad, filt(sess, 3).collect())
        served[device] = got
        s = stats[device]["serving"]
        print(f"serving-small {device}: {s['completed']} served, {s['errors']} errors ({bad_error} for the deleted "
              f"file, and the next request served); {s['batches']} micro-batches of {s['batchedRequests']} "
              f"requests after {bursts} aggregate burst(s); plan cache {s['planCache']['hitRate']:.3f}, bucket cache "
              f"{s['bucketCache']['hitRate']:.3f}, result cache {s['resultCache']['hitRate']:.3f}, build cache "
              f"{stats[device]['build_cache']['hits']} hit(s) of {stats[device]['build_cache']['hits'] + stats[device]['build_cache']['misses']}; "
              f"every result equals collect() byte for byte", flush=True)
    for name in served[gpu]:
        if name in served[cpu]:
            assert same_batch(served[gpu][name], served[cpu][name]), f"serving-small {name}: GPU differs from CPU"
    print(f"serving-small traces (GPU, from span events): filter0 {traces[gpu, 'filter0']}; join2 "
          f"{traces[gpu, 'join2']}; topk {traces[gpu, 'topk']}", flush=True)

    # the shared-scan aggregate's path, run directly under a recording
    sess = sessions[gpu]
    template = sess.read_parquet(lake).filter(c("id") < 8000).group_by("z").agg(
        n=("*", "count"), sid=("id", "sum"), lo=("f", "min"), hi=("f", "max"))
    from hyperspace_tpu_torch.rules.apply import optimize_plan
    from hyperspace_tpu_torch.rules.utils import prune_columns

    ops, leaf = shared_scan_ops(prune_columns(optimize_plan(template.plan, sess)))
    bound = [prune_columns(optimize_plan(agg(sess, v).plan, sess)) for v in (0, 5, 9)]
    D.reset_dispatches()
    with trace.recording() as events:
        batched = execute_shared_scan(sess, ops, leaf, bound)
    assert trace.summarize(events).count("agg: device-grouped-batch x3") == 1, trace.summarize(events)
    assert D.dispatches["grouped-agg-chunk"] >= 3, dict(D.dispatches)
    for v, b in zip((0, 5, 9), batched):
        assert same_batch(b, agg(sess, v).collect()), f"serving-small shared scan agg{v} differs from collect()"
    print(f"serving-small shared scan: 3 aggregates over one decode, agg: device-grouped-batch x3, "
          f"equal to collect()", flush=True)

    # refresh under traffic: pin version N, append, commit N+1
    pin = SnapshotHandle.capture(owner)
    before = {d: filt(s, 59) for d, s in sessions.items()}
    rng = np.random.default_rng(seed + 14)
    extra = 4000
    appended = pa.table({
        "id": np.arange(60_000, 60_000 + extra, dtype=np.int64), "z": rng.integers(-3, 4, extra),
        "f": np.round(rng.standard_normal(extra), 1), "n": pa.array(rng.integers(0, 9, extra), mask=None),
        "d": np.datetime64("1997-01-01") + rng.integers(0, 30, extra).astype("timedelta64[D]"),
        "s": np.array([f"s{x}" for x in rng.integers(0, 60, extra)], dtype=object),
    })
    _write_atomic(lambda p: pq.write_table(appended, p), os.path.join(lake, "part-00009.parquet"))
    after = {d: filt(s, 59) for d, s in sessions.items()}
    torch.cuda.synchronize()
    kernels.reset_launches()
    with KernelCapture() as cap:
        outcomes = RefreshManager(owner).poll_once()
        torch.cuda.synchronize()
    refresh_launches = {k: v for k, v in kernels.launches.items() if v}
    assert sorted((o["index"], o["outcome"]) for o in outcomes) == [("serve_id", "committed"),
                                                                     ("serve_skip", "committed")], outcomes
    assert refresh_launches == {K1: 1, K2: 1}, refresh_launches
    calls = cap.check()
    fresh = SnapshotHandle.capture(owner)
    assert fresh.index_version("serve_id") > pin.index_version("serve_id")
    sessions[cpu].index_manager.clear_cache()
    versions, refreshed = {}, {}
    for device, sess in sessions.items():
        res = {}
        # one server for both listings: the plan cache keys a scan by its
        # file listing (ROADMAP C8, repaired in the port), so the requests
        # over the new listing bind templates of their own
        with ht.QueryServer(sess, workers=4) as srv:
            for k, frames in (("before", before), ("after", after)):
                with snapshot_scope(pin):
                    fa = srv.submit(frames[device], timeout=120)
                fb = srv.submit(frames[device], timeout=120)
                res[k, "N"], res[k, "N+1"] = fa.result(timeout=120), fb.result(timeout=120)
        for k, frames in (("before", before), ("after", after)):
            with snapshot_scope(pin):
                want_n = frames[device].collect()
            assert same_batch(res[k, "N"], want_n), f"serving-small refresh {k} at N on {device}: differs from collect()"
            assert same_batch(res[k, "N+1"], frames[device].collect()), \
                f"serving-small refresh {k} at N+1 on {device}: differs from collect()"
            # two index versions of one data version: the same rows
            assert same_batch(as_multiset(res[k, "N"]), as_multiset(res[k, "N+1"])), f"torn: {k} on {device}"
        want_new = int(np.count_nonzero((appended["id"].to_numpy() < 61_500) & (appended["z"].to_numpy() != 0)))
        for ver in ("N", "N+1"):
            assert int(np.count_nonzero(res["after", ver]["id"] >= 60_000)) == want_new > 0, f"stale: after at {ver}"
            assert not np.any(res["before", ver]["id"] >= 60_000), f"before at {ver} saw the appended file"
        # ROADMAP C8, repaired: the server that served the old listing served
        # the new one's rows, not the old ones
        assert not same_batch(res["after", "N"], res["before", "N"]), f"serving-small C8 on {device}: old rows"
        versions[device] = {f"{a}@{b}": len(next(iter(r.values()))) for (a, b), r in res.items()}
        refreshed[device] = res
    for key, batch in refreshed[gpu].items():
        assert same_batch(batch, refreshed[cpu][key]), f"serving-small refresh {key}: GPU differs from CPU"
    print(f"serving-small refresh: poll_once committed serve_id v{pin.index_version('serve_id')} -> "
          f"v{fresh.index_version('serve_id')} and serve_skip; launches {refresh_launches}, each call equal to its "
          f"plain version ({calls}); rows per request {versions[gpu]}: pinned and fresh requests equal "
          f"collect() under the same pin, the appended rows whole in every request over the new listing, none "
          f"stale, none torn; GPU == CPU; one server served both listings, the new one's rows over the new listing "
          f"(ROADMAP C8, repaired)", flush=True)
    return {"build_launches": build_launches, "refresh_launches": refresh_launches,
            "launches": dict(collections.Counter(build_launches) + collections.Counter(refresh_launches)),
            "stats": {d: s["serving"] for d, s in stats.items()}, "build_cache": stats[gpu]["build_cache"],
            "bursts": bursts, "versions": versions}


SERVING_REQUESTS = 40  # per run: 20 q6, 8 A1, 8 J3, 4 T1 (the script's time limit)
SERVING_CLIENTS = 8


def serving_mix(seed: int) -> list:
    """The 12l request mix, in a seeded order: (kind, variant) for 50% q6
    (16 ``l_quantity`` literals), 20% A1 (4 ship-date cut-offs), 20% J3
    (2 ``o_totalprice`` literals) and 10% T1."""
    import numpy as np

    n = SERVING_REQUESTS
    mix = ([("q6", i % 16) for i in range(n // 2)] + [("A1", i % 4) for i in range(n // 5)]
           + [("J3", i % 2) for i in range(n // 5)] + [("T1", 0)] * (n - n // 2 - 2 * (n // 5)))
    order = np.random.default_rng(seed + 12).permutation(len(mix))
    return [mix[i] for i in order]


def serving_frame(sess, li_src: str, o_src: str, kind: str, v: int):
    """One 12l request over a fresh listing of the lake: q6 (its filter with
    ``l_quantity < 9 + v``), A1 (q1 over plain columns, shipped by a
    cut-off ``v`` weeks before 1998-09-02), J3 (a month of ``lineitem``
    broadcast-joined to ``orders`` with ``o_totalprice`` above a literal;
    ``o_custkey`` is in no ``orders`` index, so the join broadcasts) and T1
    (the 100 dearest lines)."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    c = ht.col
    li = sess.read_parquet(li_src)
    if kind == "q6":
        return li.filter(
            (c("l_shipdate") >= np.datetime64("1994-01-01")) & (c("l_shipdate") < np.datetime64("1995-01-01"))
            & (c("l_discount") >= 0.05) & (c("l_discount") <= 0.07) & (c("l_quantity") < 9 + v)
        ).select("l_extendedprice", "l_discount")
    if kind == "A1":
        return (li.filter(c("l_shipdate") <= np.datetime64("1998-09-02") - np.timedelta64(7 * v, "D"))
                .group_by("l_returnflag", "l_linestatus")
                .agg(sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
                     avg_qty=("l_quantity", "avg"), avg_price=("l_extendedprice", "avg"),
                     avg_disc=("l_discount", "avg"), count_order=("*", "count"),
                     sd_price=("l_extendedprice", "stddev_samp")))
    if kind == "J3":
        return (li.filter((c("l_shipdate") >= np.datetime64("1994-03-01")) & (c("l_shipdate") < np.datetime64("1994-04-01")))
                .join(sess.read_parquet(o_src), c("l_orderkey") == c("o_orderkey"))
                .filter(c("o_totalprice") > 250000.0 + 100000.0 * v)
                .select("l_orderkey", "l_extendedprice", "o_custkey", "o_totalprice"))
    return li.order_by("l_extendedprice", ascending=[False]).limit(100)


def _same_served(kind: str, got, want, ordered: bool) -> bool:
    """A served 12l result against a direct ``collect()``: byte for byte and
    in order (``ordered``), else as multisets; A1's float aggregates at
    rtol 1e-9."""
    if kind == "A1":
        return same_groups(got, want, {"sum_base_price", "avg_qty", "avg_price", "avg_disc", "sd_price"}, ordered)
    return same_batch(got, want) if ordered else same_batch(as_multiset(got), as_multiset(want))


def _serving_counts(srv) -> dict:
    """A server's cumulative counters, flat, so that a run's share is the
    difference of two readings."""
    s = srv.stats()
    out = {"completed": s["completed"], "errors": s["errors"], "batches": s["batches"],
           "batched_requests": s["batchedRequests"], "bucket_evictions": s["bucketCache"]["evictions"]}
    for key, name in (("planCache", "plan"), ("bucketCache", "bucket"), ("resultCache", "result")):
        if key in s:
            out[f"{name}_hits"], out[f"{name}_misses"] = s[key]["hits"], s[key]["misses"]
    b = srv.join_build_cache.stats()
    out["build_hits"], out["build_misses"] = b["hits"], b["misses"]
    return out


def _latencies(rows, seconds=None) -> dict:
    """Requests, queries/s over ``seconds`` (completions), and latency p50
    and p99 in ms of 12l request rows ``(kind, variant, start, end, ...)``."""
    import numpy as np

    lat = np.array([r[3] - r[2] for r in rows]) * 1e3
    out = {"requests": len(rows), "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
           "p99_ms": float(np.percentile(lat, 99)) if lat.size else None}
    if seconds is not None:
        out["qps"] = len(rows) / seconds
    return out


def _fmt_ms(x) -> str:
    return "n/a" if x is None else f"{x:.3f} ms"


def run_serving(li_src: str, o_src: str, system: str, tmp: str, args, smi: str) -> dict:
    """12l: ``QueryServer(workers=4)`` at its defaults (the result cache
    and the scheduler off) over the SF1 lake and the indexes the earlier
    phases built, fed by 8 closed-loop client threads the mix of
    ``SERVING_REQUESTS`` requests (``serving_mix``), each over a fresh
    listing of the lake. The session routes as the query phases do
    (``deviceMinRows=0``, the top-k's chunk size, hybrid scan, incremental
    refreshes); row-group pruning stays on. One server serves every run, as
    a long-lived one does: a warm-up (each distinct request once: its
    bucket cache starts empty),
    a quiesced run (A, under torch.profiler: the device's busy share), then a run
    under a background ``RefreshManager`` that refreshes every index of
    ``lineitem`` after an SF1-sized file lands, once a tenth of the mix is
    served. Each client cycles through its share until the commit and then
    sends a quarter of its share more, so no client waits for the commit; that
    run's numbers are split into before, during (the refresh's own span)
    and after the commit. Then a second server with the result cache on
    serves the mix once, its hits' and misses' latencies apart. Each run
    prints queries/s, latency p50 and p99, its cache hit rates and
    micro-batches; every fifth served result, and under the refresh each
    client's first after the commit, is held to a direct
    ``collect()`` (quiesced in order; under the refresh as multisets, by
    the data version its request could see: after the commit it must hold
    the new file's rows, before the commit the old or the new rows whole;
    anything else is a stale or torn read, which fails the phase)."""
    import threading

    import numpy as np
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.lifecycle import RefreshManager
    from hyperspace_tpu_torch.ops import kernels

    files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src) if f.endswith(".parquet"))
    # T1's chunks: the 16 files in 8, as in the topk phase
    chunk = 2 * max(os.path.getsize(f) for f in files)
    conf = {ht.keys.SYSTEM_PATH: system, ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.STREAM_CHUNK_BYTES: chunk,
            ht.keys.HYBRID_SCAN_ENABLED: True, ht.keys.LIFECYCLE_REFRESH_MODE: "incremental"}
    sess = ht.Session(conf=dict(conf), device="cuda")
    sess.enable_hyperspace()
    # the direct collect()s run in a session of their own with row-group
    # pruning off: a pruned scan caches under its predicate's key, so each
    # literal would decode the index anew; the rows are the same either way
    ref = ht.Session(conf={**conf, ht.keys.EXEC_IO_ROWGROUP_PRUNING: False}, device="cuda")
    ref.enable_hyperspace()
    mix = serving_mix(args.seed)
    variants = sorted(set(mix))
    cores = os.cpu_count()

    def references(label):
        ref.index_manager.clear_cache()
        out, seconds = {}, collections.Counter()
        for kind, v in variants:
            t = time.perf_counter()
            out[kind, v] = serving_frame(ref, li_src, o_src, kind, v).collect()
            seconds[kind] += time.perf_counter() - t
        print(f"serving: {len(variants)} distinct requests collected directly ({label}): "
              + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()), flush=True)
        return out

    ref_old = references("before the append; warms the IO and device caches")
    for kind, want in (("q6", "filter: device"), ("A1", "agg: device-grouped-scan"),
                       ("J3", "join: broadcast-hash-stream"), ("T1", "topk: device-topk-stream")):
        _, summary = traced_collect(serving_frame(sess, li_src, o_src, kind, 0))
        assert any(ln.startswith(want) for ln in summary.splitlines()), (kind, summary)
        print(f"serving trace {kind}: " + "; ".join(summary.splitlines()), flush=True)

    def run(srv, label: str, refresh=None, requests=mix):
        """One closed-loop run of ``requests`` (the mix) on ``srv``: (its
        numbers, one row per request: (kind, variant, start s, end s,
        answered at submit, result or None)). ``refresh()`` runs on a thread
        of its own once a tenth of the mix is served and returns its
        timestamps when it has committed; with it, each client cycles
        through its share until the commit and sends a quarter of its share
        more after it."""
        per = [requests[i::SERVING_CLIENTS] for i in range(SERVING_CLIENTS)]
        done, errors, state = [], [], {}
        lock = threading.Lock()
        committed = threading.Event()
        start = threading.Barrier(SERVING_CLIENTS + 1)

        def client(k):
            share, j, tail = per[k], 0, 0
            try:
                start.wait()
                while j < len(share) or (refresh is not None and not (committed.is_set()
                                                                      and tail >= 0.25 * len(share))):
                    kind, v = share[j % len(share)]
                    late = committed.is_set()
                    t0 = time.perf_counter()
                    fut = srv.submit(serving_frame(sess, li_src, o_src, kind, v), timeout=600)
                    at_submit = fut.done()  # a result-cache hit resolves inside submit()
                    got = fut.result(timeout=660)
                    t1 = time.perf_counter()
                    # every fifth result, and each client's first after the commit
                    keep = (k + j * SERVING_CLIENTS) % 5 == 0 or (late and tail == 0)
                    with lock:
                        done.append((kind, v, t0, t1, at_submit, got if keep else None))
                    j += 1
                    tail += late
            except Exception as e:  # surfaced below: a client error fails the phase
                errors.append(e)

        def refresher():
            try:
                while len(done) < len(mix) // 10 and not errors:  # a tenth of the mix served first
                    time.sleep(0.005)
                if not errors:
                    state.update(refresh())
            except Exception as e:
                errors.append(e)
            finally:
                committed.set()

        c0 = _serving_counts(srv)
        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVING_CLIENTS)]
        for th in threads:
            th.start()
        start.wait()
        t_start = time.perf_counter()
        aux = threading.Thread(target=refresher) if refresh is not None else None
        if aux is not None:
            aux.start()
        for th in threads:
            th.join(900)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        if aux is not None:
            aux.join(900)
        assert not any(th.is_alive() for th in threads), f"serving {label}: a client did not finish"
        assert not errors, errors
        c = {k: v - c0.get(k, 0) for k, v in _serving_counts(srv).items()}
        assert len(done) >= len(requests) and c["errors"] == 0, (len(done), c)

        def rate(name):
            if f"{name}_hits" not in c:
                return None
            n = c[f"{name}_hits"] + c[f"{name}_misses"]
            return c[f"{name}_hits"] / n if n else None

        wall = t_end - t_start
        out = {**_latencies(done, wall), "wall_s": wall, "micro_batches": c["batches"],
               "batched_requests": c["batched_requests"], "plan_cache_hit_rate": rate("plan"),
               "result_cache_hit_rate": rate("result"), "bucket_cache_hit_rate": rate("bucket"),
               "bucket_cache_evictions": c["bucket_evictions"], "build_cache_hit_rate": rate("build"),
               "counts": c, "by_kind": {k: _latencies([r for r in done if r[0] == k]) for k in ("q6", "A1", "J3", "T1")}}
        def fmt(x):
            return "n/a" if x is None else f"{x:.3f}"

        rc = "off (the server's default)" if "result_hits" not in c else fmt(rate("result"))
        print(f"serving {label}: {len(done)} requests from {SERVING_CLIENTS} clients on {cores} host cores in "
              f"{wall:.3f} s: {out['qps']:.3f} queries/s, latency p50 {out['p50_ms']:.3f} ms, p99 "
              f"{out['p99_ms']:.3f} ms; {c['batches']} micro-batches of {c['batched_requests']} requests; hit rates: "
              f"plan cache {fmt(rate('plan'))}, result cache {rc}, bucket cache {fmt(rate('bucket'))} "
              f"({c['bucket_evictions']} evictions), build cache {fmt(rate('build'))} "
              f"({c['build_hits']} of {c['build_hits'] + c['build_misses']}) ({smi})", flush=True)
        print(f"serving {label} by kind: " + "; ".join(
            f"{k} n={v['requests']} p50 {_fmt_ms(v['p50_ms'])} p99 {_fmt_ms(v['p99_ms'])}"
            for k, v in out["by_kind"].items()), flush=True)
        if refresh is not None:
            lo, hi = state["started_at"], state["committed_at"]
            segments = {  # (its span, the requests whose latencies it reports)
                "before": ((t_start, lo), [r for r in done if r[3] <= lo]),
                "during": ((lo, hi), [r for r in done if r[2] < hi and r[3] > lo]),
                "after": ((hi, t_end), [r for r in done if r[2] >= hi]),
            }
            out["segments"] = {}
            for name, ((a, b), rows) in segments.items():
                ended = sum(1 for r in done if a < r[3] <= b)
                out["segments"][name] = {**_latencies(rows), "seconds": b - a, "completed": ended,
                                         "qps": ended / (b - a) if b > a else None}
            print(f"serving {label} by segment (before the refresh, during it: requests in flight while it "
                  f"ran, after its commit; queries/s from the requests that ended in the segment): " + "; ".join(
                      f"{k} {v['seconds']:.3f} s, {v['completed']} ended, "
                      f"{'n/a' if v['qps'] is None else format(v['qps'], '.3f')} queries/s, n={v['requests']} "
                      f"p50 {_fmt_ms(v['p50_ms'])} p99 {_fmt_ms(v['p99_ms'])}"
                      for k, v in out["segments"].items()), flush=True)
        return out, done, state

    with ht.QueryServer(sess, workers=4) as srv:
        assert srv.result_cache is None, "the server's default has no result cache"
        run(srv, "warm-up (each distinct request once)", requests=variants)

        D.reset_dispatches()
        holder = {}

        def quiesced():
            holder["out"], holder["done"], _ = run(srv, "quiesced A")

        prof = device_profile("serving (quiesced A)", quiesced, tmp)
        quiet, done = holder["out"], holder["done"]
        quiet["device_busy_share"] = None if prof["busy_ms"] is None else prof["busy_ms"] / prof["wall_ms"]
        quiet["dispatches"] = dict(D.dispatches)
        print(f"serving quiesced A dispatches: {quiet['dispatches']}", flush=True)
        checked = 0
        for kind, v, _, _, _, got in done:
            if got is not None:
                assert _same_served(kind, got, ref_old[kind, v], ordered=True), f"serving {kind}{v}: differs from collect()"
                checked += 1
        print(f"serving quiesced: {checked} sampled results equal collect() in order", flush=True)

        # under a background incremental refresh of an appended SF1 file
        n_files = len(sess.read_parquet(li_src).plan.relation.all_file_infos())
        new_path = os.path.join(li_src, f"part-{n_files:05d}.parquet")

        def refresh():
            _write_atomic(lambda p: _write_ingest_file(p, args.seed + 12, n_files, LINEITEM_ROWS_SF1 // 16, 1.0,
                                                       "1994-03-01", ORDERS_ROWS_SF1), new_path)
            started = time.perf_counter()
            outcomes = RefreshManager(sess).poll_once()
            torch.cuda.synchronize()
            return {"started_at": started, "committed_at": time.perf_counter(), "outcomes": outcomes}

        torch.cuda.synchronize()
        kernels.reset_launches()
        with KernelCapture() as cap:
            under, done, state = run(srv, "under refresh", refresh=refresh)
        refresh_launches = {k: v for k, v in kernels.launches.items() if v}
        calls = cap.check()
    outcomes = state["outcomes"]
    committed = sorted(o["index"] for o in outcomes if o["outcome"] == "committed")
    assert committed and all(o["outcome"] in ("committed", "fresh") for o in outcomes), outcomes
    assert refresh_launches.get(K1, 0) > 0 and refresh_launches.get(K2, 0) > 0, refresh_launches
    under["refresh_s"] = state["committed_at"] - state["started_at"]
    print(f"serving refresh: {LINEITEM_ROWS_SF1 // 16} rows appended; poll_once took {under['refresh_s']:.3f} s "
          f"and committed {committed}; K1/K2 launches {refresh_launches}, each call equal to its plain version "
          f"({calls}) ({smi})", flush=True)
    ref_new = references("after the commit")
    # a request that started before the commit may see either version
    # whole: it may have been admitted against the old index version
    stale = torn = checked = 0
    for kind, v, t0, _, _, got in done:
        if got is None:
            continue
        checked += 1
        new_ok = _same_served(kind, got, ref_new[kind, v], ordered=False)
        old_ok = _same_served(kind, got, ref_old[kind, v], ordered=False)
        if t0 >= state["committed_at"] and not new_ok:
            stale += 1 if old_ok else 0
            torn += 0 if old_ok else 1
        elif t0 < state["committed_at"] and not (new_ok or old_ok):
            torn += 1
    sampled = collections.Counter(
        "after" if t0 >= state["committed_at"] else "earlier" for _, _, t0, _, _, got in done if got is not None)
    assert sampled["after"] > 0 and sampled["earlier"] > 0, sampled
    under["staleness_rejections"], under["torn"], under["checked"] = stale, torn, checked
    under["refresh_launches"] = refresh_launches
    under["committed"] = committed
    print(f"serving under refresh: {checked} sampled results checked against the data version their request "
          f"could see ({sampled['after']} after the commit): {stale} stale, {torn} torn", flush=True)
    assert stale == 0 and torn == 0, (stale, torn)

    # the result cache, off by default: a server of its own, one run
    with ht.QueryServer(sess, workers=4, result_cache_enabled=True) as srv:
        cached, done, _ = run(srv, "result cache on (a new server: its bucket cache starts empty)")
    hits = [r for r in done if r[4]]
    misses = [r for r in done if not r[4]]
    cached["hits"], cached["misses"] = _latencies(hits), _latencies(misses)
    print(f"serving result cache on: {len(hits)} answered from the cache at submit, p50 "
          f"{_fmt_ms(cached['hits']['p50_ms'])} p99 {_fmt_ms(cached['hits']['p99_ms'])}; {len(misses)} misses, p50 "
          f"{_fmt_ms(cached['misses']['p50_ms'])} p99 {_fmt_ms(cached['misses']['p99_ms'])}", flush=True)
    for kind, v, _, _, _, got in done:
        if got is not None:
            assert _same_served(kind, got, ref_new[kind, v], ordered=True), f"serving cached {kind}{v}: differs"
    return {"quiesced": quiet, "under_refresh": under,
            "result_cache": cached, "host_cores": cores, "device": smi, "launches": refresh_launches}


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


class _FixedClock:
    """A settable clock for the lease's expiry (``fabric/lease.py`` takes
    one), so that the takeover below happens at the same instant in every
    run."""

    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _fabric_conf(ht, system: str, node: str, **extra) -> dict:
    """A fabric session's conf: the fabric on under ``node``; the watcher
    thread off and the sidecar's rounds an hour apart unless ``extra`` says
    otherwise (the phase polls by hand)."""
    return {ht.keys.SYSTEM_PATH: system, ht.keys.FABRIC_ENABLED: True, ht.keys.FABRIC_NODE_ID: node,
            ht.keys.FABRIC_WATCHER_ENABLED: False, ht.keys.FABRIC_SLO_PUBLISH_INTERVAL_SECONDS: 3600, **extra}


def _record_shapes(system: str, indexes) -> dict:
    """Each index's commit records as (id, seq, origin, kind, log id, the
    number of affected files): every field but the clock reading and the
    index files' generated names."""
    from hyperspace_tpu_torch.fabric import records

    return {name: [(rid, r["seq"], r["origin"], r["kind"], r["logId"], len(r["affectedFiles"]))
                   for rid, r in records.read_commit_records(records.commits_dir(system, name))]
            for name in indexes}


def check_fabric_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """fabric-small: the same sequence on a copy of one small lake (20 000
    rows of the query-small columns in 4 files), through the CPU port and
    then on the GPU, with the fabric on in every session:

    1. a writer session (node ``n1``, the refresh lease on) builds a
       covering index (K1 on the GPU) and a MinMax data-skipping index (K2);
       a file of new ids lands and ``RefreshManager.refresh_index`` refreshes
       both, each under the lake lease with its fencing token checked at
       the log write (K1 and K2 again, each call equal to its plain
       version);
    2. a second session (node ``n2``) replays the writer's commit records
       with its watcher (``poll_once``): its bus takes the writer's
       ``commit_seq``, and its queries see the new ids, equal to the
       writer's;
    3. a zombie holds the covering index's lease, stops renewing, and a
       third node takes the lease over at a fixed clock: the zombie's
       ``write_log`` under its ``fence_scope`` raises ``LeaseLostError``
       (held token against the lake's) and no log entry lands; the
       successor's lands;
    4. fsck of the lake.

    The commit records (all but their clock readings and file names), the
    lease tokens and holders, the query rows, the fsck report and the log
    ids must be equal between the two runs."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.fabric import lease as lease_mod
    from hyperspace_tpu_torch.fabric.fsck import fsck
    from hyperspace_tpu_torch.lifecycle import RefreshManager
    from hyperspace_tpu_torch.models.log_manager import IndexLogManager
    from hyperspace_tpu_torch.ops import kernels

    root = os.path.join(tmp, "fabric_small")
    base = gen_query_lake(os.path.join(root, "base"), 20_000, 4, seed + 16)
    c = ht.col
    runs = {}
    for run, device in enumerate(devices):
        t0 = time.perf_counter()
        lake = os.path.join(root, f"{run}-{device}", "lake")
        system = os.path.join(root, f"{run}-{device}", "idx")
        shutil.copytree(base, lake)
        writer = ht.Session(conf=_fabric_conf(
            ht, system, "n1", **{ht.keys.FABRIC_LEASE_ENABLED: True, ht.keys.FABRIC_LEASE_TTL_SECONDS: 30.0,
                                 ht.keys.FABRIC_LEASE_RENEW_INTERVAL_SECONDS: 10.0, ht.keys.NUM_BUCKETS: 8,
                                 ht.keys.DEVICE_MIN_ROWS: 0}), device=device)
        reader = ht.Session(conf=_fabric_conf(ht, system, "n2", **{ht.keys.DEVICE_MIN_ROWS: 0}), device=device)
        try:
            _sync(device)
            kernels.reset_launches()
            with KernelCapture() as cap:
                hs = ht.Hyperspace(writer)
                hs.create_index(writer.read_parquet(lake), ht.CoveringIndexConfig("fab_id", ["id"], ["z", "f", "s"]))
                hs.create_index(writer.read_parquet(lake), ht.DataSkippingIndexConfig("fab_skip", ht.MinMaxSketch("id")))
                replayed = [reader.fabric.watcher.poll_once()]
                rng = np.random.default_rng(seed + 16)
                extra = 3000
                _write_atomic(lambda p: pq.write_table(pa.table({
                    "id": np.arange(50_000, 50_000 + extra, dtype=np.int64), "z": rng.integers(-3, 4, extra),
                    "f": np.round(rng.standard_normal(extra), 1),
                    "n": pa.array(rng.integers(0, 9, extra)),
                    "d": np.datetime64("1997-01-01") + rng.integers(0, 30, extra).astype("timedelta64[D]"),
                    "s": np.array([f"s{x}" for x in rng.integers(0, 60, extra)], dtype=object),
                }), p), os.path.join(lake, "part-00004.parquet"))
                manager = RefreshManager(writer)
                outcomes = [manager.refresh_index(name, "incremental") for name in ("fab_id", "fab_skip")]
                _sync(device)
            launches = {k: v for k, v in kernels.launches.items() if v}
            calls = cap.check()
            assert outcomes == ["committed", "committed"], outcomes
            replayed.append(reader.fabric.watcher.poll_once())
            assert replayed == [2, 2], replayed
            assert reader.lifecycle_bus.commit_seq == writer.lifecycle_bus.commit_seq == 4
            rows = {}
            for s, who in ((writer, "writer"), (reader, "reader")):
                s.enable_hyperspace()
                q = s.read_parquet(lake).filter((c("id") >= 49_000) & (c("z") != 0)).select("id", "z", "f", "s")
                got, summary = traced_collect(q)
                assert plan_index_scans(q.optimized_plan()), f"fabric-small {who}: the query used no index"
                assert int(np.count_nonzero(got["id"] >= 50_000)) > 0, f"fabric-small {who}: stale"
                rows[who] = got
            assert same_batch(rows["reader"], rows["writer"]), "fabric-small: the replaying session differs"

            # a zombie writer: its lease expired and a peer took it over
            clock = _FixedClock(1.0e9)
            zombie = lease_mod.acquire(system, "refresh/fab_id", "zombie", ttl_s=10.0, clock=clock)
            clock.t += 11.0
            successor = lease_mod.acquire(system, "refresh/fab_id", "n3", ttl_s=10.0, clock=clock)
            log = IndexLogManager(os.path.join(system, "fab_id"))
            latest = log.get_latest_id()
            with lease_mod.fence_scope(zombie):
                try:
                    log.write_log(latest + 1, log.get_latest_log())
                    raise AssertionError("fabric-small: the zombie's log write landed")
                except lease_mod.LeaseLostError as e:
                    fenced = (e.held_token, e.current_token)
            assert log.get_latest_id() == latest, "fabric-small: a fenced write left a log entry"
            with lease_mod.fence_scope(successor):
                assert log.write_log(latest + 1, log.get_latest_log())
            successor.release()
            tokens = {}
            for name in ("refresh/fab_id", "refresh/fab_skip"):
                token, state = lease_mod.read_state(system, name)
                tokens[name] = (token, (state or {}).get("holder"))
            report = fsck(system, clock=lambda: 1.0e9 + 7200.0)
            report["systemPath"] = "<lake>"
        finally:
            writer.fabric.stop()
            reader.fabric.stop()
        runs[run] = {
            "records": _record_shapes(system, ("fab_id", "fab_skip")), "tokens": tokens, "fenced": fenced,
            "log_id": latest + 1, "fsck": report, "replayed": replayed, "launches": launches, "calls": calls,
            "rows": rows["reader"], "seconds": time.perf_counter() - t0,
        }
        print(f"fabric-small {device}: {runs[run]['seconds']:.3f} s; records {runs[run]['records']}; "
              f"replayed {replayed}; zombie fenced (held, lake) {fenced}; lease states {tokens}; fsck removed "
              f"{report['removed']}; kernel launches {launches}", flush=True)
    cpu, gpu = 0, 1
    for key in ("records", "tokens", "fenced", "log_id", "fsck", "replayed"):
        assert runs[gpu][key] == runs[cpu][key], (f"fabric-small {key}: GPU differs from CPU", runs[gpu][key],
                                                  runs[cpu][key])
    assert same_batch(runs[gpu]["rows"], runs[cpu]["rows"]), "fabric-small: the GPU's rows differ from the CPU's"
    if devices[gpu] == "cuda":
        assert runs[gpu]["launches"].get(K1, 0) > 0 and runs[gpu]["launches"].get(K2, 0) > 0, runs[gpu]["launches"]
    print(f"fabric-small: GPU == CPU port (records, lease tokens, the fenced zombie, log ids, fsck, "
          f"{len(runs[gpu]['rows']['id'])} rows)", flush=True)
    return {"launches": runs[gpu]["launches"], "seconds": {devices[i]: r["seconds"] for i, r in runs.items()},
            "records": runs[gpu]["records"], "fsck": runs[gpu]["fsck"]["removed"], "fenced": runs[gpu]["fenced"]}


#: a fabric worker: one process with its own CUDA context on the card, a
#: ``QueryServer`` behind a ``WorkerEndpoint``, the commit watcher and the
#: coherence sidecar on. It imports the port only. argv: the repo root and a
#: JSON object (conf, device, server name, lake paths, the replay log). It
#: prints one JSON line (its URL) once it serves, and serves until its
#: standard input closes. Every replayed commit re-resolves the served views
#: (a DataFrame keeps the listing it was read with) and then appends the
#: commit and the wall time to the replay log; it subscribes after the
#: server, so its line is written once every other subscriber has run.
FABRIC_WORKER = r'''
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import hyperspace_tpu_torch as ht
from hyperspace_tpu_torch.fabric import WorkerEndpoint
from hyperspace_tpu_torch.serving import QueryServer

sess = ht.Session(conf=cfg["conf"], device=cfg["device"])
sess.enable_hyperspace()


def views():
    sess.register_view("lineitem", sess.read_parquet(cfg["lineitem"]))
    sess.register_view("orders", sess.read_parquet(cfg["orders"]))


views()
with QueryServer(sess, workers=cfg["threads"], name=cfg["name"]) as srv, WorkerEndpoint(srv) as ep:
    def replayed(event):
        views()
        with open(cfg["replays"], "a") as f:
            f.write(json.dumps({"index": event.index_name, "kind": event.kind, "logId": event.log_id,
                                "origin": event.origin, "seq": sess.lifecycle_bus.commit_seq,
                                "at": time.time()}) + "\n")

    sess.lifecycle_bus.subscribe(replayed)
    print(json.dumps({"url": ep.url, "pid": os.getpid(), "device": str(sess.device),
                      "node": sess.fabric.node_id}), flush=True)
    sys.stdin.readline()
'''

FABRIC_WORKERS = 2
FABRIC_REQUESTS = 24  # 12 q6, 5 A1, 5 J3, 2 T1 (the 12l mix's shares) over 5 distinct texts
FABRIC_CLIENTS = 4
FABRIC_TENANTS = 8


def fabric_sql(kind: str, v: int) -> str:
    """The 12l requests as SQL text, which is what a FrontDoor forwards:
    q6's filter with ``l_quantity < 9 + v``, A1 (q1 over plain columns,
    shipped by a cut-off ``v`` weeks before 1998-09-02, in group order), J3
    (a month of ``lineitem`` joined to ``orders`` above an
    ``o_totalprice``) and T1 (the 100 dearest lines)."""
    import numpy as np

    if kind == "q6":
        return ("select l_extendedprice, l_discount from lineitem where l_shipdate >= date '1994-01-01' "
                "and l_shipdate < date '1995-01-01' and l_discount >= 0.05 and l_discount <= 0.07 "
                f"and l_quantity < {9 + v}")
    if kind == "A1":
        cut = np.datetime64("1998-09-02") - np.timedelta64(7 * v, "D")
        return ("select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, sum(l_extendedprice) as "
                "sum_base_price, avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, avg(l_discount) "
                f"as avg_disc, count(*) as count_order from lineitem where l_shipdate <= date '{cut}' "
                "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
    if kind == "J3":
        return ("select l_orderkey, l_extendedprice, o_custkey, o_totalprice from lineitem, orders "
                "where l_orderkey = o_orderkey and l_shipdate >= date '1994-03-01' "
                f"and l_shipdate < date '1994-04-01' and o_totalprice > {250000.0 + 100000.0 * v}")
    return ("select l_orderkey, l_partkey, l_extendedprice, l_shipdate from lineitem "
            "order by l_extendedprice desc limit 100")


def fabric_mix(seed: int) -> list:
    """``FABRIC_REQUESTS`` requests in a seeded order, each with a tenant:
    (tenant, kind, variant). Five distinct texts (q6 at two literals), so
    that each one's direct ``collect()``, before and after the refresh,
    stays within the phase's time."""
    import numpy as np

    mix = [("q6", i % 2) for i in range(12)] + [("A1", 0)] * 5 + [("J3", 0)] * 5 + [("T1", 0)] * 2
    rng = np.random.default_rng(seed + 16)
    order = rng.permutation(len(mix))
    return [(f"tenant{int(rng.integers(0, FABRIC_TENANTS))}",) + mix[i] for i in order]


def wire(batch) -> dict:
    """A collected batch as a FrontDoor hands it back from a worker: JSON
    columns (``WorkerEndpoint``'s encoding) read into numpy arrays."""
    import numpy as np

    body = json.loads(json.dumps({"columns": {k: v.tolist() for k, v in batch.items()}}, default=str))
    return {k: np.asarray(v) for k, v in body["columns"].items()}


def _same_routed(kind: str, got, want) -> bool:
    """A routed result against a direct ``collect()`` through the same
    wire: A1 in group order with its float aggregates at rtol 1e-9, the
    others as multisets of rows."""
    if kind == "A1":
        return same_groups(got, want, {"sum_base_price", "avg_qty", "avg_price", "avg_disc"}, ordered=True)

    def rows(batch):
        return sorted(zip(*(v.tolist() for v in batch.values())), key=repr)

    return list(got) == list(want) and rows(got) == rows(want)


def _read_line(proc, timeout: float) -> str:
    """The next line of a child's standard output, or an error after
    ``timeout`` seconds."""
    import queue
    import threading

    box = queue.Queue()
    threading.Thread(target=lambda: box.put(proc.stdout.readline()), daemon=True).start()
    try:
        return box.get(timeout=timeout)
    except queue.Empty:
        raise AssertionError(f"fabric: worker {proc.pid} printed nothing in {timeout:.0f} s") from None


def parse_prometheus(text: str) -> dict:
    """A Prometheus 0.0.4 exposition as {family: [(labels, value)]}; a line
    that does not parse, or a family whose ``# TYPE`` comes twice, fails."""
    import re

    families, typed = {}, set()
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[^"}]|"(?:[^"\\]|\\.)*")*\})? (\S+)$')
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            name = line.split()[2]
            assert name not in typed, f"fabric: {name} typed twice in the merged exposition"
            typed.add(name)
            continue
        if line.startswith("#"):
            continue
        m = sample.match(line)
        assert m is not None, f"fabric: unparseable exposition line {line!r}"
        float(m.group(3))
        families.setdefault(m.group(1), []).append((m.group(2) or "", float(m.group(3))))
    return families


def run_fabric(li_src: str, o_src: str, system: str, tmp: str, args, smi: str, device: str = "cuda") -> dict:
    """fabric: the scale-out fabric over the SF1 lake and the indexes the
    earlier phases built. Two worker processes (``FABRIC_WORKER``), each
    with its own CUDA context on the one card, serve behind their
    ``WorkerEndpoint``s with the watcher (25 ms polls) and the sidecar on; a
    ``FrontDoor`` in this process, health on, routes ``FABRIC_REQUESTS``
    SQL requests of the 12l mix from ``FABRIC_CLIENTS`` closed-loop client
    threads over ``FABRIC_TENANTS`` tenants (rendezvous hashing). Then an
    SF1 ``lineitem`` file of new orders lands, and this process, as the
    fabric's writer (the lease on, its watcher off), refreshes
    ``li_shipdate`` (K1) and ``li_skip`` (K2) under the lake lease, each
    kernel call equal to its plain version. Each worker replays both
    commit records; the requests admitted after both replays run again
    through the FrontDoor and must see the new rows (0 stale, 0 torn). Every
    routed result equals a direct ``collect()`` of the same text in this
    process over the listing it could see, through the same JSON wire. The
    FrontDoor's merged ``/metrics`` must parse and carry both workers'
    ``server`` series. Prints queries/s and latency p50 and p99 through the
    FrontDoor, each worker's replay lag (from the commit record's time to
    the replay) and the refresh's seconds."""
    import subprocess
    import threading

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.fabric import FrontDoor, records
    from hyperspace_tpu_torch.lifecycle import RefreshManager
    from hyperspace_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src) if f.endswith(".parquet"))
    chunk = 2 * max(os.path.getsize(f) for f in files)
    serving_conf = {ht.keys.SYSTEM_PATH: system, ht.keys.DEVICE_MIN_ROWS: 0, ht.keys.STREAM_CHUNK_BYTES: chunk,
                    ht.keys.HYBRID_SCAN_ENABLED: True}
    root = os.path.join(tmp, "fabric")
    os.makedirs(root, exist_ok=True)
    names = [f"qs{i}" for i in range(FABRIC_WORKERS)]
    procs, logs, writer = [], [], None
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()  # the earlier phases' cached blocks: room for the workers' contexts
    try:
        t = time.perf_counter()
        for name in names:
            cfg = {"device": device, "name": name, "threads": 2, "lineitem": li_src, "orders": o_src,
                   "replays": os.path.join(root, f"{name}.replays.jsonl"),
                   "conf": {**serving_conf, ht.keys.FABRIC_ENABLED: True, ht.keys.FABRIC_NODE_ID: name,
                            ht.keys.FABRIC_POLL_INTERVAL_SECONDS: 0.025}}
            log = open(os.path.join(root, f"{name}.stderr"), "w")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, "-c", FABRIC_WORKER, HERE, json.dumps(cfg)],
                                          stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log, text=True))
        hello = []
        for proc, name in zip(procs, names):
            line = _read_line(proc, 120.0)
            if not line:
                proc.wait(timeout=30)
                with open(os.path.join(root, f"{name}.stderr")) as f:
                    raise AssertionError(f"fabric: worker {name} exited {proc.returncode}: {f.read()[-3000:]}")
            hello.append(json.loads(line))
        assert all(h["device"].startswith(device) for h in hello), hello
        started_s = time.perf_counter() - t
        print(f"fabric: {len(procs)} workers serving in {started_s:.3f} s: " + ", ".join(
            f"{h['node']} pid {h['pid']} on {h['device']} at {h['url']}" for h in hello), flush=True)

        writer = ht.Session(conf=_fabric_conf(ht, system, "writer", **{
            **serving_conf, ht.keys.FABRIC_LEASE_ENABLED: True, ht.keys.FABRIC_HEALTH_ENABLED: True,
            ht.keys.LIFECYCLE_REFRESH_MODE: "incremental"}), device=device)
        writer.enable_hyperspace()
        door = FrontDoor([h["url"] for h in hello], conf=writer.conf)
        mix = fabric_mix(args.seed)
        variants = sorted({(k, v) for _, k, v in mix})

        def direct(label):
            """Each distinct request collected directly here, over the
            current listing, through the JSON wire."""
            writer.register_view("lineitem", writer.read_parquet(li_src))
            writer.register_view("orders", writer.read_parquet(o_src))
            out = {}
            t0 = time.perf_counter()
            for kind, v in variants:
                out[kind, v] = wire(writer.sql(fabric_sql(kind, v)).collect())
            print(f"fabric: {len(variants)} distinct requests collected directly ({label}) in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            return out

        def routed(label, requests):
            per = [requests[i::FABRIC_CLIENTS] for i in range(FABRIC_CLIENTS)]
            done, errors = [], []
            lock = threading.Lock()

            def client(share):
                try:
                    for tenant, kind, v in share:
                        t0 = time.perf_counter()
                        got = door.query(fabric_sql(kind, v), tenant=tenant, timeout=300)
                        t1 = time.perf_counter()
                        with lock:
                            done.append((kind, v, t0, t1, tenant, got))
                except Exception as e:  # surfaced below: a failed request fails the phase
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(share,)) for share in per]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t0
            assert not any(th.is_alive() for th in threads), f"fabric {label}: a client did not finish"
            assert not errors, errors
            out = {**_latencies(done, wall), "wall_s": wall,
                   "by_worker": dict(collections.Counter(door.pick(r[4]) for r in done))}
            print(f"fabric {label}: {len(done)} requests through the FrontDoor from {FABRIC_CLIENTS} clients in "
                  f"{wall:.3f} s: {out['qps']:.3f} queries/s, latency p50 {out['p50_ms']:.3f} ms, p99 "
                  f"{out['p99_ms']:.3f} ms; by worker {out['by_worker']} ({smi})", flush=True)
            return out, done

        before = direct("the listing the workers read")
        first, done = routed("before the refresh", mix)
        assert len(first["by_worker"]) == len(procs), f"fabric: a worker got no request {first['by_worker']}"
        for kind, v, _, _, _, got in done:
            assert _same_routed(kind, got, before[kind, v]), f"fabric {kind}{v}: differs from collect()"

        # an SF1 file of new orders lands; the writer refreshes under the lease
        n_files = len(files)
        new_path = os.path.join(li_src, f"part-{n_files:05d}.parquet")
        _write_atomic(lambda p: _write_ingest_file(p, args.seed + 16, n_files, LINEITEM_ROWS_SF1 // 16, 1.0,
                                                   "1994-05-01", 2 * ORDERS_ROWS_SF1), new_path)
        _sync(device)
        kernels.reset_launches()
        manager = RefreshManager(writer)
        with KernelCapture() as cap:
            t = time.perf_counter()
            outcomes = {name: manager.refresh_index(name, "incremental") for name in ("li_shipdate", "li_skip")}
            _sync(device)
            refresh_s = time.perf_counter() - t
        launches = {k: v for k, v in kernels.launches.items() if v}
        calls = cap.check()
        assert outcomes == {"li_shipdate": "committed", "li_skip": "committed"}, outcomes
        if device == "cuda":
            assert launches.get(K1, 0) > 0 and launches.get(K2, 0) > 0, launches
        commits = {}
        for name in ("li_shipdate", "li_skip"):
            rid, rec = records.read_commit_records(records.commits_dir(system, name))[-1]
            assert rec["origin"] == "writer" and rec["kind"] == "refresh-incremental", rec
            commits[name] = rec
        print(f"fabric refresh: {LINEITEM_ROWS_SF1 // 16} rows landed; li_shipdate and li_skip refreshed under the "
              f"lease in {refresh_s:.3f} s ({outcomes}); launches {launches}, each call equal to its plain version "
              f"({calls}) ({smi})", flush=True)

        # each worker replays both commit records
        lags, deadline = {}, time.perf_counter() + 60.0
        for name in names:
            want = {(n, r["logId"]) for n, r in commits.items()}
            while True:
                path = os.path.join(root, f"{name}.replays.jsonl")
                seen = []
                if os.path.exists(path):
                    with open(path) as f:
                        seen = [json.loads(ln) for ln in f if ln.strip()]
                got = {(r["index"], r["logId"]): r for r in seen if r["origin"] == "writer"}
                if want <= set(got):
                    break
                assert time.perf_counter() < deadline, f"fabric: {name} did not replay {want} ({seen})"
                time.sleep(0.01)
            lags[name] = {n: got[n, r["logId"]]["at"] - r["ts"] for n, r in commits.items()}
        print(f"fabric replay lag (commit record to the worker's replay, wall clock): " + "; ".join(
            f"{w} " + ", ".join(f"{n} {1e3 * s:.3f} ms" for n, s in v.items()) for w, v in lags.items())
            + f" ({smi})", flush=True)

        after = direct("the new listing")
        second, done = routed("after the replay", mix)
        stale = torn = 0
        for kind, v, _, _, _, got in done:
            if not _same_routed(kind, got, after[kind, v]):
                if _same_routed(kind, got, before[kind, v]):
                    stale += 1
                else:
                    torn += 1
        new_rows = sum(1 for k in variants if k[0] in ("q6", "A1") and not _same_routed(k[0], after[k], before[k]))
        assert new_rows > 0, "fabric: the new file changed no q6 or A1 answer"
        print(f"fabric after the replay: {len(done)} routed results against the new listing: {stale} stale, "
              f"{torn} torn ({new_rows} of the distinct q6 and A1 answers changed with the new file)", flush=True)
        assert stale == 0 and torn == 0, (stale, torn)

        families = parse_prometheus(door.metrics_text())
        servers = {name: sum(1 for series in families.values() for labels, _ in series
                             if f'server="{name}"' in labels) for name in names}
        assert all(servers.values()), f"fabric: the merged /metrics lacks a worker's series {servers}"
        seqs = {labels: v for labels, v in families.get("hs_fabric_commit_seq", [])}
        print(f"fabric merged /metrics: {len(families)} families, series per worker {servers}, "
              f"hs_fabric_commit_seq {seqs}", flush=True)
    finally:
        if writer is not None:
            writer.fabric.stop()
        for proc in procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), f"fabric: worker exit codes {codes}"
    seconds = time.perf_counter() - t_phase
    return {"workers": len(procs), "started_s": started_s, "before": first, "after": second, "lags_s": lags,
            "refresh_s": refresh_s, "launches": launches, "stale": stale, "torn": torn, "series": servers,
            "seconds": seconds, "device": smi}


# --------------------------------------------------------------------------
# the mesh-sharded path: mesh-small and mesh
# --------------------------------------------------------------------------

MESH_SHARDS = 4  # the shards of the mesh the phases lay over cuda:0


def mesh_queries(li, c, a1_chunk: int, src_chunk: int) -> dict:
    """{name: (DataFrame, hyperspace on, conf, sharded dispatch family, the
    trace line)}: q6's filter through ``li_sd``/``li_shipdate``, A1 through
    ``li_q1`` unstreamed and streamed, T1 over the source in chunks, and
    the fused folds: FA1d (A1 grouped by ``l_discount``, a float key: A1's
    string keys stay per-family) and FT1."""
    import numpy as np

    import hyperspace_tpu_torch as ht

    k = ht.keys
    q1_aggs = dict(sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
                   avg_qty=("l_quantity", "avg"), avg_price=("l_extendedprice", "avg"),
                   avg_disc=("l_discount", "avg"), count_order=("*", "count"),
                   sd_price=("l_extendedprice", "stddev_samp"))
    streamed = {k.STREAM_AGG_MIN_BYTES: 1, k.STREAM_CHUNK_BYTES: a1_chunk}
    t1 = li.order_by("l_extendedprice", ascending=[False]).limit(100)
    fa1d = li.filter(c("l_shipdate") <= np.datetime64("1998-09-02")).group_by("l_discount").agg(**q1_aggs)
    return {
        "q6": (q6_query(li), True, {}, "fused-filter", "filter: device-sharded x1"),
        "A1": (q1_query(li), True, {k.STREAM_AGG_MIN_BYTES: 1 << 40}, "sharded-grouped",
               "agg: device-grouped-scan x1"),
        "A1s": (q1_query(li), True, streamed, "sharded-grouped", "agg: device-grouped-stream-sharded x1"),
        "T1": (t1, False, {k.STREAM_CHUNK_BYTES: src_chunk}, "sharded-topk", "topk: device-topk-stream-sharded x1"),
        "FA1d": (fa1d, True, {**streamed, k.FUSION_ENABLED: True}, "fused-stage-agg-sharded",
                 "agg: device-grouped-stream-sharded x1"),
        "FT1": (t1, False, {k.STREAM_CHUNK_BYTES: src_chunk, k.FUSION_ENABLED: True}, "fused-stage-topk-sharded",
                "topk: device-topk-stream-sharded x1"),
    }


def _mesh_session(system: str, device: str, mesh=None, **conf):
    """A session over ``system`` with the parallel path on (``minRows``
    0, ``deviceMinRows`` 0) over ``mesh`` (the session's own when None)."""
    import hyperspace_tpu_torch as ht

    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.DEVICE_MIN_ROWS: 0,
                            ht.keys.PARALLEL_ENABLED: True, ht.keys.PARALLEL_MIN_ROWS: 0, **conf}, device=device)
    if mesh is not None:
        sess.set_mesh(mesh)
    return sess


def _mesh_run(sess, q, hs_on: bool, conf: dict, parallel: bool = True):
    """(rows, trace summary, wall ms, sharded-program seconds, dispatches)
    of one ``collect()`` of ``q`` under ``conf``, the parallel path on or
    off; the conf is restored after."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    saved = {key: sess.conf.get(key) for key in list(conf) + [ht.keys.PARALLEL_ENABLED]}
    for key, v in {**conf, ht.keys.PARALLEL_ENABLED: parallel}.items():
        sess.conf.set(key, v)
    if hs_on:
        sess.enable_hyperspace()
    else:
        sess.disable_hyperspace()
    mesh_s = REGISTRY.counter("hs_mesh_collective_seconds_total")
    filt = REGISTRY.histogram("hs_device_program_seconds", program="fused-filter")
    before = (mesh_s.value, filt.sum, collections.Counter(D.dispatches))
    try:
        if sess.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        got, summary = traced_collect(q)
        ms = (time.perf_counter() - t) * 1e3
    finally:
        for key, v in saved.items():
            sess.conf.set(key, v)
    D.resolve_program_timings()
    programs_s = (mesh_s.value - before[0]) + (filt.sum - before[1] if parallel else 0.0)
    return got, summary, ms, programs_s, dict(collections.Counter(D.dispatches) - before[2])


def _same_mesh_rows(name: str, got, want, q) -> bool:
    if name in ("A1", "A1s", "FA1d"):
        return same_groups(got, want, float_aggs_of(q), ordered=True)
    return same_batch(got, want)


def check_mesh_small(tmp: str, seed: int, devices=("cpu", "cuda")) -> dict:
    """The sharded path on a small lake (60 000 ``lineitem`` rows in 4
    files), in a CPU session (the plain versions) and a GPU session, each
    over a 4-shard mesh (4 x cpu; 4 x cuda:0) with ``parallel.enabled``
    and ``minRows`` 0: ``li_sd`` and ``li_q1`` built through the exchange,
    their bucket files equal byte for byte between the two and to a
    single-device build; then q6, A1, streamed A1, T1, FA1d and FT1 (two
    files a chunk): the GPU rows equal the CPU port's (floats at rtol
    1e-9) and the GPU's single-device rows, each through its sharded
    program family, with no fallback."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.parallel import make_mesh
    from hyperspace_tpu_torch.parallel import mesh as PM

    src = gen_lineitem(os.path.join(tmp, "mesh_small"), 60_000, 4, seed + 17)
    configs = [
        ht.CoveringIndexConfig("li_sd", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]),
        ht.CoveringIndexConfig("li_q1", ["l_shipdate"], ["l_returnflag", "l_linestatus", "l_quantity",
                                                         "l_extendedprice", "l_discount", "l_tax"]),
    ]
    files = sorted(os.path.join(src, f) for f in os.listdir(src))
    chunk = 2 * max(os.path.getsize(f) for f in files)
    digests, results = {}, {}
    for device in ("single",) + tuple(devices):
        system = os.path.join(tmp, f"mesh_small_{device}")
        if device == "single":  # the plain build, on the card when the phase runs there
            sess = ht.Session(conf={ht.keys.SYSTEM_PATH: system, ht.keys.NUM_BUCKETS: 16}, device=devices[-1])
        else:
            shard = "cpu" if device == "cpu" else "cuda:0"
            sess = _mesh_session(system, device, make_mesh(devices=[shard] * MESH_SHARDS),
                                 **{ht.keys.NUM_BUCKETS: 16})
        PM.reset_collectives()
        li = sess.read_parquet(src)
        for cfg in configs:
            entry = ht.Hyperspace(sess).create_index(li, cfg)
            digests[device, cfg.index_name] = {b: sorted(open(f, "rb").read() for f in fs)
                                               for b, fs in _files_by_bucket(entry).items()}
        exchanges = PM.collective_calls[("all_to_all", "buckets")]
        assert exchanges == (0 if device == "single" else len(configs)), (device, exchanges)
        if device == "single":
            continue
        qs = mesh_queries(sess.read_parquet(src), ht.col, 1, chunk)
        out = results[device] = {}
        for name, (q, hs_on, conf, family, line) in qs.items():
            got, summary, _, _, disp = _mesh_run(sess, q, hs_on, conf)
            assert_no_fallback(summary, f"mesh-small {name} on {device}")
            assert line in summary, (device, name, summary)
            assert disp.get(family, 0) > 0, (device, name, disp)
            want = _mesh_run(sess, q, hs_on, conf, parallel=False)[0]
            assert _same_mesh_rows(name, got, want, q), f"mesh-small {name} on {device}: differs from one device"
            out[name] = (got, q, disp)
    for cfg in configs:
        name = cfg.index_name
        assert all(digests[d, name] == digests["single", name] for d in devices), \
            f"mesh-small {name}: the exchange build's bucket files differ"
    last = devices[-1]
    for name, (got, q, _) in results[last].items():
        assert _same_mesh_rows(name, got, results[devices[0]][name][0], q), f"mesh-small {name}: GPU differs from CPU"
    disp = {name: {k: v for k, v in r[2].items() if v} for name, r in results[last].items()}
    print(f"mesh-small: {MESH_SHARDS}-shard meshes (cpu, cuda:0): li_sd and li_q1 through the exchange, bucket files "
          f"GPU == CPU == single device; q6, A1, A1s, T1, FA1d, FT1: GPU == CPU port == one device, dispatches "
          f"{disp}", flush=True)
    D.reset_dispatches()
    return {"dispatches": disp}


def _files_by_bucket(entry) -> dict:
    from hyperspace_tpu_torch.indexes.covering import bucket_of_file

    out = {}
    for f in entry.content.files:
        out.setdefault(bucket_of_file(f), []).append(f)
    return out


class ShardedCapture:
    """The five functions of ``parallel/collectives.py`` that make the
    sharded programs, and the build's exchange, wrapped while installed:
    each program made keeps its first call's arguments (and its maker's),
    so it can be timed alone on them beside its single-device twin
    afterwards."""

    NAMES = {"sharded_elementwise": "sharded-filter", "sharded_grouped_chunk_program": "sharded-grouped",
             "sharded_fused_grouped_program": "fused-stage-agg-sharded",
             "sharded_topk_chunk_program": "sharded-topk", "sharded_fused_topk_program": "fused-stage-topk-sharded"}

    def __enter__(self):
        from hyperspace_tpu_torch.ops import bucketize as BZ
        from hyperspace_tpu_torch.parallel import collectives as C

        self.seen = {}
        self.real = {n: getattr(C, n) for n in self.NAMES}
        self.real_build = BZ.distributed_bucket_sort_build
        seen = self.seen

        def wrap(n):
            def make(*bargs):
                prog = self.real[n](*bargs)

                def program(*args):
                    seen.setdefault(self.NAMES[n], (prog, bargs, args))  # each family's first call
                    return prog(*args)

                return program

            return make

        def build(*args):
            seen.setdefault("exchange-build", (self.real_build, None, args))
            return self.real_build(*args)

        for n in self.NAMES:
            setattr(C, n, wrap(n))
        BZ.distributed_bucket_sort_build = build
        return self

    def __exit__(self, *exc):
        from hyperspace_tpu_torch.ops import bucketize as BZ
        from hyperspace_tpu_torch.parallel import collectives as C

        for n, fn in self.real.items():
            setattr(C, n, fn)
        BZ.distributed_bucket_sort_build = self.real_build


def sharded_program_times(seen: dict, n_dev: int, reps: int, hbm: float) -> dict:
    """Each captured sharded program alone (CUDA events, median of
    ``reps``) beside its single-device twin on the same inputs and its
    bound: every input read once and every output written once over the
    card's memory rate."""
    import torch

    from hyperspace_tpu_torch.exec import aggregate as A
    from hyperspace_tpu_torch.ops import sort as S

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    out = {}
    for family, (prog, bargs, args) in seen.items():
        if family == "sharded-filter":
            cols, lits = args
            n = next(iter(cols.values())).shape[0]
            twin, moved = (lambda: bargs[2](cols, lits)), nbytes(*cols.values()) + n
            shape = f"{n} rows, {len(cols)} columns"
        elif family in ("sharded-grouped", "fused-stage-agg-sharded"):
            _, _, pred_fn, key_specs, slot_specs, cap = bargs
            cols = args[4] if family == "fused-stage-agg-sharded" else args[0]
            n = args[6] if family == "fused-stage-agg-sharded" else args[2]
            tables = (1 + len(key_specs) + len(slot_specs)) * cap * 8
            if family == "sharded-grouped":
                single = A.grouped_chunk_program(pred_fn, key_specs, slot_specs, cap)
                moved = nbytes(*cols.values()) + tables
            else:
                single = A.fused_grouped_update_program(pred_fn, key_specs, slot_specs, cap, False)
                moved = nbytes(*cols.values()) + 2 * tables
            twin = (lambda single=single: single(*args))
            shape = f"{n} rows, {len(key_specs)} keys, {len(slot_specs)} slots, cap {cap}"
        elif family in ("sharded-topk", "fused-stage-topk-sharded"):
            _, _, num_keys, cap = bargs
            planes = args[-1]
            single = S.topk_chunk_fn(num_keys, cap) if family == "sharded-topk" else S.fused_topk_fn(num_keys, cap)
            twin = (lambda single=single: single(*args))
            moved = nbytes(planes) + (num_keys + 1) * cap * 8 * (1 if family == "sharded-topk" else 3)
            shape = f"({num_keys + 1}, {planes.shape[1]}) int64 planes, cap {cap}"
        else:  # exchange-build
            mesh, keys, hashes, kinds, ridx, n_valid, nb, cap = args
            ins = [t for k in keys for t in k] + [t for h in hashes for t in h] + list(ridx)
            moved = nbytes(*ins) + n_dev * n_dev * cap * 9
            twin = None
            shape = f"{n_valid} rows over {n_dev} shards, {len(keys)} keys, {nb} buckets, capacity {cap}"
        b_ms, b_by = bound(moved, 0, hbm)
        ms = time_ms(lambda prog=prog, args=args: prog(*args), reps)
        out[family] = {"shape": shape, "ms": ms, "single_device_ms": time_ms(twin, reps) if twin else None,
                       "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms}
    return out


def run_mesh(sess, li_src: str, a1_chunk: int, entries: dict, args, smi: str, hbm: float) -> dict:
    """The sharded path at SF1 over the main lake and its indexes, under
    two meshes: the card's own (one device) and a 4-shard mesh on cuda:0.
    Per mesh: q6, A1, streamed A1, T1, FA1d and FT1 with
    ``parallel.enabled`` and ``minRows`` 0, each a first and a warm run and
    one with the parallel path off: rows equal (floats at rtol 1e-9), the
    sharded family dispatched, no fallback; the sharded programs' seconds
    (CUDA events: ``hs_mesh_collective_seconds_total`` and the filter's
    ``hs_device_program_seconds``) and dispatches per query; then each
    sharded program alone on the warm run's inputs beside its single-device
    twin and its bound. Then ``li_shipdate`` built under each mesh: on the
    card's one device the plain build (K1, each call against its plain
    version) with a MinMax sketch (K2), on the 4-shard mesh through the
    exchange (its overflow count and the exchange alone timed); every
    bucket file equal byte for byte to the main build's."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.ops import bucketize as BZ
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.parallel import make_mesh

    files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src))
    src_chunk = 2 * max(os.path.getsize(f) for f in files)
    meshes = {"1-device": make_mesh(device_type="cuda"),
              f"{MESH_SHARDS}-shard": make_mesh(devices=["cuda:0"] * MESH_SHARDS)}
    assert meshes["1-device"].size == torch.cuda.device_count()
    reps = 3
    out = {"meshes": {}, "builds": {}}
    main_files = {b: sorted(open(f, "rb").read() for f in fs)
                  for b, fs in _files_by_bucket(entries["li_shipdate"]).items()}
    for label, mesh in meshes.items():
        msess = _mesh_session(sess.conf.system_path, "cuda", mesh)
        qs = mesh_queries(msess.read_parquet(li_src), ht.col, a1_chunk, src_chunk)
        res = out["meshes"][label] = {"shards": mesh.size, "queries": {}}
        with ShardedCapture() as cap:
            for name, (q, hs_on, conf, family, line) in qs.items():
                first = _mesh_run(msess, q, hs_on, conf)
                got, summary, warm_ms, programs_s, disp = _mesh_run(msess, q, hs_on, conf)
                assert_no_fallback(summary, f"mesh {label} {name}")
                assert line in summary, (label, name, summary)
                assert disp.get(family, 0) > 0, (label, name, disp)
                want, _, off_ms, _, _ = _mesh_run(msess, q, hs_on, conf, parallel=False)
                assert _same_mesh_rows(name, got, want, q) and _same_mesh_rows(name, first[0], want, q), \
                    f"mesh {label} {name}: differs from the single-device run"
                res["queries"][name] = {"rows": int(len(next(iter(got.values())))), "first_ms": first[2],
                                        "warm_ms": warm_ms, "off_ms": off_ms, "sharded_program_ms": programs_s * 1e3,
                                        "dispatches": {k: v for k, v in disp.items() if v}}
                print(f"mesh {label} {name}: {res['queries'][name]['rows']} rows, first {first[2]:.3f} ms, warm "
                      f"{warm_ms:.3f} ms (parallel off {off_ms:.3f} ms); sharded programs {programs_s * 1e3:.3f} ms "
                      f"over {res['queries'][name]['dispatches']} ({smi})", flush=True)
        res["programs"] = sharded_program_times(cap.seen, mesh.size, reps, hbm)
        for fam, p in res["programs"].items():
            print(f"program {fam} @ {label} ({p['shape']}): {p['ms']} ms, single device {p['single_device_ms']} ms, "
                  f"bound {p['bound_ms']} ms ({p['bound_by']}), {100 * p['share_of_bound']:.2f}% of bound ({smi})",
                  flush=True)
        # the mesh build of li_shipdate
        bsess = _mesh_session(os.path.join(os.path.dirname(sess.conf.system_path), f"mesh_build_{mesh.size}"),
                              "cuda", mesh)
        configs = [ht.CoveringIndexConfig("li_shipdate", ["l_shipdate"],
                                          ["l_quantity", "l_extendedprice", "l_discount"])]
        if mesh.size == 1:
            configs.append(ht.DataSkippingIndexConfig("li_skip_mesh", ht.MinMaxSketch("l_extendedprice")))
        overflow = BZ.overflow_rows["build"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        with KernelCapture() as kcap, ShardedCapture() as scap:
            built = {cfg.index_name: ht.Hyperspace(bsess).create_index(bsess.read_parquet(li_src), cfg)
                     for cfg in configs}
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        launches = {k: v for k, v in kernels.launches.items() if v}
        calls = kcap.check()
        got_files = {b: sorted(open(f, "rb").read() for f in fs)
                     for b, fs in _files_by_bucket(built["li_shipdate"]).items()}
        assert got_files == main_files, f"mesh {label}: li_shipdate's bucket files differ from the main build's"
        if mesh.size == 1:
            assert launches.get(K1, 0) > 0 and launches.get(K2, 0) > 0 and "exchange-build" not in scap.seen, launches
        else:
            assert "exchange-build" in scap.seen and launches.get(K1, 0) == 0, launches
        entry = {"seconds": build_s, "rows_per_s": args.rows / build_s, "launches": launches,
                 "overflow_rows": BZ.overflow_rows["build"] - overflow}
        if "exchange-build" in scap.seen:
            entry["exchange"] = sharded_program_times({"exchange-build": scap.seen["exchange-build"]}, mesh.size,
                                                      reps, hbm)["exchange-build"]
        out["builds"][label] = entry
        print(f"mesh build li_shipdate @ {label}: {build_s:.3f} s ({entry['rows_per_s']:.0f} rows/s), launches "
              f"{launches} (each K1/K2 call equal to its plain version: {calls}), exchange overflow "
              f"{entry['overflow_rows']} rows; bucket files equal the main build's byte for byte ({smi})", flush=True)
        if "exchange" in entry:
            p = entry["exchange"]
            print(f"program exchange-build @ {label} ({p['shape']}): {p['ms']} ms, bound {p['bound_ms']} ms "
                  f"({p['bound_by']}), {100 * p['share_of_bound']:.2f}% of bound ({smi})", flush=True)
        del bsess, built
    return out


# --- static analysis and program contracts (12o) --------------------------------

#: the families each query of the check phase runs
CHECK_FAMILIES = {
    "q6": ("fused-filter",),
    "q6s": ("fused-filter", "dict-expand"),
    "A1": ("grouped-agg-chunk",),
    "A1s": ("grouped-agg-chunk", "grouped-merge"),
    "A2": ("fused-agg",),
    "J1": ("bucketed-smj-span",),
    "J3": ("hash-build", "hash-probe", "fused-postjoin"),
    "T1": ("topk-chunk", "topk-merge"),
    "FA1d": ("fused-stage-agg",),
    "FT1": ("fused-stage-topk",),
    "FJ3": ("fused-stage-join-agg",),
    "lineage": ("lineage-antijoin",),
    "mesh q6": ("fused-filter",),
    "mesh A1": ("sharded-grouped",),
    "mesh T1": ("sharded-topk",),
    "mesh FA1d": ("fused-stage-agg-sharded",),
    "mesh FT1": ("fused-stage-topk-sharded",),
    "mesh rebucket": ("index-rebucket",),
    "mesh hierarchical": ("hierarchical-exchange",),
    "mesh build": ("index-build-exchange",),
}
#: the families whose windows must report no synchronisation on the card:
#: the grouped programs and the exchanges, fixed-shape as the JAX
#: package's (ROADMAP §C: C12, C13)
SYNC_FREE_FAMILIES = ("grouped-agg-chunk", "sharded-grouped", "grouped-merge", "fused-stage-agg",
                      "fused-stage-agg-sharded", "fused-stage-join-agg", "index-build-exchange", "index-rebucket",
                      "hierarchical-exchange")
#: rows and buckets of the check phase's hierarchical exchange
HIER_ROWS = 1 << 20
HIER_BUCKETS = 200


def hierarchical_rows(seed: int, n: int = HIER_ROWS):
    """``li_shipdate``'s widths from ``seed``: the ship date as int64 days
    (the key), ``l_quantity`` (int64) and ``l_extendedprice`` (f64), and
    each row's bucket, the build's hash of its key over ``HIER_BUCKETS``."""
    import numpy as np

    from hyperspace_tpu_torch.ops.hashing import bucket_ids_np, numeric_hash32

    rng = np.random.default_rng(seed)
    key = np.datetime64("1992-01-01", "D").astype(np.int64) + rng.integers(0, 2526, n)
    cols = {"k": key.astype(np.int64), "q": rng.integers(1, 51, n).astype(np.int64),
            "p": np.round(rng.uniform(900.0, 105000.0, n), 2)}
    return cols, bucket_ids_np([numeric_hash32(cols["k"])], HIER_BUCKETS)


def exchange_rows(mesh, cols: dict, buckets, capacity: int, hierarchical: bool) -> dict:
    """Re-bucket ``cols`` over ``mesh`` (``rebucket_hierarchical`` on a 2-D
    one at ``capacity`` in both phases, else the flat ``rebucket``): each
    shard's valid rows as one (bucket, k, q, p bits) array sorted row by
    row (a multiset), the overflow, and the all-to-alls it called."""
    import numpy as np

    from hyperspace_tpu_torch.ops import bucketize as BZ
    from hyperspace_tpu_torch.parallel import mesh as PM

    place = PM.Placement(mesh)
    args = ({n: place.put(v) for n, v in cols.items()}, place.put(buckets))
    before = collections.Counter(PM.collective_calls)
    if hierarchical:
        out, ob, valid, overflow = BZ.rebucket_hierarchical(mesh, *args, capacity, capacity)
    else:
        out, ob, valid, overflow = BZ.rebucket(mesh, *args, capacity)
    calls = {key[1]: n - before[key] for key, n in PM.collective_calls.items()
             if key[0] == "all_to_all" and n > before[key]}
    n_dev = mesh.size
    mask = np.asarray(valid).reshape(n_dev, -1)
    planes = [np.asarray(ob).astype(np.int64)] + [np.asarray(out[n]).view(np.int64) for n in cols]
    rows = []
    for g in range(n_dev):
        r = np.stack([p.reshape(n_dev, -1)[g][mask[g]] for p in planes], axis=1)
        rows.append(r[np.lexsort(r.T[::-1])])
    return {"rows": rows, "overflow": int(np.asarray(overflow).sum()), "all_to_all": calls}


def check_queries(li, orders, a1_chunk: int, src_chunk: int) -> dict:
    """{name: (DataFrame, hyperspace on, conf, streamed)}: q6 through
    ``li_shipdate``, q6s (a string filter over the dictionary-encoded
    source, streamed a file a chunk: a file's string column arrives
    dictionary-coded), A1 through ``li_q1`` unstreamed and streamed, A2
    (q6's global aggregate), J1, J3 (J1 under a Filter, hyperspace off,
    streamed through the broadcast join), T1 over the source in chunks,
    and the fused FA1d, FT1 and FJ3 (J3's chain grouped by
    ``o_shippriority``)."""
    import hyperspace_tpu_torch as ht

    k, c = ht.keys, ht.col
    mq = mesh_queries(li, c, a1_chunk, src_chunk)
    j = li.join(orders, c("l_orderkey") == c("o_orderkey"))
    cols = ("l_orderkey", "l_extendedprice", "o_orderdate", "o_totalprice")
    fj3 = j.filter(c("o_totalprice") > 300000.0).group_by("o_shippriority").agg(
        n=("*", "count"), revenue=("l_extendedprice", "sum"))
    return {
        "q6": (q6_query(li), True, {}, False),
        "q6s": (li.filter((c("l_returnflag") == "R") & (c("l_quantity") < 24)), False,
                {ht.keys.STREAM_CHUNK_BYTES: src_chunk // 2}, True),
        "A1": (mq["A1"][0], True, mq["A1"][2], False),
        "A1s": (mq["A1s"][0], True, mq["A1s"][2], False),
        "A2": (q6_filter(li).agg(revenue=("l_extendedprice", "sum"), n=("*", "count")), True,
               {k.STREAM_AGG_MIN_BYTES: 1 << 40}, False),
        "J1": (j.select(*cols), True, {}, False),
        "J3": (j.filter(c("o_totalprice") > 300000.0).select(*cols), False, {}, True),
        "T1": (mq["T1"][0], False, mq["T1"][2], False),
        "FA1d": (mq["FA1d"][0], True, mq["FA1d"][2], False),
        "FT1": (mq["FT1"][0], False, mq["FT1"][2], False),
        "FJ3": (fj3, False, {k.STREAM_AGG_MIN_BYTES: 1, k.STREAM_CHUNK_BYTES: src_chunk, k.FUSION_ENABLED: True},
                False),
    }


def _check_switch(sess, on: bool) -> None:
    """The check on or off: the session's conf, and the module default the
    sites with no conf in reach read (``dict-expand``, the exchange)."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.check import program_lint as PL

    sess.conf.set(ht.keys.CHECK_HLO_ENABLED, on)
    PL.set_default_enabled(on)


def _check_run(sess, q, hs_on: bool, conf: dict, streamed: bool):
    """One run of ``q`` under ``conf`` (restored after): its rows, as a
    multiset when streamed."""
    from hyperspace_tpu_torch.exec import batch as B

    saved = {key: sess.conf.get(key) for key in conf}
    for key, v in conf.items():
        sess.conf.set(key, v)
    try:
        with sess.hyperspace_scope(hs_on):
            if streamed:
                return as_multiset(B.concat(list(q.to_local_iterator())))
            return q.collect()
    finally:
        for key, v in saved.items():
            sess.conf.set(key, v)


def _same_check_rows(name: str, got, want, q) -> bool:
    if name in ("A1", "A1s", "A2", "FA1d", "FJ3", "mesh A1", "mesh FA1d"):
        return same_groups(got, want, float_aggs_of(q), ordered=True)
    return same_batch(got, want)


def _findings_by_family(findings) -> dict:
    """{family: {rule: {op: count}}} of program-contract findings (a
    collective budget's count under the op ``calls``)."""
    out: dict = {}
    for f in findings:
        rules = out.setdefault(f.detail["family"], {})
        ops = rules.setdefault(f.rule, {})
        for op, n in (f.detail.get("ops") or {"calls": f.detail.get("count", 0)}).items():
            ops[op] = ops.get(op, 0) + n
    return out


def contract_pass(system: str, li_src: str, o_src: str, a1_chunk: int, src_chunk: int, device: str,
                  mesh_devices, build_root: str, seed: int, syncs: bool = False):
    """Every check query on ``device`` with the check on, the
    ``lineage-antijoin`` program, and on a mesh over ``mesh_devices`` q6,
    A1, T1, FA1d and FT1, the flat re-bucketing of ``hierarchical_rows(seed)``
    (``out["flat"]``, ``exchange_rows``) and its hierarchical exchange on a
    2 x 2 mesh at a roomy and a tight capacity (``out["hierarchical"]``, by
    capacity), and ``li_shipdate`` built through the exchange: each family's
    verified count and findings; then every query again with the check off,
    its rows equal to the on run's. With ``syncs`` the recorded windows
    also run under ``torch.cuda.set_sync_debug_mode("warn")``, the scan
    pipeline off (the debug mode and the warnings it raises are
    process-wide), and each window's synchronisations are counted. Returns
    (the results, the session, its queries)."""
    import warnings

    import numpy as np

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.check import program_lint as PL
    from hyperspace_tpu_torch.exec import device as D
    from hyperspace_tpu_torch.exec import io as IO
    from hyperspace_tpu_torch.exec import lineage as LN
    from hyperspace_tpu_torch.obs.metrics import REGISTRY
    from hyperspace_tpu_torch.parallel import make_mesh, make_mesh_2d

    k = ht.keys

    def verified():
        return {f: REGISTRY.counter("hs_check_programs_verified_total", program=f).value
                for f in PL.registered_contracts()}

    sess = ht.Session(conf={k.SYSTEM_PATH: system, k.DEVICE_MIN_ROWS: 0, k.JOIN_DEVICE_MATERIALIZE_MAX_BYTES: 2 << 30},
                      device=device)
    qs = check_queries(sess.read_parquet(li_src), sess.read_parquet(o_src), a1_chunk, src_chunk)
    rng = np.random.default_rng(7)
    ids_col = rng.integers(0, 1000, 1_000_000).astype(np.int64)
    deleted = sorted(set(rng.integers(0, 1000, 100).tolist()))
    msess = _mesh_session(system, device, make_mesh(devices=[mesh_devices] * MESH_SHARDS))
    mq = mesh_queries(msess.read_parquet(li_src), ht.col, a1_chunk, src_chunk)
    mesh_qs = {f"mesh {name}": mq[name][:3] + (False,) for name in ("q6", "A1", "T1", "FA1d", "FT1")}
    out = {"device": device, "ms": {"on": {}, "off": {}}}

    def run(pass_, name, s, spec):
        t = time.perf_counter()
        try:
            return _check_run(s, *spec)
        finally:
            out["ms"][pass_][name] = (time.perf_counter() - t) * 1e3

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # each finding also warns; they print below
        # the device columns go, and the first source file's decode, so the
        # on pass uploads again and decodes that file afresh: dict-expand
        # runs where a file's dictionary-coded string column is uploaded
        D.clear_device_cache()
        IO.purge_io_cache([os.path.join(li_src, min(os.listdir(li_src)))])
        PL.reset_runtime_state()
        before = verified()
        t = time.perf_counter()
        _check_switch(sess, True)
        if syncs:
            sess.conf.set(k.PIPELINE_ENABLED, False)
            PL.count_syncs(True)
        try:
            on = {name: run("on", name, sess, spec) for name, spec in qs.items()}
            mask = LN.lineage_delete_mask(sess, {"_data_file_id": ids_col}, "_data_file_id", deleted)
            assert mask.tobytes() == LN.lineage_keep_mask_plain(ids_col, deleted).tobytes(), \
                "lineage-antijoin differs"
            _check_switch(msess, True)
            on.update({name: run("on", name, msess, spec) for name, spec in mesh_qs.items()})
            # the flat re-bucketing exchange over the mesh (one all-to-all),
            # then the hierarchical one over a 2 x 2 (dcn, ici) mesh (two), at
            # a capacity that holds every row and one that cannot
            hcols, hbuckets = hierarchical_rows(seed)
            out["flat"] = exchange_rows(msess.mesh, hcols, hbuckets, HIER_ROWS // MESH_SHARDS, False)
            hmesh = make_mesh_2d(2, MESH_SHARDS // 2, devices=[mesh_devices] * MESH_SHARDS)
            out["hierarchical"] = {cap: exchange_rows(hmesh, hcols, hbuckets, cap, True)
                                   for cap in (HIER_ROWS // MESH_SHARDS, HIER_ROWS // (4 * MESH_SHARDS))}
            bsess = _mesh_session(build_root, device, make_mesh(devices=[mesh_devices] * MESH_SHARDS))
            _check_switch(bsess, True)
            t_b = time.perf_counter()
            ht.Hyperspace(bsess).create_index(bsess.read_parquet(li_src), ht.CoveringIndexConfig(
                "li_shipdate", ["l_shipdate"], ["l_quantity", "l_extendedprice", "l_discount"]))
            out["ms"]["on"]["mesh build"] = (time.perf_counter() - t_b) * 1e3
        finally:
            PL.count_syncs(False)
            sess.conf.set(k.PIPELINE_ENABLED, True)
        out["seconds_on"] = time.perf_counter() - t
        after = verified()
        findings = PL.runtime_violations()
        out["verified"] = {f: int(after[f] - before.get(f, 0.0)) for f in after if after[f] > before.get(f, 0.0)}
        out["findings"] = _findings_by_family(findings)
        missing = {f for fams in CHECK_FAMILIES.values() for f in fams} - set(out["verified"])
        assert not missing, f"check {device}: never verified {sorted(missing)}"
        if syncs:
            out["syncs"] = PL.runtime_syncs()
            out["host_callback_ops"] = {fam: sum(rules.get("forbidden-op:host-callback", {}).values())
                                        for fam, rules in out["findings"].items()}
        t = time.perf_counter()
        _check_switch(sess, False)
        _check_switch(msess, False)
        off = {name: run("off", name, sess, spec) for name, spec in qs.items()}
        off.update({name: run("off", name, msess, spec) for name, spec in mesh_qs.items()})
        out["seconds_off"] = time.perf_counter() - t
        for name, (q, *_rest) in {**qs, **mesh_qs}.items():
            assert _same_check_rows(name, on[name], off[name], q), f"check {device} {name}: rows differ with the check on"
    return out, sess, qs

def run_check(system: str, li_src: str, o_src: str, a1_chunk: int, tmp: str, args, smi: str,
              device: str = "cuda") -> dict:
    """12o: the lint on this tree, then the program contracts on the card
    over the SF1 lake (``system``'s indexes), beside the CPU port's over a
    60 000-row lake, then warm q6 and A1 with the check on against off.
    Raises on any finding and on a synchronisation in a window of
    ``SYNC_FREE_FAMILIES``."""
    import contextlib
    import io
    import statistics

    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.check import program_lint as PL
    from hyperspace_tpu_torch.check.__main__ import main as lint_main
    from hyperspace_tpu_torch.ops import kernels

    out = {}
    t = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = lint_main([])
    out["lint"] = {"rc": rc, "findings": len(text.getvalue().splitlines()), "seconds": time.perf_counter() - t}
    assert rc == 0, f"the port's lint found:\n{text.getvalue()}"
    print(f"check lint: python -m hyperspace_tpu_torch.check exits 0, 0 findings "
          f"({out['lint']['seconds']:.3f} s)", flush=True)

    files = sorted(os.path.join(li_src, f) for f in os.listdir(li_src))
    src_chunk = 2 * max(os.path.getsize(f) for f in files)
    kernels.reset_launches()
    card, sess, qs = contract_pass(system, li_src, o_src, a1_chunk, src_chunk, device, device,
                                   os.path.join(tmp, "check_mesh_build"), args.seed, syncs=device == "cuda")
    out["launches"] = {k_: v for k_, v in kernels.launches.items() if v}

    # the CPU port over a small lake: the same queries, indexes and mesh
    t = time.perf_counter()
    small = os.path.join(tmp, "check_cpu")
    s_li = gen_lineitem(small, 60_000, 4, args.seed)
    s_o = gen_orders(small, 15_000, 2, args.seed + 1)
    s_sys = os.path.join(small, "indexes")
    bsess = ht.Session(conf={ht.keys.SYSTEM_PATH: s_sys, ht.keys.NUM_BUCKETS: 8}, device="cpu")
    hs = ht.Hyperspace(bsess)
    for name, src, key, inc in (
            ("li_shipdate", s_li, "l_shipdate", ["l_quantity", "l_extendedprice", "l_discount"]),
            ("li_q1", s_li, "l_shipdate", ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                                           "l_discount", "l_tax"]),
            ("li_orderkey", s_li, "l_orderkey", ["l_extendedprice"]),
            ("o_orderkey", s_o, "o_orderkey", ["o_orderdate", "o_totalprice"])):
        hs.create_index(bsess.read_parquet(src), ht.CoveringIndexConfig(name, [key], inc))
    s_chunk = max(1, index_bytes(s_sys, "li_q1") // 8)
    s_files = sorted(os.path.join(s_li, f) for f in os.listdir(s_li))
    cpu, _, _ = contract_pass(s_sys, s_li, s_o, s_chunk, 2 * max(os.path.getsize(f) for f in s_files), "cpu", "cpu",
                              os.path.join(small, "mesh_build"), args.seed)
    cpu_s = time.perf_counter() - t

    out["families"] = {}
    for fam in sorted(set(card["verified"]) | set(cpu["verified"])):
        row = {"verified_card": card["verified"].get(fam, 0), "findings_card": card["findings"].get(fam, {}),
               "verified_cpu": cpu["verified"].get(fam, 0), "findings_cpu": cpu["findings"].get(fam, {})}
        syncs = ""
        if "syncs" in card:
            row["syncs_card"] = card["syncs"].get(fam, {})
            row["host_callback_ops_card"] = card["host_callback_ops"].get(fam, 0)
            syncs = (f"; syncs reported {sum(row['syncs_card'].values())} {row['syncs_card'] or ''} beside "
                     f"{row['host_callback_ops_card']} host-callback ops")
        out["families"][fam] = row
        print(f"check {fam}: card verified {row['verified_card']}, findings {row['findings_card'] or 'none'}; "
              f"CPU port verified {row['verified_cpu']}, findings {row['findings_cpu'] or 'none'}{syncs} ({smi})",
              flush=True)
    out["seconds"] = {"card_on": card["seconds_on"], "card_off": card["seconds_off"], "cpu": cpu_s}
    if "syncs" in card:
        out["syncs"] = {fam: sum(row.get("syncs_card", {}).values()) for fam, row in out["families"].items()}
        print("check syncs per family (card windows): " + ", ".join(
            f"{fam} {n}" for fam, n in sorted(out["syncs"].items())) + f" ({smi})", flush=True)
        stalled = {fam: out["families"][fam]["syncs_card"] for fam in SYNC_FREE_FAMILIES
                   if out["syncs"].get(fam)}
        assert not stalled, f"check: windows of sync-free families synchronised: {stalled}"
    found = {fam: {"card": row["findings_card"], "cpu": row["findings_cpu"]}
             for fam, row in out["families"].items() if row["findings_card"] or row["findings_cpu"]}
    assert not found, f"check: recorded windows report findings: {found}"
    registered = sorted(PL.registered_contracts())
    unverified = [fam for fam in registered if not card["verified"].get(fam)]
    assert not unverified, f"check: families never verified on {device}: {unverified}"
    print(f"check families: {len(registered)} of the {len(registered)} registered families verified on {device} "
          f"with 0 findings ({smi})", flush=True)
    out["hierarchical"] = check_hierarchical(card, cpu, device, args.seed, args.reps, smi)

    # warm q6 and A1, each program already verified, the check on and off
    out["warm_ms"] = {}
    for name in ("q6", "A1"):
        times = {True: [], False: []}
        for on in (False, True):  # warm-up: the CPU pass above emptied the query caches
            _check_switch(sess, on)
            _check_run(sess, *qs[name])
        for on in (False, True, True, False) * max(1, args.reps // 3):
            _check_switch(sess, on)
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            _check_run(sess, *qs[name])
            times[on].append((time.perf_counter() - t) * 1e3)
        _check_switch(sess, False)
        med = {k_: statistics.median(v) for k_, v in times.items()}
        out["warm_ms"][name] = {"on": med[True], "off": med[False], "runs": len(times[True])}
        print(f"check warm {name}: {med[True]:.3f} ms with the check on (verified), {med[False]:.3f} ms off, "
              f"medians of {len(times[True])} ({smi})", flush=True)
    for pass_, ms in card["ms"].items():
        if ms:
                print(f"check {pass_} pass: " + ", ".join(f"{n} {v:.1f}" for n, v in ms.items()) + " ms", flush=True)
    out["ms"] = card["ms"]
    print(f"check: card passes {card['seconds_on']:.3f} s with the check on"
          f"{' under the sync debug mode' if 'syncs' in card else ''}, {card['seconds_off']:.3f} s off; CPU port "
          f"{cpu_s:.3f} s (its lake and builds included); kernel launches {out['launches']}", flush=True)
    return out


def check_hierarchical(card: dict, cpu: dict, device: str, seed: int, reps: int, smi: str) -> dict:
    """The hierarchical exchange of the contract passes: two all-to-alls a
    call (``ici``, then ``dcn``); every row on its owner shard (``b % 4``);
    each shard's rows, as a multiset, the CPU port's on its 2 x 2 CPU mesh
    and, at the roomy capacity, the flat ``rebucket``'s on the 4-shard mesh
    of ``device``; overflow 0 at the roomy capacity and the CPU port's
    count at the tight one, where every row is placed or counted. Then, on
    the card, one call's CUDA-event time beside ``index-rebucket``'s on the
    same rows."""
    import numpy as np

    from hyperspace_tpu_torch.ops import bucketize as BZ
    from hyperspace_tpu_torch.parallel import mesh as PM

    roomy, tight = sorted(card["hierarchical"], reverse=True)
    flat = card["flat"]
    out = {"rows": HIER_ROWS, "buckets": HIER_BUCKETS, "capacity": {}}
    for cap, got in card["hierarchical"].items():
        want = cpu["hierarchical"][cap]
        assert got["all_to_all"] == {"ici": 1, "dcn": 1}, f"hierarchical exchange at {cap}: {got['all_to_all']}"
        for g, rows in enumerate(got["rows"]):
            assert np.all(rows[:, 0] % MESH_SHARDS == g), f"hierarchical exchange at {cap}: shard {g} holds foreign rows"
            assert np.array_equal(rows, want["rows"][g]), f"hierarchical exchange at {cap}: shard {g} != the CPU port's"
        placed = sum(len(r) for r in got["rows"])
        assert got["overflow"] == want["overflow"] and placed + got["overflow"] == HIER_ROWS, \
            f"hierarchical exchange at {cap}: overflow {got['overflow']}, CPU port {want['overflow']}, placed {placed}"
        out["capacity"][cap] = {"placed": placed, "overflow": got["overflow"], "overflow_cpu": want["overflow"]}
    assert out["capacity"][roomy]["overflow"] == 0 and out["capacity"][tight]["overflow"] > 0, out["capacity"]
    assert flat["overflow"] == 0 and all(np.array_equal(h, f) for h, f in zip(card["hierarchical"][roomy]["rows"],
                                                                            flat["rows"])), \
        "hierarchical exchange: rows differ from the flat rebucket's"
    line = ", ".join(f"capacity {cap}: {c['placed']} rows placed, overflow {c['overflow']} (CPU port "
                     f"{c['overflow_cpu']})" for cap, c in out["capacity"].items())
    print(f"check hierarchical-exchange: 2 x 2 (dcn, ici) mesh over {device}, {HIER_ROWS} rows, {HIER_BUCKETS} "
          f"buckets, 2 all-to-alls a call (ici 1, dcn 1); {line}; every row on its owner, each shard's rows == "
          f"the flat rebucket's (4 shards over {device}) == the CPU port's (2 x 2 over cpu)", flush=True)
    if device == "cuda":
        cols, buckets = hierarchical_rows(seed)
        hmesh = PM.make_mesh_2d(2, MESH_SHARDS // 2, devices=[device] * MESH_SHARDS)
        flat_mesh = PM.make_mesh(devices=[device] * MESH_SHARDS)
        args = {m: ({n: PM.Placement(m).put(v) for n, v in cols.items()}, PM.Placement(m).put(buckets))
                for m in (hmesh, flat_mesh)}
        out["ms"] = {"hierarchical-exchange": time_ms(
                         lambda: BZ.rebucket_hierarchical(hmesh, *args[hmesh], roomy, roomy), reps),
                     "index-rebucket": time_ms(lambda: BZ.rebucket(flat_mesh, *args[flat_mesh], roomy), reps)}
        print(f"check exchange time ({HIER_ROWS} rows, capacity {roomy}, CUDA events, median of {reps}): "
              f"hierarchical-exchange {out['ms']['hierarchical-exchange']} ms on the 2 x 2 mesh, index-rebucket "
              f"{out['ms']['index-rebucket']} ms on the 4-shard mesh ({smi})", flush=True)
    return out


def grouped_program_times(queries: dict, smi: str) -> dict:
    """The grouped programs' times the earlier phases measured (ms, CUDA
    events), on one line: ``grouped-agg-chunk`` alone at A1 (``agg``),
    ``grouped-merge`` alone on streamed A1's tables (``stream``), each fused
    fold summed over its query's chunks with the median per-family chunk
    program beside it (``fusion``), and the sharded twins alone at each mesh
    (``mesh``)."""
    out = {"A1 grouped-agg-chunk": queries["agg"]["programs"]["grouped-agg-chunk"]["ms"],
           "A1 streamed grouped-merge": queries["stream"]["grouped_merge"]["ms"]}
    for name in ("FA1d", "FA4", "FJ3-shippriority", "FJ3-partkey"):
        entry = queries["fusion"][name]
        out[f"{name} {entry['fused']['family']}"] = entry["fused"]["ms"]
        if "grouped_agg_chunk" in entry:
            out[f"{name} grouped-agg-chunk (median chunk)"] = entry["grouped_agg_chunk"]["ms"]
    for label, res in queries["mesh"]["meshes"].items():
        for fam in ("sharded-grouped", "fused-stage-agg-sharded"):
            if fam in res.get("programs", {}):
                out[f"{fam} @ {label}"] = res["programs"][fam]["ms"]
    print("grouped programs (ms): " + ", ".join(f"{k} {v}" for k, v in out.items()) + f" ({smi})", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=DEFAULT_ROWS, help="lineitem rows (6M = SF1; default SF 0.5)")
    ap.add_argument("--files", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3, help="timed runs per kernel and warm query")
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
        sql_small = check_sql_small(tmp, args.seed)
        phase("sql-small", t)

        t = time.perf_counter()
        bcast_small = check_bcast_small(tmp, args.seed)
        bcast_small["programs"] = check_bcast_programs("cuda")
        phase("bcast-small", t)

        t = time.perf_counter()
        topk_small = check_topk_small(tmp, args.seed)
        topk_small["programs"] = check_topk_programs("cuda")
        phase("topk-small", t)

        t = time.perf_counter()
        api_small = check_api_small(tmp, args.seed)
        phase("api-small", t)

        t = time.perf_counter()
        explain_small = check_explain_small(tmp)
        phase("explain-small", t)

        t = time.perf_counter()
        nested_small = check_nested_small(tmp, args.seed)
        phase("nested-small", t)

        t = time.perf_counter()
        fusion_small = check_fusion_small(tmp, args.seed)
        phase("fusion-small", t)

        t = time.perf_counter()
        native_small = check_native_small(tmp, args.seed)
        phase("native-small", t)

        t = time.perf_counter()
        serving_small = check_serving_small(tmp, args.seed)
        phase("serving-small", t)

        t = time.perf_counter()
        fabric_small = check_fabric_small(tmp, args.seed)
        phase("fabric-small", t)

        t = time.perf_counter()
        mesh_small = check_mesh_small(tmp, args.seed)
        phase("mesh-small", t)

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
        phase("index-check", t)

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

        t = time.perf_counter()
        queries["sql"] = run_sql(tmp, args, smi, hbm)
        queries["sql"]["small"] = sql_small
        queries["sql"]["bcast_small"] = bcast_small
        phase("sql", t)

        t = time.perf_counter()
        queries["native"] = run_native(sess, hs, df, src, j1, args, smi, hbm)
        queries["native"]["small"] = native_small
        phase("native", t)

        t = time.perf_counter()
        queries["topk"] = run_topk(sess, src, args, smi, hbm)
        queries["topk"]["small"] = topk_small
        phase("topk", t)

        t = time.perf_counter()
        queries["nested"] = run_nested(src, o_src, tmp, args, smi, nested_small["join_tier"])
        queries["nested"]["small"] = nested_small
        queries["nested"]["api_small"] = api_small
        queries["nested"]["explain_small"] = explain_small
        phase("nested", t)

        t = time.perf_counter()
        queries["fusion"] = run_fusion(sess, src, o_src, a1_streamed, chunk, args, smi, hbm)
        queries["fusion"]["small"] = fusion_small
        phase("fusion", t)

        t = time.perf_counter()
        queries["mesh"] = run_mesh(sess, src, chunk, entries, args, smi, hbm)
        queries["mesh"]["small"] = mesh_small
        phase("mesh", t)

        t = time.perf_counter()
        queries["check"] = run_check(sess.conf.system_path, src, o_src, chunk, tmp, args, smi)
        queries["check"]["grouped_ms"] = grouped_program_times(queries, smi)
        phase("check", t)
        for name in results:
            results[name]["launches_by_path"] = {
                "build": results[name]["launches"],
                "prune": queries["prune"]["li_part"]["launches"].get(name, 0),
                "hybrid": queries["hybrid"]["build"]["launches"].get(name, 0)
                + queries["hybrid"]["full_refresh"]["launches"].get(name, 0),
                "delta": sum(a["launches"].get(name, 0) for a in queries["delta"]["actions"]),
                "sql-small": sql_small["k1_launches"] if name == "bucket_histogram" else 0,
                "sql": sum(b["launches"].get(name, 0) for b in queries["sql"]["builds"].values())
                + queries["sql"]["li_q1_build"]["launches"].get(name, 0)
                + sum(b["launches"].get(name, 0) for b in queries["sql"]["other_builds"].values()),
                "api-small": api_small["launches"].get(name, 0),
                "nested-small": nested_small["launches"].get(name, 0),
                "nested": sum(b["launches"].get(name, 0) for b in queries["nested"]["builds"].values()),
                "native": queries["native"]["launches"].get(name, 0),
                "serving-small": serving_small["launches"].get(name, 0),
                "fabric-small": fabric_small["launches"].get(name, 0),
                "mesh": queries["mesh"]["builds"]["1-device"]["launches"].get(name, 0),
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
        queries["scale"] = run_scale(sess, tmp, args, smi)
        phase("scale", t)

        t = time.perf_counter()
        queries["serving"] = run_serving(src, o_src, sess.conf.system_path, tmp, args, smi)
        queries["serving"]["small"] = serving_small
        for name in results:
            results[name]["launches_by_path"]["serving"] = queries["serving"]["launches"].get(name, 0)
        phase("serving", t)

        t = time.perf_counter()
        queries["fabric"] = run_fabric(src, o_src, sess.conf.system_path, tmp, args, smi)
        queries["fabric"]["small"] = fabric_small
        for name in results:
            results[name]["launches_by_path"]["fabric"] = queries["fabric"]["launches"].get(name, 0)
        phase("fabric", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps(queries))
    print(json.dumps({"kernels": [results[k] for k in ("bucket_histogram", "segmented_min_max")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
