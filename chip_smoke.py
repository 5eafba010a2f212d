"""Chip smoke test of the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100; the
kernels build for sm_90a):

    python3 chip_smoke.py                # every phase, TPC-H SF1 and SF10
    python3 chip_smoke.py --scales 1     # a shorter run: SF1 only
    python3 chip_smoke.py --profile      # also trace warm Q1/Q6 (1 and 4 partitions), deep Q1, Q3 and Q5 at the first scale, with Q3's and Q5's phases, and the five slowest of the 22 queries
    python3 chip_smoke.py --kernels-only # phases 1 and 2 only, for iterating on a kernel
    python3 chip_smoke.py --ab TREE      # no phase: warm SF1 times through TREE's port (ab_times)

Phases, each of which fails the run:
  1. build every kernel of the main path from the sources in the checkout,
     all nvcc runs at once: K1 (csrc/masked_segment_sums.cu), the scatter-sums
     kernel (csrc/segment_scatter_sums.cu) and the K2 sources (generated by
     kernels/fused_expr_sums.py) of every deep plan the script drives and of
     the phase-2 edge cases. The deep plans' K2 programs are found by running
     those plans once on a 4096-row frame on the CPU, where K2 takes its plain
     version and builds nothing;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, at edge cases and on both sides of the
     crossover between pass 1's two loops (segment_sums.pass1_loop: the
     largest G that takes the row-parallel loop and the smallest that takes
     the output-parallel one), and time it (CUDA events) beside its bound,
     the plain version and one library call; K1 also with sorted codes, each
     block one group, the longest dependent chain through shared memory.
     K2's operands are the ones the engine hands it for SF1 Q1 and Q6,
     captured from a run through the engine; K2 must equal its plain version
     and the composed route (torch derive, stack, K1) bit for bit. The
     scatter kernel must equal its plain version and itself across two
     launches bit for bit, at G = 4097 and a large shape, with random and
     sorted codes and masked rows, with fewer segments than pass 1 has
     owners and with codes outside [0, G); its library route is index_add_
     plus device._kahan_combine;
  3. at the first scale, drive TPC-H Q1 and Q6 through
     daft_tpu_torch.from_arrow(...).collect() on the card in the 32-bit
     device mode, through K1 (the composed route)
     and through K2 (use_deep_fusion_kernel), and Q1 written with
     with_column through a device-resident plan segment (DeviceSegmentOp),
     with K2 and with K1; at SF1, Q1 and Q6 again over the table cut into 4
     partitions, the two-stage aggregate (stage 1 through K1 on each
     partition, a hash shuffle of Q1's partials, a gather of Q6's, stage 2),
     timed warm beside the one-partition run; at SF1, a lone filter, a
     one-expression projection and a distinct over lineitem, each on the
     card through its single-op hook (device_filters, device_projections,
     device_distincts), held against pyarrow and timed warm; then TPC-H Q3
     and Q5 (optimized: pruned join sides as fused map chains on the card,
     joins through the device probe, the device argsort, Limit) over
     generate_tables(scale, seed=42) at every scale, Q3's aggregate
     through the scatter kernel and Q5's through K1. Hold every result against the pyarrow
     oracle of benchmarks/tpch.py at rtol 1e-6 (Q3's top 10 by q3_parity);
     check that each path ran on the card through its kernel (its launch
     count, set to 0 just before the path and read just after, and the
     join, sort and routing counters of the optimized plan), and time them
     warm. At every scale the scatter kernel is also held against its plain
     version and timed at the operands the engine handed it in Q3, and K1
     held against its plain version at the operands of Q5;
  4. the 22 queries of benchmarks/tpch_queries.py (parsed with col and lit
     bound to daft_tpu_torch, tpch22_module) on the card with
     device_min_rows=8: at SF0.005 with lineitem, orders, customer and
     partsupp in 3 partitions (into_partitions) against the SQLite oracle,
     and at SF1 (one partition per table, tables generated by a background
     process started at the top of the run) against the port's host path,
     each under tests/device32/test_tpch_suite32.py's rule; each SF1 query
     cold and warm (median of 2) with its routing counters and K1's, K2's
     and the scatter kernel's launches (set to 0 just before the query),
     device_agg_fallbacks 0, the new lanes' filters on the card, and float
     sums through K1 or the scatter kernel where the CPU tests put them.
     With --profile, the phase breakdown and device profile of the five
     slowest warm queries;
  5. the 32-bit lanes at SF1 over phase 4's tables (lane_tables: lineitem
     and orders with their dates cast to timestamp[us], a 7-row table of
     the ship modes, a 25-row table of the phone country codes), each query
     of lane_queries on the card and through the port's host path: a
     string-key join, a join on c_phone.str.left(2), Q12's lineitem
     predicate over timestamps (composed through K1, and its two
     column-to-column compares alone through K2), a timestamp sort with
     limit, a group by a lowered string, a string if_else then distinct, a
     column-to-column string filter. Each with its rows, its routing
     counters (LANE_ROUTES, pinned by the CPU tests) and its kernel
     launches, timed cold and warm (median of 3) with the device's idle
     share; the deep query's K2 program held against its plain version and
     the composed route bit for bit, and timed. The deep program is built in
     phase 1 beside the others (from a 6,000-row lineitem of the same
     schema);
  6. the 64-bit device mode (device_x64=True), see phase_x64;
  7. the exchange between partitions on the card, in the 32-bit mode, over
     each scale's generate_tables(scale, seed=42) right after phase 3's
     joins, with lineitem, orders and customer cut into 4 partitions: a
     grouped aggregate by l_suppkey (count, max, min) whose shuffle folds
     its stage-1 pieces, and again with hierarchical_exchange_combine off
     (more exchange_rows, equal rows); at SF1 a sort on (l_shipdate desc,
     l_orderkey, l_linenumber), range-shuffled and sorted per partition on
     the card; TPC-H Q3 with broadcast_join_size_bytes_threshold=0, so both
     joins co-partition by hash shuffles (8 probes on the card) with the
     runtime join filter's Bloom probe on the card; repartition(4) then Q6;
     and at SF1 the unsigned lanes (l_linenumber as uint8, l_quantity as
     uint16, l_partkey as uint32: a wrapping projection, a filter, a sort, a
     group by, float sums over wrapping uint arithmetic through K2, and a
     uint32-key join in the 64-bit mode). Each against its
     oracle (pyarrow, numpy's wrapping arithmetic, q3_parity) with its
     routing and launches read around it, timed cold (and at SF1 warm) with
     the exchange's host share, and at SF1 the device's idle share. Phase 4's SF0.005
     run in 3 partitions also holds each query's routing to
     TPCH22_ROUTES_3P;
  8. faults on the card (needs SF1 in --scales), in the 32-bit mode over
     phase 3's SF1 lineitem and phase 7's SF1 tables, each in 4 partitions
     (phase_faults): composed Q1 with the device.kernel fault site armed
     always (threshold 2: one trip, two injected faults, two degraded
     partitions, K1 never launched) and first_n 1 (threshold 1, cooldown 0:
     one trip, one recovery, K1 on the other 3 partitions); deep Q1 as a
     DeviceSegmentOp with fuse.segment armed nth 2 (the first resident
     handoff fails, its partition runs the staged ops, K2 launches on all
     4); the hash-join Q3 with join.filter armed always (nothing pruned,
     equal rows by q3_parity, the probes and float sums still on the
     card); each beside its unarmed run, its counters pinned by
     FAULT_PINS, which tests/test_torch_faults.py pins for both packages on
     the CPU. Then K1's wrapper replaced by one that raises DaftKernelError
     (collect() raises it and the breaker stays closed), a deadline of 1e-6
     s (DaftTimeoutError with deadline_expired), and, with nothing armed,
     warm Q1 and Q6 beside phase 3's runs of the same call;
  9. the relational surface on the card (needs SF1 in --scales), in the
     32-bit mode over phase 7's SF1 tables with lineitem, orders, customer
     and nation in 4 partitions each (phase_relational,
     relational_cases): the sort-merge join of lineitem and orders
     (6,000,000 rows equal to pyarrow's join by count and by the sum of
     each numeric column, l_orderkey non-decreasing across the
     partitions, one aligned exchange of 7,500,000 rows), a grouped
     aggregate on it through K1, and the hash join of the same sides to
     time it against; the cross join of customer and nation (3,750,000
     rows), and a filter and grouped sum on it equal to the equi-join's;
     concat of two 2-partition halves then Q1 (equal to Q1 over the uncut
     frame, K1 as often); sample(0.1, seed=7) then Q1 (equal to Q1 over
     numpy's draw of the same rows); explode of each order's l_quantity
     list then a sum and count; unpivot (18,000,000 rows) then a grouped
     sum; pivot (its names through the device distinct); monotonic ids
     (partition i from i << 36), then Q6 and the largest id, whose
     counters are held to ID_PINS (tests/test_torch_reshape.py pins them
     for both packages). Each case cold with its launches counted from 0,
     against its oracle, then warm (one run);
 10. the bounded-memory exchange on the card (needs SF1 in --scales), in the
     32-bit mode over phase 7's SF1 tables with lineitem, orders and
     customer in 4 partitions each (phase_spill, spill_cases): the sort
     (async spill writes and readahead on, then off), hash-join Q3, the
     grouped aggregate by l_suppkey with the fold on, the sort-merge join
     of lineitem and orders with its grouped aggregate, and
     repartition(4, "l_returnflag") then Q1 (its low-cardinality columns
     dictionary-encoded; again with encoding off), each unbudgeted and
     under a budget of a quarter of the bytes its exchange moved (for the
     sort, a quarter of lineitem's bytes), cold then once warm. The
     budgeted run gives the unbudgeted rows, the same kernel launches and
     device sorts, probes and Bloom probes, spills, and
     leaves the ledger at 0 and no spill directory; it prints the spill
     write and read MB/s. Then each fault site of the slice armed always:
     spill.write (rows equal, spill_write_failures), spill.readback
     (DaftTransientError reaches the caller), spill.corrupt with
     synchronous writes (DaftCorruptionError, lineage truncated) on the
     sort, and
     exchange.encode (rows equal, nothing encoded) on the repartition;
 11. planning for repeated queries on the card (needs SF1 in --scales), in
     the 32-bit mode with the default knobs but a 4 GiB plan-cache cap, over
     phase 7's SF1 tables in 4 partitions (phase_adapt): Q6 twice under the
     default cap (its frame is beyond it: no hit); composed Q1, deep Q1,
     Q6 and hash-join Q3 cold, 3 times warm with the plan cache on and 3
     with it off (the last warm run a hit with no optimize, translate or
     compile call, its rows byte-identical to and its launches equal to
     the run that planned it), and Q6 with other discounts as a second
     binding; float sums by l_suppkey over 8 partitions, whose second run
     resizes the exchange; lineitem joined with January 1992's orders,
     whose second run flips to a broadcast join and third hits it; the
     same shape over 85 % of orders (the flip mispredicts and is demoted);
     the flip's query under enable_aqe; plancache.lookup armed always; the
     card's allocated bytes with the frames dropped and their plans cached,
     then with the cache cleared. Each run against a pyarrow oracle;
 12. scans on the card (needs SF1 in --scales), in the 32-bit mode, over
     parquet files that a background thread writes into a temporary
     directory while the earlier phases run, removed at the end
     (ParquetFiles, phase_scans): the 22 queries over phase 4's SF1 tables,
     each file in 8 row groups, through read_parquet(...,
     _split_row_groups=True), once each with the sub-plan result cache off,
     against phase 4's rows in memory, with each query's wall, scan tasks
     and launches; Q1 and Q6 over phase 3's SF1 lineitem sorted by
     l_shipdate in 16 row groups (one scan task), composed (K1) and deep
     (K2), cold and twice warm, against the pyarrow oracle, with the
     columns read and Q6's row groups pruned by their statistics as
     pyarrow's metadata counts them; Q6's filter and derived revenue under
     two aggregates, the second a sub-plan result-cache hit with the same
     revenue and K1 launches; the float-to-int cast on the card in both
     modes, with the reference's saturated values; then, outside the
     zero-failure checks, scan.read armed first_n 2 (2 retries, the same
     rows) and always (the reader's error after scan_retry_attempts), and a
     hash repartition of the lineitem scan under a 32 MiB budget with its
     first spill file damaged (spill.corrupt): the piece recomputes from the
     parquet file and the rows are the undamaged run's;
 13. the scan's readahead and the write path on the card (needs SF1 in
     --scales; phase_prefetch_write): phase 3's SF1 lineitem written by the
     port's own write_parquet over into_partitions(8) into a temporary
     directory the phase removes; composed Q1 (K1), deep Q1 (K2) and Q6 over
     the 8 files, one scan task each, at scan_prefetch_depth 0 and 2, cold
     and then warm once, against the pyarrow oracle at rtol 1e-6, with
     equal rows and launches at both depths, the readahead engaged at depth
     2 and the ledger's prefetch_inflight and current at 0 after each
     query; Q1's result written hive-partitioned by l_returnflag and read
     back equal; then, outside the zero-failure checks, prefetch.fetch
     armed first_n 1, whose error reaches the caller.
 14. the rest of the columnar core on the card (needs SF1 in --scales;
     phase_columnar), over phase 3's SF1 lineitem: Q1's groups with the
     sum, mean and stddev of l_quantity, l_extendedprice, l_discount and the
     discounted price over into_partitions(4), composed (stage 1 through K1,
     4 launches) and deep (K2), against the float64 pyarrow oracle (stddevs
     at rtol 1e-5), and over one partition on the host; revenue by
     dt.truncate("1 month") and by partitioning.months() of l_shipdate, and
     by l_extendedprice.hash() % 64 (sums through K1); agg_list, agg_concat,
     any_value and skew over the first 200,000 rows in 4 partitions, on the
     host, against pyarrow and numpy. One cold run each.
 15. the SQL front end and python UDFs on the card (phase_sql_udf and
     phase_sql_sf1).
 16. observability around K1 and K2 (needs SF1 in --scales;
     phase_observability), over phase 3's SF1 lineitem and phase 7's SF1
     tables: Q1 composed and deep over 1 and 4 partitions, profiled and
     unprofiled in turns (the same rows bit for bit and the same launches,
     valid profiles without orphan spans, device_dispatch phases, self time
     against op_wall_ns), Q3 with hash joins profiled into a chrome trace
     and again spilling under a budget, composed Q1 with device.kernel
     armed three times (its fault and breaker events and log line), the
     query log, health() during and after a query, metrics_text() and a
     slow query's diagnostics bundle.
 17. the partition scheduler and the morsel pipeline around K1, K2 and the
     scatter kernel (needs SF1 in --scales; phase_scheduling), over phase
     3's SF1 lineitem and phase 7's SF1 tables: Q1 composed and deep over 8
     partitions whose first declines the card, so the pool's threads launch
     K1 (and build one new K2 program once, under concurrent first use),
     bit for bit against one thread; Q1 over 4 even partitions on the
     double-buffered driver; hash-join Q3 with streaming on and off; a
     limit over a streamed chain (short-circuits, time to the first row);
     DataFrame.cancel() from a second thread during Q3; the ledger's window
     accounts at 0 after every query.
 18. the mesh runner (needs SF1 in --scales; phase_mesh), over phase 3's SF1
     lineitem and phase 7's SF1 tables, on default_mesh(8) (8 slots on the
     card) and default_mesh(): the raw exchange of l_orderkey (each
     destination's multiset against numpy, two launches bit for bit); the
     exchange fused with the scatter kernel's segment sum by order (bit for
     bit across launches, RTOL against numpy float64, exact counts); Q1 over
     repartition(8) (K1 once a partition, from the exchange's seeded
     columns), hash-join, broadcast and sort-merge Q3 and, in x64, a global
     sort and Q1, each through MeshRunner against the oracles and timed warm
     beside NativeRunner with the exchange's steps, broadcast Q3 also on one
     slot; collective.exchange armed under broadcast Q3 (the breaker trips
     once, the rows come back from the host); a
     one-process nccl group through init_distributed.
 19. object stores, lake tables and Python scan sources around K1 and K2
     (needs SF1 in --scales; phase_io), over phase 12's file of phase 4's
     SF1 lineitem (16 columns), linked and never rewritten: a Delta log over it
     (read_deltalake), an Iceberg table over it whose manifests the port's
     avro codec wrote (read_iceberg), and the file behind a loopback S3
     endpoint (LoopbackS3, read_parquet("s3://.../*.parquet")), each with
     composed Q1 (K1), deep Q1 (K2) and Q6 (K1) against the pyarrow oracle,
     cold and warm once; the endpoint's bytes for Q1 under the file's size
     (ranged reads), and Q1 again with io.get armed once (one retry, the
     same rows); write_deltalake and write_iceberg of Q1's seven columns,
     each read back through Q1; a ScanOperator of the file's row groups
     through Q1; IO_BLOBS objects through url.upload and url.download,
     equal to the bytes put.
 20. the approximate aggregations and the images around K1 (needs SF1 in
     --scales; phase_sketch_image), over phase 7's SF1 tables: K9 alone at
     the operands of approx_count_distinct(l_orderkey) by (l_shipmode,
     l_returnflag), bit for bit against the host registers; the dashboard
     (Q1's sums through K1 joined to three approximate distinct counts,
     K9 on every partition) over into_partitions(8) against pyarrow and
     the host path; approx_percentiles by l_shipmode; the mesh's register
     merge under MeshRunner; the fault sites device.kernel, collective.sketch
     and sketch.merge; K11 over 4,096 RGB 256 x 256 images (and RGB16 and
     RGB32F batches) against its plain version on the CPU; and, where PIL
     imports, the LAION pipeline over JPEGs served on 127.0.0.1.
 21. the distributed runner (needs SF1 in --scales; phase_distributed): two
     worker processes on the card, each with its own CUDA context, run the
     map tasks of composed and deep Q1 and Q6 over SF1 lineitem as 8 parquet
     files (the workers read the files), of Q1 over 8 in-memory partitions,
     of hash-join Q3 over phase 7's SF1 tables (the peer-to-peer exchange)
     and of Q1 over the files repartitioned on the workers (pieces pulled
     peer to peer); each query's rows equal NativeRunner's byte for byte,
     the driver launches no kernel and the workers launch NativeRunner's
     (their pongs' counts, a line of the phase's own); a worker SIGKILLed
     mid-query by worker.exec leaves the rows unchanged and respawns; the
     pool's shutdown leaves no process.

Every phase runs under the port's defaults: one worker thread per core
(executor_threads 0) and the morsel pipeline on. The legs whose held counts
follow the order in which pool threads finish (phase 8, phase 10's
budgeted counts, phase 16 (c) and (d)) run on one thread (ONE_THREAD), as
the reference's tests pin them, and so does phase 16 (a), whose checks read
the sequential driver's spans. Where a leg holds a map op's route counters
to the CPU tests' pins (phase 3's single ops and joins, phase 4 at SF1,
phase 5, phase 6's Q3/Q5, phase 7's unsigned projection and filter), a
chain over an in-memory partition above the morsel size streams in
device-morsel mode: its ops count one unit a morsel (morsel_units, one a
partition on the partition path and in the CPU tests, whose partitions are
all smaller) and no *_dispatches unit, and the leg holds them, with
stream_morsels, at those values.

Phases 8-11, phase 15 but its SF1 SQL leg, phases 16 to 18, 20 and 21
run after phase 7 and before phase 4, while the 22-query tables are still
being generated (BackgroundTables: a process on a core of its own, this
process's threads on the others until the tables are read; it makes phase
3's SF10 join tables first, where its temporary directory has room); phase 19 runs
last, after phase 15's SF1 SQL leg. Phases 1-10 turn feedback-directed
planning and the whole-plan result cache off (PLAN_PINS): each times its
plans as written. Every query of phases 1-7 and 9-21 (but the ids' Q6
and largest id and the fault cases of phases 10-13, 16, 20 and 21) is held
to 0 device_attempt_failures, device_breaker_trips, degraded_completions,
faults_injected, join_filter_errors and every *_fallbacks counter (phase
18's armed leg aside; Phases.watch reads them as collect() returns, and each
phase's line says how many queries it read), so that no failure the device
path caught can hide behind a passing route.

The last line of standard output is {"ok": true, "device": {...}} when every
phase passed; the exit code is 0 only then. The line before it is the card's
name and power limit as nvidia-smi reports them, the line before that the
run's total time, and the line before that the kernel table as one JSON
object: each kernel's time over its bound (`x_bound`), its launches on the
main path (null with --kernels-only, which skips phase 3) and, for K1 and K2,
pass 1's loop at the main path's shape (`loop`). Every K1/K2 check line
names the loop it ran. Imports nothing of jax or daft_tpu.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import datetime
import json
import statistics
import subprocess
import sys
import time
import traceback

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, H100 SXM data sheet
H100_FP64_FLOPS = 34e12      # fp64 outside the tensor cores, H100 SXM data sheet
RTOL = 1e-6
RTOL_X64 = 1e-9              # phase 6, the 64-bit mode, against the pyarrow oracle
SF1_BUCKET = 8_388_608       # size_bucket of SF1's 6,000,000 lineitem rows


def q1(lineitem, shipdate: datetime.date = datetime.date(1998, 9, 2)):
    """TPC-H Q1 (pricing summary report) over a daft_tpu_torch DataFrame
    (``shipdate`` is the predicate's literal; phase 17 changes it to make a
    new deep program)."""
    from daft_tpu_torch import col

    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    charge = disc_price * (1 + col("l_tax"))
    return (
        lineitem
        .where(col("l_shipdate") <= shipdate)
        .groupby("l_returnflag", "l_linestatus")
        .agg(
            col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            disc_price.sum().alias("sum_disc_price"),
            charge.sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order"),
        )
        .sort(["l_returnflag", "l_linestatus"])
    )


def q1_with_columns(lineitem):
    """TPC-H Q1 with its derived columns written as with_column steps, as
    DataFrame users write them: it plans as one DeviceSegmentOp."""
    from daft_tpu_torch import col

    return (
        lineitem
        .with_column("disc_price", col("l_extendedprice") * (1 - col("l_discount")))
        .with_column("charge", col("disc_price") * (1 + col("l_tax")))
        .where(col("l_shipdate") <= datetime.date(1998, 9, 2))
        .groupby("l_returnflag", "l_linestatus")
        .agg(
            col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            col("disc_price").sum().alias("sum_disc_price"),
            col("charge").sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order"),
        )
        .sort(["l_returnflag", "l_linestatus"])
    )


def q6(lineitem):
    """TPC-H Q6 (forecasting revenue change) over a daft_tpu_torch DataFrame."""
    from daft_tpu_torch import col

    return (
        lineitem
        .where((col("l_shipdate") >= datetime.date(1994, 1, 1))
               & (col("l_shipdate") < datetime.date(1995, 1, 1))
               & (col("l_discount") >= 0.05)
               & (col("l_discount") <= 0.07)
               & (col("l_quantity") < 24))
        .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue"))
    )


def q3(customer, orders, lineitem):
    """TPC-H Q3 (shipping priority: 3-way join, aggregate, top 10) over
    daft_tpu_torch DataFrames, as benchmarks/tpch.py writes it."""
    from daft_tpu_torch import col

    cutoff = datetime.date(1995, 3, 15)
    c = customer.where(col("c_mktsegment") == "BUILDING")
    o = orders.where(col("o_orderdate") < cutoff)
    l = lineitem.where(col("l_shipdate") > cutoff)
    return (
        c.join(o, left_on="c_custkey", right_on="o_custkey")
        .join(l, left_on="o_orderkey", right_on="l_orderkey")
        .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
        .groupby("o_orderkey", "o_orderdate", "o_shippriority")
        .agg(col("revenue").sum().alias("revenue"))
        .select("o_orderkey", "revenue", "o_orderdate", "o_shippriority")
        .sort(["revenue", "o_orderdate"], desc=[True, False])
        .limit(10)
    )


def q5(customer, orders, lineitem, nation):
    """The TPC-H-shaped Q5 of benchmarks/tpch.py (revenue by nation for the
    ASIA region in 1994) over daft_tpu_torch DataFrames."""
    from daft_tpu_torch import col

    lo = datetime.date(1994, 1, 1)
    hi = datetime.date(1995, 1, 1)
    n = nation.where(col("n_regionname") == "ASIA")
    o = orders.where((col("o_orderdate") >= lo) & (col("o_orderdate") < hi))
    return (
        n.join(customer, left_on="n_nationkey", right_on="c_nationkey")
        .join(o, left_on="c_custkey", right_on="o_custkey")
        .join(lineitem, left_on="o_orderkey", right_on="l_orderkey")
        .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
        .groupby("n_name")
        .agg(col("revenue").sum().alias("revenue"))
        .sort("revenue", desc=True)
    )


def tpch22_module(path: str = "benchmarks/tpch_queries.py"):
    """The 22 TPC-H queries of ``benchmarks/tpch_queries.py`` (``QUERIES``,
    ``SQL``) with ``col`` and ``lit`` bound to daft_tpu_torch. That file
    imports them from daft_tpu, which imports jax: its text is parsed, that
    one import is dropped, and the rest runs in a fresh namespace."""
    import ast
    import os
    import types

    import daft_tpu_torch

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)) as f:
        tree = ast.parse(f.read(), path)
    tree.body = [st for st in tree.body
                 if not (isinstance(st, ast.ImportFrom) and st.module == "daft_tpu")]
    mod = types.ModuleType("tpch_queries_torch")
    mod.col, mod.lit = daft_tpu_torch.col, daft_tpu_torch.lit
    exec(compile(tree, path, "exec"), mod.__dict__)
    return mod


def parity(got: dict, want: dict, rtol: float) -> bool:
    """bench.py's _parity rule: same keys and lengths, floats within
    max(rtol * |want|, 1e-6), everything else equal."""
    if set(got) != set(want):
        return False
    for k in want:
        if len(got[k]) != len(want[k]):
            return False
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float):
                if abs(a - b) > max(rtol * abs(b), 1e-6):
                    return False
            elif a != b:
                return False
    return True


def oracle_q3_groups(customer, orders, lineitem) -> dict:
    """Q3's groups before its sort and limit, by pyarrow (the joins and the
    aggregate of benchmarks/tpch.py's oracle_q3): o_orderkey -> (revenue,
    o_orderdate, o_shippriority). o_orderkey determines the other two keys."""
    import pyarrow as pa
    import pyarrow.compute as pc

    cutoff = pa.scalar(datetime.date(1995, 3, 15))
    c = customer.filter(pc.equal(customer["c_mktsegment"], "BUILDING"))
    o = orders.filter(pc.less(orders["o_orderdate"], cutoff))
    l = lineitem.filter(pc.greater(lineitem["l_shipdate"], cutoff))
    j = c.join(o, keys="c_custkey", right_keys="o_custkey", join_type="inner")
    j = j.join(l, keys="o_orderkey", right_keys="l_orderkey", join_type="inner")
    j = j.append_column("revenue", pc.multiply(j["l_extendedprice"],
                                               pc.subtract(pa.scalar(1.0), j["l_discount"])))
    g = j.group_by(["o_orderkey", "o_orderdate", "o_shippriority"]).aggregate(
        [("revenue", "sum")]).to_pydict()
    return {k: (r, d, p) for k, r, d, p in zip(g["o_orderkey"], g["revenue_sum"],
                                                g["o_orderdate"], g["o_shippriority"])}


def q3_parity(got: dict, want: dict, groups: dict, rtol: float) -> bool:
    """Q3's top 10 follows a float32 sum, so two groups whose float64
    revenues differ by less than float32 rounding may trade places at the
    limit. The port's 10 revenues must equal the oracle's 10 at ``rtol`` in
    order, and each port row (o_orderkey, revenue, o_orderdate,
    o_shippriority) must be a row of the oracle's result before the limit,
    at the same tolerance."""
    if set(got) != set(want) or len(got["revenue"]) != len(want["revenue"]):
        return False
    for a, b in zip(got["revenue"], want["revenue"]):
        if abs(a - b) > max(rtol * abs(b), 1e-6):
            return False
    for k, r, d, p in zip(got["o_orderkey"], got["revenue"], got["o_orderdate"],
                          got["o_shippriority"]):
        if k not in groups:
            return False
        wr, wd, wp = groups[k]
        if abs(r - wr) > max(rtol * abs(wr), 1e-6) or (d, p) != (wd, wp):
            return False
    return True


# Phases 1-10 time each plan as it is written: with the whole-plan result
# cache on, a repeated collect would be served the result of the DataFrame
# still held from the run before, and with feedback-directed planning on, a
# repeated shape would flip its joins and resize its exchanges between a
# phase's cold and warm runs. Phase 11 measures both under the defaults; the
# plan cache stays on everywhere (a warm run that skips planning is what a
# user's repeated query gets).
PLAN_PINS = {"enable_result_cache": False, "history_fdo": False}
# the legs whose held counts follow the order in which pool threads finish
# (phase 8's armed faults and breaker, phase 10's budgeted spill counts,
# phase 16 (c) and (d)) run on one executor thread, as the reference's own
# tests pin them (tests/test_faults.py, tests/torch_parity.py SPILL_BASE),
# and so does phase 16 (a), whose checks read the sequential driver's spans
ONE_THREAD = {"executor_threads": 1}


def morsel_units(rows: int) -> int:
    """The units a device-pipelinable map op counts over one in-memory
    partition of ``rows`` rows under the defaults: one a morsel,
    ceil(rows / morsel_size_rows), where the partition is above the morsel
    size (device-morsel mode streams the chain), else one (the partition
    path, as in the CPU tests)."""
    import daft_tpu_torch as dtt

    m = dtt.ExecutionConfig().morsel_size_rows
    return -(-rows // m) if rows > m else 1


def streamed_morsels(*rows: int) -> int:
    """stream_morsels of chains over one partition each of ``rows`` rows:
    the morsels of those above the morsel size (the others do not stream)."""
    return sum(morsel_units(n) for n in rows if morsel_units(n) > 1)


def config(**kw):
    """The ExecutionConfig of phases 1-10: ``kw`` over PLAN_PINS."""
    import daft_tpu_torch as dtt

    return dtt.ExecutionConfig(**{**PLAN_PINS, **kw})


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, flops: float = H100_FP32_FLOPS) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their type's rate (fp32 unless
    ``flops`` says otherwise)."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / flops * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def loop_name(g: int, k: int) -> str:
    """Pass 1's loop for G groups and K columns (one launch's chunk)."""
    from daft_tpu_torch.kernels import segment_sums as ss

    return ss.LOOP_NAMES[ss.pass1_loop(g, min(k, 32))]


def crossover(k: int) -> tuple:
    """(largest G that takes the rows loop, smallest G that takes the
    outputs loop) for K columns."""
    from daft_tpu_torch.kernels import segment_sums as ss

    rows = [g for g in range(1, ss.MAX_GROUPS + 1) if ss.pass1_loop(g, k) == ss.LOOP_ROWS]
    return max(rows), max(rows) + 1


def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two float32 or float64 tensors (NaN payloads
    included)."""
    import torch

    ints = torch.int64 if a.element_size() == 8 else torch.int32
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints), b.view(ints)))


# counters every query of phases 1-7 must leave at 0, with every counter
# named *_fallbacks: a failure the device path caught (a device attempt that
# failed, a breaker trip, a degraded partition, an injected fault, a join
# filter that failed open) must not hide behind a passing route
HEALTH_COUNTERS = ("device_attempt_failures", "device_breaker_trips", "degraded_completions",
                   "faults_injected", "join_filter_errors")


class Phases:
    def __init__(self):
        self.failures = []
        self.phase = None     # the phase whose queries are held to HEALTH_COUNTERS
        self.queries = 0      # ... how many of them collected so far
        self.unhealthy = 0    # ... and how many of those caught a failure
        self.collects = []    # the counters of every query collected (watch)

    def check(self, ok: bool, what: str) -> bool:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)
        return ok

    def watch(self) -> None:
        """Hold every query collected from now on to 0 in HEALTH_COUNTERS
        and in every *_fallbacks counter while a phase is open (``begin``):
        DataFrame.collect checks the query's counters as it returns."""
        from daft_tpu_torch.dataframe import DataFrame

        real, ph = DataFrame.collect, self

        def collect(df, *args, **kwargs):
            fresh = df._result is None
            out = real(df, *args, **kwargs)
            if fresh:
                ph.collects.append(df.stats.snapshot()["counters"])
            if fresh and ph.phase is not None:
                ph.queries += 1
                c = df.stats.snapshot()["counters"]
                bad = {k: v for k, v in c.items()
                       if v and (k in HEALTH_COUNTERS or k.endswith("_fallbacks"))}
                if bad:
                    ph.unhealthy += 1
                    print(f"{ph.phase}: query {ph.queries} caught a failure on the device "
                          f"path: {bad}", flush=True)
            return out

        DataFrame.collect = collect

    def begin(self, phase) -> None:
        """Close the open phase, failing it if a query of it caught a
        failure, and open ``phase`` (None: no phase, as in phase 8, which
        arms faults)."""
        if self.phase is not None:
            self.check(self.unhealthy == 0,
                       f"{self.phase}: {self.queries - self.unhealthy} of its {self.queries} "
                       f"queries with 0 failed attempts, trips, degraded completions, "
                       f"injected faults, join-filter errors and fallbacks")
        self.phase, self.queries, self.unhealthy = phase, 0, 0


# ---------------------------------------------------------------------------
# phase 1: builds
# ---------------------------------------------------------------------------

def q1_new_nodes(lineitem):
    """A deep program at the Q1 shape whose sum holds an if_else under a
    numeric is_in filter: the nodes K2's emitter took on with the
    expression function surface."""
    from daft_tpu_torch import col

    rev = (col("l_discount") > 0.05).if_else(
        col("l_extendedprice") * (1 - col("l_discount")), 0.0)
    return (lineitem.where(col("l_quantity").is_in([1, 5, 24]))
            .groupby("l_returnflag", "l_linestatus")
            .agg(rev.sum().alias("rev"))
            .sort(["l_returnflag", "l_linestatus"]))


DEEP_PLANS = {"q1": q1, "q6": q6, "q1_with_columns": q1_with_columns,
              "q1_new_nodes": q1_new_nodes}


def unsigned_deep_table(lineitem):
    """Unsigned columns from either lineitem generator: l_quantity as uint8
    and as uint16, the floor of l_extendedprice as uint32, and
    l_extendedprice itself."""
    import pyarrow as pa
    import pyarrow.compute as pc

    price = lineitem["l_extendedprice"]
    return pa.table({"u8": lineitem["l_quantity"].cast(pa.uint8()),
                     "u16": lineitem["l_quantity"].cast(pa.uint16()),
                     "u32": pc.floor(price).cast(pa.uint32()), "p": price})


def unsigned_deep(frame):
    """A deep program over the unsigned lanes of ``unsigned_deep_table``: a
    predicate and float sums over uint arithmetic that wraps at each width
    (quantity**4 past 65535, price**2 past 2**32, quantity**2 past 255
    under a subtraction)."""
    from daft_tpu_torch import DataType, col

    q4 = col("u16") * col("u16") * col("u16") * col("u16")
    f64 = DataType.float64()
    return (frame.where(q4 > 30000).groupby("u8")
            .agg((col("u32") * col("u32")).cast(f64).sum().alias("sq"),
                 q4.cast(DataType.float32()).sum().alias("q4"),
                 (col("u8") - col("u8") * col("u8")).cast(f64).sum().alias("d8"),
                 (col("u32") // 7 + col("u32") % 5).cast(f64).sum().alias("dm"),
                 col("p").sum().alias("p"), col("p").count().alias("n")))


def unsigned_deep_oracle(ut) -> dict:
    """``unsigned_deep`` in numpy's wrapping uint arithmetic and float64
    sums: {u8 key -> (sq, q4, d8, dm, p, n)}."""
    import numpy as np

    u8, u16, u32 = (ut[c].to_numpy() for c in ("u8", "u16", "u32"))
    price = ut["p"].to_numpy()
    q4 = u16 * u16 * u16 * u16
    sel = q4 > 30000
    keys = u8[sel]
    cols = [(u32 * u32), q4, (u8 - u8 * u8), (u32 // 7 + u32 % 5), price]
    sums = [np.bincount(keys, weights=c[sel].astype(np.float64), minlength=256) for c in cols]
    n = np.bincount(keys, minlength=256)
    return {int(k): tuple(float(s[k]) for s in sums) + (int(n[k]),) for k in np.unique(keys)}


def edge_specs():
    """Phase-2 edge cases of K2 over a synthetic schema: name -> (predicate
    or None, child expressions)."""
    from daft_tpu_torch import DataType, col

    derived = [col("x") * col("y"), col("x") - col("y") * 2.5, col("x") / col("y")]
    return {
        "nan_nulls_ragged": (col("d") < 50, derived),
        "k33": (col("d") < 80, [col("x") * (j + 1) + col("y") for j in range(33)]),
        "rejects_all": (col("d") > 1000, derived),
        "casts": (None, [col("f").cast(DataType.int8()).cast(DataType.float64()),
                         col("f").cast(DataType.int16()).cast(DataType.float64()),
                         col("f").cast(DataType.int32()).cast(DataType.float64()),
                         col("f") // col("y"), col("f") % col("y"),
                         (col("d") // 7).cast(DataType.float64()),
                         ((col("d") % 7) * 3 - 2).cast(DataType.float64())]),
    }


def edge_schema():
    from daft_tpu_torch import DataType, Field, Schema

    return Schema([Field("x", DataType.float64()), Field("y", DataType.float64()),
                   Field("d", DataType.int64()), Field("f", DataType.float64())])


def edge_programs() -> dict:
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels.device import normalize_and_check

    schema = edge_schema()
    dtypes = {"x": torch.float32, "y": torch.float32, "d": torch.int32, "f": torch.float32}
    progs = {}
    for name, (pred, kids) in edge_specs().items():
        pnode = normalize_and_check([pred], schema)[0] if pred is not None else None
        progs[name] = fes.program(pnode, normalize_and_check(kids, schema), schema, dtypes)
    return progs


def enumerate_deep_programs() -> list:
    """The K2 programs of every deep plan the main path drives: the engine
    plans each one on a 4096-row frame on the CPU (K2's plain version there),
    which generates the same programs the card runs at every scale."""
    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch.kernels import fused_expr_sums as fes

    dtt.set_execution_config(config(device="cpu", device_min_rows=1,
                                    use_deep_fusion_kernel=True))
    small = dtt.from_arrow(tpch.generate_lineitem_only(
        scale=4096 / tpch.LINEITEM_ROWS_PER_SF, seed=1)).collect()
    for plan in DEEP_PLANS.values():
        plan(small).collect()
    # phase 5's deep plan over its own schema (tables of the 22 queries)
    from benchmarks import tpch_full

    lanes = {k: dtt.from_arrow(v).collect()
             for k, v in lane_tables(tpch_full.generate(scale=0.001, seed=7)).items()}
    lane_queries(dtt)["timestamps_deep"][0](lanes).collect()
    # phase 12's deep Q1 and Q6 over a parquet file: the filter is read in
    # the scan, so their programs hold no predicate
    import tempfile

    import pyarrow.parquet as papq

    with tempfile.TemporaryDirectory(prefix="chip_smoke_deep_") as tmp:
        path = f"{tmp}/lineitem.parquet"
        papq.write_table(small.to_arrow(), path, row_group_size=1024)
        dtt.set_execution_config(config(device="cpu", device_min_rows=1,
                                        use_deep_fusion_kernel=True,
                                        scan_tasks_min_size_bytes=1 << 40))
        for plan in (q1, q6):
            plan(dtt.read_parquet(path, _split_row_groups=True)).collect()
    # phase 8's deep segment over 4 partitions: its stage-1 program, and the
    # staged ops' program (the plan with residency off) that a failed
    # resident handoff runs; stage 2 stays on the host, under
    # device_min_rows, as at SF1
    build = fault_cases()["q1_segment_handoff"][0]
    li = small.to_arrow()
    four = dtt.from_arrow([li.slice(i * 1024, 1024) for i in range(FAULT_PARTS)]).collect()
    for residency in (True, False):
        dtt.set_execution_config(config(
            device="cpu", device_min_rows=64, use_deep_fusion_kernel=True,
            device_residency=residency))
        build({"lineitem_4": four}).collect()
    # phase 14's deep stddev over 4 partitions: its stage-1 program (the
    # sums of x and x * x); stage 2 stays on the host, as at SF1
    dtt.set_execution_config(config(device="cpu", device_min_rows=64,
                                    use_deep_fusion_kernel=True))
    q1_stddev(dtt.from_arrow([li.slice(i * 1024, 1024) for i in range(COLUMNAR_PARTS)])).collect()
    # phase 15's deep Q1 over a host-run UDF chain, in 1 and 4 partitions:
    # stage 1's program, and stage 2's over the partials at device_min_rows=8
    dtt.set_execution_config(config(device="cpu", device_min_rows=8,
                                    use_deep_fusion_kernel=True))
    for parts in UDF_PARTS:
        q1_udf(dtt, dtt.from_arrow([li.slice(i * (4096 // parts), 4096 // parts)
                                    for i in range(parts)]), []).collect()
    # phase 16's deep Q1 over 4 partitions: stage 1's program; stage 2 stays
    # on the host, under device_min_rows, as at SF1
    dtt.set_execution_config(config(device="cpu", device_min_rows=64,
                                    use_deep_fusion_kernel=True))
    q1(dtt.from_arrow([li.slice(i * 1024, 1024) for i in range(OBS_PARTS)])).collect()
    return fes.programs()


def phase_build(ph: Phases) -> dict:
    """Start nvcc on K1 and every K2 program at once, wait for all, and
    print each build's time. Returns the edge-case programs."""
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    edges = edge_programs()
    progs = enumerate_deep_programs()
    t0 = time.perf_counter()
    k1_job = ss.start_build()
    sc_job = scs.start_build()
    jobs = {"K1 masked_segment_sums": k1_job, "scatter segment_scatter_sums": sc_job}
    for i, prog in enumerate(progs):
        jobs[f"K2 program {i} (K={prog.k}, columns {','.join(prog.names)})"] = prog.start_build()
    done = {}
    while len(done) < len(jobs):
        for name, job in jobs.items():
            if name not in done and (job is None or job.done()):
                done[name] = time.perf_counter() - t0
        time.sleep(0.05)
    ss.finish_build(k1_job)
    scs.finish_build(sc_job)
    for prog in progs:
        prog.build()
    for name, secs in done.items():
        print(f"built {name} in {secs:.2f}s (all builds started together)", flush=True)
    ph.check(len(progs) >= len(DEEP_PLANS) + len(edges)
             and all(hasattr(scs.build(), f"segment_scatter_sums_{t}") for t in ("f32", "f64")),
             f"phase 1: {len(progs)} K2 programs, K1 and the scatter kernel (its float32 and "
             f"float64 instantiations) built for sm_90a")
    logs = ([("K1", ss.BUILD_LOG), ("scatter", scs.BUILD_LOG)]
            + [(f"K2 program {i}", p.build_log) for i, p in enumerate(progs)])
    for label, log in logs:
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {label}: " + line.strip(), flush=True)
    fes.LAUNCHES = fes.ENTRIES = 0
    return edges


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------

def k1_operands(n: int, g: int, k: int, seed: int, used_groups: int = 6):
    """Main-path-shaped K1 operands on the card: codes over `used_groups` of
    the g slots, a mask keeping ~98% of rows (Q1's filter), money-like values."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, used_groups, (n, 1), generator=gen, device="cuda", dtype=torch.int32)
    mask = (torch.rand((n, 1), generator=gen, device="cuda") < 0.98).to(torch.float32)
    vals = torch.rand((n, k), generator=gen, device="cuda") * 104100.0 + 900.0
    return codes, mask, vals


def exact64(codes, mask, vals, g):
    """float64 sums and summed magnitudes per group (the oracle)."""
    import torch

    v = torch.where(mask != 0, vals.double(), 0.0)
    idx = codes.view(-1).long()
    sums = torch.zeros((g, vals.shape[1]), dtype=torch.float64, device=vals.device).index_add_(0, idx, v)
    mags = torch.zeros_like(sums).index_add_(0, idx, v.abs())
    return sums, mags


def check_k1(ph: Phases, name: str, codes, mask, vals, g: int) -> float:
    """Kernel vs plain version (bit for bit: the plain version adds in the
    kernel's order) and vs float64 at rtol 1e-6 of the summed magnitudes, and
    two launches bit for bit. Returns max |kernel - plain|."""
    import torch

    from daft_tpu_torch.kernels import segment_sums as ss

    a = ss.masked_segment_sums_padded(codes, mask, vals, g)
    b = ss.masked_segment_sums_padded(codes, mask, vals, g)
    torch.cuda.synchronize()
    plain = ss.masked_segment_sums_plain(codes, mask, vals, g)
    sums, mags = exact64(codes, mask, vals, g)
    bnd = RTOL * mags + 1e-30
    name = f"{name} [{loop_name(g, vals.shape[1])} loop]"
    ph.check(torch.equal(a, b), f"K1 {name}: two launches agree bit for bit")
    ph.check(same_bits(a, plain), f"K1 {name}: equals its plain version bit for bit")
    ok_exact = bool(((a.double() - sums).abs() <= bnd).all())
    err = float((a - plain).abs().max())
    ph.check(ok_exact and bool(torch.isfinite(a).all()),
             f"K1 {name}: matches float64 at rtol {RTOL} (max |kernel-plain| {err:.6g})")
    return err


def phase_k1(ph: Phases) -> dict:
    """Phase 2, K1 against its plain version; returns its kernel-table entry."""
    import numpy as np
    import torch

    from daft_tpu_torch.kernels import segment_sums as ss

    n = SF1_BUCKET
    entry = {"name": "masked_segment_sums", "route": "cuda",
             "source": "daft_tpu_torch/csrc/masked_segment_sums.cu",
             "replaces": "daft_tpu/kernels/pallas_ops.py:66"}
    shapes = {}
    for k in (7, 1):  # Q1 and Q6 at SF1
        codes, mask, vals = k1_operands(n, 16, k, seed=k)
        err = check_k1(ph, f"main path n={n} G=16 K={k}", codes, mask, vals, 16)
        vk = torch.where(mask != 0, vals, 0.0)
        idx = codes.view(-1)
        ms = cuda_ms(lambda: ss.masked_segment_sums_padded(codes, mask, vals, 16), iters=20)
        plain_ms = cuda_ms(lambda: ss.masked_segment_sums_plain(codes, mask, vals, 16),
                           iters=2, warmup=1)
        library_ms = cuda_ms(lambda: torch.zeros((16, k), device="cuda").index_add_(0, idx, vk),
                             iters=20)
        shapes[k] = {"loop": loop_name(16, k), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms,
                     **bound(n * (4 + 4 + 4 * k) + 16 * k * 4, 2 * n * k),
                     "library_ms": library_ms}
        shapes[k]["x_bound"] = ms / shapes[k]["bound_ms"]
        if k == 7:  # each block one group: every row of a chain hits one sum
            codes_sorted = torch.sort(codes.view(-1)).values.view(n, 1)
            check_k1(ph, f"sorted codes n={n} G=16 K={k}", codes_sorted, mask, vals, 16)
            shapes[k]["sorted_codes_ms"] = cuda_ms(
                lambda: ss.masked_segment_sums_padded(codes_sorted, mask, vals, 16), iters=20)
            del codes_sorted
        print("K1 timing " + json.dumps({"n": n, "G": 16, "K": k, **shapes[k]}), flush=True)
        del codes, mask, vals, vk
    entry.update(shapes[7])

    # edge cases: the widest group bucket, an all-masked block, NaN behind the
    # mask, more columns than one launch takes, and a padded ragged tail
    codes, mask, vals = k1_operands(1 << 20, 4096, 2, seed=11, used_groups=4096)
    check_k1(ph, "G=4096", codes, mask, vals, 4096)
    for g in crossover(7):  # both sides of the loops' crossover at Q1's K
        codes, mask, vals = k1_operands(1 << 20, g, 7, seed=g, used_groups=g)
        check_k1(ph, f"crossover G={g} K=7", codes, mask, vals, g)
    codes, mask, vals = k1_operands(1 << 16, 16, 3, seed=12)
    mask[3 * 1024:4 * 1024] = 0  # one whole block masked out
    vals[mask.view(-1) == 0, 1] = float("nan")  # NaN behind the mask
    check_k1(ph, "all-masked block + NaN behind the mask", codes, mask, vals, 16)
    codes, mask, vals = k1_operands(1 << 14, 16, 40, seed=13)
    check_k1(ph, "K=40 (two launches)", codes, mask, vals, 16)
    rng = np.random.RandomState(14)
    nr = 1_000_003
    c = rng.randint(0, 7, nr)
    m = rng.rand(nr) < 0.9
    v = rng.rand(nr, 3) * 68000 + 900
    got, cnt = ss.masked_segment_sums(c, m, v, 16, device="cuda")
    want = np.zeros((16, 3))
    for j in range(3):
        np.add.at(want[:, j], c[m], v[m, j])
    ph.check(bool(np.all(np.abs(got - want) <= RTOL * np.abs(want)))
             and (cnt == np.bincount(c[m], minlength=16)).all(),
             f"K1 ragged tail n={nr}: numpy-level wrapper matches float64, counts exact")
    return entry


# ---------------------------------------------------------------------------
# phase 2: K2
# ---------------------------------------------------------------------------

def capture_k2_operands(frame, plan) -> tuple:
    """Run ``plan`` through the engine on the card with deep fusion and
    return the (program, codes, env, n, groups) it handed K2."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes

    seen = []
    wrapped = fes.fused_expr_sums

    def record(prog, codes, env, n, num_groups):
        seen.append((prog, codes, {k: env[k] for k in prog.names}, n, num_groups))
        return wrapped(prog, codes, env, n, num_groups)

    dtt.set_execution_config(config(use_deep_fusion_kernel=True))
    fes.fused_expr_sums = record
    try:
        plan(frame).collect()
    finally:
        fes.fused_expr_sums = wrapped
    if len(seen) != 1:
        raise RuntimeError(f"expected one K2 call, the engine made {len(seen)}")
    return seen[0]


def check_k2(ph: Phases, name: str, prog, codes, env, n: int, g: int) -> dict:
    """K2 against its plain version and the composed route (the same
    operands through K1), both bit for bit, and two launches bit for bit."""
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    a = fes.fused_expr_sums(prog, codes, env, n, g)
    b = fes.fused_expr_sums(prog, codes, env, n, g)
    torch.cuda.synchronize()
    plain = prog.plain(codes, env, n, g)
    composed = ss.masked_segment_sums_padded(*prog.operands(codes, env, n), g)
    name = f"{name} [{loop_name(g, prog.k)} loop]"
    ph.check(same_bits(a, b), f"K2 {name}: two launches agree bit for bit")
    ph.check(same_bits(a, plain), f"K2 {name}: equals its plain version bit for bit")
    ph.check(same_bits(a, composed), f"K2 {name}: equals the composed route (torch derive, "
                                     f"stack, K1) bit for bit")
    diff = (a - plain).abs()
    return {"max_abs_err": float(torch.nan_to_num(diff, nan=float("inf")).max())}


def time_k2(prog, codes, env, n: int, g: int) -> dict:
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    b = codes.shape[0]
    _c, _m, vk = prog.operands(codes, env, n)
    idx = codes.view(-1)
    out = {
        "ms": cuda_ms(lambda: fes.fused_expr_sums(prog, codes, env, n, g), iters=20),
        "composed_ms": cuda_ms(
            lambda: ss.masked_segment_sums_padded(*prog.operands(codes, env, n), g), iters=20),
        "plain_ms": cuda_ms(lambda: prog.plain(codes, env, n, g), iters=2, warmup=1),
        # the library call for the reduction part: no single torch call
        # evaluates K2's expressions and sums them
        "library_ms": cuda_ms(
            lambda: torch.zeros((g, prog.k), device="cuda").index_add_(0, idx, vk), iters=20),
    }
    # pass 1 reads the codes of every padded block, and a column's values and
    # validity only for the n real rows; the row body runs on those rows alone.
    # A tensor bound under two names (an epoch's hi and lo lanes share one
    # validity) is read once.
    lanes = {t.data_ptr(): t for nm in prog.names for t in env[nm]}
    row_bytes = sum(t.element_size() for t in lanes.values())
    nbytes = b * 4 + n * row_bytes + g * prog.k * 4
    out.update(bound(nbytes, n * (2 * prog.k + prog.row_ops)))
    out["x_bound"] = out["ms"] / out["bound_ms"]
    return out


def edge_env(n_pad: int, seed: int):
    """Synthetic columns of edge_schema() on the card: NaN in x wherever
    d >= 50 (behind Q-shaped predicates), about 10% nulls, f with NaN, +-inf
    and values outside every int range, and garbage in the padding rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.randint(0, 100, (n_pad,), generator=gen, device="cuda", dtype=torch.int32)
    x = torch.rand(n_pad, generator=gen, device="cuda") * 1000 + 1
    x = torch.where(d >= 50, float("nan"), x)
    y = torch.rand(n_pad, generator=gen, device="cuda") * 9 - 4.5
    f = (torch.rand(n_pad, generator=gen, device="cuda") - 0.5) * 2e5
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e10, -1e10, 127.9,
                             -128.9, 128.0, -129.0, 32767.5, -32769.0, 2147483648.0,
                             -2147483904.0, -0.0, 0.0], device="cuda")
    f[:len(specials)] = specials
    valid = {k: torch.rand(n_pad, generator=gen, device="cuda") > 0.1 for k in "xydf"}
    return {"x": (x, valid["x"]), "y": (y, valid["y"]), "d": (d, valid["d"]),
            "f": (f, valid["f"])}


def phase_k2(ph: Phases, lineitem, edges: dict) -> dict:
    """Phase 2, K2: the SF1 Q1 and Q6 operands the engine gives it, then the
    edge cases; returns its kernel-table entry."""
    import torch

    import daft_tpu_torch as dtt

    entry = {"name": "fused_expr_sums", "route": "cuda",
             "source": "daft_tpu_torch/kernels/fused_expr_sums.py",
             "replaces": "daft_tpu/kernels/pallas_ops.py:86"}
    frame = dtt.from_arrow(lineitem).collect()
    shapes = {}
    for qname, plan in (("q1", q1), ("q6", q6), ("q1_new_nodes", q1_new_nodes)):
        prog, codes, env, n, g = capture_k2_operands(frame, plan)
        print(f"K2 {qname} operands: n={n} padded to {codes.shape[0]}, G={g}, K={prog.k}, "
              "columns " + ", ".join(f"{nm} {env[nm][0].dtype}" for nm in prog.names),
              flush=True)
        shapes[qname] = check_k2(ph, f"main path {qname} n={codes.shape[0]} G={g} K={prog.k}",
                                 prog, codes, env, n, g)
        shapes[qname].update(loop=loop_name(g, prog.k), **time_k2(prog, codes, env, n, g))
        print(f"K2 timing {qname} " + json.dumps(shapes[qname]), flush=True)
    entry.update(shapes["q1"])
    entry["q6_shape"] = shapes["q6"]
    entry["q1_new_nodes_shape"] = shapes["q1_new_nodes"]
    # the unsigned lanes (uint8, uint16 in int32, uint32 in int64), each
    # masked to its width in the generated row function
    prog, codes, env, n, g = capture_k2_operands(
        dtt.from_arrow(unsigned_deep_table(lineitem)).collect(), unsigned_deep)
    print(f"K2 unsigned operands: n={n} padded to {codes.shape[0]}, G={g}, K={prog.k}, columns "
          + ", ".join(f"{nm} {env[nm][0].dtype}" for nm in prog.names), flush=True)
    entry["unsigned_shape"] = check_k2(ph, f"unsigned lanes n={codes.shape[0]} G={g} "
                                           f"K={prog.k}", prog, codes, env, n, g)
    del frame, prog, codes, env
    torch.cuda.empty_cache()

    n_pad = 1 << 20
    below, above = crossover(edges["nan_nulls_ragged"].k)
    for name, n, g in (("nan_nulls_ragged", n_pad - 77, 16), ("nan_nulls_ragged", n_pad, 4096),
                       ("nan_nulls_ragged", n_pad - 77, below),
                       ("nan_nulls_ragged", n_pad - 77, above),
                       ("k33", n_pad, 16), ("rejects_all", n_pad, 16), ("casts", n_pad, 16)):
        env = edge_env(n_pad, seed=len(name) + g)
        gen = torch.Generator(device="cuda").manual_seed(g)
        codes = torch.randint(0, g, (n_pad,), generator=gen, device="cuda", dtype=torch.int32)
        prog = edges[name]
        check_k2(ph, f"edge {name} n={n} of {n_pad} G={g} K={prog.k}", prog, codes, env, n, g)
        if name == "rejects_all":
            out = prog.plain(codes, env, n, g)
            ph.check(bool((out == 0).all()), "K2 edge rejects_all: every sum is 0")
    return entry


# ---------------------------------------------------------------------------
# phase 2: the scatter-sums kernel
# ---------------------------------------------------------------------------

# a large shape: the padded rows and groups stated for TPC-H Q3 at SF1 when
# this kernel was planned (the main path's own SF1 shape is smaller; phase 3
# captures it and checks the kernel there too)
SCATTER_LARGE = (262_144, 148_152)


def scatter_operands(b: int, g: int, seed: int, sort_codes: bool = False,
                     masked: float = 0.2, dtype=None):
    """Scatter-sum operands on the card: codes over g segments (random or
    sorted), money-like values (float32, or float64 with every bit of the
    mantissa drawn), a fraction of the rows masked to 0.0."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, g, (b,), generator=gen, device="cuda", dtype=torch.int32)
    if sort_codes:
        codes = torch.sort(codes).values
    vals = torch.rand(b, generator=gen, device="cuda",
                      dtype=dtype or torch.float32) * 104100.0 + 900.0
    keep = torch.rand(b, generator=gen, device="cuda") >= masked
    return torch.where(keep, vals, 0.0), codes


def library_scatter(values, codes, g: int):
    """The library route: torch's index_add_ for the chunk partials (atomics
    on the card) and device._kahan_combine (4 launches a chunk), the port's
    route before the kernel. Timed here only."""
    import torch

    from daft_tpu_torch.kernels.device import _kahan_combine

    b = values.shape[0]
    chunk = min(8192, b)
    nch = b // chunk
    flat = torch.arange(nch, device=codes.device).repeat_interleave(chunk) * g + codes.long()
    partials = torch.zeros(nch * g, dtype=values.dtype,
                           device=values.device).index_add_(0, flat, values)
    return _kahan_combine(partials.view(nch, g))


def scatter_bound(vals, codes, g: int) -> dict:
    """What the function must do: codes and values of the b rows read once
    and G sums written once; one addition for each row that joins a chain
    (nonzero value, code in range) and the 4 operations of each of the
    nch x G Kahan steps, at the fp32 or the fp64 rate. The partials are the
    two-pass design's own traffic, not the function's."""
    b = vals.shape[0]
    nch = b // min(8192, b)
    adds = int(((vals != 0) & (codes >= 0) & (codes < g)).sum())
    width = vals.element_size()
    return bound(b * (4 + width) + g * width, adds + 4 * nch * g,
                 H100_FP64_FLOPS if width == 8 else H100_FP32_FLOPS)


def queued_cuda_ms(fn, calls: int = 20) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events, with the calls
    queued behind a torch.cuda._sleep of 10**8 cycles (about 50 ms at the
    H100's clocks): the host enqueues all of them while the card sleeps, so
    the events see the calls back to back, without the wrapper's host cost
    between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 ** 8)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def scatter_device_ms(vals, codes, g: int, calls: int = 20) -> dict:
    """Device time per call of the scatter kernel's two passes, from
    torch.profiler over `calls` calls (the mean over the launches the trace
    holds): the card's own time, apart from the wrapper's host cost that
    CUDA events around the calls also see.
    A session whose trace holds no time for either pass is made once more;
    if the second sees none either, the device events it did hold are
    listed and device_ms comes from queued_cuda_ms (both passes of each call
    together: they launch inside one C call). ``device_ms_method`` names the
    method; ``queued_events_ms`` is the second method's number in any case."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from daft_tpu_torch.kernels import scatter_sums as scs

    queued = queued_cuda_ms(lambda: scs.scatter_sum_kahan(vals, codes, g), calls)
    for _attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                scs.scatter_sum_kahan(vals, codes, g)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        out = {}
        for name in ("pass1", "pass2"):
            # per traced launch: a trace that drops some launches (it
            # happens) must not read as a faster kernel
            seen = [e for e in events if f"scatter_{name}" in e.key]
            count = sum(e.count for e in seen)
            out[f"{name}_device_ms"] = (sum(e.self_device_time_total for e in seen) / 1e3 / count
                                        if count else 0.0)
            out[f"{name}_launches_traced"] = count
        out["queued_events_ms"] = queued
        if out["pass1_device_ms"] > 0.0 and out["pass2_device_ms"] > 0.0:
            out["device_ms"] = out["pass1_device_ms"] + out["pass2_device_ms"]
            out["device_ms_method"] = "profiler"
            return out
    out["profiler_device_events"] = [[e.key[:60], e.count] for e in events]
    out["device_ms"] = queued
    out["device_ms_method"] = "cuda events, calls queued behind a sleep"
    return out


def check_scatter(ph: Phases, name: str, vals, codes, g: int) -> float:
    """The kernel against its plain version bit for bit, two launches bit for
    bit, and float64 sums at rtol 1e-6 (1e-12 for float64 values) of the
    summed magnitudes. Returns max |kernel - plain|."""
    import torch

    from daft_tpu_torch.kernels import scatter_sums as scs

    a = scs.scatter_sum_kahan(vals, codes, g)
    b = scs.scatter_sum_kahan(vals, codes, g)
    torch.cuda.synchronize()
    plain = scs.scatter_sum_kahan_plain(vals, codes, g)
    idx = codes.long()
    exact = torch.zeros(g, dtype=torch.float64, device=vals.device).index_add_(
        0, idx, vals.double())
    mags = torch.zeros_like(exact).index_add_(0, idx, vals.double().abs())
    rtol = 1e-12 if vals.dtype == torch.float64 else RTOL
    ph.check(same_bits(a, b), f"scatter {name}: two launches agree bit for bit")
    ph.check(same_bits(a, plain), f"scatter {name}: equals its plain version bit for bit")
    err = float((a - plain).abs().max())
    ok = bool(((a.double() - exact).abs() <= rtol * mags + 1e-30).all())
    ph.check(ok and bool(torch.isfinite(a).all()),
             f"scatter {name}: matches float64 at rtol {rtol} (max |kernel-plain| {err:.6g})")
    return err


def time_scatter(vals, codes, g: int) -> dict:
    """CUDA-event times of the kernel's wrapper, its plain version and the
    library route at one shape, beside the bound and the profiler's device
    time of the kernel's two passes; also whether two runs of the library
    route gave the same bits."""
    from daft_tpu_torch.kernels import scatter_sums as scs

    b = vals.shape[0]
    out = {"b": b, "G": g,
           "ms": cuda_ms(lambda: scs.scatter_sum_kahan(vals, codes, g), iters=20),
           "plain_ms": cuda_ms(lambda: scs.scatter_sum_kahan_plain(vals, codes, g),
                               iters=2, warmup=1),
           "library_ms": cuda_ms(lambda: library_scatter(vals, codes, g), iters=20),
           "library_runs_same_bits": same_bits(library_scatter(vals, codes, g),
                                               library_scatter(vals, codes, g))}
    out.update(scatter_bound(vals, codes, g))
    out["x_bound"] = out["ms"] / out["bound_ms"]
    out.update(scatter_device_ms(vals, codes, g))
    if out["device_ms"] is not None:
        out["device_x_bound"] = out["device_ms"] / out["bound_ms"]
    return out


def phase_scatter(ph: Phases, dtype=None) -> dict:
    """Phase 2, the scatter kernel (phase 6 for its float64 instantiation,
    ``dtype=torch.float64``): G = 4097 (just above K1's range), the large
    shape with random and sorted codes, an all-masked input and the
    smallest bucket; returns its kernel-table entry (the large shape's
    numbers until phase 3, or 6, measures the main path's shape)."""
    import torch

    from daft_tpu_torch.kernels import scatter_sums as scs

    f64 = dtype == torch.float64
    tag = "f64 " if f64 else ""
    entry = {"name": "segment_scatter_sums_f64" if f64 else "segment_scatter_sums",
             "route": "cuda", "source": "daft_tpu_torch/csrc/segment_scatter_sums.cu",
             "replaces": "daft_tpu/kernels/device.py:2679"}
    for sort_codes in (False, True):
        vals, codes = scatter_operands(65_536, 4097, seed=1, sort_codes=sort_codes, dtype=dtype)
        check_scatter(ph, f"{tag}b=65536 G=4097 {'sorted' if sort_codes else 'random'} codes",
                      vals, codes, 4097)
    b, g = SCATTER_LARGE
    vals, codes = scatter_operands(b, g, seed=2, dtype=dtype)
    entry["max_abs_err"] = check_scatter(ph, f"{tag}large b={b} G={g} random codes", vals,
                                         codes, g)
    entry.update(time_scatter(vals, codes, g))
    vals, codes = scatter_operands(b, g, seed=3, sort_codes=True, dtype=dtype)
    check_scatter(ph, f"{tag}large b={b} G={g} sorted codes", vals, codes, g)
    entry["sorted_codes_ms"] = cuda_ms(lambda: scs.scatter_sum_kahan(vals, codes, g), iters=20)
    print(f"scatter {tag}timing " + json.dumps(entry), flush=True)
    vals, codes = scatter_operands(8192, 5000, seed=4, masked=1.0, dtype=dtype)
    out = scs.scatter_sum_kahan(vals, codes, 5000)
    ph.check(bool((out.view(torch.int32) == 0).all()),
             f"scatter {tag}all rows masked: every sum is +0.0")
    vals, codes = scatter_operands(1024, 5000, seed=5, dtype=dtype)
    check_scatter(ph, f"{tag}smallest bucket b=1024 G=5000", vals, codes, 5000)
    # one chunk spreads over 32 CTAs (R = 1024 owners): G = 1000 leaves the
    # last CTA no segment at all
    vals, codes = scatter_operands(8192, 1000, seed=6, dtype=dtype)
    check_scatter(ph, f"{tag}b=8192 G=1000, fewer segments than owners", vals, codes, 1000)
    if f64:  # the +-0.0 rows, which pass 1 leaves out of every chain
        vals, codes = scatter_operands(65_536, 4097, seed=8, dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(8)
        pick = torch.rand(codes.shape[0], generator=gen, device="cuda", dtype=dtype)
        vals = torch.where(pick < 0.2, -0.0, torch.where(pick < 0.3, -vals, vals))
        check_scatter(ph, f"{tag}b=65536 G=4097, 20% of rows -0.0, 10% negative", vals,
                      codes, 4097)
    vals, codes = scatter_operands(65_536, 4097, seed=7, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    bad = torch.rand(codes.shape[0], generator=gen, device="cuda") < 0.3
    far = torch.tensor([-1, -5000, 4097, 4128, 1 << 30], device="cuda", dtype=torch.int32)
    codes = torch.where(bad, far[torch.randint(0, 5, codes.shape, generator=gen,
                                                device="cuda")], codes)
    a = scs.scatter_sum_kahan(vals, codes, 4097)
    ph.check(same_bits(a, scs.scatter_sum_kahan_plain(vals, codes, 4097)),
             f"scatter {tag}b=65536 G=4097, 30% of codes outside [0, G): equals its plain "
             "version bit for bit")
    del vals, codes
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

PORT_KERNEL_NAMES = ("ss_pass1", "ss_pass2", "scatter_pass1", "scatter_pass2")


def profile_queries(queries: dict, frame, rows: int, card: str, reps: int = 5) -> None:
    """torch.profiler over `reps` warm runs of each query: wall and device-busy
    time per query, the device's idle share, the top kernels by device time
    and the port's own kernels. Prints one JSON line per query."""
    for name, query in queries.items():
        query(frame).collect().to_pydict()
        res, kernels = device_profile(lambda query=query: query(frame).collect().to_pydict(),
                                      reps)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        # the port's own kernels (K1/K2 passes, the scatter passes), top 12 or not
        ours = [e for e in kernels if any(n in e.key for n in PORT_KERNEL_NAMES)]
        print(f"profile {name} " + json.dumps({
            "rows": rows, **res, "card": card,
            "top": [[e.key[:80], e.count // reps, e.self_device_time_total / 1e3 / reps]
                    for e in top],
            "port_kernels": [[e.key[:80], e.count // reps,
                              e.self_device_time_total / 1e3 / reps] for e in ours]}),
              flush=True)


def device_profile(run, reps: int) -> tuple:
    """torch.profiler over ``reps`` calls of ``run`` (warm): ({wall_ms,
    device_busy_ms, device_idle_share, device_events} per call, the device
    events). Busy time counts device-side events only (kernels, memcpys):
    the aten:: host ops also carry the device time of the kernels they
    launched. A trace that holds no device event (the profiler drops one
    now and then) is taken once more; if the second holds none either, the
    busy time and idle share are None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels:
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
            return ({"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / wall_ms,
                     "device_events": sum(e.count for e in kernels) // reps}, kernels)
    return ({"wall_ms": wall_ms, "device_busy_ms": None, "device_idle_share": None,
             "device_events": 0}, kernels)


# warm runs of phase 3's timings at SF1; past SF1 one (phases 15 and 18
# took the time of the others at SF10, where each Q3 and Q5 run takes
# seconds)
WARM_RUNS_SF1 = 5
WARM_RUNS_PAST_SF1 = 1


def warm_runs(scale: float) -> int:
    return WARM_RUNS_SF1 if scale <= 1.0 else WARM_RUNS_PAST_SF1


def warm_median(query, frame, runs: int = 5, fetch: str = "to_pydict",
                keep: bool = False) -> dict:
    """Warm wall time of ``query(frame)``: collect, then ``fetch`` the
    result (to_arrow for results of millions of rows). ``keep`` adds every
    run's time (``warm_s``) and the median of each operator's wall time
    over the runs (``op_ms``, from the query's RuntimeStats)."""
    import torch

    warm, ops = [], {}
    for _ in range(runs):
        t0 = time.perf_counter()
        df = query(frame).collect()
        getattr(df, fetch)()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if keep:
            for op, ns in df.stats.snapshot()["op_wall_ns"].items():
                ops.setdefault(op, []).append(ns / 1e6)
    out = {"warm_median_s": statistics.median(warm), "warm_min_s": min(warm),
           "warm_max_s": max(warm), "warm_runs": len(warm)}
    if keep:
        out.update(warm_s=warm, op_ms={k: statistics.median(v) for k, v in ops.items()})
    return out


def drive(ph: Phases, label: str, query, frame, want: dict, deep: bool, segment: bool,
          group_codes: bool = False) -> dict:
    """Drive one path once through the engine (cold), with the kernels'
    launch counts set to 0 just before and read just after; check the result
    and that the path ran on the card through its kernel."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    dtt.set_execution_config(config(use_deep_fusion_kernel=deep))
    ss.LAUNCHES = fes.LAUNCHES = 0
    t0 = time.perf_counter()
    df = query(frame).collect()
    got = df.to_pydict()
    cold = time.perf_counter() - t0
    k1, k2 = ss.LAUNCHES, fes.LAUNCHES
    c = df.stats.snapshot()["counters"]
    ph.check(parity(got, want, RTOL), f"{label}: matches the pyarrow oracle at rtol {RTOL}")
    on_card = (c.get("device_aggregations", 0) >= 1 and c.get("device_agg_fallbacks", 0) == 0
               and (k2, k1) == ((1, 0) if deep else (0, 1)))
    if segment:
        on_card = on_card and c.get("device_resident_segments") == 1 \
            and c.get("segment_fallbacks", 0) == 0
    if group_codes:  # the first grouped query on a frame computes its codes on the card
        on_card = on_card and c.get("device_group_codes", 0) >= 1
    ph.check(on_card, f"{label}: ran on the card through {'K2' if deep else 'K1'} "
                      f"(K1 launches {k1}, K2 launches {k2}, counters {c})")
    return {"cold_s": cold, "k1_launches": k1, "k2_launches": k2}


def phase_main_path(ph: Phases, scale: float, lineitem, card: str, profile: bool) -> dict:
    """Phase 3 at one scale factor: Q1/Q6 composed (K1) and deep (K2), then
    the with_column Q1 through a DeviceSegmentOp with K2 and with K1."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch

    rows = lineitem.num_rows
    want = {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}
    queries = {"q1": q1, "q6": q6}
    out = {"rows": rows, "k1_launches": 0, "k2_launches": 0}

    def record(key, res):
        res.update(rows=rows, card=card)
        if "warm_median_s" in res:
            res["warm_rows_per_s"] = rows / res["warm_median_s"]
        out[key] = res
        out["k1_launches"] += res.get("k1_launches", 0)
        out["k2_launches"] += res.get("k2_launches", 0)
        print(f"SF{scale:g} {key} " + json.dumps(res), flush=True)

    frame = dtt.from_arrow(lineitem).collect()
    runs = warm_runs(scale)
    for name, query in queries.items():  # the composed route through K1
        res = drive(ph, f"SF{scale:g} {name}", query, frame, want[name], deep=False,
                    segment=False, group_codes=name == "q1")
        record(name, {**res, **warm_median(query, frame, runs)})
    for name, query in queries.items():  # the deep route through K2
        res = drive(ph, f"SF{scale:g} {name} deep", query, frame, want[name], deep=True,
                    segment=False)
        # deep against composed, back to back (bench.py's q1_deep_pallas_vs_composed)
        res.update({f"deep_{k}": v for k, v in warm_median(query, frame, runs).items()})
        dtt.set_execution_config(config(use_deep_fusion_kernel=False))
        res.update({f"composed_{k}": v for k, v in warm_median(query, frame, runs).items()})
        res["composed_over_deep"] = res["composed_warm_median_s"] / res["deep_warm_median_s"]
        record(f"{name}_deep", res)
    if profile:
        profile_queries(queries, frame, rows, card)
        dtt.set_execution_config(config(use_deep_fusion_kernel=True))
        profile_queries({"q1_deep": q1}, frame, rows, card)
    del frame
    torch.cuda.empty_cache()

    # the map chain: a fresh frame, so the first run stages its columns
    frame = dtt.from_arrow(lineitem).collect()
    for deep in (True, False):
        key = "q1_with_columns_" + ("deep" if deep else "composed")
        res = drive(ph, f"SF{scale:g} {key}", q1_with_columns, frame, want["q1"], deep=deep,
                    segment=True, group_codes=deep)
        record(key, {**res, **warm_median(q1_with_columns, frame, runs)})
    del frame
    torch.cuda.empty_cache()
    return out


def phase_multi_partition(ph: Phases, lineitem, card: str, single: dict, profile: bool,
                          nparts: int = 4) -> dict:
    """Phase 3, the two-stage aggregate: Q1 and Q6 (composed route) over the
    lineitem table cut into ``nparts`` equal partitions. Stage 1 aggregates
    each partition through K1, a hash shuffle (Q1) or a gather (Q6) moves the
    partials, stage 2 merges them. Each query is driven once with K1's
    launch count set to 0 just before and read just after, held against the
    pyarrow oracle, and timed warm beside the one-partition warm median of
    this run (``single``); with ``profile``, traced warm as well."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    rows = lineitem.num_rows
    step = -(-rows // nparts)
    frame = dtt.from_arrow([lineitem.slice(i * step, step) for i in range(nparts)]).collect()
    want = {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}
    out = {"k1_launches": 0}
    for name, query in (("q1", q1), ("q6", q6)):
        label = f"{nparts}-partition {name}"
        dtt.set_execution_config(config())
        ss.LAUNCHES = fes.LAUNCHES = 0
        t0 = time.perf_counter()
        df = query(frame).collect()
        got = df.to_pydict()
        cold = time.perf_counter() - t0
        k1, k2 = ss.LAUNCHES, fes.LAUNCHES
        c = df.stats.snapshot()["counters"]
        ph.check(parity(got, want[name], RTOL),
                 f"{label}: matches the pyarrow oracle at rtol {RTOL}")
        # every aggregation on the card (stage 1 on each partition, stage 2
        # when its partials reach device_min_rows) sums its floats in one K1
        # launch; stage 2 over a few partial rows runs on the host
        stage2 = c.get("device_aggregations", 0) - nparts
        # Q1: the partials' hash shuffle, then its sort's range shuffle
        ok = (k1 == nparts + stage2 and stage2 >= 0 and k2 == 0
              and c.get("shuffles", 0) == (2 if name == "q1" else 0)
              and c.get("device_agg_fallbacks", 0) == 0)
        ph.check(ok, f"{label}: {nparts} stage-1 aggregations and {stage2} stage-2 ones on "
                     f"the card through K1 (launches {k1}), "
                     f"{'two shuffles' if name == 'q1' else 'a gather'} (counters {c})")
        res = {"parts": nparts, "cold_s": cold, "k1_launches": k1,
               "stage2_device_aggregations": stage2,
               "counters": {k: c.get(k, 0) for k in (
                   "device_aggregations", "host_aggregations", "shuffles",
                   "device_group_codes", "device_agg_fallbacks")},
               **warm_median(query, frame), "rows": rows, "card": card}
        res["one_partition_warm_median_s"] = single[name]["warm_median_s"]
        res["over_one_partition"] = res["warm_median_s"] / res["one_partition_warm_median_s"]
        out[name] = res
        out["k1_launches"] += k1
        print(f"SF1 {label} " + json.dumps(res), flush=True)
        del df
    if profile:
        dtt.set_execution_config(config())
        profile_queries({f"q1_{nparts}_parts": q1, f"q6_{nparts}_parts": q6}, frame, rows, card)
    del frame
    torch.cuda.empty_cache()
    return out


def single_op_oracles(lineitem) -> dict:
    """pyarrow's answers for phase_single_ops: columns of the filtered rows,
    the projected column, and the distinct (l_returnflag, l_linestatus) pairs in
    first-occurrence order."""
    import numpy as np
    import pyarrow.compute as pc

    cutoff = datetime.date(1995, 3, 15)
    kept = lineitem.filter(pc.greater(lineitem["l_shipdate"], cutoff))
    combined = np.zeros(lineitem.num_rows, dtype=np.int64)
    for name in ("l_returnflag", "l_linestatus"):
        enc = lineitem[name].combine_chunks().dictionary_encode()
        combined = combined * (len(enc.dictionary) + 1) + np.asarray(enc.indices.fill_null(-1)) + 1
    _, first = np.unique(combined, return_index=True)
    first = np.sort(first)
    return {
        "filter": {c: kept[c].to_numpy() for c in ("l_quantity", "l_extendedprice",
                                                    "l_shipdate")},
        "projection": lineitem["l_quantity"].to_numpy() * 2,
        "distinct": list(zip(*(lineitem[c].take(first).to_pylist()
                               for c in ("l_returnflag", "l_linestatus")))),
    }


def phase_single_ops(ph: Phases, lineitem, card: str) -> dict:
    """Phase 3, the single-op hooks at SF1 over lineitem: a lone filter (its
    mask on the card, the compaction on the host), a one-expression
    projection and a distinct of two string columns (the group-codes
    kernel's first rows). Each is driven once with its device counter read
    from the query's stats (the filter and the projection stream, one unit
    a morsel), held against pyarrow, and timed warm."""
    import numpy as np
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch import col

    cutoff = datetime.date(1995, 3, 15)
    queries = {
        "filter": (lambda f: f.where(col("l_shipdate") > cutoff), "device_filters"),
        "projection": (lambda f: f.select(col("l_quantity") * 2), "device_projections"),
        "distinct": (lambda f: f.select("l_returnflag", "l_linestatus").distinct(),
                     "device_distincts"),
    }
    want = single_op_oracles(lineitem)
    units = morsel_units(lineitem.num_rows)
    expect = {"filter": (units, streamed_morsels(lineitem.num_rows)),
              "projection": (units, streamed_morsels(lineitem.num_rows)), "distinct": (1, None)}
    dtt.set_execution_config(config())
    frame = dtt.from_arrow(lineitem).collect()
    out = {}
    for name, (query, counter) in queries.items():
        t0 = time.perf_counter()
        df = query(frame).collect()
        got = df.to_arrow()
        cold = time.perf_counter() - t0
        c = df.stats.snapshot()["counters"]
        if name == "filter":
            ok = all(np.array_equal(got[k].to_numpy(), v) for k, v in want["filter"].items())
        elif name == "projection":
            ok = bool(np.allclose(got["l_quantity"].to_numpy(), want["projection"],
                                  rtol=RTOL, atol=0.0))
        else:
            ok = list(zip(*(got[k].to_pylist() for k in ("l_returnflag", "l_linestatus")))) \
                == want["distinct"]
        ph.check(ok, f"SF1 single {name}: matches pyarrow ({got.num_rows} rows)")
        n, morsels = expect[name]
        ph.check(c.get(counter) == n and morsels in (None, c.get("stream_morsels", 0)),
                 f"SF1 single {name}: ran on the card ({counter} {c.get(counter)}, want {n}"
                 f"{'' if morsels is None else f', stream_morsels {morsels}'}; counters {c})")
        res = {"cold_s": cold, "out_rows": got.num_rows, "counters": c,
               **warm_median(query, frame, fetch="to_arrow"),
               "rows": lineitem.num_rows, "card": card}
        out[name] = res
        print(f"SF1 single {name} " + json.dumps(res), flush=True)
        del df, got
    del frame
    torch.cuda.empty_cache()
    return out


def join_routes(name: str, rows: dict) -> dict:
    """The routing of an optimized join query that phases 3 and 6 hold, over
    one partition a table of ``rows[table]`` rows: the reference's plan and
    counters, every join side pruned, Q3's three chains fused and on the
    card (customer's string filter through the string-literal lane), Q5's
    orders chain on the card, its nation chain (25 rows, under
    device_min_rows) on the host and its pure-selection Projects over
    customer and lineitem on the card, each chain counted one unit a morsel
    where it streams (morsel_units). A streamed Project is not dispatched
    by the partition path: device_projection_dispatches counts the others."""
    u = {k: morsel_units(n) for k, n in rows.items()}
    if name == "q3":
        return {"device_fused_maps": u["customer"] + u["orders"] + u["lineitem"],
                "host_filters": 0,
                "stream_morsels": streamed_morsels(rows["customer"], rows["orders"],
                                                   rows["lineitem"])}
    return {"device_fused_maps": u["orders"],
            "device_projections": u["customer"] + u["lineitem"] + 2 * u["orders"],
            "device_projection_dispatches": sum(u[k] == 1 for k in ("customer", "lineitem")),
            "stream_morsels": streamed_morsels(rows["customer"], rows["orders"],
                                               rows["lineitem"])}


ROUTE_COUNTERS = ("fused_chains", "device_fused_maps", "host_fused_maps", "device_filters",
                  "host_filters", "device_projections", "device_projection_dispatches",
                  "host_projections")


JOIN_QUERIES = {
    "q3": (q3, ("customer", "orders", "lineitem"), 2),
    "q5": (q5, ("customer", "orders", "lineitem", "nation"), 3),
}


def physical_plan(df) -> str:
    """The physical plan the port runs for ``df`` (optimized, translated,
    fused), as one line per operator."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import translate

    return translate(optimize(df._plan), dtt.get_context().execution_config).display_tree()


def join_breakdown(run, reps: int = 3) -> dict:
    """Wall milliseconds per warm query of each phase of a join query,
    by wrapping the port's functions with timers that synchronise the card
    before and after each call (so device time lands in its phase):
    the fused map chains (launch: staging and the program; resolve: the
    fetch and the host compaction), the single projections and filters
    dispatched to the card (launch and resolve), the key staging and probe
    launch, the probe's resolve (its sync and fetch), the host assembly of
    the join's output, the filters, fused chains and aggregations that run
    on the host, the plan segment (launch and fetch) and the sort."""
    import torch

    from daft_tpu_torch import execution, physical
    from daft_tpu_torch.fuse import segment
    from daft_tpu_torch.kernels import device_join

    acc: dict = {}

    def timed(fn, label, resolve_label=None):
        """fn timed under label; with resolve_label, the resolver it returns
        is timed under that label."""
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
            if resolve_label is not None and out is not None:
                return timed(out, resolve_label)
            return out
        return call

    ctx = execution.ExecutionContext
    patches = [(ctx, "eval_fused_dispatch", "fused map launch", "fused map resolve"),
               (ctx, "eval_projection_dispatch", "projection dispatch",
                "projection resolve"),
               (ctx, "eval_filter_dispatch", "filter dispatch", "filter resolve"),
               (device_join, "device_join_launch", "probe launch (key staging)",
                "probe resolve (sync, fetch)"),
               (segment, "run_segment_async", "segment launch", "segment resolve"),
               (ctx, "_assemble_join", "join assembly (host)", None),
               (ctx, "eval_sort", "sort", None),
               (physical.FilterOp, "map_partition_declined", "filters (host)", None),
               (ctx, "_eval_fused_host", "fused maps (host)", None),
               (ctx, "_eval_agg_host", "aggregations (host)", None)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _l, _r in patches]
    try:
        for obj, name, label, resolve_label in patches:
            setattr(obj, name, timed(getattr(obj, name), label, resolve_label))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    out = {k: v * 1e3 / reps for k, v in acc.items()}
    out["wall_ms"] = wall * 1e3 / reps
    out["other_ms"] = out["wall_ms"] - sum(v for k, v in out.items() if k != "wall_ms")
    return out


def phase_joins(ph: Phases, scale: float, card: str, profile: bool,
                keep_tables: bool = False, tables=None) -> dict:
    """Phase 3, the join path at one scale factor: TPC-H Q3 and Q5 over one
    set of tables (generate_tables(scale, seed=42)), each driven once cold
    with every kernel's launch count set to 0 just before and read just
    after, checked against the pyarrow oracle, then timed warm. The
    operands the engine hands the scatter kernel in Q3 and K1 in Q5 are
    kept from the cold run; each kernel is then held against its plain
    version bit for bit at those operands, and the scatter kernel is timed
    there. With ``keep_tables`` the host tables come back as
    ``out["tables"]`` (phases 6 and 7 run Q3 over them) and Q3's oracle as
    ``out["q3_oracle"]``. ``tables``, when given, are those tables, made
    elsewhere (BackgroundTables)."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    t0 = time.perf_counter()
    where = "read from the background process"
    if tables is None:
        tables = tpch.generate_tables(scale=scale, seed=42)
        where = "generated"
    print(f"SF{scale:g}: tables {where} in {time.perf_counter() - t0:.1f}s ("
          + ", ".join(f"{k} {v.num_rows}" for k, v in tables.items()) + ")", flush=True)
    frames = {k: dtt.from_arrow(v).collect() for k, v in tables.items()}
    want = {"q3": tpch.oracle_q3(*[tables[a] for a in JOIN_QUERIES["q3"][1]]),
            "q5": tpch.oracle_q5(*[tables[a] for a in JOIN_QUERIES["q5"][1]])}
    groups3 = oracle_q3_groups(*[tables[a] for a in JOIN_QUERIES["q3"][1]])
    out = {}
    # (module, wrapper) whose calls each query's cold run records
    capture = {"q3": (scs, "scatter_sum_kahan"), "q5": (ss, "masked_segment_sums_padded")}
    captured = {"q3": [], "q5": []}
    for name, (query, args, probes) in JOIN_QUERIES.items():
        def plan(_frame=None, query=query, args=args):
            return query(*[frames[a] for a in args])

        def run(plan=plan):
            return plan().collect()

        dtt.set_execution_config(config())
        module, attr = capture[name]
        real = getattr(module, attr)

        def record(*operands, real=real, seen=captured[name]):
            seen.append(operands)
            return real(*operands)

        setattr(module, attr, record)
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        try:
            t0 = time.perf_counter()
            df = run()
            got = df.to_pydict()
            cold = time.perf_counter() - t0
        finally:
            setattr(module, attr, real)
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        c = df.stats.snapshot()["counters"]
        label = f"SF{scale:g} {name}"
        ok = (q3_parity(got, want[name], groups3, RTOL) if name == "q3"
              else parity(got, want[name], RTOL))
        ph.check(ok, f"{label}: matches the pyarrow oracle at rtol {RTOL}")
        on_card = (c.get("device_join_probes") == probes
                   and c.get("device_resident_segments") == 1
                   and c.get("device_agg_fallbacks", 0) == 0
                   and (c.get("device_sorts", 0) >= 1 and launches["scatter"] >= 1
                        if name == "q3" else launches["k1"] >= 1))
        ph.check(on_card, f"{label}: joins probed on the card ({probes}), the aggregate "
                          f"resident, through its kernel (launches {launches}, counters {c})")
        want_route = join_routes(name, {k: v.num_rows for k, v in tables.items()})
        route = {k: c.get(k, 0) for k in want_route}
        ph.check(route == want_route,
                 f"{label}: the optimized plan's routing {route} (want {want_route})")
        res = {"cold_s": cold, "launches": launches,
               "group_codes": "device" if c.get("device_group_codes") else "host",
               "counters": {k: c.get(k, 0) for k in (
                   "device_join_probes", "broadcast_joins", "host_joins", "device_sorts",
                   "host_sorts", "device_group_codes", "device_resident_segments",
                   "device_agg_fallbacks") + ROUTE_COUNTERS},
               "plan": physical_plan(plan()),
               "rows": {k: tables[k].num_rows for k in args}, "card": card}
        res.update(warm_median(plan, None, warm_runs(scale)))
        if profile:
            res["breakdown_ms"] = join_breakdown(run)
            profile_queries({f"{name}_warm": plan}, None, tables["lineitem"].num_rows, card)
        out[name] = res
        print(f"SF{scale:g} {name} " + json.dumps(res), flush=True)
        del df
    ph.check(len(captured["q3"]) == 1 and len(captured["q5"]) == 1,
             f"SF{scale:g}: Q3 called the scatter kernel's wrapper once "
             f"({len(captured['q3'])}), Q5 K1's once ({len(captured['q5'])})")
    for vals, codes, g in captured["q3"]:
        name = f"main path SF{scale:g} Q3 b={vals.shape[0]} G={g}"
        err = check_scatter(ph, name, vals, codes, g)
        out["scatter_main"] = {"max_abs_err": err, **time_scatter(vals, codes, g)}
        print(f"scatter timing main path SF{scale:g} " + json.dumps(out["scatter_main"]),
              flush=True)
    for codes, mask, vals, g in captured["q5"]:
        name = f"main path SF{scale:g} Q5 n={codes.shape[0]} G={g} K={vals.shape[1]}"
        out["k1_q5"] = {"n": codes.shape[0], "G": g, "K": vals.shape[1],
                        "max_abs_err": check_k1(ph, name, codes, mask, vals, g)}
    if keep_tables:
        out["tables"] = tables
        out["q3_oracle"] = (want["q3"], groups3)  # phase 7 runs Q3 over them again
    del frames, tables, captured
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the 22 TPC-H queries of benchmarks/tpch_queries.py
# ---------------------------------------------------------------------------

TPCH22_BIG_TABLES = ("lineitem", "orders", "customer", "partsupp")
# queries whose float sums run on the card in the CPU tests at SF0.005
# (tests/test_torch_tpch22.py, device_min_rows=8): through K1 there; at SF1
# an aggregate of more than 4096 groups sums through the scatter kernel
TPCH22_CARD_SUMS = (1, 3, 5, 6, 7, 8, 9, 10, 11, 14, 15, 17, 18, 19, 22)
# of those, the ones with a float sum over at most 4096 groups at SF1 (Q3,
# Q10, Q15 and Q18 group by an order, customer or supplier key; Q17's
# average groups by part key, and its final sum / 7.0 runs on the host)
TPCH22_K1 = (1, 5, 6, 7, 8, 9, 11, 14, 19, 22)
# queries whose filters take the new dictionary and is_in lanes, all of
# them on the card in the CPU tests: none of their filters may run on the host
TPCH22_LANE_FILTERS = (9, 12, 13, 14, 16, 19, 22)
# (device_aggregations, host_aggregations) of each query, one partition per
# table: tests/test_torch_tpch22.py holds the port's counters at SF0.005 to
# these and to the reference's; the same routes hold at SF1. Q16's grouped
# count_distinct, and Q17's, Q21's and Q22's aggregates over a host input,
# run on the host in both packages
TPCH22_AGG_ROUTES = {1: (1, 0), 2: (1, 0), 3: (1, 0), 4: (1, 0), 5: (1, 0), 6: (1, 0),
                     7: (1, 0), 8: (1, 0), 9: (1, 0), 10: (1, 0), 11: (1, 0), 12: (1, 0),
                     13: (2, 0), 14: (1, 0), 15: (1, 0), 16: (0, 1), 17: (1, 1), 18: (2, 0),
                     19: (1, 0), 20: (1, 0), 21: (1, 2), 22: (0, 1)}
# the routing of each query at SF0.005 with the four large tables in 3
# partitions (device_min_rows=8): tests/test_torch_tpch22_partitions.py holds
# the port's counters to these and to the reference's, and phase 4 the card's
_ROUTES_3P = ("device_aggregations", "host_aggregations", "device_sorts", "host_sorts",
              "device_join_probes", "host_joins", "shuffles")
TPCH22_ROUTES_3P = {
    1: dict(zip(_ROUTES_3P, (4, 2, 0, 3, 0, 0, 2))),
    2: dict(zip(_ROUTES_3P, (1, 0, 0, 1, 6, 2, 0))),
    3: dict(zip(_ROUTES_3P, (6, 0, 1, 0, 6, 0, 2))),
    4: dict(zip(_ROUTES_3P, (3, 3, 0, 3, 3, 0, 2))),
    5: dict(zip(_ROUTES_3P, (3, 3, 0, 3, 15, 0, 2))),
    6: dict(zip(_ROUTES_3P, (3, 1, 0, 0, 0, 0, 0))),
    7: dict(zip(_ROUTES_3P, (3, 3, 0, 3, 15, 0, 2))),
    8: dict(zip(_ROUTES_3P, (1, 5, 0, 3, 19, 2, 2))),
    9: dict(zip(_ROUTES_3P, (6, 0, 3, 0, 15, 0, 2))),
    10: dict(zip(_ROUTES_3P, (6, 0, 1, 0, 9, 0, 2))),
    11: dict(zip(_ROUTES_3P, (6, 0, 3, 0, 6, 0, 2))),
    12: dict(zip(_ROUTES_3P, (3, 3, 0, 3, 3, 0, 2))),
    13: dict(zip(_ROUTES_3P, (9, 3, 0, 3, 3, 0, 3))),
    14: dict(zip(_ROUTES_3P, (3, 1, 0, 0, 3, 0, 0))),
    15: dict(zip(_ROUTES_3P, (6, 0, 0, 3, 1, 2, 2))),
    16: dict(zip(_ROUTES_3P, (0, 3, 3, 0, 6, 0, 2))),
    17: dict(zip(_ROUTES_3P, (6, 1, 0, 0, 0, 6, 1))),
    18: dict(zip(_ROUTES_3P, (10, 2, 0, 3, 9, 0, 3))),
    19: dict(zip(_ROUTES_3P, (3, 1, 0, 0, 3, 0, 0))),
    20: dict(zip(_ROUTES_3P, (6, 0, 0, 3, 8, 4, 4))),
    21: dict(zip(_ROUTES_3P, (1, 11, 0, 3, 13, 2, 4))),
    22: dict(zip(_ROUTES_3P, (0, 6, 0, 3, 3, 0, 2))),
}
# the same routes in the 64-bit device mode (device_x64=True): phase 6 holds
# the card to them, tests/test_torch_tpch22_x64.py the port and the reference
# at SF0.005
TPCH22_X64_AGG_ROUTES = TPCH22_AGG_ROUTES
# (device_fused_maps, host_fused_maps) of the queries whose chains take the
# new lanes, held the same way
TPCH22_LANE_MAPS = {9: (1, 0), 12: (1, 0), 13: (1, 0), 14: (1, 0), 16: (2, 0), 19: (1, 0),
                    22: (1, 0)}
# the table under each of those device fused chains: at SF1 each counts
# morsel_units of it (phase 4 holds device_fused_maps to their sum)
TPCH22_LANE_MAP_TABLES = {9: ("part",), 12: ("lineitem",), 13: ("orders",), 14: ("lineitem",),
                          16: ("part", "supplier"), 19: ("lineitem",), 22: ("customer",)}
assert all(len(TPCH22_LANE_MAP_TABLES[q]) == m[0] for q, m in TPCH22_LANE_MAPS.items())
# warm runs of each of the 22 queries at SF1 (phases 4 and 6): one, so the
# whole run stays well inside its time limit (two until phase 15 came)
TPCH22_WARM = 1
TPCH22_COUNTERS = ("device_aggregations", "host_aggregations", "device_agg_fallbacks",
                   "device_join_probes", "host_joins", "device_sorts", "host_sorts",
                   "device_group_codes", "device_resident_segments", "segment_fallbacks",
                   "shuffles") + ROUTE_COUNTERS


def _write_ipc(path: str, tbl) -> None:
    import pyarrow as pa

    with pa.OSFile(path, "wb") as sink:
        with pa.ipc.new_file(sink, tbl.schema) as writer:
            writer.write_table(tbl)


def _generate_into(queue, out_dir: str, scale: float, seed: int, groups: int,
                   join_scales=()) -> None:
    """Target of the background process: first, for each of
    ``join_scales``, phase 3's join tables (benchmarks/tpch.generate_tables
    at that scale, seed 42) as arrow IPC files, each scale announced by a
    message; then generate the TPC-H tables; write each as an uncompressed
    arrow IPC file into ``out_dir`` (phases 4-19 read them), then as a
    parquet file of ``groups`` row groups (phase 12's scans, phase 19's lake
    tables); run the 22 queries through the port's host path over them
    (phase 4's reference rows, ``host_rows.pickle``); and send one small
    message with the times (wall clock) at which each step ended, or the
    error."""
    import pickle
    import traceback as tb

    try:
        import pyarrow.parquet as papq

        import daft_tpu_torch as dtt
        from benchmarks import tpch, tpch_full

        for js in join_scales:
            joined = tpch.generate_tables(scale=js, seed=42)
            for name, tbl in joined.items():
                _write_ipc(f"{out_dir}/join_{js:g}_{name}.arrow", tbl)
            queue.put({"join_scale": js, "names": list(joined), "at": time.time()})
            del joined
        tables = tpch_full.generate(scale=scale, seed=seed)
        times = {"generated_at": time.time()}
        for name, tbl in tables.items():
            _write_ipc(f"{out_dir}/{name}.arrow", tbl)
        times["written_at"] = time.time()
        for name, tbl in tables.items():
            papq.write_table(tbl, f"{out_dir}/{name}.parquet",
                             row_group_size=max(1, -(-tbl.num_rows // groups)))
        times["parquet_at"] = time.time()
        # phase 4's host path: use_device_kernels off on the CPU, as there
        dtt.set_execution_config(config(use_device_kernels=False, device="cpu"))
        queries = tpch22_module()
        frames = tpch22_frames(tables, 1)
        host = {qn: tpch22_rows(zip(*queries.QUERIES[qn](frames).to_pydict().values()))
                for qn in sorted(queries.QUERIES)}
        with open(f"{out_dir}/host_rows.pickle", "wb") as f:
            pickle.dump(host, f)
        times["host_at"] = time.time()
        queue.put({"names": list(tables), **times})
    except Exception:  # the parent reads it rather than waiting out its timeout
        queue.put({"error": tb.format_exc()})


class BackgroundTables:
    """Phase 4's SF1 tables (``benchmarks.tpch_full.generate``), their
    parquet files and the host path's rows of the 22 queries over them,
    made by a spawned process while the earlier phases run: its per-row
    Python loops take about two minutes at SF1. Before them it makes phase
    3's join tables of ``join_scales`` (SF10's take about 40 s), which
    ``join_tables`` reads, and deletes the files of, as soon as they are
    written (SF10's take about 6.5 GB of the temporary directory, whose
    free bytes it prints at the start). The process runs on a core
    of its own (the last this process may use) and this process's threads
    on the others until it is done (``_watch``), so that it never waits on
    the phases' threads, nor they on it. The tables come back as arrow IPC
    files in a temporary directory, read in about a second (not pickled
    through a pipe, which began only when ``get`` read it). ``get`` waits
    for the process and returns the tables; ``parquet`` and ``host_rows``
    hold the rest. ``stop`` stops the process in any case and removes the
    directory."""

    def __init__(self, scale: float, seed: int, groups: int, join_scales=()):
        import multiprocessing
        import os
        import shutil
        import tempfile
        import threading

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_tables_")
        print(json.dumps({"tables_dir_free_bytes": shutil.disk_usage(self.dir).free}),
              flush=True)
        self.join_scales = list(join_scales)
        self.joins = {}  # join scale -> its message, once written
        self.joins_ready = {js: threading.Event() for js in self.join_scales}
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.proc = ctx.Process(target=_generate_into,
                                args=(self.queue, self.dir, scale, seed, groups,
                                      self.join_scales), daemon=True)
        self.started = time.perf_counter()
        self.started_wall = time.time()
        self.proc.start()
        self.cores = sorted(os.sched_getaffinity(0))
        self.pinned = len(self.cores) >= 4
        if self.pinned:
            os.sched_setaffinity(self.proc.pid, {self.cores[-1]})
            self._pin_own_threads(set(self.cores[:-1]))
        self.msg = None
        self.done_at = None
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    @staticmethod
    def _pin_own_threads(cores: set) -> None:
        """Every thread of this process onto ``cores`` (threads made later
        inherit their creator's set)."""
        import os

        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), cores)
            except OSError:  # the thread ended meanwhile
                pass

    def _watch(self) -> None:
        """Wait for the process's messages (each join scale's, then the
        last); give this process every core back as soon as the last
        comes."""
        import queue

        while True:
            try:
                msg = self.queue.get(timeout=1500)
            except queue.Empty:
                msg = {"error": "the background process sent nothing in 1500 s"}
            if "join_scale" in msg:
                self.joins[msg["join_scale"]] = msg
                self.joins_ready[msg["join_scale"]].set()
                continue
            self.msg = msg
            break
        for ev in self.joins_ready.values():  # a failure wakes every waiter
            ev.set()
        self.done_at = time.perf_counter() - self.started
        if self.pinned:
            self._pin_own_threads(set(self.cores))

    def join_tables(self, scale: float, timeout: float = 600.0):
        """Phase 3's join tables at ``scale`` from the process (None at a
        scale it does not make, SF1, whose tables phase 3 generates
        itself); their files are deleted once read."""
        import os

        import pyarrow as pa

        if scale not in self.joins_ready:
            return None
        self.joins_ready[scale].wait(timeout)
        msg = self.joins.get(scale)
        if msg is None:
            raise RuntimeError("the background process made no SF%g join tables: %s"
                               % (scale, (self.msg or {}).get("error", f"none in {timeout} s")))
        tables = {}
        for name in msg["names"]:
            path = f"{self.dir}/join_{scale:g}_{name}.arrow"
            with pa.OSFile(path, "rb") as source:
                tables[name] = pa.ipc.open_file(source).read_all()
            os.remove(path)
        return tables

    def get(self, timeout: float = 900.0) -> dict:
        import pickle

        import pyarrow as pa

        self._watcher.join(timeout=timeout)
        msg = self.msg
        if msg is None or "error" in msg:
            raise RuntimeError("the background process failed: "
                               + (msg or {}).get("error", f"no message in {timeout} s"))
        self.proc.join(timeout=60)
        self.timing = {k[:-3] + "_s": v - self.started_wall
                       for k, v in msg.items() if k.endswith("_at")}
        self.timing["done_s"] = self.done_at
        self.timing["pinned_core"] = self.cores[-1] if self.pinned else None
        tables = {}
        for name in msg["names"]:
            with pa.OSFile(f"{self.dir}/{name}.arrow", "rb") as source:
                tables[name] = pa.ipc.open_file(source).read_all()
        self.parquet = {name: f"{self.dir}/{name}.parquet" for name in msg["names"]}
        with open(f"{self.dir}/host_rows.pickle", "rb") as f:
            self.host_rows = pickle.load(f)
        return tables

    def stop(self) -> None:
        import shutil

        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=30)
        shutil.rmtree(self.dir, ignore_errors=True)


def tpch22_rows(rows, keep_order: bool = False) -> list:
    """tests/device32/test_tpch_suite32.py's normal form of ``rows`` (an
    iterable of tuples): floats rounded to 2 decimals, dates as ISO text,
    rows sorted (unless ``keep_order``)."""
    def norm(v):
        if isinstance(v, float):
            return round(v, 2)
        if isinstance(v, (datetime.date, datetime.datetime)):
            return v.isoformat()[:10]
        return v

    def key(r):
        return tuple((x is None, repr(type(x)), x if x is not None else 0) for x in r)

    out = [tuple(norm(v) for v in row) for row in rows]
    return out if keep_order else sorted(out, key=key)


def tpch22_match(got: list, want: list) -> bool:
    """The suite32 rule: the same rows, floats within max(5e-4 relative,
    0.02) of each other."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None or abs(float(x) - float(y)) > max(
                        5e-4 * abs(float(y)), 0.02):
                    return False
            elif x != y:
                return False
    return True


def tpch22_frames(data: dict, nparts: int) -> dict:
    import daft_tpu_torch as dtt

    out = {}
    for name, tbl in data.items():
        df = dtt.from_arrow(tbl)
        if nparts > 1 and name in TPCH22_BIG_TABLES:
            df = df.into_partitions(nparts)
        out[name] = df.collect()
    return out


def phase_tpch22(ph: Phases, queries, data: dict, host: dict, card: str, profile: bool) -> dict:
    """Phase 4: the 22 queries of benchmarks/tpch_queries.py through the
    port on the card, in the 32-bit device mode with device_min_rows=8 (the
    configuration of tests/device32/test_tpch_suite32.py). At SF0.005 (seed
    7), with the four large tables cut into 3 partitions by into_partitions
    (that file's layout), each against the SQLite oracle under that file's
    rule, with its sorts, joins and aggregates exchanged and routed as
    TPCH22_ROUTES_3P says (the CPU tests hold the port to it). At SF1 (seed 7), one partition per table: each driven once
    cold with K1's, K2's and the scatter kernel's launch counts set to 0
    just before and read just after, timed warm (median of 2), held to the
    port's host path on the same tables (``host``: use_device_kernels=False,
    device="cpu", run by the background process that made the tables,
    BackgroundTables) under the same rule, with no aggregate
    declined after launch, the new lanes' filters on the card, and the
    float sums through K1 or the scatter kernel where the CPU tests put
    them on the card, and every aggregate, and the new lanes' fused chains,
    routed to the card or the host as the CPU tests route them (a chain over
    a table above the morsel size counts one unit a morsel)."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch_full
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    out = {"k1_launches": 0, "scatter_launches": 0, "k2_launches": 0}
    # --- SF0.005 in three partitions, against the SQLite oracle
    small = tpch_full.generate(scale=0.005, seed=7)
    conn = tpch_full.load_sqlite(small)
    try:
        dtt.set_execution_config(config(device_min_rows=8))
        frames = tpch22_frames(small, 3)
        for qn in sorted(queries.QUERIES):
            t0 = time.perf_counter()
            df = queries.QUERIES[qn](frames).collect()
            got = tpch22_rows(zip(*df.to_pydict().values()))
            secs = time.perf_counter() - t0
            want = tpch22_rows(conn.execute(queries.SQL[qn]).fetchall())
            ph.check(tpch22_match(got, want),
                     f"SF0.005 Q{qn} (3 partitions): {len(got)} rows match the SQLite oracle "
                     f"({secs:.2f}s on the card)")
            c = df.stats.snapshot()["counters"]
            routes = {k: c.get(k, 0) for k in TPCH22_ROUTES_3P[qn]}
            ph.check(routes == TPCH22_ROUTES_3P[qn],
                     f"SF0.005 Q{qn} (3 partitions): routing {routes}, as the CPU tests route "
                     f"it (TPCH22_ROUTES_3P)")
    finally:
        conn.close()
    del small, frames

    # --- SF1 (``data``), one partition per table, against the port's host
    # path (``host``); the CPU tests' configuration, so that the routing compares with theirs
    dtt.set_execution_config(config(device_min_rows=8))
    frames = tpch22_frames(data, 1)
    rows = {k: v.num_rows for k, v in data.items()}
    warm_by_query = {}
    out["card_rows"] = {}  # phase 12 holds the same queries over parquet to them
    for qn in sorted(queries.QUERIES):
        def run(qn=qn):
            return queries.QUERIES[qn](frames).collect()

        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        df = run()
        got = tpch22_rows(zip(*df.to_pydict().values()))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        c = df.stats.snapshot()["counters"]
        label = f"SF1 Q{qn}"
        out["card_rows"][qn] = got
        ph.check(tpch22_match(got, host[qn]),
                 f"{label}: {len(got)} rows match the port's host path")
        ph.check(c.get("device_agg_fallbacks", 0) == 0, f"{label}: device_agg_fallbacks 0")
        aggs = (c.get("device_aggregations", 0), c.get("host_aggregations", 0))
        ph.check(aggs == TPCH22_AGG_ROUTES[qn],
                 f"{label}: (device_aggregations, host_aggregations) {aggs}, as the CPU "
                 f"tests route them ({TPCH22_AGG_ROUTES[qn]})")
        if qn in TPCH22_LANE_MAPS:
            maps = (c.get("device_fused_maps", 0), c.get("host_fused_maps", 0))
            want_maps = (sum(morsel_units(rows[t]) for t in TPCH22_LANE_MAP_TABLES[qn]),
                         TPCH22_LANE_MAPS[qn][1])
            ph.check(maps == want_maps,
                     f"{label}: (device_fused_maps, host_fused_maps) {maps}, as the CPU "
                     f"tests route them ({TPCH22_LANE_MAPS[qn]}), one unit a morsel over "
                     f"{'/'.join(TPCH22_LANE_MAP_TABLES[qn])} ({want_maps})")
        if qn in TPCH22_CARD_SUMS:
            ph.check(launches["k1"] + launches["scatter"] >= 1,
                     f"{label}: float sums through K1 or the scatter kernel ({launches})")
        if qn in TPCH22_K1:
            ph.check(launches["k1"] >= 1, f"{label}: K1 launched ({launches})")
        if qn in TPCH22_LANE_FILTERS:
            ph.check(c.get("host_filters", 0) == 0 and c.get("device_filters", 0) >= 1,
                     f"{label}: its filters ran on the card through the new lanes "
                     f"(device_filters {c.get('device_filters', 0)}, host_filters "
                     f"{c.get('host_filters', 0)})")
        if qn == 14:  # startswith inside the resident aggregate
            ph.check(c.get("device_resident_segments", 0) == 1
                     and c.get("segment_fallbacks", 0) == 0,
                     f"{label}: the startswith lane ran in the resident plan segment")
        for k in ("k1", "k2", "scatter"):
            out[f"{k}_launches"] += launches[k]
        res = {"cold_s": cold, "launches": launches,
               "counters": {k: c.get(k, 0) for k in TPCH22_COUNTERS if c.get(k, 0)},
               **warm_median(lambda _f, run=run: run(), None, runs=TPCH22_WARM), "card": card}
        warm_by_query[qn] = res["warm_median_s"]
        out[f"q{qn}"] = res
        print(f"SF1 tpch22 Q{qn} " + json.dumps(res), flush=True)
        del df
    out["rows"] = rows
    out["host_rows"] = host  # phase 6 holds the 64-bit mode to them
    total = sum(warm_by_query.values())
    print("SF1 tpch22 summary " + json.dumps({
        "warm_total_s": total, "cold_total_s": sum(out[f"q{q}"]["cold_s"] for q in warm_by_query),
        "slowest": sorted(warm_by_query, key=lambda q: -warm_by_query[q])[:5],
        "launches": {k: out[k] for k in ("k1_launches", "k2_launches", "scatter_launches")},
        "rows": rows, "card": card}), flush=True)
    if profile:
        for qn in sorted(warm_by_query, key=lambda q: -warm_by_query[q])[:5]:
            def run(qn=qn):
                return queries.QUERIES[qn](frames).collect()

            print(f"SF1 tpch22 Q{qn} breakdown_ms " + json.dumps(join_breakdown(run)),
                  flush=True)
            profile_queries({f"tpch22_q{qn}_warm": lambda _f, run=run: run()}, None,
                            rows["lineitem"], card, reps=3)
    del frames
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: the 32-bit lanes at SF1 (epoch lanes, string transforms and
# choices, the joint dictionary, string-key joins)
# ---------------------------------------------------------------------------

LANE_MODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
LANE_COUNTERS = ("device_join_probes", "host_joins", "device_sorts", "host_sorts",
                 "device_filters", "host_filters", "device_projections", "host_projections",
                 "device_fused_maps", "host_fused_maps", "device_aggregations",
                 "host_aggregations", "device_group_codes", "device_distincts",
                 "host_distincts", "device_agg_fallbacks")
# the routing counters of each phase-5 query (device_min_rows=8, one partition
# per table), the counters LANE_COUNTERS names that are not 0:
# tests/test_torch_string_joins.py holds the port's and the reference's to
# these at SF0.005, and phase 5 the port's on the card at SF1
LANE_ROUTES = {
    "string_key_join": {"device_join_probes": 1, "device_projections": 1,
                        "device_aggregations": 1, "device_group_codes": 1, "host_sorts": 1},
    "transformed_key_join": {"device_join_probes": 1, "device_projections": 1,
                             "device_aggregations": 1, "device_group_codes": 1,
                             "device_sorts": 1},
    "timestamps": {"device_aggregations": 1, "device_group_codes": 1, "host_sorts": 1},
    "timestamps_deep": {"device_aggregations": 1, "device_group_codes": 1, "host_sorts": 1},
    "timestamp_sort": {"device_sorts": 1, "host_projections": 2},
    "lower_group": {"device_aggregations": 1, "device_group_codes": 1, "host_sorts": 1},
    "choice_distinct": {"device_projections": 1, "device_distincts": 1, "device_sorts": 1},
    "colcol_filter": {"device_fused_maps": 1, "device_filters": 1, "device_projections": 2},
}
# the phase-5 queries with a device map chain over a table (one partition)
# above the morsel size, the table and the counters of LANE_ROUTES that
# count one unit a morsel there (morsel_units)
LANE_STREAMED = {
    "string_key_join": ("lineitem", ("device_projections",)),
    "transformed_key_join": ("customer", ("device_projections",)),
    "choice_distinct": ("lineitem", ("device_projections",)),
    "colcol_filter": ("lineitem", ("device_fused_maps", "device_filters", "device_projections")),
}
# phase-5 queries whose float sums run through K1 (K2 for the deep one)
LANE_K1 = ("string_key_join", "transformed_key_join", "timestamps", "lower_group")


def lane_tables(data: dict) -> dict:
    """Phase 5's pyarrow tables from the 22 queries' tables: lineitem and
    orders with their dates cast to timestamp[us], customer, a 7-row table
    of the l_shipmode values with a rate, and a 25-row table of the country
    codes c_phone starts with (nation key + 10)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    def with_timestamps(tbl, names):
        for name in names:
            i = tbl.schema.get_field_index(name)
            tbl = tbl.set_column(i, name, pc.cast(tbl.column(name), pa.timestamp("us")))
        return tbl

    return {
        "lineitem": data["lineitem"],
        "lineitem_ts": with_timestamps(data["lineitem"],
                                       ("l_shipdate", "l_commitdate", "l_receiptdate")),
        "orders_ts": with_timestamps(data["orders"], ("o_orderdate",)),
        "customer": data["customer"],
        "modes": pa.table({"mode": list(LANE_MODES),
                           "rate": [1.0 + 0.125 * i for i in range(len(LANE_MODES))]}),
        "countries": pa.table({"code": [str(k + 10) for k in range(25)],
                               "cname": [f"country {k}" for k in range(25)]}),
    }


def lane_queries(pkg) -> dict:
    """Phase 5's queries over the frames of lane_tables, written against the
    package ``pkg`` (daft_tpu_torch here; the CPU tests also pass daft_tpu):
    name -> (query, deep). ``deep`` marks the one run with
    use_deep_fusion_kernel."""
    col = pkg.col
    lo, hi = datetime.datetime(1994, 1, 1), datetime.datetime(1995, 1, 1)

    def q12_lineitem(f, literal_range: bool):
        # tpch_queries.q12's lineitem predicate over timestamp columns
        pred = ((col("l_commitdate") < col("l_receiptdate"))
                & (col("l_shipdate") < col("l_commitdate")))
        if literal_range:
            pred = (col("l_shipmode").is_in(["MAIL", "SHIP"]) & pred
                    & (col("l_receiptdate") >= lo) & (col("l_receiptdate") < hi))
        return (f["lineitem_ts"].where(pred).groupby("l_shipmode")
                .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("rev"),
                     col("l_quantity").sum().alias("qty"), col("l_quantity").count().alias("n"))
                .sort("l_shipmode"))

    return {
        "string_key_join": (lambda f: (
            f["lineitem"].join(f["modes"], left_on="l_shipmode", right_on="mode")
            .groupby("l_shipmode")
            .agg((col("l_extendedprice") * col("rate")).sum().alias("charge"),
                 col("l_quantity").count().alias("n"))
            .sort("l_shipmode")), False),
        "transformed_key_join": (lambda f: (
            f["customer"].join(f["countries"], left_on=col("c_phone").str.left(2),
                               right_on="code")
            .groupby("cname").agg(col("c_acctbal").sum().alias("bal"),
                                  col("c_acctbal").count().alias("n"))
            .sort("cname")), False),
        "timestamps": (lambda f: q12_lineitem(f, True), False),
        "timestamps_deep": (lambda f: q12_lineitem(f, False), True),
        "timestamp_sort": (lambda f: (
            f["orders_ts"].sort(["o_orderdate", "o_orderkey"], desc=[True, False]).limit(10)
            .select(col("o_orderkey"), col("o_orderdate"), col("o_totalprice"))), False),
        "lower_group": (lambda f: (
            f["lineitem"].groupby(col("l_shipmode").str.lower().alias("mode"))
            .agg(col("l_extendedprice").sum().alias("s")).sort("mode")), False),
        "choice_distinct": (lambda f: (
            f["lineitem"].select((col("l_quantity") > 25).if_else(
                col("l_shipmode"), col("l_shipinstruct")).alias("pick"))
            .distinct().sort("pick")), False),
        "colcol_filter": (lambda f: (
            f["lineitem"].where(col("l_shipmode") < col("l_shipinstruct"))
            .select(col("l_orderkey"), col("l_linenumber"), col("l_shipmode"))), False),
    }


def lane_rows(tbl) -> list:
    """A phase-5 result's rows in order, in tpch22_rows' normal form."""
    return tpch22_rows(zip(*tbl.to_pydict().values()), keep_order=True)


def phase_lanes(ph: Phases, data: dict, card: str) -> dict:
    """Phase 5: the lane queries over phase 4's SF1 tables (lane_tables), one
    partition per table, on the card with device_min_rows=8, each against
    the port's host path on the same tables (rows in order, floats under
    tests/device32/test_tpch_suite32.py's rule; a result of more than
    100,000 rows, with no float, equal as an Arrow table), with K1's, K2's
    and the scatter kernel's launches set to 0 just before the query and
    read just after, and every routing counter LANE_COUNTERS names equal to
    LANE_ROUTES. Each is timed cold and warm (median of 3) with the device's
    idle share (torch.profiler, 2 warm runs). The deep query's K2 program is
    then held against its plain version and the composed route at the
    operands the engine hands it, and timed."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    tables = lane_tables(data)
    queries = lane_queries(dtt)
    t0 = time.perf_counter()
    dtt.set_execution_config(config(use_device_kernels=False, device="cpu"))
    hframes = {k: dtt.from_arrow(v).collect() for k, v in tables.items()}
    host = {name: q(hframes).collect().to_arrow() for name, (q, _deep) in queries.items()}
    del hframes
    print(f"SF1 lanes: the host path ran the {len(queries)} queries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}
    for name, (query, deep) in queries.items():
        # fresh frames: each query stages its own columns and group codes
        # cold, as in the CPU tests whose routing it is held to
        frames = {k: dtt.from_arrow(v).collect() for k, v in tables.items()}

        def run(query=query, frames=frames):
            return query(frames).collect()

        dtt.set_execution_config(config(device_min_rows=8, use_deep_fusion_kernel=deep))
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        df = run()
        got = df.to_arrow()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        c = df.stats.snapshot()["counters"]
        label = f"SF1 lanes {name}"
        want = host[name]
        if want.num_rows > 100_000:
            ok = got.equals(want)
        else:
            ok = tpch22_match(lane_rows(got), lane_rows(want))
        ph.check(ok, f"{label}: {got.num_rows} rows match the port's host path, in order")
        routes = {k: c.get(k, 0) for k in LANE_COUNTERS}
        table, per_morsel = LANE_STREAMED.get(name, (None, ()))
        units = morsel_units(tables[table].num_rows) if table else 1
        want_routes = {k: LANE_ROUTES[name].get(k, 0) * (units if k in per_morsel else 1)
                       for k in LANE_COUNTERS}
        if table:
            routes["stream_morsels"] = c.get("stream_morsels", 0)
            want_routes["stream_morsels"] = streamed_morsels(tables[table].num_rows)
        ph.check(routes == want_routes,
                 f"{label}: routing counters {({k: v for k, v in routes.items() if v})} "
                 f"as the CPU tests pin them"
                 + (f", one unit a morsel over {table} ({units})" if table else ""))
        if deep:
            ph.check(launches["k2"] >= 1 and launches["k1"] == 0,
                     f"{label}: float sums through K2 ({launches})")
        elif name in LANE_K1:
            ph.check(launches["k1"] >= 1, f"{label}: float sums through K1 ({launches})")
        for k in ("k1", "k2", "scatter"):
            out[f"{k}_launches"] += launches[k]
        res = {"cold_s": cold, "launches": launches, "rows": got.num_rows,
               **warm_median(lambda _f, run=run: run(), None, runs=3, fetch="to_arrow"),
               **device_profile(lambda run=run: run().to_arrow(), reps=2)[0], "card": card}
        out[name] = res
        print(f"SF1 lanes {name} " + json.dumps(res), flush=True)
        del df, got, frames, run
        torch.cuda.empty_cache()

    # the deep query's K2 program at the operands the engine hands it
    frames = {k: dtt.from_arrow(v).collect() for k, v in tables.items()}
    prog, codes, env, n, g = capture_k2_operands(frames, queries["timestamps_deep"][0])
    print(f"K2 timestamps_deep operands: n={n} padded to {codes.shape[0]}, G={g}, K={prog.k}, "
          f"{len(prog.names)} lanes: " + ", ".join(
              f"{nm.replace(chr(0), '/')} {env[nm][0].dtype}" for nm in prog.names), flush=True)
    shape = check_k2(ph, f"phase 5 timestamps_deep n={codes.shape[0]} G={g} K={prog.k}",
                     prog, codes, env, n, g)
    shape.update(loop=loop_name(g, prog.k), **time_k2(prog, codes, env, n, g))
    print("K2 timing timestamps_deep " + json.dumps(shape), flush=True)
    out["k2_shape"] = shape
    del frames, host, tables
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: the 64-bit device mode (device_x64=True)
# ---------------------------------------------------------------------------

# phase 6's main-path queries: (query, the tables it reads, device join probes)
X64_WARM = 3  # warm runs of Q1, Q6, Q3 and Q5 in each mode: few, for the time limit
X64_QUERIES = {
    "q1": (q1, ("lineitem",), 0),
    "q6": (q6, ("lineitem",), 0),
    "q3": (q3, ("customer", "orders", "lineitem"), 2),
    "q5": (q5, ("customer", "orders", "lineitem", "nation"), 3),
}


def rel_gap(got: dict, want: dict) -> float:
    """The largest relative gap between the float values of ``got`` and
    ``want``, column by column and row by row (the rows in order)."""
    gap = 0.0
    for k, col in want.items():
        for a, b in zip(got.get(k, []), col):
            if isinstance(b, float) and isinstance(a, float):
                gap = max(gap, abs(a - b) / max(abs(b), 1e-300))
    return gap


def float_bits(d: dict) -> dict:
    """The bits of every float value of a result (a float64 view of each)."""
    import struct

    return {k: [struct.pack("<d", v) if isinstance(v, float) else v for v in col]
            for k, col in d.items()}


def x64_oracles(lineitem, tables) -> dict:
    from benchmarks import tpch

    return {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]},
            "q3": tpch.oracle_q3(*[tables[a] for a in X64_QUERIES["q3"][1]]),
            "q5": tpch.oracle_q5(*[tables[a] for a in X64_QUERIES["q5"][1]])}


def x64_drive(ph: Phases, name: str, x64: bool, source: dict, want: dict, groups3: dict,
              card: str, captured: list) -> dict:
    """One query of phase 6 in one mode over fresh frames: cold (every
    kernel's launch count set to 0 just before and read just after; in the
    64-bit mode the operands of the float64 scatter kernel's wrapper are
    kept), checked against the pyarrow oracle, then warm (median of 3)."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    query, args, probes = X64_QUERIES[name]
    dtt.set_execution_config(config(device_x64=x64))
    frames = [dtt.from_arrow(source[a]).collect() for a in args]
    real = scs.scatter_sum_kahan

    def record(values, codes, g):
        if values.dtype == torch.float64:
            captured.append((values, codes, g))
        return real(values, codes, g)

    scs.scatter_sum_kahan = record
    ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = scs.LAUNCHES_F64 = 0
    try:
        t0 = time.perf_counter()
        df = query(*frames).collect()
        got = df.to_pydict()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    finally:
        scs.scatter_sum_kahan = real
    launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES,
                "scatter_f64": scs.LAUNCHES_F64}
    c = df.stats.snapshot()["counters"]
    mode = "x64" if x64 else "32-bit"
    label = f"SF1 {name} ({mode})"
    rtol = RTOL_X64 if x64 else RTOL
    ok = (q3_parity(got, want, groups3, rtol) if name == "q3" else parity(got, want, rtol))
    gap = rel_gap(got, want)
    ph.check(ok, f"{label}: matches the pyarrow oracle at rtol {rtol} (largest relative gap "
                 f"{gap:.3g})")
    on_card = (c.get("device_aggregations", 0) >= 1 and c.get("device_agg_fallbacks", 0) == 0
               and c.get("device_join_probes", 0) == probes)
    if name in JOIN_QUERIES:
        want_route = join_routes(name, {a: source[a].num_rows for a in args})
        on_card = on_card and {k: c.get(k, 0) for k in want_route} == want_route
    if x64:  # K1 and K2 never launch in this mode; Q3's sums take the float64 scatter
        on_card = on_card and (launches["k1"], launches["k2"], launches["scatter"]) == (0, 0, 0)
        if name == "q3":
            on_card = on_card and launches["scatter_f64"] >= 1 and c.get("device_sorts", 0) >= 1
    ph.check(on_card, f"{label}: ran on the card (launches {launches}, counters "
                      f"{ {k: v for k, v in c.items() if v} })")
    res = {"mode": mode, "cold_s": cold, "launches": launches, "max_rel_gap": gap,
           **warm_median(lambda _f: query(*frames), None, runs=X64_WARM), "card": card}
    if x64 and name == "q3":  # a second run gives every float the same bits
        again = query(*frames).collect().to_pydict()
        ph.check(float_bits(again) == float_bits(got),
                 f"{label}: a second run gives every float output the same bits")
    del df, frames
    torch.cuda.empty_cache()
    return res


def onehot_f64_breakdown(card: str) -> dict:
    """Where a float64 sum of the 64-bit mode's one-hot route spends its
    time at the SF1 Q1 shape (b = 8,388,608 rows, 16 group slots), by CUDA
    events: the whole ``segment_reduce(..., "sum")`` (with its count), the
    chunk partials alone (the (chunks, 8192, 16) compare, select and sum)
    and the Kahan walk over the 1024 chunk partials alone (4 small launches
    a chunk)."""
    import torch

    from daft_tpu_torch.kernels import device as dv

    gen = torch.Generator(device="cuda").manual_seed(11)
    b, g = SF1_BUCKET, 16
    vals = torch.rand(b, generator=gen, device="cuda", dtype=torch.float64) * 1e5
    codes = torch.randint(0, 4, (b,), generator=gen, device="cuda", dtype=torch.int32)
    valid = torch.rand(b, generator=gen, device="cuda") < 0.98
    sel = dv._onehot(valid, codes, g)
    partials = torch.where(sel, vals.view(sel.shape[0], sel.shape[1], 1), 0).sum(dim=1)
    out = {"b": b, "G": g, "chunks": partials.shape[0],
           "segment_reduce_sum_ms": cuda_ms(
               lambda: dv.segment_reduce(vals, valid, codes, g, "sum"), iters=5),
           "chunk_partials_ms": cuda_ms(lambda: torch.where(
               dv._onehot(valid, codes, g), vals.view(sel.shape[0], sel.shape[1], 1),
               0).sum(dim=1), iters=5),
           "kahan_walk_ms": cuda_ms(lambda: dv._kahan_combine(partials), iters=5),
           "card": card}
    del vals, codes, valid, sel, partials
    torch.cuda.empty_cache()
    return out


def phase_x64(ph: Phases, lineitem, tables: dict, queries, data: dict, host_rows: dict,
              scatter32: dict, card: str) -> dict:
    """Phase 6, the 64-bit device mode on the card: the float64 scatter
    kernel at phase 2's shapes; Q1, Q6 (lineitem, SF1) and Q3, Q5
    (generate_tables(1, seed=42)) in the 32-bit mode and then in the 64-bit
    one, cold and warm, each mode over fresh frames, the 64-bit runs at
    rtol 1e-9 of the pyarrow oracle, with K1 and K2 at 0 launches and Q3's
    sums through the float64 scatter kernel, which is then held against its
    plain version at the operands the engine handed it and timed there;
    the 22 queries in the 64-bit mode at SF0.005 (3 partitions) against
    SQLite and at SF1 against phase 4's host-path rows, each query's
    aggregate routes held to TPCH22_X64_AGG_ROUTES and its float64 scatter
    launches to phase 4's float32 ones."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch_full
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    entry = phase_scatter(ph, torch.float64)
    out = {"scatter_f64_launches": 0, "k1_launches": 0, "k2_launches": 0}
    source = dict(tables, lineitem=lineitem)
    want = x64_oracles(lineitem, tables)
    groups3 = oracle_q3_groups(*[tables[a] for a in X64_QUERIES["q3"][1]])
    captured: list = []
    for name in X64_QUERIES:
        if name == "q3":  # the join queries read the join tables' lineitem
            source["lineitem"] = tables["lineitem"]
        pair = {}
        for x64 in (False, True):
            pair["x64" if x64 else "32"] = x64_drive(ph, name, x64, source, want[name],
                                                   groups3, card, captured)
        res = pair["x64"]
        res["warm_32bit_s"] = pair["32"]["warm_median_s"]
        res["cold_32bit_s"] = pair["32"]["cold_s"]
        res["warm_x64_over_32bit"] = res["warm_median_s"] / res["warm_32bit_s"]
        for k in ("k1", "k2"):
            out[f"{k}_launches"] += res["launches"][k]
        out["scatter_f64_launches"] += res["launches"]["scatter_f64"]
        out[name] = res
        print(f"SF1 x64 {name} " + json.dumps(res), flush=True)
    dtt.set_execution_config(config(device_x64=True))
    out["onehot_f64"] = onehot_f64_breakdown(card)
    print("SF1 x64 one-hot float64 sum " + json.dumps(out["onehot_f64"]), flush=True)
    ph.check(len(captured) == 1, f"SF1 x64: Q3 called the float64 scatter wrapper once "
                                 f"({len(captured)})")
    for vals, codes, g in captured[:1]:
        name = f"f64 main path SF1 x64 Q3 b={vals.shape[0]} G={g}"
        err = check_scatter(ph, name, vals, codes, g)
        keep = ("name", "route", "source", "replaces")
        entry["large_shape"] = {k: entry.pop(k) for k in list(entry) if k not in keep}
        entry.update({"max_abs_err": err, **time_scatter(vals, codes, g)})
        print("scatter f64 timing main path SF1 x64 " + json.dumps(entry), flush=True)
    del captured
    torch.cuda.empty_cache()

    # --- the 22 queries: SF0.005 in three partitions against SQLite
    small = tpch_full.generate(scale=0.005, seed=7)
    conn = tpch_full.load_sqlite(small)
    try:
        dtt.set_execution_config(config(device_min_rows=8, device_x64=True))
        frames = tpch22_frames(small, 3)
        for qn in sorted(queries.QUERIES):
            got = tpch22_rows(zip(*queries.QUERIES[qn](frames).to_pydict().values()))
            want22 = tpch22_rows(conn.execute(queries.SQL[qn]).fetchall())
            ph.check(tpch22_match(got, want22),
                     f"SF0.005 x64 Q{qn} (3 partitions): {len(got)} rows match the SQLite "
                     f"oracle")
    finally:
        conn.close()
    del small, frames

    # --- SF1, one partition per table, against phase 4's host-path rows
    dtt.set_execution_config(config(device_min_rows=8, device_x64=True))
    frames = tpch22_frames(data, 1)
    warm, cold = {}, {}
    for qn in sorted(queries.QUERIES):
        def run(qn=qn):
            return queries.QUERIES[qn](frames).collect()

        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = scs.LAUNCHES_F64 = 0
        t0 = time.perf_counter()
        df = run()
        got = tpch22_rows(zip(*df.to_pydict().values()))
        torch.cuda.synchronize()
        cold[qn] = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES,
                    "scatter_f64": scs.LAUNCHES_F64}
        c = df.stats.snapshot()["counters"]
        label = f"SF1 x64 Q{qn}"
        ph.check(tpch22_match(got, host_rows[qn]),
                 f"{label}: {len(got)} rows match the port's host path")
        aggs = (c.get("device_aggregations", 0), c.get("host_aggregations", 0))
        ph.check(aggs == TPCH22_X64_AGG_ROUTES[qn] and c.get("device_agg_fallbacks", 0) == 0,
                 f"{label}: (device_aggregations, host_aggregations) {aggs}, as the CPU "
                 f"tests route them ({TPCH22_X64_AGG_ROUTES[qn]}), no fallback")
        ph.check((launches["k1"], launches["k2"], launches["scatter"]) == (0, 0, 0)
                 and launches["scatter_f64"] == scatter32.get(qn, 0),
                 f"{label}: K1, K2 and the float32 scatter kernel not launched, the float64 "
                 f"one as often as phase 4's float32 one ({launches}; phase 4 "
                 f"{scatter32.get(qn, 0)})")
        out["scatter_f64_launches"] += launches["scatter_f64"]
        out["k1_launches"] += launches["k1"]
        out["k2_launches"] += launches["k2"]
        res = {"cold_s": cold[qn], "launches": launches,
               **warm_median(lambda _f, run=run: run(), None, runs=TPCH22_WARM), "card": card}
        warm[qn] = res["warm_median_s"]
        print(f"SF1 tpch22 x64 Q{qn} " + json.dumps(res), flush=True)
        del df
    print("SF1 tpch22 x64 summary " + json.dumps({
        "warm_total_s": sum(warm.values()), "cold_total_s": sum(cold.values()),
        "slowest": sorted(warm, key=lambda q: -warm[q])[:5], "card": card}), flush=True)
    del frames
    torch.cuda.empty_cache()
    out["entry"] = entry
    return out


# ---------------------------------------------------------------------------
# phase 7: the exchange between partitions on the card
# ---------------------------------------------------------------------------

EXCHANGE_PARTS = 4
# the counters every phase-7 line reports
EXCHANGE_COUNTERS = ("device_aggregations", "host_aggregations", "device_agg_fallbacks",
                     "device_sorts", "host_sorts", "device_join_probes", "host_joins",
                     "device_group_codes", "device_filters", "host_filters",
                     "device_projections", "host_projections", "shuffles", "exchange_rows",
                     "exchange_bytes", "exchange_precombined_rows", "join_filter_built",
                     "join_filter_probe_rows", "join_filter_rows_pruned",
                     "join_filter_device_probes", "stream_morsels")


class ExchangeClock:
    """Host nanoseconds spent inside ShuffleOp.execute's own work (the
    split, the fold, the prune with its Bloom probe on the card, the bucket
    concat), not counting the pulls from its input: installed for the
    phase, read per query."""

    def __init__(self):
        from daft_tpu_torch import physical

        self.ns = 0
        self._physical = physical
        self._real = physical.ShuffleOp.execute
        clock, real = self, self._real

        def execute(op, inputs, ctx):
            upstream = [0]

            def timed(stream):
                it = iter(stream)
                while True:
                    t0 = time.perf_counter_ns()
                    p = next(it, None)
                    upstream[0] += time.perf_counter_ns() - t0
                    if p is None:
                        return
                    yield p

            gen = real(op, [timed(inputs[0])], ctx)
            while True:
                t0, up0 = time.perf_counter_ns(), upstream[0]
                p = next(gen, None)
                clock.ns += time.perf_counter_ns() - t0 - (upstream[0] - up0)
                if p is None:
                    return
                yield p

        physical.ShuffleOp.execute = execute

    def close(self) -> None:
        self._physical.ShuffleOp.execute = self._real


def _exchange_agg_items(li) -> dict:
    """Phase 7's item 1: the grouped aggregate by l_suppkey whose stage-2
    shuffle folds the stage-1 pieces (exact kinds), and the same query with
    the fold off, against pyarrow."""
    from daft_tpu_torch import col

    g = li.group_by("l_suppkey").aggregate([("l_orderkey", "count"), ("l_extendedprice", "max"),
                                            ("l_shipdate", "min")])
    want1 = {k: (c, m, d) for k, c, m, d in zip(*[g[x].to_pylist() for x in (
        "l_suppkey", "l_orderkey_count", "l_extendedprice_max", "l_shipdate_min")])}

    def agg_check(got):
        d = got.to_pydict()
        rows = dict(zip(d["l_suppkey"], zip(d["n"], d["hi"], d["first"])))
        ok = len(rows) == len(want1) == got.num_rows and all(
            k in rows and rows[k][0] == c and rows[k][2] == dd
            and abs(rows[k][1] - m) <= RTOL * abs(m) for k, (c, m, dd) in want1.items())
        return ok, f"{got.num_rows} groups against pyarrow's {len(want1)}"

    def agg(frames):
        return frames["lineitem"].groupby("l_suppkey").agg(
            col("l_orderkey").count().alias("n"), col("l_extendedprice").max().alias("hi"),
            col("l_shipdate").min().alias("first"))

    routes = {"shuffles": 1, "device_agg_fallbacks": 0}
    return {"grouped_agg_combine": (agg, {}, agg_check, routes),
            "grouped_agg_no_combine": (agg, {"hierarchical_exchange_combine": False},
                                       agg_check, routes)}


def exchange_items(tables: dict, scale: float, q3_oracle: tuple) -> tuple:
    """Phase 7's queries over generate_tables(scale, seed=42): ({name ->
    (build(frames) -> DataFrame, the config's overrides, the oracle's check
    (got pyarrow table) -> (ok, detail), the routing each must show)}, the
    extra tables they read). ``q3_oracle`` is phase 3's (oracle_q3,
    oracle_q3_groups) over the same tables."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from benchmarks import tpch
    from daft_tpu_torch import col

    li = tables["lineitem"]
    n = li.num_rows
    p = EXCHANGE_PARTS
    # 1. the grouped aggregate (SF1 only, as items 4 and 5)
    items = _exchange_agg_items(li) if scale == 1.0 else {}

    # 2. the sort over 4 partitions: range shuffle, one device sort each.
    # Rows with equal keys share a range partition and keep their input
    # order there, and each partition's sort is stable, so the result is
    # pyarrow's stable sort of the whole table, row for row: the same key
    # order and the same multiset of rows. SF1 only: past it the same check
    # over more rows (a 60 M-row oracle sort and exchange at SF10) cost the
    # run's time limit, and nothing in it depends on the row count
    if scale == 1.0:
        keys = ["l_shipdate", "l_orderkey", "l_linenumber"]
        want2 = li.take(pc.sort_indices(li, sort_keys=[("l_shipdate", "descending"),
                                                       ("l_orderkey", "ascending"),
                                                       ("l_linenumber", "ascending")]))
        # the port's strings are large_string, its canonical string storage
        want2 = want2.cast(pa.schema([pa.field(f.name, pa.large_string())
                                      if f.type == pa.string() else f
                                      for f in want2.schema]))

        def sort_check(got):
            same_keys = got.select(keys).equals(want2.select(keys))
            same_rows = got.num_rows == n and got.equals(want2)
            return same_keys and same_rows, (f"key order equal {same_keys}, the {n} rows "
                                             f"equal pyarrow's stable sort {same_rows}")

        items["sort"] = (lambda frames: frames["lineitem"].sort(keys, desc=[True, False, False]),
                         {}, sort_check, {"device_sorts": p, "host_sorts": 0, "shuffles": 1})

    # 3. Q3 over co-partitioned hash joins with the runtime join filter
    want3, groups3 = q3_oracle
    items["q3_hash_joins"] = (
        lambda frames: q3(frames["customer"], frames["orders"], frames["lineitem"]),
        {"broadcast_join_size_bytes_threshold": 0},
        lambda got: (q3_parity(got.to_pydict(), want3, groups3, RTOL), "q3_parity at rtol 1e-6"),
        {"device_join_probes": 2 * p, "host_joins": 0, "broadcast_joins": 0,
         "device_agg_fallbacks": 0})

    if scale != 1.0:
        return items, {}
    # 4. a random repartition, then Q6
    want6 = {"revenue": [tpch.oracle_q6(li)]}
    items["random_repartition_q6"] = (
        lambda frames: q6(frames["lineitem_1"].repartition(p)), {},
        lambda got: (parity(got.to_pydict(), want6, RTOL), "the pyarrow oracle at rtol 1e-6"),
        {"shuffles": 1, "device_agg_fallbacks": 0})

    # 5. unsigned lanes (one partition): numpy's wrapping arithmetic, pyarrow
    u = pa.table({"u8": li["l_linenumber"].cast(pa.uint8()),
                  "u16": li["l_quantity"].cast(pa.uint16()),
                  "u32": li["l_partkey"].cast(pa.uint32()),
                  "k": li["l_orderkey"]})
    u8 = u["u8"].to_numpy()
    u32 = u["u32"].to_numpy()
    want_proj = {"a": (u8 + u8).astype(np.uint8), "m": (u32 * u32).astype(np.uint32)}

    def proj_check(got):
        ok = all(np.array_equal(got[k].to_numpy(), v) for k, v in want_proj.items())
        return ok, "u8 + u8 and u32 * u32 equal numpy's wrapping arithmetic"

    def table_check(want):
        return lambda got: (got.equals(want), f"{got.num_rows} rows equal pyarrow's, in order")

    want_filter = u.filter(pc.greater(u["u16"], 25))
    want_sort = u.take(pc.sort_indices(u, sort_keys=[("u32", "ascending"),
                                                     ("k", "ascending")]))
    gu = u.group_by("u8").aggregate([("k", "count"), ("u16", "min")])
    want_group = {a: (b, c) for a, b, c in zip(*[gu[x].to_pylist()
                                                 for x in ("u8", "k_count", "u16_min")])}

    def group_check(got):
        d = got.to_pydict()
        rows = dict(zip(d["u8"], zip(d["n"], d["lo"])))
        return rows == want_group, f"{len(rows)} groups equal pyarrow's"

    pick = np.unique(u32)[::20]
    right = pa.table({"pk": pa.array(pick, pa.uint32()), "w": np.arange(len(pick))})
    j = u.join(right, keys="u32", right_keys="pk", join_type="inner")
    want_join = (j.num_rows, pc.sum(j["w"]).as_py(), pc.sum(j["k"]).as_py())

    def join_check(got):
        have = (got.num_rows, pc.sum(got["w"]).as_py(), pc.sum(got["k"]).as_py())
        return have == want_join, f"(rows, sum w, sum k) {have} against pyarrow's {want_join}"

    items["unsigned_projection"] = (
        lambda frames: frames["unsigned"].select((col("u8") + col("u8")).alias("a"),
                                                 (col("u32") * col("u32")).alias("m")),
        {}, proj_check, {"device_projections": morsel_units(u.num_rows), "host_projections": 0,
                         "stream_morsels": streamed_morsels(u.num_rows)})
    items["unsigned_filter"] = (lambda frames: frames["unsigned"].where(col("u16") > 25),
                                {}, table_check(want_filter),
                                {"device_filters": morsel_units(u.num_rows), "host_filters": 0,
                                 "stream_morsels": streamed_morsels(u.num_rows)})
    items["unsigned_sort"] = (lambda frames: frames["unsigned"].sort(["u32", "k"]), {},
                              table_check(want_sort), {"device_sorts": 1, "host_sorts": 0})
    items["unsigned_group"] = (
        lambda frames: frames["unsigned"].groupby("u8").agg(col("k").count().alias("n"),
                                                           col("u16").min().alias("lo")),
        {}, group_check, {"device_aggregations": 1, "host_aggregations": 0,
                          "device_group_codes": 1})
    ud = unsigned_deep_table(li)
    want_deep = unsigned_deep_oracle(ud)

    def deep_check(got):
        d = got.to_pydict()
        names = ("sq", "q4", "d8", "dm", "p")
        rows = {k: tuple(d[c][i] for c in names) + (d["n"][i],) for i, k in enumerate(d["u8"])}
        ok = rows.keys() == want_deep.keys() and all(
            rows[k][-1] == w[-1] and all(abs(a - b) <= RTOL * abs(b) for a, b in zip(rows[k], w))
            for k, w in want_deep.items())
        return ok, (f"{len(rows)} groups, float sums over wrapped uint values against numpy's at "
                    f"rtol 1e-6, counts exact")

    items["unsigned_deep_sums"] = (
        lambda frames: unsigned_deep(frames["unsigned_deep"]), {"use_deep_fusion_kernel": True},
        deep_check, {"device_aggregations": 1, "host_aggregations": 0,
                     "device_agg_fallbacks": 0})
    items["unsigned_join_x64"] = (
        lambda frames: frames["unsigned"].join(frames["unsigned_right"], left_on="u32",
                                               right_on="pk"),
        {"device_x64": True}, join_check, {"device_join_probes": 1, "host_joins": 0})
    return items, {"unsigned": u, "unsigned_right": right, "unsigned_deep": ud}


def k10_probe_times(ph: Phases, label: str, seen: list) -> list:
    """Each Bloom probe the engine made on the card in one query, again:
    K10 (``probe_bits_device``: the probe indices to the card, the gather
    and min there, the mask back) against the host's numpy probe over the
    same indices, equal masks, each the median wall time of 5 calls."""
    import numpy as np

    from daft_tpu_torch.exchange.joinfilter import probe_bits_device

    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = []
    for bits, idx in seen:
        table = bits.cpu().numpy().astype(bool)

        def host(table=table, idx=idx):
            hit = table[idx[0]]
            for row in idx[1:]:
                hit &= table[row]
            return hit

        same = np.array_equal(probe_bits_device(bits, idx), host())
        ph.check(same, f"{label}: K10 over {idx.shape[1]} rows equals the host's Bloom probe")
        out.append({"rows": int(idx.shape[1]), "bits": int(bits.numel()),
                    "device_ms": median_ms(lambda: probe_bits_device(bits, idx)),
                    "host_ms": median_ms(host)})
    return out


def phase_exchange(ph: Phases, scale: float, tables: dict, q3_oracle: tuple,
                   card: str) -> dict:
    """Phase 7: the exchange between partitions on the card, in the 32-bit
    device mode (the default config), over generate_tables(scale, seed=42)
    with lineitem, orders and customer cut into 4 partitions
    (into_partitions): TPC-H Q3 through co-partitioned hash joins with the
    runtime join filter (K10 on the card) at every scale; at SF1 also a sort
    over the 4 partitions, a grouped aggregate whose shuffle
    folds its stage-1 pieces (and again with the fold off), a random
    repartition then Q6, and the unsigned lanes (one partition; the uint32
    join in the 64-bit mode).
    Each query is driven once cold with K1's, K2's and the scatter kernel's
    launches set to 0 just before and read just after, checked against its
    oracle and its routing, then timed warm outside the profiler (3 runs at
    SF1, 1 at SF10), each run with the exchange's host share of its own
    wall (the median share is reported), then once under torch.profiler
    for the device's idle share. In Q3 each Bloom probe the engine made on
    the card is timed again against the host's numpy probe of the same
    indices (``k10_probe_times``). Past SF1 Q3 also runs cold over fresh
    frames with streaming off (``partition_cold_s``), beside its streamed
    cold run."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    from daft_tpu_torch.exchange import joinfilter as jfm

    real_probe = jfm.probe_bits_device
    t0 = time.perf_counter()
    items, extra = exchange_items(tables, scale, q3_oracle)
    tables = {**tables, **extra}
    print(f"SF{scale:g} exchange: oracles in {time.perf_counter() - t0:.1f}s", flush=True)
    clock = ExchangeClock()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}
    try:
        for name, (build, overrides, check, routes) in items.items():
            dtt.set_execution_config(config(**overrides))

            def fresh_frames():
                frames = {}
                for k, v in tables.items():
                    df = dtt.from_arrow(v)
                    if k in ("lineitem", "orders", "customer"):
                        df = df.into_partitions(EXCHANGE_PARTS)
                    frames[k] = df.collect()
                frames["lineitem_1"] = dtt.from_arrow(tables["lineitem"]).collect()
                return frames

            frames = fresh_frames()

            def run(build=build, frames=frames):
                return build(frames).collect()

            k10_seen = []  # the (bit table, probe indices) of each Bloom probe on the card
            if name == "q3_hash_joins":
                def record(bits, idx, seen=k10_seen):
                    seen.append((bits, idx))
                    return real_probe(bits, idx)

                jfm.probe_bits_device = record
            ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
            clock.ns = 0
            t0 = time.perf_counter()
            try:
                df = run()
                got = df.to_arrow()
                torch.cuda.synchronize()
            finally:
                jfm.probe_bits_device = real_probe
            cold = time.perf_counter() - t0
            cold_exchange = clock.ns / 1e9
            launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
            c = df.stats.snapshot()["counters"]
            label = f"SF{scale:g} exchange {name}"
            ok, detail = check(got)
            ph.check(ok, f"{label}: matches its oracle ({detail})")
            seen = {k: c.get(k, 0) for k in routes}
            ph.check(seen == routes, f"{label}: routing {seen} (want {routes})")
            sizes = [len(p) for p in df._result.partitions]
            if name == "sort":
                ph.check(max(sizes) <= got.num_rows // 2,
                         f"{label}: no output partition holds more than half the rows {sizes}")
            if name == "grouped_agg_combine":
                ph.check(c.get("exchange_precombined_rows", 0) > 0,
                         f"{label}: the shuffle folded {c.get('exchange_precombined_rows', 0)} "
                         f"stage-1 rows")
            if name == "grouped_agg_no_combine":
                on = out["grouped_agg_combine"]["counters"]["exchange_rows"]
                ph.check(on < c.get("exchange_rows", 0) and got.equals(out["_agg_rows"]),
                         f"{label}: exchange_rows {c.get('exchange_rows', 0)} with the fold off "
                         f"against {on} with it on, equal rows")
            if name == "q3_hash_joins":
                ph.check(c.get("join_filter_rows_pruned", 0) > 0
                         and c.get("join_filter_device_probes", 0) > 0,
                         f"{label}: the join filter pruned {c.get('join_filter_rows_pruned', 0)} "
                         f"rows, {c.get('join_filter_device_probes', 0)} Bloom probes on the card")
                ph.check(launches["k1"] + launches["scatter"] >= 1,
                         f"{label}: float sums through K1 or the scatter kernel ({launches})")
                k10 = k10_probe_times(ph, label, k10_seen)
            del k10_seen
            if name == "unsigned_deep_sums":
                ph.check(launches["k2"] >= 1 and launches["k1"] == 0,
                         f"{label}: the float sums through K2 ({launches})")
            if name == "random_repartition_q6":
                one = q6(frames["lineitem_1"]).collect().to_pydict()
                ph.check(parity(got.to_pydict(), one, RTOL) and launches["k1"] >= 1,
                         f"{label}: equals the one-partition Q6 at rtol 1e-6, K1 launched "
                         f"({launches})")
            for k in ("k1", "k2", "scatter"):
                out[f"{k}_launches"] += launches[k]
            # warm runs outside the profiler, each with its own exchange
            # share; then one run under torch.profiler for the idle share
            walls, shares, exchange_s = [], [], []
            for _ in range(3 if scale == 1.0 else 0):
                clock.ns = 0
                t0 = time.perf_counter()
                run().to_arrow()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                exchange_s.append(clock.ns / 1e9)
                shares.append(exchange_s[-1] / walls[-1])
            # past SF1 the cold run alone (the phase's depth, cut for phase 10)
            prof = (device_profile(lambda run=run: run().to_arrow(), reps=1)[0]
                    if scale == 1.0 else {"wall_ms": None})
            res = {"cold_s": cold, "cold_exchange_s": cold_exchange,
                   "cold_exchange_share": cold_exchange / cold,
                   "warm_median_s": statistics.median(walls) if walls else None,
                   "warm_runs": walls, "warm_exchange_s": exchange_s,
                   "warm_exchange_shares": shares,
                   "warm_exchange_share": statistics.median(shares) if shares else None,
                   "profiled_wall_ms": prof.pop("wall_ms"), **prof,
                   "launches": launches, "partition_rows": sizes,
                   "counters": {k: c.get(k, 0) for k in EXCHANGE_COUNTERS if c.get(k, 0)},
                   "plan": physical_plan(build(frames)), "card": card}
            if name == "q3_hash_joins":
                res["k10_probes"] = k10
            if name == "q3_hash_joins" and scale > 1.0:
                # the same cold run over fresh frames with streaming off:
                # what the morsel pipeline does to the wall at this scale
                dtt.set_execution_config(config(**overrides, streaming_execution=False))
                off = fresh_frames()
                t0 = time.perf_counter()
                df_off = build(off).collect()
                got_off = df_off.to_arrow()
                torch.cuda.synchronize()
                res["partition_cold_s"] = time.perf_counter() - t0
                ok_off, detail_off = check(got_off)
                ph.check(ok_off and df_off.stats.snapshot()["counters"].get("stream_morsels", 0)
                         == 0, f"{label} with streaming off: matches its oracle ({detail_off})")
                dtt.set_execution_config(config(**overrides))
                del off, df_off, got_off
            out[name] = res
            if name == "grouped_agg_combine":
                out["_agg_rows"] = got
            print(f"SF{scale:g} exchange {name} " + json.dumps(res), flush=True)
            del df, got, frames, run
            torch.cuda.empty_cache()
    finally:
        clock.close()
    out.pop("_agg_rows", None)
    return out


# ---------------------------------------------------------------------------
# phase 8: faults on the card
# ---------------------------------------------------------------------------

FAULT_PARTS = 4
FAULT_COUNTERS = HEALTH_COUNTERS + (
    "device_breaker_probes", "device_breaker_recoveries", "device_breaker_reopens",
    "device_aggregations", "host_aggregations", "device_agg_fallbacks", "segment_fallbacks",
    "device_resident_segments", "device_join_probes", "host_joins", "join_filter_built",
    "join_filter_rows_pruned", "join_filter_device_probes", "deadline_expired")
# what each armed case of phase 8 must count: the CPU test
# (tests/test_torch_faults.py, the same plans over 4 partitions of a small
# table) pins the same numbers for daft_tpu and the port. Launches are K1's,
# K2's (on the CPU: their wrappers' entries)
FAULT_PINS = {
    # device.kernel always, threshold 2: stage 1's first two partitions fail
    # and trip the breaker, the other two are degraded; stage 2 and the sort
    # take the host below device_min_rows (plain routing)
    "q1_kernel_always": {"device_breaker_trips": 1, "faults_injected": 2,
                         "device_attempt_failures": 2, "degraded_completions": 2,
                         "device_aggregations": 0, "k1": 0},
    # device.kernel first_n 1, threshold 1, cooldown 0: the first partition
    # trips the breaker, the second probes and closes it again
    "q1_kernel_first": {"device_breaker_trips": 1, "device_breaker_recoveries": 1,
                        "faults_injected": 1, "device_attempt_failures": 1,
                        "degraded_completions": 0,
                        "device_aggregations": 3, "k1": 3},
    # fuse.segment nth 2 (call 1 is the segment's compile at planning, call 2
    # the first resident handoff): the first partition runs the staged ops
    "q1_segment_handoff": {"faults_injected": 1, "device_attempt_failures": 1,
                           "segment_fallbacks": 1,
                           "device_resident_segments": 1, "device_breaker_trips": 0, "k2": 4},
    # join.filter always: every build feed fails, nothing is pruned (the
    # filter's own fail-open takes it: no device attempt fails)
    "q3_join_filter": {"join_filter_rows_pruned": 0, "join_filter_built": 0,
                       "device_attempt_failures": 0,
                       "device_join_probes": 2 * FAULT_PARTS, "host_joins": 0,
                       "device_breaker_trips": 0},
}


def fault_cases():
    """Phase 8's armed cases: name -> (the query over the frames, config
    overrides, the fault plan (site, mode, kwargs))."""
    return {
        "q1_kernel_always": (lambda f: q1(f["lineitem_4"]), {"device_breaker_threshold": 2},
                             ("device.kernel", "always", {})),
        "q1_kernel_first": (lambda f: q1(f["lineitem_4"]),
                            {"device_breaker_threshold": 1, "device_breaker_cooldown_s": 0.0},
                            ("device.kernel", "first_n", {"n": 1})),
        "q1_segment_handoff": (lambda f: q1_with_columns(f["lineitem_4"]),
                               {"use_deep_fusion_kernel": True},
                               ("fuse.segment", "nth", {"n": 2})),
        "q3_join_filter": (lambda f: q3(f["customer"], f["orders"], f["lineitem"]),
                           {"broadcast_join_size_bytes_threshold": 0},
                           ("join.filter", "always", {})),
    }


def phase_faults(ph: Phases, lineitem, tables: dict, q3_oracle: tuple, main_sf1: dict,
                 card: str) -> dict:
    """Phase 8: faults on the card, in the 32-bit mode, over phase 3's SF1
    lineitem and phase 7's SF1 tables, each in 4 partitions. The armed cases
    of ``fault_cases`` (each with its unarmed run first, its rows held to
    that run's at rtol 1e-6, Q3's by q3_parity, and its counters and
    launches to FAULT_PINS); K1's wrapper replaced by one that raises
    DaftKernelError (collect() raises it, the breaker stays closed); a
    deadline of 1e-6 s (DaftTimeoutError carrying deadline_expired); and,
    with nothing armed, warm Q1 and Q6 over one partition (median of 5)
    beside phase 3's runs of this call: the cost of the disarmed registry
    and the breaker's gate."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch import faults
    from daft_tpu_torch.errors import DaftKernelError, DaftTimeoutError
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    step = -(-lineitem.num_rows // FAULT_PARTS)
    frames = {"lineitem_4": dtt.from_arrow(
        [lineitem.slice(i * step, step) for i in range(FAULT_PARTS)]).collect()}
    for k in ("lineitem", "orders", "customer"):
        frames[k] = dtt.from_arrow(tables[k]).into_partitions(FAULT_PARTS).collect()
    want3, groups3 = q3_oracle
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}

    def drive_case(name, build, overrides, plan=None):
        dtt.set_execution_config(config(**ONE_THREAD, **overrides))
        if plan is not None:
            faults.arm(plan[0], plan[1], **plan[2])
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            df = build(frames).collect()
            got = df.to_pydict()
            torch.cuda.synchronize()
        finally:
            faults.disarm()
        wall = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k in launches:
            out[f"{k}_launches"] += launches[k]
        c = df.stats.snapshot()["counters"]
        res = {"wall_s": wall, "launches": launches,
               "counters": {k: c.get(k, 0) for k in FAULT_COUNTERS if c.get(k, 0)},
               "plan": None if plan is None else list(plan[:2]) + [plan[2]], "card": card}
        print(f"SF1 faults {name} " + json.dumps(res), flush=True)
        return got, c, launches

    for name, (build, overrides, plan) in fault_cases().items():
        want, c0, _ = drive_case(name + " unarmed", build, overrides)
        ph.check(all(c0.get(k, 0) == 0 for k in HEALTH_COUNTERS),
                 f"phase 8 {name}: unarmed, no trip, degraded completion or injected fault")
        got, c, launches = drive_case(name, build, overrides, plan)
        same = (q3_parity(got, want3, groups3, RTOL) if name == "q3_join_filter"
                else parity(got, want, RTOL))
        ph.check(same, f"phase 8 {name}: rows equal the unarmed run's "
                       + ("by q3_parity" if name == "q3_join_filter" else f"at rtol {RTOL}"))
        pins = FAULT_PINS[name]
        seen = {k: (launches[k] if k in launches else c.get(k, 0)) for k in pins}
        ph.check(seen == pins, f"phase 8 {name}: counters and launches {seen} (want {pins})")
        if name == "q3_join_filter":
            ph.check(c.get("join_filter_errors", 0) > 0
                     and launches["k1"] + launches["scatter"] >= 1,
                     f"phase 8 {name}: {c.get('join_filter_errors', 0)} join-filter errors, "
                     f"float sums through K1 or the scatter kernel ({launches}), the probes "
                     f"through K7 ({c.get('device_join_probes', 0)})")

    # a failure of the port itself: K1's wrapper raises DaftKernelError
    real = ss.masked_segment_sums_padded

    def broken(*a, **kw):
        raise DaftKernelError("masked_segment_sums kernel launch failed: replaced wrapper")

    dtt.set_execution_config(config(**ONE_THREAD))
    df = q1(frames["lineitem_4"])
    ss.masked_segment_sums_padded = broken
    try:
        df.collect()
        raised = None
    except DaftKernelError as e:
        raised = e
    finally:
        ss.masked_segment_sums_padded = real
    c = df.stats.snapshot()["counters"]
    ph.check(raised is not None and c.get("device_breaker_trips", 0) == 0
             and c.get("degraded_completions", 0) == 0,
             f"phase 8 kernel_error: collect() raised {type(raised).__name__} ({raised}), "
             f"the breaker closed (counters {dict((k, c.get(k, 0)) for k in HEALTH_COUNTERS)})")

    # a deadline
    dtt.set_execution_config(config(execution_timeout_s=1e-6, **ONE_THREAD))
    try:
        q1(frames["lineitem_4"]).collect()
        err = None
    except DaftTimeoutError as e:
        err = e
    expired = (err.stats.get("counters", {}).get("deadline_expired", 0)
               if err is not None else 0)
    ph.check(err is not None and expired >= 1,
             f"phase 8 deadline: DaftTimeoutError ({err}), deadline_expired {expired}")

    # nothing armed: warm Q1 and Q6 over one partition beside phase 3's runs
    dtt.set_execution_config(config(**ONE_THREAD))
    frame = dtt.from_arrow(lineitem).collect()
    for name, query in (("q1", q1), ("q6", q6)):
        ss.LAUNCHES = 0
        query(frame).collect()
        out["k1_launches"] += ss.LAUNCHES
        res = warm_median(query, frame)
        res.update(phase3_warm_median_s=main_sf1[name]["warm_median_s"],
                   over_phase3=res["warm_median_s"] / main_sf1[name]["warm_median_s"],
                   card=card)
        out[f"{name}_disarmed"] = res
        print(f"SF1 faults {name}_disarmed " + json.dumps(res), flush=True)
    del frame, frames
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the relational surface on the card
# ---------------------------------------------------------------------------

REL_PARTS = 4
REL_WARM = 1  # warm runs a case: few, so the whole run stays well inside its time limit
ID_PARTS = 4


def ids_q6(frame, col):
    """TPC-H Q6 over a frame that carries monotonic ids (it reads none)."""
    return (frame
            .where((col("l_shipdate") >= datetime.date(1994, 1, 1))
                   & (col("l_shipdate") < datetime.date(1995, 1, 1))
                   & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                   & (col("l_quantity") < 24))
            .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue")))


def ids_max(frame, col):
    """A filter, then the largest id and a sum: it stages the ids."""
    return (frame.where(col("l_quantity") < 24)
            .agg(col("rid").max().alias("rid_max"), col("l_extendedprice").sum().alias("price")))


ID_QUERIES = {"q6": ids_q6, "max_id": ids_max}
# what phase 9 (h)'s queries over ID_PARTS partitions count in the 32-bit
# mode; tests/test_torch_reshape.py pins the same for daft_tpu and the port
# on the CPU. Ids of partitions 1 and later are at least 2**36, past the
# int32 staging guard: Q6 never stages them; the largest id fails its device
# attempt on partitions 1-3 (DaftStagingError) and those partitions complete
# on the host. Partition 0's success resolves after partition 1's failed
# launch (the dispatch runs one partition ahead), so no three failures are
# consecutive and the breaker stays closed. Stage 2 takes the host below
# device_min_rows (plain routing)
ID_PINS = {
    "q6": {"device_attempt_failures": 0, "device_breaker_trips": 0, "degraded_completions": 0,
           "device_aggregations": ID_PARTS, "host_aggregations": 1},
    "max_id": {"device_attempt_failures": 3, "device_breaker_trips": 0,
                   "degraded_completions": 0, "device_aggregations": 1,
                   "host_aggregations": ID_PARTS},
}


def _close(a, b, rtol: float = RTOL) -> bool:
    return abs(a - b) <= max(rtol * abs(b), 1e-6)


def _column_sums(tbl) -> dict:
    """The sum of each numeric column of a pyarrow table."""
    import pyarrow as pa
    import pyarrow.compute as pc

    return {f.name: pc.sum(tbl[f.name]).as_py() for f in tbl.schema
            if pa.types.is_integer(f.type) or pa.types.is_floating(f.type)}


def _sums_match(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        (got[k] == want[k]) if isinstance(want[k], int) else _close(got[k], want[k])
        for k in want)


def _grouped(tbl, keys, value: str) -> dict:
    """{key tuple: value} of a result table."""
    cols = [tbl[k].to_pylist() for k in keys]
    return dict(zip(zip(*cols), tbl[value].to_pylist()))


def _dict_close(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(_close(got[k], want[k]) for k in want)


def relational_cases(frames: dict, tables: dict, ph: Phases) -> dict:
    """Phase 9's cases: name -> (build() -> DataFrame, check(df, counters,
    launches) -> [(ok, what)], whether the case is held to HEALTH_COUNTERS).
    The oracles are pyarrow's (numpy's draws for the sample)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from benchmarks import tpch
    from daft_tpu_torch import col

    li, orders, cust, nation = (tables[k] for k in ("lineitem", "orders", "customer", "nation"))
    L, O = frames["lineitem"], frames["orders"]

    # (a) the sort-merge join, its grouped aggregate, and the hash join of
    # the same sides
    joined = li.join(orders, keys="l_orderkey", right_keys="o_orderkey")
    join_sums = _column_sums(joined)
    status = joined.group_by("o_orderstatus").aggregate(
        [("l_extendedprice", "sum"), ("l_orderkey", "count")])
    want_status = {k: (s, n) for k, s, n in zip(*[status[c].to_pylist() for c in (
        "o_orderstatus", "l_extendedprice_sum", "l_orderkey_count")])}
    del joined, status

    def smj():
        return L.join(O, left_on="l_orderkey", right_on="o_orderkey", strategy="sort_merge")

    def check_join(df, c, launches, smj_route=True):
        got = df.to_arrow()
        out = [(got.num_rows == li.num_rows and _sums_match(_column_sums(got), join_sums),
                f"{got.num_rows} rows (pyarrow's join: {li.num_rows}), the sum of each "
                f"numeric column equal to pyarrow's")]
        if smj_route:
            keys = np.concatenate([np.asarray(p.table().to_arrow()["l_orderkey"])
                                   for p in df._result.partitions])
            want_x = li.num_rows + orders.num_rows
            out += [(bool(np.all(np.diff(keys) >= 0)),
                     "l_orderkey non-decreasing across the collected partitions "
                     f"{[len(p) for p in df._result.partitions]}"),
                    (c.get("aligned_boundary_shuffles") == 1 and c.get("exchange_rows") == want_x
                     and c.get("device_join_probes", 0) == 0,
                     f"aligned_boundary_shuffles {c.get('aligned_boundary_shuffles')} (want 1), "
                     f"exchange_rows {c.get('exchange_rows')} (want {want_x}), merged on the host")]
        else:
            out.append((c.get("device_join_probes") == REL_PARTS and c.get("host_joins", 0) == 0,
                        f"{c.get('device_join_probes')} probes on the card (want {REL_PARTS})"))
        return out

    def check_status(df, c, launches):
        d = df.to_pydict()
        got = {k: (s, n) for k, s, n in zip(d["o_orderstatus"], d["revenue"], d["n"])}
        return [(set(got) == set(want_status) and all(
            _close(got[k][0], want_status[k][0]) and got[k][1] == want_status[k][1]
            for k in want_status), f"{len(got)} groups against pyarrow's at rtol {RTOL}"),
            (launches["k1"] >= 1, f"the sums through K1 ({launches})")]

    # (b) the cross join
    eq = cust.join(nation, keys="c_nationkey", right_keys="n_nationkey").group_by(
        "n_name").aggregate([("c_acctbal", "sum")])
    want_cross = dict(zip(eq["n_name"].to_pylist(), eq["c_acctbal_sum"].to_pylist()))
    ncross = cust.num_rows * nation.num_rows
    cross_sums = {"c_acctbal": pc.sum(cust["c_acctbal"]).as_py() * nation.num_rows,
                  "n_nationkey": pc.sum(nation["n_nationkey"]).as_py() * cust.num_rows}

    def cross():
        return frames["customer"].join(frames["nation"], how="cross")

    def check_cross(df, c, launches):
        got = df.to_arrow()
        names = list(cust.column_names) + list(nation.column_names)
        return [(got.num_rows == ncross and got.column_names == names
                 and _close(pc.sum(got["c_acctbal"]).as_py(), cross_sums["c_acctbal"])
                 and pc.sum(got["n_nationkey"]).as_py() == cross_sums["n_nationkey"],
                 f"{got.num_rows} rows (want {ncross}), columns {got.column_names}, "
                 f"sums of c_acctbal and n_nationkey {ncross // cust.num_rows} and "
                 f"{ncross // nation.num_rows} times the sides'")]

    def cross_agg():
        return (cross().where(col("c_nationkey") == col("n_nationkey")).groupby("n_name")
                .agg(col("c_acctbal").sum().alias("bal")))

    def check_cross_agg(df, c, launches):
        got = _grouped(df.to_arrow(), ["n_name"], "bal")
        return [(_dict_close({k[0]: v for k, v in got.items()}, want_cross),
                 f"{len(got)} nations equal to the equi-join's sums at rtol {RTOL}"),
                (c.get("host_filters", 0) == 0 and c.get("device_aggregations", 0) >= REL_PARTS
                 and launches["k1"] + launches["scatter"] >= 1,
                 f"the predicate on the card (the aggregates' mask), the sums through K1 "
                 f"({launches})")]

    # (c) concat: lineitem cut into two frames of 2 partitions each
    half = li.num_rows // 2
    import daft_tpu_torch as dtt

    halves = [dtt.from_arrow(li.slice(0, half)).into_partitions(2).collect(),
              dtt.from_arrow(li.slice(half)).into_partitions(2).collect()]
    want_q1 = tpch.oracle_q1(li)
    uncut = {}

    def check_concat(df, c, launches):
        got = df.to_pydict()
        if not uncut:
            from daft_tpu_torch.kernels import segment_sums as ss

            k1 = ss.LAUNCHES
            uncut["rows"] = q1(L).collect().to_pydict()
            uncut["k1"] = ss.LAUNCHES - k1
        return [(parity(got, want_q1, RTOL) and parity(got, uncut["rows"], RTOL),
                 f"equals pyarrow's Q1 over the whole table and the port's Q1 over the uncut "
                 f"{REL_PARTS}-partition frame at rtol {RTOL}"),
                (launches["k1"] == uncut["k1"] >= REL_PARTS,
                 f"K1 launched {launches['k1']} times (the uncut frame: {uncut['k1']})")]

    # (d) sample: partition i draws RandomState(7 + i).permutation(n_i)[:k]
    drawn, want_n = [], 0
    for i, part in enumerate(L._result.partitions):
        t = part.table().to_arrow()
        k = int(round(0.1 * t.num_rows))
        want_n += k
        drawn.append(t.take(pa.array(np.random.RandomState(7 + i).permutation(t.num_rows)[:k])))
    want_sample = tpch.oracle_q1(pa.concat_tables(drawn))
    del drawn

    def check_sample(df, c, launches):
        n = L.sample(0.1, seed=7).count_rows()
        return [(n == want_n, f"{n} rows drawn (want {want_n}, round(0.1 n_i) of each)"),
                (parity(df.to_pydict(), want_sample, RTOL),
                 f"Q1 equals pyarrow's over numpy's draw of the same rows at rtol {RTOL}"),
                (launches["k1"] >= REL_PARTS, f"K1 on each partition ({launches})")]

    # (e) explode: each order's l_quantity values as one list
    lists = li.group_by("l_orderkey").aggregate([("l_quantity", "list")])
    lists_frame = dtt.from_arrow(lists).into_partitions(REL_PARTS).collect()
    nlists = lists.num_rows
    del lists
    want_qty = pc.sum(li["l_quantity"]).as_py()

    def explode():
        return lists_frame.explode("l_quantity_list").agg(
            col("l_quantity_list").sum().alias("s"), col("l_quantity_list").count().alias("n"))

    def check_explode(df, c, launches):
        d = df.to_pydict()
        return [(d["n"] == [li.num_rows] and _close(d["s"][0], want_qty),
                 f"{nlists} lists exploded to {d['n']} rows (want {li.num_rows}), their sum "
                 f"equal to lineitem's at rtol {RTOL}"),
                (c.get("device_aggregations", 0) >= REL_PARTS,
                 f"aggregated on the card ({c.get('device_aggregations', 0)} partitions, "
                 f"launches {launches})")]

    # (f) unpivot
    values = ["l_quantity", "l_extendedprice", "l_discount"]
    flags = li.group_by("l_returnflag").aggregate([(v, "sum") for v in values])
    want_unpivot = {(f, v): s for v in values
                    for f, s in zip(flags["l_returnflag"].to_pylist(), flags[f"{v}_sum"].to_pylist())}

    def unpivot():
        return (L.unpivot("l_returnflag", values).groupby("l_returnflag", "variable")
                .agg(col("value").sum().alias("s")))

    def check_unpivot(df, c, launches):
        got = _grouped(df.to_arrow(), ["l_returnflag", "variable"], "s")
        gaps = {f"{f}/{v}": abs(got[(f, v)] - w) / abs(w)
                for (f, v), w in want_unpivot.items() if (f, v) in got}
        # K1 adds a 1024-row block's rows in float32 before its Kahan step
        # across blocks: a block of l_discount values (0.00 to 0.10) sums to
        # about 17, where each addition rounds by up to 1e-6, and the sum of
        # 2,000,000 of them drifts about 1.25e-6 relative (the plain version,
        # bit for bit the kernel's, gives the same on the CPU). Those three
        # sums are held to the 32-bit suite's rule (tpch22_match), the other
        # six at RTOL
        loose = {k: want_unpivot[k] for k in want_unpivot if k[1] == "l_discount"}
        tight = {k: w for k, w in want_unpivot.items() if k not in loose}
        return [(_dict_close({k: got.get(k) for k in tight}, tight) and set(got) == set(
                    want_unpivot),
                 f"{len(got)} groups over {3 * li.num_rows} unpivoted rows against pyarrow's: "
                 f"l_quantity and l_extendedprice at rtol {RTOL}"),
                (tpch22_match([tuple(got[k] for k in loose)], [tuple(loose.values())]),
                 f"the l_discount sums within the 32-bit suite's rule (5e-4 relative): "
                 f"relative gaps {gaps}"),
                (c.get("device_aggregations", 0) >= REL_PARTS
                 and launches["k1"] + launches["scatter"] >= 1,
                 f"grouped on the card ({launches})")]

    # (g) pivot
    pv = li.group_by(["l_returnflag", "l_linestatus"]).aggregate([("l_quantity", "sum")])
    want_pivot = _grouped(pv, ["l_returnflag", "l_linestatus"], "l_quantity_sum")
    discovery = []

    def pivot():
        seen = len(ph.collects)
        df = L.pivot("l_returnflag", "l_linestatus", "l_quantity", "sum")
        discovery[:] = ph.collects[seen:]
        return df

    def check_pivot(df, c, launches):
        d = df.to_pydict()
        got = {(f, s): d[s][i] for i, f in enumerate(d["l_returnflag"]) for s in d
               if s != "l_returnflag" and d[s][i] is not None}
        dc = discovery[0] if len(discovery) == 1 else {}
        return [(_dict_close(got, want_pivot),
                 f"{len(d['l_returnflag'])} rows x {len(d) - 1} names against pyarrow's at "
                 f"rtol {RTOL}"),
                (dc.get("device_distincts", 0) >= REL_PARTS,
                 f"the names found by one query through the device distinct on each "
                 f"partition ({len(discovery)} queries, device_distincts "
                 f"{dc.get('device_distincts')})")]

    # (h) monotonic ids
    sizes = [len(p) for p in L._result.partitions]

    def ids():
        return L.with_monotonically_increasing_id("rid")

    def check_ids(df, c, launches):
        ok = len(df._result.partitions) == len(sizes)
        for i, (p, n) in enumerate(zip(df._result.partitions, sizes)):
            rid = np.asarray(p.table().to_arrow()["rid"])
            ok = ok and rid.dtype == np.uint64 and np.array_equal(
                rid, np.arange(i << 36, (i << 36) + n, dtype=np.uint64))
        return [(ok, f"partition i's ids are [i << 36, (i << 36) + n_i) for n_i in {sizes}")]

    # the filter moves below the ids (the optimizer's pushdown), so each
    # partition numbers the rows that pass it
    mask = np.asarray(li["l_quantity"]) < 24
    bounds = np.cumsum([0] + sizes)
    kept = [int(mask[bounds[i]:bounds[i + 1]].sum()) for i in range(len(sizes))]
    want_ids = {"q6": {"revenue": [tpch.oracle_q6(li)]},
                "max_id": {"rid_max": [max((i << 36) + m - 1 for i, m in enumerate(kept) if m)],
                           "price": [float(np.asarray(li["l_extendedprice"])[mask].sum())]}}

    def id_case(name):
        def check(df, c, launches):
            seen = {k: (launches[k] if k in launches else c.get(k, 0)) for k in ID_PINS[name]}
            return [(parity(df.to_pydict(), want_ids[name], RTOL),
                     f"equals numpy's and pyarrow's at rtol {RTOL}"),
                    (seen == ID_PINS[name], f"counters {seen} (want {ID_PINS[name]})")]
        return (lambda: ID_QUERIES[name](ids(), col), check, False)

    return {
        "sort_merge_join": (smj, check_join, True),
        "sort_merge_join_agg": (lambda: smj().groupby("o_orderstatus").agg(
            col("l_extendedprice").sum().alias("revenue"), col("l_orderkey").count().alias("n")),
            check_status, True),
        "hash_join_same_sides": (lambda: L.join(O, left_on="l_orderkey", right_on="o_orderkey",
                                                strategy="hash"),
                                 lambda df, c, la: check_join(df, c, la, smj_route=False), True),
        "cross_join": (cross, check_cross, True),
        "cross_join_filter_agg": (cross_agg, check_cross_agg, True),
        "concat_q1": (lambda: q1(halves[0].concat(halves[1])), check_concat, True),
        "sample_q1": (lambda: q1(L.sample(0.1, seed=7)), check_sample, True),
        "explode_agg": (explode, check_explode, True),
        "unpivot_agg": (unpivot, check_unpivot, True),
        "pivot": (pivot, check_pivot, True),
        "monotonic_ids": (ids, check_ids, True),
        "ids_q6": id_case("q6"),
        "ids_max_id": id_case("max_id"),
    }


def phase_relational(ph: Phases, tables: dict, card: str) -> dict:
    """Phase 9: the relational surface on the card, in the 32-bit mode, over
    phase 7's SF1 tables (generate_tables(1.0, seed=42)) with lineitem,
    orders, customer and nation in 4 partitions each (relational_cases):
    the sort-merge join of lineitem and orders (and a grouped aggregate on
    top, and the hash join of the same sides to time against), the cross
    join of customer and nation (and a filter and grouped sum on top,
    against the equi-join), concat then Q1, sample then Q1, explode then a
    sum and count, unpivot then a grouped sum, pivot, and monotonic ids (then
    Q6, and the largest id, whose counters are held to ID_PINS instead of
    HEALTH_COUNTERS). Each case is driven once cold with K1's, K2's and the
    scatter kernel's launches set to 0 just before and read just after,
    checked against its oracle, then timed warm (one run)."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    dtt.set_execution_config(config())
    t0 = time.perf_counter()
    frames = {k: dtt.from_arrow(tables[k]).into_partitions(REL_PARTS).collect()
              for k in ("lineitem", "orders", "customer", "nation")}
    cases = relational_cases(frames, tables, ph)
    print(f"SF1 relational: frames and oracles in {time.perf_counter() - t0:.1f}s", flush=True)
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}
    for name, (build, check, healthy) in cases.items():
        if not healthy:
            ph.begin(None)  # these cases' failures are pinned by ID_PINS instead
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        df = build().collect()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k in launches:
            out[f"{k}_launches"] += launches[k]
        c = df.stats.snapshot()["counters"]
        for ok, what in check(df, c, launches):
            ph.check(ok, f"phase 9 {name}: {what}")
        del df
        warm = []
        for _ in range(REL_WARM):
            t0 = time.perf_counter()
            build().collect()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        res = {"cold_s": cold, "warm_median_s": statistics.median(warm), "warm_runs": warm,
               "launches": launches, "counters": {k: v for k, v in c.items() if v},
               "plan": physical_plan(build()), "card": card}
        out[name] = res
        print(f"SF1 relational {name} " + json.dumps(res), flush=True)
    del frames, cases
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: the bounded-memory exchange on the card
# ---------------------------------------------------------------------------

SPILL_PARTS = 4
SPILL_WARM = 1  # warm runs a case: few, so the whole run stays well inside its time limit
# the counters each phase-10 line reports
SPILL_COUNTERS = ("spilled_partitions", "spill_write_bytes", "spill_read_bytes",
                  "spill_write_failures", "unspill_readahead_submitted", "unspill_readahead_hits",
                  "exchange_rows", "exchange_bytes", "exchange_pieces_encoded",
                  "exchange_bytes_encodable", "exchange_bytes_encoded", "exchange_encode_failures",
                  "exchange_precombined_rows", "corruption_detected", "lineage_truncated",
                  "shuffles", "aligned_boundary_shuffles", "device_sorts", "device_join_probes",
                  "join_filter_device_probes", "device_aggregations", "host_aggregations")
# the device work a budget must leave as it is: the kernels' launches and the
# device counters of the sort (K5), the probe (K7) and the Bloom probe (K10).
# Not the aggregations: past half the budget the combine abandons its fold,
# so stage 2 of (c) merges four times the rows and may clear device_min_rows
SPILL_SAME = ("k1", "k2", "scatter", "device_sorts", "device_join_probes",
              "join_filter_device_probes")


def spill_dirs() -> set:
    """The port's spill directories in the temp directory."""
    import glob
    import os
    import tempfile

    from daft_tpu_torch.spill import SPILL_DIR_PREFIX

    return set(glob.glob(os.path.join(tempfile.gettempdir(), SPILL_DIR_PREFIX + "*")))


def same_rows(got, want, ordered: bool) -> tuple:
    """(equal, detail) of two pyarrow tables: equal names and types, and
    equal rows, in order when ``ordered``, else as multisets; float values
    within 1e-12 relative, everything else exactly (the reference's own
    rule for an exchange knob, tests/test_exchange.py: the host's threaded
    float sums may differ in the last ulp between runs)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    if got.schema != want.schema or got.num_rows != want.num_rows:
        return False, f"schema or rows differ ({got.num_rows} rows against {want.num_rows})"
    if not ordered:
        floats = [f.name for f in want.schema if pa.types.is_floating(f.type)]
        keys = [(f.name, "ascending") for f in want.schema if f.name not in floats]
        keys += [(name, "ascending") for name in floats]
        got = got.take(pc.sort_indices(got, sort_keys=keys))
        want = want.take(pc.sort_indices(want, sort_keys=keys))
    for f in want.schema:
        a, b = got[f.name], want[f.name]
        if pa.types.is_floating(f.type):
            x, y = a.to_numpy(zero_copy_only=False), b.to_numpy(zero_copy_only=False)
            ok = bool(np.allclose(x, y, rtol=1e-12, atol=0.0, equal_nan=True))
        else:
            ok = a.equals(b)
        if not ok:
            return False, f"column {f.name} differs"
    return True, f"{want.num_rows} rows equal" + (", in order" if ordered else "")


def spill_cases(frames: dict, tables: dict) -> dict:
    """Phase 10's cases: name -> (build() -> DataFrame, the config's
    overrides, ordered rows, the unbudgeted case it shares, the fault plan
    (site, kind of result) or None)."""
    from daft_tpu_torch import col

    L, O = frames["lineitem"], frames["orders"]
    keys = ["l_shipdate", "l_orderkey", "l_linenumber"]

    def sort():
        return L.sort(keys, desc=[True, False, False])

    def smj_agg():
        return (L.join(O, left_on="l_orderkey", right_on="o_orderkey", strategy="sort_merge")
                .groupby("o_orderstatus")
                .agg(col("l_extendedprice").sum().alias("revenue"),
                     col("l_orderkey").count().alias("n")))

    def repartition_q1():
        return q1(L.repartition(SPILL_PARTS, "l_returnflag"))

    agg = _exchange_agg_items(tables["lineitem"])["grouped_agg_combine"][0]
    return {
        # (a) the sort, async writes and readahead on, then both off
        "sort": (sort, {}, True, None, None),
        "sort_sync": (sort, {"async_spill_writes": False, "unspill_readahead": False}, True,
                      "sort", None),
        # (b) Q3 through co-partitioned hash joins
        "q3_hash_joins": (lambda: q3(frames["customer"], O, L),
                          {"broadcast_join_size_bytes_threshold": 0}, True, None, None),
        # (c) the grouped aggregate whose shuffle folds its stage-1 pieces
        "grouped_agg_combine": (lambda: agg(frames), {}, False, None, None),
        # (d) the sort-merge join and its grouped aggregate
        "sort_merge_join_agg": (smj_agg, {}, False, None, None),
        # (e) a hash repartition by a flag, then Q1; again with encoding off
        "repartition_q1": (repartition_q1, {}, False, None, None),
        "repartition_q1_raw": (repartition_q1, {"exchange_payload_encoding": False}, False,
                               "repartition_q1", None),
        # (f) each fault site armed always
        "fault_spill_write": (sort, {}, True, "sort", ("spill.write", "rows")),
        "fault_spill_readback": (sort, {}, True, "sort", ("spill.readback", "transient")),
        # synchronous writes: an async write's bits flip when the writer
        # thread gets to it, and a read before that is served from memory
        "fault_spill_corrupt": (sort, {"async_spill_writes": False}, True, "sort",
                                ("spill.corrupt", "corruption")),
        "fault_exchange_encode": (repartition_q1, {}, False, "repartition_q1",
                                  ("exchange.encode", "rows")),
    }


def phase_spill(ph: Phases, tables: dict, card: str) -> dict:
    """Phase 10: the bounded-memory exchange on the card, in the 32-bit
    mode, over phase 7's SF1 tables (generate_tables(1.0, seed=42)) with
    lineitem, orders and customer in 4 partitions each (spill_cases): (a)
    the sort (async spill writes and readahead on, then both off), (b)
    hash-join Q3, (c) the grouped aggregate by l_suppkey with the fold on,
    (d) the sort-merge join of lineitem and orders with its grouped
    aggregate, (e) repartition(4, "l_returnflag") then Q1 (and with
    encoding off), (f) each fault site of the slice armed always on (a) or
    (e). Each case runs unbudgeted, cold then once warm, and then under
    a budget of a quarter of the bytes its unbudgeted exchange moved
    (``exchange_bytes``; for the sort, a quarter of lineitem's bytes), cold
    with K1's, K2's and the scatter kernel's launches set to 0 just before
    and read just after, then once warm. The budgeted cold run must give
    the unbudgeted rows (same_rows), the same launches and device counters
    (SPILL_SAME), spilled_partitions > 0, and leave the ledger at 0 with no
    spill directory; (f) as its fault site says."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch.errors import DaftCorruptionError, DaftTransientError
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.spill import MEMORY_LEDGER

    t0 = time.perf_counter()
    dtt.set_execution_config(config(**ONE_THREAD))
    frames = {k: dtt.from_arrow(tables[k]).into_partitions(SPILL_PARTS).collect()
              for k in ("lineitem", "orders", "customer")}
    cases = spill_cases(frames, tables)
    print(f"SF1 spill: frames in {time.perf_counter() - t0:.1f}s; lineitem "
          f"{tables['lineitem'].nbytes} arrow bytes", flush=True)
    dirs0 = spill_dirs()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}
    plain = {}  # name -> (rows, counters, launches, exchange bytes, times)

    def timed(build, fault=None):
        """One collect and fetch: (DataFrame, arrow table or the exception,
        seconds, launches)."""
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        df = build()
        t = time.perf_counter()
        try:
            if fault is not None:
                from daft_tpu_torch import faults

                faults.arm(fault, "always")
            got = df.collect().to_arrow()
        except DaftTransientError as e:
            got = e
        finally:
            if fault is not None:
                faults.disarm()
        torch.cuda.synchronize()
        return (df, got, time.perf_counter() - t,
                {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES})

    def warm(build) -> list:
        walls = []
        for _ in range(SPILL_WARM):
            walls.append(timed(build)[2])
        return walls

    for name, (build, overrides, ordered, shares, fault) in cases.items():
        label = f"SF1 spill {name}"
        if fault is not None and ph.phase is not None:
            ph.begin(None)  # the fault cases read their own counters
        base = shares or name
        dtt.set_execution_config(config(**ONE_THREAD, **overrides))
        if base not in plain:
            df, rows, cold, launches = timed(build)
            c = df.stats.snapshot()["counters"]
            plain[base] = {"rows": rows, "counters": c, "launches": launches,
                           "budget": max(1, c.get("exchange_bytes", 0) // 4),
                           "cold_s": cold, "warm_s": warm(build)}
            del df
        ref = plain[base]
        budget = ref["budget"]
        dtt.set_execution_config(config(memory_budget_bytes=budget, **ONE_THREAD, **overrides))
        MEMORY_LEDGER.reset()
        df, got, cold, launches = timed(build, fault[0] if fault else None)
        c = df.stats.snapshot()["counters"]
        led = MEMORY_LEDGER.snapshot()
        left = spill_dirs() - dirs0
        ph.check(led["current"] == 0 and led["async_spill_inflight"] == 0 and not left,
                 f"{label}: ledger current {led['current']}, async in flight "
                 f"{led['async_spill_inflight']}, spill directories left {sorted(left)}")
        seen = {k: (launches[k] if k in launches else c.get(k, 0)) for k in SPILL_SAME}
        want = {k: (ref["launches"][k] if k in ref["launches"] else ref["counters"].get(k, 0))
                for k in SPILL_SAME}
        kind = fault[1] if fault else "rows"
        if kind == "rows":
            ok, detail = ((False, repr(got)) if isinstance(got, Exception)
                          else same_rows(got, ref["rows"], ordered))
            ph.check(ok, f"{label}: the unbudgeted run's rows ({detail})")
            ph.check(seen == want, f"{label}: launches and device counters {seen} "
                                   f"(unbudgeted: {want})")
        elif kind == "transient":
            ph.check(isinstance(got, DaftTransientError)
                     and not isinstance(got, DaftCorruptionError),
                     f"{label}: DaftTransientError reached the caller ({got!r:.120})")
        else:
            ph.check(isinstance(got, DaftCorruptionError) and c.get("lineage_truncated", 0) > 0,
                     f"{label}: DaftCorruptionError reached the caller ({got!r:.120}), "
                     f"lineage_truncated {c.get('lineage_truncated', 0)}")
        if fault is None:
            ph.check(c.get("spilled_partitions", 0) > 0,
                     f"{label}: {c.get('spilled_partitions', 0)} partitions spilled under a "
                     f"budget of {budget} bytes")
            for k in ("k1", "k2", "scatter"):
                out[f"{k}_launches"] += launches[k]
        elif fault[0] == "spill.write":
            ph.check(c.get("spill_write_failures", 0) > 0 and c.get("spilled_partitions", 0) == 0,
                     f"{label}: spill_write_failures {c.get('spill_write_failures', 0)}, "
                     f"spilled_partitions {c.get('spilled_partitions', 0)}")
        elif fault[0] == "exchange.encode":
            ph.check(c.get("exchange_pieces_encoded", 0) == 0
                     and c.get("exchange_encode_failures", 0) > 0,
                     f"{label}: exchange_pieces_encoded {c.get('exchange_pieces_encoded', 0)}, "
                     f"exchange_encode_failures {c.get('exchange_encode_failures', 0)}")
        if name == "repartition_q1":
            ph.check(0 < c.get("exchange_bytes_encoded", 0) < c.get("exchange_bytes", 0),
                     f"{label}: exchange_bytes_encoded {c.get('exchange_bytes_encoded', 0)} < "
                     f"exchange_bytes {c.get('exchange_bytes', 0)}")
        if name == "repartition_q1_raw":
            enc = out["repartition_q1"]["counters"].get("spill_write_bytes", 0)
            ph.check(0 < enc < c.get("spill_write_bytes", 0),
                     f"{label}: spill written with encoding on {enc} < off "
                     f"{c.get('spill_write_bytes', 0)}")
        io = df.stats.io_breakdown()
        del df, got
        res = {"budget_bytes": budget, "cold_s": cold,
               "warm_s": warm(build) if fault is None else None,
               "unbudgeted_cold_s": ref["cold_s"], "unbudgeted_warm_s": ref["warm_s"],
               "spill_write_mbps": io["spill_write_mbps"], "spill_read_mbps": io["spill_read_mbps"],
               "io_wait_share": io["io_wait_share"], "launches": launches,
               "counters": {k: c.get(k, 0) for k in SPILL_COUNTERS if c.get(k, 0)},
               "ledger_high_water": led["high_water"], "card": card}
        if fault is None:
            res["warm_median_s"] = statistics.median(res["warm_s"])
            res["unbudgeted_warm_median_s"] = statistics.median(ref["warm_s"])
        out[name] = res
        print(f"{label} " + json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    dtt.set_execution_config(config(**ONE_THREAD))
    del frames, cases, plain
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: planning for repeated queries (the plan cache, feedback-directed
# planning, adaptive execution, the whole-plan result cache)
# ---------------------------------------------------------------------------

ADAPT_PARTS = 4
ADAPT_FANOUT_PARTS = 8
ADAPT_WARM = 3
# phase 11's plan-cache cap: a plan pins its frames' partitions, and SF1
# lineitem alone holds 517,711,792 arrow bytes, so the default cap (64 MiB)
# keeps every plan over it out of the cache, as (a0) shows
ADAPT_CACHE_BYTES = 4 << 30
ADAPT_FLIP_DATE = datetime.date(1992, 2, 1)        # keeps about 1 % of orders
ADAPT_MISPREDICT_DATE = datetime.date(1998, 1, 1)  # keeps about 85 % of orders
# the counters each phase-11 line reports
ADAPT_COUNTERS = ("plan_cache_hits", "plan_cache_misses", "plan_cache_errors",
                  "result_cache_hits", "fdo_join_flips", "fdo_shuffle_resizes",
                  "fdo_reduced_partitions", "fdo_mispredicts", "aqe_stages",
                  "aqe_shuffle_resizes", "broadcast_joins", "device_join_probes",
                  "join_filter_device_probes", "device_aggregations", "host_aggregations",
                  "shuffles", "planning_wall_ns", "compile_wall_ns")


def q6_discounts(lineitem, lo: float, hi: float):
    """TPC-H Q6 with its discount range as parameters (q6 is (0.05, 0.07))."""
    from daft_tpu_torch import col

    return (
        lineitem
        .where((col("l_shipdate") >= datetime.date(1994, 1, 1))
               & (col("l_shipdate") < datetime.date(1995, 1, 1))
               & (col("l_discount") >= lo)
               & (col("l_discount") <= hi)
               & (col("l_quantity") < 24))
        .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue"))
    )


def oracle_q6_discounts(li, lo: float, hi: float) -> dict:
    import pyarrow as pa
    import pyarrow.compute as pc

    m = pc.and_(pc.and_(pc.greater_equal(li["l_shipdate"], pa.scalar(datetime.date(1994, 1, 1))),
                        pc.less(li["l_shipdate"], pa.scalar(datetime.date(1995, 1, 1)))),
                pc.and_(pc.and_(pc.greater_equal(li["l_discount"], lo),
                                pc.less_equal(li["l_discount"], hi)),
                        pc.less(li["l_quantity"], 24)))
    t = li.filter(m)
    return {"revenue": [pc.sum(pc.multiply(t["l_extendedprice"], t["l_discount"])).as_py()]}


def suppkey_agg(lineitem):
    """Float sums by l_suppkey (10,000 groups at SF1): no merge of it is
    exact, so its exchange does not fold, and stage 2 reads the partials."""
    from daft_tpu_torch import col

    return (lineitem.groupby("l_suppkey")
            .agg(col("l_extendedprice").sum().alias("revenue"),
                 col("l_discount").mean().alias("avg_disc"))
            .sort("l_suppkey"))


def oracle_suppkey_agg(li) -> dict:
    g = li.group_by("l_suppkey").aggregate([("l_extendedprice", "sum"), ("l_discount", "mean")])
    g = g.sort_by("l_suppkey")
    return {"l_suppkey": g["l_suppkey"].to_pylist(),
            "revenue": g["l_extendedprice_sum"].to_pylist(),
            "avg_disc": g["l_discount_mean"].to_pylist()}


def flip_query(lineitem, orders, before: datetime.date):
    """lineitem joined with the orders placed before ``before``, then the
    revenue by order priority: the join's orders side shrinks behind its
    filter, which its static estimate (all of orders) does not see."""
    from daft_tpu_torch import col

    o = orders.where(col("o_orderdate") < before)
    return (lineitem.join(o, left_on="l_orderkey", right_on="o_orderkey")
            .groupby("o_orderstatus").agg(col("l_extendedprice").sum().alias("revenue"))
            .sort("o_orderstatus"))


def oracle_flip(li, orders, before: datetime.date) -> dict:
    import pyarrow as pa
    import pyarrow.compute as pc

    o = orders.filter(pc.less(orders["o_orderdate"], pa.scalar(before)))
    j = li.join(o, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
    g = j.group_by("o_orderstatus").aggregate([("l_extendedprice", "sum")])
    g = g.sort_by("o_orderstatus")
    return {"o_orderstatus": g["o_orderstatus"].to_pylist(),
            "revenue": g["l_extendedprice_sum"].to_pylist()}


class PlanningCalls:
    """Counts the port's optimize, translate, map-chain compile and
    plan-segment compile calls while it is entered: what a warm plan-cache
    hit must not pay."""

    TARGETS = (("daft_tpu_torch.optimizer", "optimize"), ("daft_tpu_torch.physical", "translate"),
               ("daft_tpu_torch.fuse.compile", "compile_chain"),
               ("daft_tpu_torch.fuse", "compile_plan_segments"))

    def __enter__(self) -> dict:
        import importlib

        self.calls = {name: 0 for _, name in self.TARGETS}
        self.real = []
        for mod, name in self.TARGETS:
            m = importlib.import_module(mod)
            fn = getattr(m, name)
            self.real.append((m, name, fn))

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)

            setattr(m, name, counted)
        return self.calls

    def __exit__(self, *exc) -> None:
        for m, name, fn in self.real:
            setattr(m, name, fn)


def adapt_run(build) -> dict:
    """One collect and fetch of ``build()`` with the kernels' launches set to
    0 just before and read just after, and the planning calls counted. The
    DataFrame is dropped before this returns, so that the next run is not
    served from its result (the whole-plan result cache is on)."""
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
    with PlanningCalls() as calls:
        t0 = time.perf_counter()
        df = build().collect()
        rows = df.to_arrow()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c = df.stats.snapshot()["counters"]
    del df
    return {"rows": rows, "s": wall, "calls": dict(calls),
            "launches": {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES,
                         "probes": c.get("device_join_probes", 0)},
            "counters": {k: c.get(k, 0) for k in ADAPT_COUNTERS if c.get(k, 0)}}


def phase_adapt(ph: Phases, tables: dict, q3_oracle: tuple, card: str) -> dict:
    """Phase 11: planning for repeated queries on the card, in the 32-bit
    mode with the default knobs (the plan cache, feedback-directed planning
    and the whole-plan result cache on) but the plan cache's cap
    (ADAPT_CACHE_BYTES), over phase 7's SF1 tables with lineitem, orders and
    customer in 4 partitions. (a0) Q6 twice under the default cap: no hit,
    its frames are beyond the cap. (a) composed Q1, deep Q1 (K2), Q6 and
    hash-join Q3 (broadcast threshold 0): cold, 3 warm runs with the plan
    cache on, 3 with it off; the last warm run is a hit with no optimize,
    translate or compile call, its rows byte-identical to the run that
    planned its binding and its K1, K2, scatter and probe launches equal;
    Q6 with another discount range shares the entry as a second binding.
    (b) float sums by l_suppkey over lineitem in 8 partitions: the second
    run resizes the exchange to k partitions, each reduced partition
    aggregated on the card. (c) lineitem joined with the orders of January
    1992, then a grouped sum: the second run flips to a broadcast join
    (probes through K7), the third is a plan hit. (d) the same shape keeping
    85 % of orders: the flip mispredicts, the shape's plans are demoted, the
    next run joins by hash. (e) (c) under enable_aqe. (f) the
    plancache.lookup fault armed always. (g) the card's allocated bytes with
    the frames dropped and their plans cached, then after the cache is
    cleared. Every run's rows are held against a pyarrow oracle."""
    import gc

    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch import faults
    from daft_tpu_torch.adapt import HISTORY, PLAN_CACHE
    from daft_tpu_torch.adapt.fingerprint import canonical_site_fp
    from daft_tpu_torch.logical import Join
    from daft_tpu_torch.optimizer import optimize

    t0 = time.perf_counter()
    PLAN_CACHE.clear()
    HISTORY.clear()
    li, orders = tables["lineitem"], tables["orders"]
    frames = {k: dtt.from_arrow(tables[k]).into_partitions(ADAPT_PARTS).collect()
              for k in ("lineitem", "orders", "customer")}
    L, O, C = frames["lineitem"], frames["orders"], frames["customer"]
    L8 = dtt.from_arrow(li).into_partitions(ADAPT_FANOUT_PARTS).collect()
    want = {"q1": tpch.oracle_q1(li), "q6": oracle_q6_discounts(li, 0.05, 0.07),
            "q6_other": oracle_q6_discounts(li, 0.02, 0.04),
            "suppkey": oracle_suppkey_agg(li),
            "flip": oracle_flip(li, orders, ADAPT_FLIP_DATE),
            "mispredict": oracle_flip(li, orders, ADAPT_MISPREDICT_DATE)}
    q3_want, q3_groups = q3_oracle
    print(f"SF1 adapt: frames and oracles in {time.perf_counter() - t0:.1f}s", flush=True)
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}

    def run(build) -> dict:
        r = adapt_run(build)
        for k in ("k1", "k2", "scatter"):
            out[f"{k}_launches"] += r["launches"][k]
        return r

    def holds(r, name) -> bool:
        got = r["rows"].to_pydict()
        if name == "q3":
            return q3_parity(got, q3_want, q3_groups, RTOL)
        return parity(got, want[name], RTOL)

    def line(label, res) -> None:
        print(f"SF1 adapt {label} " + json.dumps(res), flush=True)

    def cfg(**kw):
        return dtt.ExecutionConfig(plan_cache_bytes=ADAPT_CACHE_BYTES, **kw)

    def brief(r) -> dict:
        return {"s": r["s"], "counters": r["counters"], "launches": r["launches"]}

    # (a0) the default cap: a plan over SF1 lineitem is never cached
    dtt.set_execution_config(dtt.ExecutionConfig())
    runs = [run(lambda: q6_discounts(L, 0.05, 0.07)) for _ in range(2)]
    pinned = sum(p.size_bytes() or 0 for p in L._result.partitions)
    ph.check(runs[1]["counters"].get("plan_cache_hits", 0) == 0
             and runs[1]["counters"].get("plan_cache_misses", 0) == 1
             and pinned > dtt.ExecutionConfig().plan_cache_bytes,
             f"SF1 adapt (a0): under the default cap a second Q6 plans again "
             f"({runs[1]['counters']}): its frame pins {pinned} arrow bytes > "
             f"{dtt.ExecutionConfig().plan_cache_bytes}")

    # (a) the warm path
    cases = {"q1": (lambda: q1(L), {}, "q1"),
             "q1_deep": (lambda: q1(L), {"use_deep_fusion_kernel": True}, "q1"),
             "q6": (lambda: q6_discounts(L, 0.05, 0.07), {}, "q6"),
             "q3_hash_joins": (lambda: q3(C, O, L), {"broadcast_join_size_bytes_threshold": 0},
                               "q3")}
    q6_rows = None
    for name, (build, over, oracle) in cases.items():
        dtt.set_execution_config(cfg(**over))
        on = [run(build) for _ in range(1 + ADAPT_WARM)]
        dtt.set_execution_config(cfg(plan_cache=False, **over))
        off = [run(build) for _ in range(ADAPT_WARM)]
        label = f"(a) {name}"
        ph.check(all(holds(r, oracle) for r in on + off),
                 f"SF1 adapt {label}: all {len(on) + len(off)} runs match the pyarrow oracle "
                 f"at rtol {RTOL}")
        hit = on[-1]
        planned = [r for r in on[:-1] if r["counters"].get("plan_cache_misses")][-1]
        ph.check(hit["counters"].get("plan_cache_hits") == 1
                 and not any(hit["calls"].values()),
                 f"SF1 adapt {label}: the last warm run hits with no planning call "
                 f"({hit['calls']})")
        ph.check(hit["rows"].equals(planned["rows"]) and hit["launches"] == planned["launches"],
                 f"SF1 adapt {label}: the hit's rows byte-identical to the run that planned "
                 f"its binding (run {on.index(planned)}), launches {hit['launches']} equal "
                 f"to its {planned['launches']}")
        ph.check(all(not r["counters"].get("plan_cache_hits") for r in off),
                 f"SF1 adapt {label}: plan_cache off plans every run")
        if name == "q6":
            q6_rows = on[0]["rows"]
        line(label, {"cold_s": on[0]["s"], "warm_s": [r["s"] for r in on[1:]],
                     "warm_cache_off_s": [r["s"] for r in off],
                     "planning_wall_ns_cold": on[0]["counters"].get("planning_wall_ns", 0),
                     "planning_wall_ns_hit": hit["counters"].get("planning_wall_ns", 0),
                     "planning_wall_ns_off": [r["counters"].get("planning_wall_ns", 0)
                                              for r in off],
                     "compile_wall_ns_cold": on[0]["counters"].get("compile_wall_ns", 0),
                     "planned_by_run": on.index(planned),
                     "runs": [brief(r) for r in on], "card": card})
    # a second binding of Q6's entry
    dtt.set_execution_config(cfg())
    before = PLAN_CACHE.snapshot()
    r = run(lambda: q6_discounts(L, 0.02, 0.04))
    after = PLAN_CACHE.snapshot()
    ph.check(holds(r, "q6_other") and r["counters"].get("plan_cache_misses") == 1
             and after["entries"] == before["entries"]
             and after["bindings"] == before["bindings"] + 1,
             f"SF1 adapt (a) q6 discounts 0.02-0.04: a second binding of Q6's entry "
             f"(entries {before['entries']} -> {after['entries']}, bindings "
             f"{before['bindings']} -> {after['bindings']}), rows equal to its oracle")

    # (b) the fan-out resize
    runs = [run(lambda: suppkey_agg(L8)) for _ in range(2)]
    cold, resized = (r["counters"] for r in runs)
    k = ADAPT_FANOUT_PARTS - resized.get("fdo_reduced_partitions", 0)
    ph.check(all(holds(r, "suppkey") for r in runs)
             and not cold.get("fdo_shuffle_resizes") and resized.get("fdo_shuffle_resizes") == 1
             and resized.get("device_aggregations") == ADAPT_FANOUT_PARTS + k
             and not resized.get("host_aggregations"),
             f"SF1 adapt (b) by l_suppkey over {ADAPT_FANOUT_PARTS} partitions: the second run "
             f"resizes the exchange to {k} partitions, each aggregated on the card "
             f"(device_aggregations {resized.get('device_aggregations')}), rows equal")
    line("(b) resize", {"k": k, "runs": [brief(r) for r in runs], "card": card})

    # (c) the join flip
    def flip(before=ADAPT_FLIP_DATE):
        return flip_query(L, O, before)

    join = [p for p in _walk(optimize(flip()._plan)) if isinstance(p, Join)][0]
    site, static = canonical_site_fp(join.right), join.right.approx_size_bytes()
    del join  # it holds the frames' partitions, which (g) counts
    threshold = dtt.ExecutionConfig().broadcast_join_size_bytes_threshold
    runs = [run(flip)]
    observed = (HISTORY.size(site) or (0, 0, 0))[1]
    runs += [run(flip), run(flip)]
    c1, c2, c3 = (r["counters"] for r in runs)
    ph.check(2 * observed < threshold < static,
             f"SF1 adapt (c): the side's observed bytes {observed} (twice: {2 * observed}) < "
             f"threshold {threshold} < its static estimate {static}")
    ph.check(all(holds(r, "flip") for r in runs) and not c1.get("broadcast_joins")
             and c2.get("fdo_join_flips") == 1 and c2.get("broadcast_joins", 0) >= 1
             and c2.get("device_join_probes", 0) >= 1
             and c3.get("plan_cache_hits") == 1 and c3.get("broadcast_joins", 0) >= 1,
             f"SF1 adapt (c): cold hash join, the second run flips to broadcast with "
             f"{c2.get('device_join_probes')} probes on the card, the third hits the flipped "
             f"plan; rows equal")
    line("(c) flip", {"observed_bytes": observed, "threshold": threshold,
                      "static_bytes": static, "runs": [brief(r) for r in runs], "card": card})
    flip_rows = runs[0]["rows"].to_pydict()

    # (d) the mispredict
    demotions = PLAN_CACHE.snapshot()["demotions"]
    runs = [run(lambda: flip(ADAPT_MISPREDICT_DATE)) for _ in range(2)]
    d1, d2 = (r["counters"] for r in runs)
    demoted = PLAN_CACHE.snapshot()["demotions"]
    ph.check(all(holds(r, "mispredict") for r in runs) and d1.get("fdo_join_flips") == 1
             and d1.get("fdo_mispredicts", 0) >= 1 and demoted > demotions
             and not d2.get("fdo_join_flips") and not d2.get("broadcast_joins"),
             f"SF1 adapt (d): the flip mispredicts ({d1.get('fdo_mispredicts')}), demotions "
             f"{demotions} -> {demoted}, the next run joins by hash; rows equal")
    line("(d) mispredict", {"runs": [brief(r) for r in runs], "card": card})

    # (e) adaptive execution
    dtt.set_execution_config(cfg(enable_aqe=True))
    r = run(flip)
    c = r["counters"]
    ph.check(c.get("aqe_stages", 0) >= 1 and c.get("broadcast_joins", 0) >= 1
             and parity(r["rows"].to_pydict(), flip_rows, RTOL),
             f"SF1 adapt (e) enable_aqe: {c.get('aqe_stages')} stage(s), a broadcast join, "
             f"rows equal to the static plan's")
    line("(e) aqe", brief(r))

    # (f) the lookup fault (it counts faults_injected: no health check)
    ph.begin(None)
    dtt.set_execution_config(cfg())
    with faults.inject("plancache.lookup", "always"):
        r = run(lambda: q6_discounts(L, 0.05, 0.07))
    ph.check(r["rows"].equals(q6_rows) and r["counters"].get("plan_cache_errors", 0) >= 1,
             f"SF1 adapt (f) plancache.lookup armed always: rows equal, plan_cache_errors "
             f"{r['counters'].get('plan_cache_errors')}")

    # (g) the device memory a cached plan pins
    torch.cuda.synchronize()
    with_frames = torch.cuda.memory_allocated()
    del L, O, C, L8, frames
    gc.collect()
    cached = torch.cuda.memory_allocated()
    snap = PLAN_CACHE.snapshot()
    PLAN_CACHE.clear()
    gc.collect()
    cleared = torch.cuda.memory_allocated()
    ph.check(cleared <= cached,
             f"SF1 adapt (g): allocated on the card {with_frames} B with the frames, {cached} B "
             f"with them dropped and their {snap['bindings']} plans cached "
             f"({snap['bytes']} B in the cache's estimate), {cleared} B after the cache is "
             f"cleared")
    out["memory"] = {"with_frames": with_frames, "frames_dropped_plans_cached": cached,
                     "cache_cleared": cleared, "plan_cache_estimate": snap["bytes"],
                     "bindings": snap["bindings"]}
    line("(g) memory", out["memory"])
    HISTORY.clear()
    dtt.set_execution_config(dtt.ExecutionConfig())
    torch.cuda.empty_cache()
    print(f"SF1 adapt: phase 11 in {time.perf_counter() - t0:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: scans, the TPC-H tables read back from parquet files
# ---------------------------------------------------------------------------

SCAN_TPCH_GROUPS = 8   # row groups of each 22-query table's file
SCAN_LI_GROUPS = 16    # row groups of the l_shipdate-sorted lineitem's file
SCAN_WARM = 2
# the lineitem columns each query reads (IO_STATS.columns_read of one task)
SCAN_COLUMNS = {"q1": 7, "q6": 4}
CAST_INPUT = [1.5, float("nan"), float("inf"), float("-inf"), 3e10, -2.5]
# the reference's device cast of CAST_INPUT (XLA saturates), by (x64, target)
CAST_WANT = {
    (False, "int32"): [1, 0, 2**31 - 1, -2**31, 2**31 - 1, -2],
    (False, "int64"): [1, 0, 2**31 - 1, -2**31, 2**31 - 1, -2],
    (True, "int32"): [1, 0, 2**31 - 1, -2**31, 2**31 - 1, -2],
    (True, "int64"): [1, 0, 2**63 - 1, -2**63, 30000000000, -2],
}


class ParquetFiles:
    """Tables written as parquet in a background thread, into a temporary
    directory that ``remove`` deletes: pyarrow's writer releases the GIL, so
    the writes overlap the phases that run meanwhile. ``path`` waits for
    one file."""

    def __init__(self):
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_scan_")
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._jobs = {}

    def write(self, name: str, table, groups: int, sort_by=None) -> None:
        import os

        path = os.path.join(self.dir, f"{name}.parquet")
        self._jobs[name] = self._pool.submit(self._write, path, table, groups, sort_by)

    @staticmethod
    def _write(path, table, groups, sort_by):
        import pyarrow.parquet as papq

        t0 = time.perf_counter()
        if sort_by is not None:
            table = table.sort_by(sort_by)
        papq.write_table(table, path, row_group_size=max(1, -(-table.num_rows // groups)))
        return path, time.perf_counter() - t0

    def adopt(self, name: str, path: str) -> None:
        """A file written elsewhere (its write's time is not known here)."""
        from concurrent.futures import Future

        job = Future()
        job.set_result((path, None))
        self._jobs[name] = job

    def path(self, name: str) -> str:
        return self._jobs[name].result()[0]

    def write_s(self) -> dict:
        return {k: round(j.result()[1], 2) for k, j in self._jobs.items()
                if j.done() and j.result()[1] is not None}

    def remove(self) -> None:
        import shutil

        self._pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(self.dir, ignore_errors=True)


def scan_q6_revenue_sum(lineitem, extra: bool):
    """Q6's filter and derived revenue, then a sum (and a count and a max
    when ``extra``): two aggregates over one Project/Filter prefix."""
    from daft_tpu_torch import col

    pre = (lineitem
           .where((col("l_shipdate") >= datetime.date(1994, 1, 1))
                  & (col("l_shipdate") < datetime.date(1995, 1, 1))
                  & (col("l_discount") >= 0.05)
                  & (col("l_discount") <= 0.07)
                  & (col("l_quantity") < 24))
           .with_column("rev", col("l_extendedprice") * col("l_discount")))
    aggs = [col("rev").sum().alias("revenue")]
    if extra:
        aggs += [col("rev").count().alias("n"), col("rev").max().alias("top")]
    return pre.agg(*aggs)


def q6_groups_missing_the_year(path: str) -> int:
    """The row groups whose l_shipdate range misses Q6's year, from
    pyarrow's own row-group statistics."""
    import pyarrow.parquet as papq

    pf = papq.ParquetFile(path)
    idx = pf.schema_arrow.get_field_index("l_shipdate")
    lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
    n = 0
    for rg in range(pf.metadata.num_row_groups):
        st = pf.metadata.row_group(rg).column(idx).statistics
        n += st.max < lo or st.min >= hi
    return n


def phase_scans(ph: Phases, files: ParquetFiles, data: dict, card_rows: dict, lineitem,
                queries, card: str) -> dict:
    """Phase 12: scans on the card, in the 32-bit mode, over parquet files
    written meanwhile (ParquetFiles): (a) the 22 queries over phase 4's SF1
    tables, each in 8 row groups, through read_parquet(...,
    _split_row_groups=True), each once with the sub-plan result cache off,
    against phase 4's rows of the same data in memory; (b) Q1 and Q6 over
    phase 3's SF1 lineitem sorted by l_shipdate in 16 row groups, as one
    scan task, composed (K1) and deep (K2), cold and twice warm, against
    the pyarrow oracle, with the columns read and, for Q6, the row groups
    pruned by their l_shipdate statistics (pyarrow's own count); (c) Q6's
    filter and derived revenue under two aggregates with resident segments
    off: the second is a sub-plan result-cache hit with the first's revenue
    and its K1 launches; (f) the float-to-int cast on the card in both
    modes. Then, outside the zero-failure checks: (d) scan.read armed
    first_n 2 (Q6 completes with 2 retries) and always (the reader's error
    after scan_retry_attempts); (e) a hash repartition of the lineitem scan
    under a memory budget that spills, with the first spill file damaged
    (spill.corrupt nth 1): the piece recomputes from the file
    (partitions_recomputed) and the rows are the undamaged run's. Each
    driven query counts K1's, K2's and the scatter kernel's launches from 0
    just before it."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch import col, faults
    from daft_tpu_torch.adapt import RESULT_CACHE
    from daft_tpu_torch.errors import DaftTransientError
    from daft_tpu_torch.io import IO_STATS
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.spill import MEMORY_LEDGER

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}

    def driven(build):
        """One driven query: (DataFrame, seconds, launches, IO_STATS)."""
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        IO_STATS.reset()
        t0 = time.perf_counter()
        df = build().collect()
        df.to_pydict()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k, v in launches.items():
            out[f"{k}_launches"] += v
        return df, secs, launches, IO_STATS.snapshot()

    # --- (a) the 22 queries over parquet
    t0 = time.perf_counter()
    paths = {n: files.path(n) for n in data}
    print(f"SF1 scan: files ready (waited {time.perf_counter() - t0:.1f}s; written in "
          f"{json.dumps(files.write_s())} s)", flush=True)
    dtt.set_execution_config(config(device_min_rows=8, subplan_result_cache=False))
    frames = {n: dtt.read_parquet(p, _split_row_groups=True) for n, p in paths.items()}
    walls = {}
    for qn in sorted(queries.QUERIES):
        df, secs, launches, io = driven(lambda qn=qn: queries.QUERIES[qn](frames))
        got = tpch22_rows(zip(*df.to_pydict().values()))
        c = df.stats.snapshot()["counters"]
        label = f"SF1 scan Q{qn}"
        ph.check(tpch22_match(got, card_rows[qn]),
                 f"{label}: {len(got)} rows over parquet match phase 4's rows in memory")
        walls[qn] = secs
        res = {"wall_s": secs, "scan_tasks": c.get("scan_tasks_emitted", 0),
               "scan_tasks_pruned": c.get("scan_tasks_pruned", 0), "launches": launches,
               "rows_read": io["rows_read"], "bytes_read": io["bytes_read"], "card": card}
        print(f"{label} " + json.dumps(res), flush=True)
        del df
    out["tpch22_wall_s"] = sum(walls.values())
    print("SF1 scan tpch22 summary " + json.dumps({
        "wall_total_s": out["tpch22_wall_s"],
        "slowest": sorted(walls, key=lambda q: -walls[q])[:5], "card": card}), flush=True)
    del frames

    # --- (b) Q1 and Q6 over lineitem sorted by l_shipdate, one scan task
    li_path = files.path("lineitem_by_shipdate")
    want = {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}
    pruned_want = q6_groups_missing_the_year(li_path)
    one_task = 1 << 40  # scan_tasks_min_size_bytes: the 16 row groups in one task
    for deep in (False, True):
        route = "deep" if deep else "composed"
        dtt.set_execution_config(config(use_deep_fusion_kernel=deep,
                                        scan_tasks_min_size_bytes=one_task))
        for name, query in (("q1", q1), ("q6", q6)):
            def build(query=query):
                return query(dtt.read_parquet(li_path, _split_row_groups=True))

            label = f"SF1 scan {name} {route}"
            df, cold, launches, io = driven(build)
            c = df.stats.snapshot()["counters"]
            ph.check(parity(df.to_pydict(), want[name], RTOL),
                     f"{label}: matches the pyarrow oracle at rtol {RTOL}")
            ph.check(c.get("scan_tasks_emitted", 0) == 1
                     and io["columns_read"] == SCAN_COLUMNS[name],
                     f"{label}: one scan task, {io['columns_read']} columns read (the query "
                     f"reads {SCAN_COLUMNS[name]})")
            if name == "q6":
                ph.check(io["row_groups_pruned"] == pruned_want > 0
                         and io["row_groups_read"] + io["row_groups_pruned"] == SCAN_LI_GROUPS,
                         f"{label}: {io['row_groups_pruned']} row groups pruned by their "
                         f"statistics, as pyarrow's metadata counts ({pruned_want}), "
                         f"{io['row_groups_read']} read")
            kernel = launches["k2"] if deep else launches["k1"]
            ph.check(kernel >= 1 and c.get("device_aggregations", 0) >= 1,
                     f"{label}: aggregated on the card through {'K2' if deep else 'K1'} "
                     f"({launches})")
            res = {"cold_s": cold, "launches": launches, "io": io,
                   **warm_median(lambda _f: build(), None, runs=SCAN_WARM), "card": card}
            out[f"{name}_{route}"] = res
            print(f"{label} " + json.dumps(res), flush=True)
            del df

    # --- (c) the sub-plan result cache: one prefix under two aggregates
    RESULT_CACHE.clear()
    dtt.set_execution_config(config(device_residency=False))
    runs = []
    for extra in (False, True):
        df, secs, launches, _ = driven(
            lambda extra=extra: scan_q6_revenue_sum(dtt.read_parquet(li_path), extra))
        c = df.stats.snapshot()["counters"]
        runs.append((df.to_pydict(), c, launches, secs))
    (r1, c1, l1, s1), (r2, c2, l2, s2) = runs
    ph.check(c1.get("subplan_cache_misses", 0) == 1 and c2.get("subplan_cache_hits", 0) == 1
             and r2["revenue"] == r1["revenue"]
             and parity({"revenue": r1["revenue"]}, want["q6"], RTOL),
             f"SF1 scan subplan cache: the second aggregate hit the prefix (misses "
             f"{c1.get('subplan_cache_misses', 0)}, hits {c2.get('subplan_cache_hits', 0)}), "
             f"revenue {r2['revenue']} as the first's and the oracle's")
    ph.check(l1["k1"] >= 1 and l2["k1"] == l1["k1"],
             f"SF1 scan subplan cache: K1 launches {l1['k1']} then {l2['k1']}")
    out["subplan_cache"] = {"miss_s": s1, "hit_s": s2, "launches": [l1, l2],
                            "cached_bytes": MEMORY_LEDGER.subplan_cache_bytes, "card": card}
    print("SF1 scan subplan cache " + json.dumps(out["subplan_cache"]), flush=True)
    RESULT_CACHE.clear()

    # --- (f) the repaired float-to-int cast on the card
    for x64 in (False, True):
        dtt.set_execution_config(config(device_min_rows=8, device_x64=x64))
        for tgt in ("int32", "int64"):
            df = dtt.from_pydict({"v": CAST_INPUT * 4}).select(
                col("v").cast(getattr(dtt.DataType, tgt)())).collect()
            got = df.to_pydict()["v"][:6]
            c = df.stats.snapshot()["counters"]
            want_cast = CAST_WANT[(x64, tgt)]
            ph.check(got == want_cast and c.get("device_projections", 0) == 1,
                     f"SF1 scan cast to {tgt} ({'x64' if x64 else '32-bit'} mode): {got} on "
                     f"the card (device_projections {c.get('device_projections', 0)}), the "
                     f"reference's {want_cast}")

    # --- outside the zero-failure checks: the fault sites
    ph.begin(None)
    # (d) scan.read
    dtt.set_execution_config(config(scan_tasks_min_size_bytes=one_task,
                                    scan_retry_backoff_s=0.0))

    def q6_file():
        return q6(dtt.read_parquet(li_path, _split_row_groups=True))

    try:
        faults.arm("scan.read", "first_n", n=2)
        df, secs, launches, io = driven(q6_file)
        ph.check(io["retries"] == 2 and parity(df.to_pydict(), want["q6"], RTOL),
                 f"SF1 scan scan.read first_n 2: Q6 completes after {io['retries']} retries "
                 f"with the oracle's rows ({secs:.2f}s)")
        faults.arm("scan.read", "always")
        IO_STATS.reset()
        try:
            q6_file().collect()
            raised = None
        except DaftTransientError as e:
            raised = e
        cfg = dtt.get_context().execution_config
        attempts, runs = cfg.scan_retry_attempts, cfg.task_retry_attempts + 1
        # the partition's task runs `runs` times (the scheduler's retries, each
        # counted as a retry too), each read `attempts` times
        want_retries = attempts * runs + (runs if runs > 1 else 0)
        ph.check(raised is not None and IO_STATS.retries == want_retries,
                 f"SF1 scan scan.read always: the reader's error reaches the caller "
                 f"({type(raised).__name__}) after {IO_STATS.retries} retries counted "
                 f"({runs} runs of the task, scan_retry_attempts {attempts})")
    finally:
        faults.disarm()

    # (e) a spilled shuffle piece over the scan recomputes from its file
    dirs0 = spill_dirs()

    def repartitioned():
        # no select: a Project over the scan would load each partition before
        # the shuffle, whose pieces then have no file to recompute from (the
        # aggregate's columns reach the scan as its column pushdown)
        return (dtt.read_parquet(li_path, _split_row_groups=True)
                .repartition(4, "l_returnflag")
                .groupby("l_returnflag")
                .agg(col("l_quantity").sum().alias("q"), col("l_extendedprice").sum().alias("p"),
                     col("l_quantity").count().alias("n"))
                .sort("l_returnflag"))

    dtt.set_execution_config(config(memory_budget_bytes=32 << 20, async_spill_writes=False))
    clean, secs_clean, _, _ = driven(repartitioned)
    try:
        faults.arm("spill.corrupt", "nth", n=1)
        damaged, secs_damaged, _, _ = driven(repartitioned)
    finally:
        faults.disarm()
    c = damaged.stats.snapshot()["counters"]
    ph.check(c.get("spilled_partitions", 0) > 0 and c.get("partitions_recomputed", 0) >= 1
             and c.get("lineage_truncated", 0) == 0
             and damaged.to_pydict() == clean.to_pydict(),
             f"SF1 scan lineage: a damaged spill file of the repartition recomputed from the "
             f"parquet file (spilled_partitions {c.get('spilled_partitions', 0)}, "
             f"partitions_recomputed {c.get('partitions_recomputed', 0)}, corruption_detected "
             f"{c.get('corruption_detected', 0)}), the undamaged run's rows")
    ph.check(MEMORY_LEDGER.current == 0 and spill_dirs() == dirs0,
             "SF1 scan lineage: the ledger back at 0, no spill directory left")
    out["lineage"] = {"clean_s": secs_clean, "damaged_s": secs_damaged, "card": card,
                      "counters": {k: c.get(k, 0) for k in (
                          "spilled_partitions", "partitions_recomputed",
                          "corruption_detected", "spill_write_bytes")}}
    print("SF1 scan lineage " + json.dumps(out["lineage"]), flush=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 13: the scan's readahead and the write path
# ---------------------------------------------------------------------------

WRITE_PARTS = 8  # phase 13 writes SF1 lineitem as this many parquet files
PREFETCH_DEPTHS = (0, 2)


def phase_prefetch_write(ph: Phases, lineitem, card: str) -> dict:
    """Phase 13: the scan's readahead and the write path on the card, in the
    32-bit mode: (a) phase 3's SF1 lineitem written by the port's own
    write_parquet over into_partitions(8), 8 files in a temporary directory
    that the phase removes; (b) Q1 composed (K1), Q1 deep (K2) and Q6 over
    those files, one scan task a file (scan_tasks_min_size_bytes 1), each
    at scan_prefetch_depth 0 and 2, cold and then warm once, against the
    pyarrow oracle at rtol 1e-6, with equal rows and launches at both
    depths, the readahead engaged at depth 2 (prefetch_submitted, hits and
    misses) and the ledger's prefetch_inflight and current at 0 after each
    query; (c) Q1's result written hive-partitioned by l_returnflag and read
    back equal. Then, outside the zero-failure checks: (d) prefetch.fetch
    armed first_n 1, whose error reaches the caller. Each driven query
    counts K1's, K2's and the scatter kernel's launches from 0 just before
    it."""
    import gc
    import os
    import shutil
    import tempfile

    import pyarrow.parquet as papq
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch import faults
    from daft_tpu_torch.errors import DaftTransientError
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.spill import MEMORY_LEDGER

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}

    def count_launches() -> dict:
        """The launches since the counts were last set to 0, added to the
        phase's; the counts start again from 0."""
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k, v in launches.items():
            out[f"{k}_launches"] += v
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        return launches

    root = tempfile.mkdtemp(prefix="chip_smoke_write_")
    try:
        # --- (a) the write
        dtt.set_execution_config(config())
        t0 = time.perf_counter()
        manifest = dtt.from_arrow(lineitem).into_partitions(WRITE_PARTS).write_parquet(
            os.path.join(root, "lineitem"))
        write_s = time.perf_counter() - t0
        paths = manifest.to_pydict()["path"]
        nrows = sum(papq.ParquetFile(p).metadata.num_rows for p in paths)
        nbytes = sum(os.path.getsize(p) for p in paths)
        ph.check(len(paths) == WRITE_PARTS and nrows == lineitem.num_rows,
                 f"SF1 write: write_parquet over into_partitions({WRITE_PARTS}) wrote "
                 f"{len(paths)} files of {nrows} rows in all ({nbytes} bytes, {write_s:.2f}s)")
        out["write"] = {"write_s": write_s, "files": len(paths), "bytes": nbytes, "card": card}
        print("SF1 write " + json.dumps(out["write"]), flush=True)

        # --- (b) Q1 composed, Q1 deep and Q6 over the files at depths 0 and 2
        want = {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}
        summary = {}
        for name, query, deep in (("q1", q1, False), ("q1", q1, True), ("q6", q6, False)):
            route = "deep" if deep else "composed"
            kernel = "k2" if deep else "k1"
            runs = {}
            for depth in PREFETCH_DEPTHS:
                dtt.set_execution_config(config(use_deep_fusion_kernel=deep,
                                                scan_tasks_min_size_bytes=1,
                                                scan_prefetch_depth=depth))
                label = f"SF1 prefetch {name} {route} depth {depth}"
                walls, seen = [], []
                for rep in ("cold", "warm"):
                    ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
                    t0 = time.perf_counter()
                    df = query(dtt.read_parquet(paths)).collect()
                    rows = df.to_pydict()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    launches = count_launches()
                    c = df.stats.snapshot()["counters"]
                    seen.append((rows, launches, c))
                    ph.check(parity(rows, want[name], RTOL),
                             f"{label} {rep}: matches the pyarrow oracle at rtol {RTOL}")
                    ph.check(c.get("scan_tasks_emitted", 0) == WRITE_PARTS
                             and launches[kernel] >= 1 and c.get("device_aggregations", 0) >= 1,
                             f"{label} {rep}: {c.get('scan_tasks_emitted', 0)} scan tasks, "
                             f"aggregated on the card through {kernel.upper()} ({launches})")
                    ph.check(MEMORY_LEDGER.prefetch_inflight == 0 and MEMORY_LEDGER.current == 0,
                             f"{label} {rep}: the ledger's prefetch_inflight "
                             f"{MEMORY_LEDGER.prefetch_inflight} and current "
                             f"{MEMORY_LEDGER.current} after the query")
                    del df
                (rows0, l0, c0), (rows1, l1, _) = seen
                ph.check(rows1 == rows0 and l1 == l0,
                         f"{label}: the warm run's rows and launches are the cold run's")
                if depth:
                    ph.check(c0.get("prefetch_submitted", 0) > 0
                             and c0.get("prefetch_hits", 0) + c0.get("prefetch_misses", 0) > 0,
                             f"{label}: the readahead engaged (prefetch_submitted "
                             f"{c0.get('prefetch_submitted', 0)}, hits "
                             f"{c0.get('prefetch_hits', 0)}, misses "
                             f"{c0.get('prefetch_misses', 0)})")
                res = {"cold_s": walls[0], "warm_s": walls[1], "launches": l0,
                       "io_wait_ms": c0.get("io_wait_ns", 0) / 1e6,
                       "prefetch_read_ms": c0.get("prefetch_read_ns", 0) / 1e6,
                       **{k: c0.get(k, 0) for k in ("prefetch_submitted", "prefetch_hits",
                                                    "prefetch_misses", "prefetch_throttled")},
                       "card": card}
                print(f"{label} " + json.dumps(res), flush=True)
                runs[depth] = (rows0, l0, res)
            (r0, l0, res0), (r2, l2, res2) = runs[0], runs[2]
            ph.check(r2 == r0 and l2 == l0,
                     f"SF1 prefetch {name} {route}: equal rows and launches ({l0}) at depths 0 "
                     f"and 2")
            summary[f"{name}_{route}"] = {f"depth{d}": {"cold_s": runs[d][2]["cold_s"],
                                                        "warm_s": runs[d][2]["warm_s"]}
                                          for d in PREFETCH_DEPTHS}
        out["prefetch"] = summary
        print("SF1 prefetch summary " + json.dumps({**summary, "card": card}), flush=True)

        # --- (c) Q1's result written hive-partitioned, read back
        dtt.set_execution_config(config(scan_tasks_min_size_bytes=1))
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        q1_rows = q1(dtt.read_parquet(paths)).to_pydict()
        q1_launches = count_launches()
        t0 = time.perf_counter()
        m = q1(dtt.read_parquet(paths)).write_parquet(
            os.path.join(root, "q1"), partition_cols=["l_returnflag"]).to_pydict()
        hive_s = time.perf_counter() - t0
        write_launches = count_launches()
        ph.check(write_launches == q1_launches and write_launches["k1"] >= 1,
                 f"SF1 write Q1 by l_returnflag: the written query launched as Q1 did "
                 f"({write_launches})")
        back = []
        for path, flag in zip(m["path"], m["l_returnflag"]):
            d = dtt.read_parquet(path).to_pydict()
            d["l_returnflag"] = [flag] * len(next(iter(d.values())))
            back += [{k: d[k][i] for k in q1_rows} for i in range(len(d["l_returnflag"]))]
        key = (lambda r: (r["l_returnflag"], r["l_linestatus"]))
        want_rows = sorted(dtt.from_pydict(q1_rows).to_pylist(), key=key)
        dirs = sorted({os.path.basename(os.path.dirname(p)) for p in m["path"]})
        ph.check(sorted(back, key=key) == want_rows
                 and dirs == sorted(f"l_returnflag={f}" for f in set(q1_rows["l_returnflag"])),
                 f"SF1 write Q1 by l_returnflag: {len(m['path'])} files in {dirs}, read back "
                 f"equal to the {len(want_rows)} rows written ({hive_s:.2f}s)")
        out["hive_write_s"] = hive_s

        # --- (d) outside the zero-failure checks: prefetch.fetch
        ph.begin(None)
        dtt.set_execution_config(config(scan_tasks_min_size_bytes=1, scan_prefetch_depth=2))
        raised = None
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        try:
            faults.arm("prefetch.fetch", "first_n", n=1)
            try:
                q6(dtt.read_parquet(paths)).collect()
            except DaftTransientError as e:
                # the name only: the error's traceback holds the query's
                # partitions, and with them their fetches' charges
                raised = type(e).__name__
            injected = faults.snapshot()["injected"].get("prefetch.fetch", 0)
        finally:
            faults.disarm()
        count_launches()
        gc.collect()  # what the failed query left (its partitions) before the ledger is read
        ph.check(raised is not None and injected == 1,
                 f"SF1 prefetch prefetch.fetch first_n 1: the fetch's error reaches the caller "
                 f"({raised}, {injected} injected)")
        ph.check(MEMORY_LEDGER.prefetch_inflight == 0 and MEMORY_LEDGER.current == 0,
                 f"SF1 prefetch prefetch.fetch first_n 1: the ledger's prefetch_inflight "
                 f"{MEMORY_LEDGER.prefetch_inflight} and current {MEMORY_LEDGER.current} after "
                 f"the failed query")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: the rest of the columnar core
# ---------------------------------------------------------------------------

COLUMNAR_PARTS = 4         # phase 14 (a) and (d) cut lineitem into this many partitions
COLUMNAR_ROWS = 200_000    # (d) runs over the first rows of SF1 lineitem
RTOL_STDDEV = 1e-5         # tests/test_pallas.py's tolerance, for a float32-summed stddev
STDDEV_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "disc_price")
Q1_GROUPS = ["l_returnflag", "l_linestatus"]


def q1_stddev(lineitem):
    """Q1's filter and groups with the sum, mean and population stddev of
    l_quantity, l_extendedprice, l_discount and the discounted price. Over
    several partitions each stddev splits into the sums of x and x * x and
    the count (stage 1 on the card), shared with the sum and the mean."""
    from daft_tpu_torch import col

    vals = {"l_quantity": col("l_quantity"), "l_extendedprice": col("l_extendedprice"),
            "l_discount": col("l_discount"),
            "disc_price": col("l_extendedprice") * (1 - col("l_discount"))}
    aggs = []
    for name, e in vals.items():
        aggs += [e.sum().alias(f"sum_{name}"), e.mean().alias(f"avg_{name}"),
                 e.stddev().alias(f"sd_{name}")]
    return (lineitem.where(col("l_shipdate") <= datetime.date(1998, 9, 2))
            .groupby(*Q1_GROUPS).agg(*aggs).sort(Q1_GROUPS))


def oracle_q1_stddev(lineitem) -> dict:
    """q1_stddev by pyarrow in float64 (stddev with ddof 0), one thread."""
    import pyarrow as pa
    import pyarrow.compute as pc

    t = lineitem.filter(pc.less_equal(lineitem["l_shipdate"],
                                      pa.scalar(datetime.date(1998, 9, 2))))
    t = t.append_column("disc_price", pc.multiply(
        t["l_extendedprice"], pc.subtract(pa.scalar(1.0), t["l_discount"])))
    specs = []
    for c in STDDEV_COLUMNS:
        specs += [(c, "sum"), (c, "mean"), (c, "stddev", pc.VarianceOptions(ddof=0))]
    g = t.group_by(Q1_GROUPS, use_threads=False).aggregate(specs)
    g = g.sort_by([(k, "ascending") for k in Q1_GROUPS])
    out = {k: g[k].to_pylist() for k in Q1_GROUPS}
    for c in STDDEV_COLUMNS:
        out[f"sum_{c}"] = g[f"{c}_sum"].to_pylist()
        out[f"avg_{c}"] = g[f"{c}_mean"].to_pylist()
        out[f"sd_{c}"] = g[f"{c}_stddev"].to_pylist()
    return out


def revenue_by(lineitem, key):
    """The discounted revenue and the line count of each ``key`` group."""
    from daft_tpu_torch import col

    return (lineitem.groupby(key.alias("g"))
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue"),
                 col("l_quantity").count().alias("n"))
            .sort("g"))


def oracle_revenue_by(lineitem, keys) -> dict:
    """revenue_by by pyarrow in float64 over the key column ``keys``."""
    import pyarrow as pa
    import pyarrow.compute as pc

    t = pa.table({"g": keys, "r": pc.multiply(lineitem["l_extendedprice"], pc.subtract(
        pa.scalar(1.0), lineitem["l_discount"])), "q": lineitem["l_quantity"]})
    g = t.group_by("g", use_threads=False).aggregate([("r", "sum"), ("q", "count")])
    g = g.sort_by("g")
    return {"g": g["g"].to_pylist(), "revenue": g["r_sum"].to_pylist(),
            "n": g["q_count"].to_pylist()}


def order_dependent(lineitem):
    """The order-dependent and whole-group kinds by Q1's groups:
    agg_list, agg_concat (of each row's flag as a one-element list),
    any_value and skew. None of them has a device reduction."""
    from daft_tpu_torch import col

    return (lineitem.groupby(*Q1_GROUPS).agg(
        col("l_quantity").agg_list().alias("quantities"),
        col("l_returnflag").str.split(",").agg_concat().alias("flags"),
        col("l_extendedprice").any_value().alias("first_price"),
        col("l_extendedprice").skew().alias("skew_price"))
        .sort(Q1_GROUPS))


def oracle_order_dependent(lineitem) -> dict:
    """order_dependent by pyarrow (lists and first values in row order, one
    thread) and numpy (skew's population moments in float64). In the 32-bit
    mode the projection under the exchange runs on the card, which hands
    l_extendedprice back rounded to float32 (as in the reference), so the
    oracle rounds it the same way first."""
    import numpy as np
    import pyarrow as pa

    price = lineitem["l_extendedprice"].cast(pa.float32()).cast(pa.float64())
    lineitem = lineitem.set_column(lineitem.schema.get_field_index("l_extendedprice"),
                                   "l_extendedprice", price)
    g = lineitem.group_by(Q1_GROUPS, use_threads=False).aggregate(
        [("l_quantity", "list"), ("l_returnflag", "list"), ("l_extendedprice", "first"),
         ("l_extendedprice", "list")])
    g = g.sort_by([(k, "ascending") for k in Q1_GROUPS])
    skews = []
    for prices in g["l_extendedprice_list"].to_pylist():
        v = np.asarray(prices, dtype=np.float64)
        sd = v.std()
        skews.append(0.0 if sd == 0 else float(((v - v.mean()) ** 3).mean() / sd ** 3))
    return {**{k: g[k].to_pylist() for k in Q1_GROUPS},
            "quantities": g["l_quantity_list"].to_pylist(),
            "flags": g["l_returnflag_list"].to_pylist(),
            "first_price": g["l_extendedprice_first"].to_pylist(), "skew_price": skews}


def max_rel_gaps(got: dict, want: dict, columns) -> dict:
    """The largest relative gap of each float column against its oracle."""
    return {c: max(abs(a - b) / abs(b) if b else abs(a - b) for a, b in zip(got[c], want[c]))
            for c in columns}


def phase_columnar(ph: Phases, lineitem, card: str) -> dict:
    """Phase 14: the rest of the columnar core on the card, in the 32-bit
    mode, over phase 3's SF1 lineitem (generate_lineitem_only(1.0, seed=42)):
    (a) q1_stddev over into_partitions(4), composed (stage 1 through K1, 4
    launches a run) and deep (K2, 4 launches, ``child * child`` in the
    kernel), against the float64 pyarrow oracle (sums and means at rtol
    1e-6, stddevs at 1e-5, each column's largest gap printed), and over one
    partition, where a stddev keeps the whole aggregate on the host (0
    launches); (b) revenue by l_shipdate.dt.truncate("1 month") and by
    partitioning.months() over one partition (the keys on the host, the
    sums through K1); (c) sums by l_extendedprice.hash() % 64 against
    pyarrow grouping the port's host hash column; (d) order_dependent over
    the first 200,000 rows in 4 partitions, on the host (no device
    reduction for any of its kinds), against pyarrow and numpy. One cold
    run each; each counts K1's, K2's and the scatter kernel's launches from
    0 just before it."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch import col
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}

    def run(label: str, build, frame, **knobs):
        """One cold run of ``build(frame)``: (rows, launches, counters, wall)."""
        dtt.set_execution_config(config(**knobs))
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        df = build(frame).collect()
        rows = df.to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k, v in launches.items():
            out[f"{k}_launches"] += v
        c = df.stats.snapshot()["counters"]
        out[label] = {"wall_s": wall, "launches": launches,
                      **{k: c.get(k, 0) for k in ("device_aggregations", "host_aggregations",
                                                  "device_group_codes", "shuffles")}}
        print(f"SF1 columnar {label} " + json.dumps(out[label]), flush=True)
        return rows, launches, c

    t_phase = time.perf_counter()
    # --- (a) stddev beside sum and mean, over 4 partitions and over one
    four = dtt.from_arrow(lineitem).into_partitions(COLUMNAR_PARTS).collect()
    one = dtt.from_arrow(lineitem).collect()
    want = oracle_q1_stddev(lineitem)
    sd_cols = [f"sd_{c}" for c in STDDEV_COLUMNS]
    other_cols = [k for k in want if k.startswith(("sum_", "avg_"))]
    for label, frame, deep in (("stddev 4 partitions composed", four, False),
                               ("stddev 4 partitions deep", four, True),
                               ("stddev 1 partition", one, False)):
        rows, launches, c = run(label, q1_stddev, frame, use_deep_fusion_kernel=deep)
        gaps = max_rel_gaps(rows, want, sd_cols + other_cols) if set(rows) == set(want) else {}
        out[label]["stddev_gaps"] = {k: gaps.get(k) for k in sd_cols}
        ph.check(bool(gaps) and rows["l_returnflag"] == want["l_returnflag"]
                 and rows["l_linestatus"] == want["l_linestatus"]
                 and all(gaps[k] <= RTOL_STDDEV for k in sd_cols)
                 and parity({k: rows[k] for k in other_cols},
                            {k: want[k] for k in other_cols}, RTOL),
                 f"SF1 columnar {label}: sums and means at rtol {RTOL}, stddevs at "
                 f"{RTOL_STDDEV} of the float64 pyarrow oracle (largest stddev gaps "
                 f"{json.dumps(out[label]['stddev_gaps'])})")
        if frame is one:
            ok = (launches == {"k1": 0, "k2": 0, "scatter": 0}
                  and c.get("device_aggregations", 0) == 0 and c.get("host_aggregations", 0) == 1)
            what = "the whole aggregate on the host (0 launches, host_aggregations 1)"
        else:
            kernel = "k2" if deep else "k1"
            ok = (launches[kernel] == COLUMNAR_PARTS
                  and launches["k1" if deep else "k2"] == 0
                  and c.get("device_aggregations", 0) == COLUMNAR_PARTS
                  and c.get("shuffles", 0) == 2)
            what = (f"stage 1 on the card through {kernel.upper()}, {COLUMNAR_PARTS} launches "
                    f"and device_aggregations, two shuffles (the partials', the sort's)")
        ph.check(ok, f"SF1 columnar {label}: {what} ({launches}, device_aggregations "
                     f"{c.get('device_aggregations', 0)}, host_aggregations "
                     f"{c.get('host_aggregations', 0)})")
    del four

    # --- (b) the month of each ship date as a group key, two ways
    ship = lineitem["l_shipdate"]
    months = pc.floor_temporal(ship, multiple=1, unit="month")
    epoch_months = pc.add(pc.multiply(pc.subtract(pc.year(ship), 1970), 12),
                          pc.subtract(pc.month(ship).cast(pa.int32()), 1)).cast(pa.int32())
    # --- (c) and a hash bucket, against the port's own host hash column
    hashes = dtt.Series.from_arrow(lineitem["l_extendedprice"]).hash().to_arrow()
    buckets = pc.bit_wise_and(hashes, pa.scalar(63, pa.uint64()))
    for label, key, keys in (
            ("revenue by dt.truncate month", col("l_shipdate").dt.truncate("1 month"), months),
            ("revenue by partitioning.months", col("l_shipdate").partitioning.months(),
             epoch_months),
            ("revenue by hash % 64", col("l_extendedprice").hash() % 64, buckets)):
        rows, launches, c = run(label, lambda f, key=key: revenue_by(f, key), one)
        want = oracle_revenue_by(lineitem, keys)
        ph.check(rows["g"] == want["g"] and rows["n"] == want["n"]
                 and parity({"revenue": rows["revenue"]}, {"revenue": want["revenue"]}, RTOL),
                 f"SF1 columnar {label}: {len(rows['g'])} groups equal to pyarrow's (revenue at "
                 f"rtol {RTOL})")
        ph.check(launches["k1"] == 1 and c.get("device_aggregations", 0) == 1
                 and c.get("device_group_codes", 0) == 0,
                 f"SF1 columnar {label}: the key on the host (device_group_codes 0, as in the "
                 f"reference), the sums on the card through K1 ({launches})")
    del one

    # --- (d) the order-dependent kinds and skew, on the host
    head = lineitem.slice(0, COLUMNAR_ROWS)
    step = -(-COLUMNAR_ROWS // COLUMNAR_PARTS)
    parts = dtt.from_arrow([head.slice(i * step, step) for i in range(COLUMNAR_PARTS)]).collect()
    rows, launches, c = run("list concat any_value skew", order_dependent, parts)
    want = oracle_order_dependent(head)
    same = all(rows[k] == want[k] for k in want if k != "skew_price")
    skew_gap = max_rel_gaps(rows, want, ["skew_price"])["skew_price"] if same else None
    out["list concat any_value skew"]["skew_gap"] = skew_gap
    ph.check(same and skew_gap <= RTOL_X64,
             f"SF1 columnar list concat any_value skew: {COLUMNAR_ROWS} rows in "
             f"{COLUMNAR_PARTS} partitions, lists and first values equal to pyarrow's in row "
             f"order, skew within {RTOL_X64} of numpy's over the float32-rounded prices "
             f"(gap {skew_gap})")
    ph.check(launches == {"k1": 0, "k2": 0, "scatter": 0}
             and c.get("device_aggregations", 0) == 0 and c.get("host_aggregations", 0) >= 1,
             f"SF1 columnar list concat any_value skew: on the host, as in the reference "
             f"({launches}, host_aggregations {c.get('host_aggregations', 0)})")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 columnar phase 14 wall {out['wall_s']:.1f}s ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: the SQL front end and python UDFs
# ---------------------------------------------------------------------------

# the texts of benchmarks/tpch_queries.SQL that the SQL front end plans (the
# other 14 are tests/test_sql_tpch_parse.py's strict xfails)
SQL_PLANNING = (1, 3, 5, 6, 10, 12, 14, 19)
# the texts over one table; the others join their tables with a comma list,
# which the front end (the reference's, copied) plans as cross joins under
# the WHERE filter: at SF0.005 Q3 alone would make 750 x 7500 x 30000 rows,
# so those texts run over SQL_TOY_ROWS rows of their key table instead
SQL_SINGLE_TABLE = (1, 6)
# comma-join text -> (the key it draws by, rows that satisfy the text drawn,
# rows that do not): as many rows that satisfy the text as the cross
# products allow, under about 75,000 rows (Q5 takes its two orders that
# match and no other: with a third its product is 162,000 rows; Q19 has no
# matching row at SF0.005, so all 100 of its draws miss)
SQL_TOY_ROWS = {3: ("order", 16, 8), 5: ("order", 2, 0), 10: ("order", 6, 3),
                12: ("order", 80, 40), 14: ("line", 120, 60), 19: ("line", 100, 100)}


def sql_toy_catalogs(data: dict, texts: dict, seed: int = 7) -> dict:
    """Each comma-join text's tables (SQL_TOY_ROWS) cut to a few joined rows
    of ``data``: the orders (or lineitems) that satisfy the text (of
    ``texts``, by query number) in its FROM and WHERE, found by SQLite, and as many drawn from the rest (numpy seed
    ``seed``), with every lineitem of the chosen orders and the customers,
    suppliers and parts they reference; nation and region whole. Both
    packages and the oracle run over the same rows. Returns {text: {table:
    pyarrow table}}."""
    import re

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from benchmarks import tpch_full

    li = data["lineitem"]
    conn = tpch_full.load_sqlite(data)
    out = {}
    try:
        for col, tbl in (("o_orderkey", "orders"), ("c_custkey", "customer"),
                         ("s_suppkey", "supplier"), ("p_partkey", "part")):
            conn.execute(f"CREATE INDEX {col}_idx ON {tbl} ({col})")
        for qn, (kind, n_hit, n_miss) in SQL_TOY_ROWS.items():
            text = texts[qn]
            body = re.search(r"\bFROM\b(.*?)(?:\bGROUP BY\b|\bORDER BY\b|$)", text,
                             re.S).group(1)
            tables, cond = body.split("WHERE", 1)
            names = [t.strip().split()[0] for t in tables.split(",")]
            key = "o_orderkey" if kind == "order" else "l_orderkey * 8 + l_linenumber"
            # a conjunct the text already implies, so that SQLite joins part by key
            extra = " AND l_partkey = p_partkey" if kind == "line" else ""
            hits = sorted(r[0] for r in conn.execute(
                f"SELECT DISTINCT {key} FROM {tables} WHERE ({cond}){extra}"))
            rng = np.random.default_rng(seed)
            if kind == "order":
                every = data["orders"].column("o_orderkey").to_numpy()
            else:
                every = li.column("l_orderkey").to_numpy() * 8 + li.column("l_linenumber").to_numpy()
            rest = np.setdiff1d(every, np.asarray(hits, dtype=every.dtype))
            chosen = pa.array(np.concatenate([
                np.asarray(hits[:n_hit], dtype=every.dtype),
                rng.choice(rest, size=min(n_miss, len(rest)), replace=False)]))
            if kind == "order":
                orders = data["orders"].filter(pc.is_in(data["orders"].column("o_orderkey"),
                                                        chosen))
                lines = li.filter(pc.is_in(li.column("l_orderkey"), orders.column("o_orderkey")))
            else:
                lines = li.filter(pc.is_in(pc.add(pc.multiply(li.column("l_orderkey"), 8),
                                                  li.column("l_linenumber")), chosen))
                orders = data["orders"].filter(pc.is_in(data["orders"].column("o_orderkey"),
                                                        lines.column("l_orderkey")))
            cut = {"lineitem": lines, "orders": orders,
                   "customer": data["customer"].filter(pc.is_in(
                       data["customer"].column("c_custkey"), orders.column("o_custkey"))),
                   "supplier": data["supplier"].filter(pc.is_in(
                       data["supplier"].column("s_suppkey"), lines.column("l_suppkey"))),
                   "part": data["part"].filter(pc.is_in(
                       data["part"].column("p_partkey"), lines.column("l_partkey"))),
                   "nation": data["nation"], "region": data["region"]}
            out[qn] = {n: cut[n] for n in names}
    finally:
        conn.close()
    return out


# the SQL texts' routing at SF0.005 in 3 partitions (device_min_rows=8;
# Q1 and Q6 over the whole tables, the others over sql_toy_catalogs):
# (device_aggregations, host_aggregations) as tests/test_torch_sql.py pins
# them, equal to the reference's there
SQL_ROUTES_3P = {1: (4, 2), 3: (4, 2), 5: (2, 4), 6: (3, 1), 10: (3, 3), 12: (3, 3),
                 14: (3, 1), 19: (3, 1)}
SQL_WARM = 1        # warm runs of each SQL text, after its cold one
UDF_PARTS = (1, 4)  # phase 15 (b) runs over SF1 lineitem in 1 and in 4 partitions
# (b)'s launches of K1 and K2 a run, composed and deep, at device_min_rows=8:
# tests/test_torch_udf.py holds the port's entries to these and its counters
# to the reference's (stage 1 on each partition, stage 2 over the 4 buckets)
UDF_Q1_ROUTES = {(1, False): {"k1": 1, "k2": 0}, (1, True): {"k1": 0, "k2": 1},
                 (4, False): {"k1": 6, "k2": 0}, (4, True): {"k1": 0, "k2": 6}}
K13_MAX_ROWS = 1 << 20  # (c)'s batch budget: each 1,500,000-row partition flushes alone
K13_PARTS = 4
K13_WEIGHT_BYTES = 1 << 20


def q1_udf(pkg, lineitem, calls: list):
    """TPC-H Q1 with disc_price computed by a row-local numpy UDF of ``pkg``
    (each call's row count appended to ``calls``) in the map chain before
    the aggregate."""
    import numpy as np

    col = pkg.col

    @pkg.udf(return_dtype=pkg.DataType.float64())
    def disc_price(price, discount):
        calls.append(len(price))
        return np.asarray(price.to_numpy()) * (1.0 - np.asarray(discount.to_numpy()))

    return (
        lineitem
        .with_column("disc_price", disc_price(col("l_extendedprice"), col("l_discount")))
        .with_column("charge", col("disc_price") * (1 + col("l_tax")))
        .where(col("l_shipdate") <= datetime.date(1998, 9, 2))
        .groupby("l_returnflag", "l_linestatus")
        .agg(
            col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            col("disc_price").sum().alias("sum_disc_price"),
            col("charge").sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order"),
        )
        .sort(["l_returnflag", "l_linestatus"])
    )


class PriceScorer:
    """tests/test_batch.py's scorer as a pinned model: ``__call__`` on the
    host in float64, ``apply_torch`` (K13) on the card."""

    weight_bytes = K13_WEIGHT_BYTES

    def __call__(self, v):
        import numpy as np

        return np.asarray(v.to_numpy(), dtype=np.float64) * 2.0 - 3.0

    @staticmethod
    def apply_torch(v):
        return v * 2.0 - 3.0


def sql_udf_runner(out: dict):
    """``run(build, warm_runs=SQL_WARM, fetch="to_pydict", **knobs)``: one
    cold run and ``warm_runs`` warm runs of ``build()`` under
    ``config(**knobs)``, K1's, K2's and the scatter kernel's launches
    counted from 0 just before the cold run and added to ``out``'s
    ``*_launches``; returns (the cold run's rows by ``fetch``, its counters
    and launches, cold s, warm s)."""
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    def run(build, warm_runs: int = SQL_WARM, fetch: str = "to_pydict", **knobs):
        dtt.set_execution_config(config(**knobs))
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        df = build().collect()
        rows = getattr(df, fetch)()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        warm = []
        for _ in range(warm_runs):
            t0 = time.perf_counter()
            getattr(build().collect(), fetch)()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        out["k1_launches"] += ss.LAUNCHES
        out["k2_launches"] += fes.LAUNCHES
        out["scatter_launches"] += scs.LAUNCHES
        return rows, df.stats.snapshot()["counters"], launches, cold, warm

    return run


def phase_sql_udf(ph: Phases, lineitem, texts: dict, card: str) -> dict:
    """Phase 15 (but its SF1 SQL leg, phase_sql_sf1): the SQL front end and
    python UDFs on the card, in the 32-bit mode. It reads phase 3's SF1
    lineitem and its own SF0.005 tables, so it runs while the 22-query
    tables are generated.
    (a) The 8 TPC-H texts that plan (``texts``: tpch22_module's SQL, by
    query number), through daft_tpu_torch.sql, cold and
    warm, at SF0.005 in 3 partitions against SQLite over the same tables
    (Q1 and Q6 over the whole tables, the six comma-join texts over
    sql_toy_catalogs, since the front end plans a comma list as cross
    joins), routed as SQL_ROUTES_3P.
    (b) q1_udf over ``lineitem`` (SF1, seed 42) in 1 and 4 partitions,
    composed and deep: the UDF pinned in one host-run fused chain, one call
    a partition, the sums through K1 or K2 as UDF_Q1_ROUTES, the rows
    against pyarrow's Q1 at RTOL.
    (c) K13: PriceScorer with device=True over l_extendedprice in 4
    partitions: every batch applied on the card, the output bit for bit
    apply_torch over the float32 CPU tensors and within RTOL of the host
    instance, the ledger settled, model_cache_bytes pinned and released.
    (d) Admission of num_gpus=1, refusal of num_gpus=2.
    (e) The batch.coalesce and actor.load fault sites (outside the health
    window: they inject faults)."""
    import numpy as np
    import pyarrow as pa
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch, tpch_full
    from daft_tpu_torch import faults
    from daft_tpu_torch.batch.actors import pinned_model_count, shutdown_all_models
    from daft_tpu_torch.errors import DaftResourceError
    from daft_tpu_torch.spill import MEMORY_LEDGER

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}
    t_phase = time.perf_counter()
    run = sql_udf_runner(out)

    # --- (a) SQL at SF0.005, 3 partitions, against SQLite
    small = tpch_full.generate(scale=0.005, seed=7)
    toys = sql_toy_catalogs(small, texts)
    conn = tpch_full.load_sqlite({"lineitem": small["lineitem"]})
    try:
        wants = {qn: tpch22_rows(conn.execute(texts[qn]).fetchall())
                 for qn in SQL_SINGLE_TABLE}
    finally:
        conn.close()
    for qn in SQL_PLANNING:
        tables = small if qn in SQL_SINGLE_TABLE else toys[qn]
        if qn in SQL_SINGLE_TABLE:
            want = wants[qn]
        else:
            conn = tpch_full.load_sqlite(tables)
            try:
                want = tpch22_rows(conn.execute(texts[qn]).fetchall())
            finally:
                conn.close()
        frames = tpch22_frames({"lineitem": small["lineitem"]} if qn in SQL_SINGLE_TABLE
                               else tables, 3)
        rows, c, launches, cold, warm = run(
            lambda: dtt.sql(texts[qn], **frames), device_min_rows=8)
        got = tpch22_rows(zip(*rows.values()))
        routes = (c.get("device_aggregations", 0), c.get("host_aggregations", 0))
        label = f"SF0.005 SQL Q{qn} (3 partitions{'' if qn in SQL_SINGLE_TABLE else ', toy'})"
        out[f"sql_q{qn}_sf0.005"] = {"cold_s": cold, "warm_s": warm, "launches": launches,
                                     "rows": len(got), "counters": {
                                         k: c.get(k, 0) for k in TPCH22_COUNTERS}}
        print(f"{label} " + json.dumps(out[f"sql_q{qn}_sf0.005"]), flush=True)
        ph.check(tpch22_match(got, want),
                 f"{label}: {len(got)} rows match the SQLite oracle under the suite's rule")
        ph.check(routes == SQL_ROUTES_3P[qn] and c.get("device_agg_fallbacks", 0) == 0,
                 f"{label}: (device, host) aggregations {routes}, as the CPU tests route them "
                 f"(SQL_ROUTES_3P {SQL_ROUTES_3P[qn]}), device_agg_fallbacks "
                 f"{c.get('device_agg_fallbacks', 0)} (launches {launches})")
    del small, toys, frames

    out["wall_sf0.005_s"] = time.perf_counter() - t_phase

    # --- (b) a row-local numpy UDF pinned in Q1's map chain
    want = tpch.oracle_q1(lineitem)
    frames = {1: dtt.from_arrow(lineitem).collect(),
              4: dtt.from_arrow(lineitem).into_partitions(UDF_PARTS[-1]).collect()}
    for parts in UDF_PARTS:
        for deep in (False, True):
            calls = []
            rows, c, launches, cold, _ = run(
                lambda: q1_udf(dtt, frames[parts], calls), warm_runs=0, device_min_rows=8,
                use_deep_fusion_kernel=deep)
            label = f"SF1 udf q1 {parts} partition(s) {'deep' if deep else 'composed'}"
            out[f"udf_q1_{parts}_{'deep' if deep else 'composed'}"] = {
                "cold_s": cold, "launches": launches, "calls": calls[:parts]}
            print(f"{label} cold {cold:.3f}s launches {launches}", flush=True)
            ph.check(parity(rows, want, RTOL),
                     f"{label}: matches pyarrow's Q1 at rtol {RTOL}")
            want_launches = dict(UDF_Q1_ROUTES[(parts, deep)], scatter=0)
            ph.check(len(calls) == parts and c.get("fused_chains", 0) >= 1
                     and c.get("host_fused_maps", 0) >= parts and launches == want_launches,
                     f"{label}: the UDF pinned in a host-run fused chain, {len(calls)} "
                     f"call(s), one a partition, the sums through "
                     f"{'K2' if deep else 'K1'} (launches {launches}, want {want_launches})")
    del frames

    out["wall_udf_s"] = time.perf_counter() - t_phase

    # --- (c) K13: the batched apply on the card
    price = lineitem["l_extendedprice"]
    frame = dtt.from_arrow(pa.table({"v": price})).into_partitions(K13_PARTS).collect()
    scorer = dtt.batch_udf(return_dtype=dtt.DataType.float64(), max_rows=K13_MAX_ROWS,
                           flush_ms=10_000.0, device=True)(PriceScorer)
    rows, c, launches, cold, warm = run(lambda: frame.select(scorer(dtt.col("v")).alias("s")),
                                        fetch="to_arrow", device_min_rows=8)
    got = rows.column("s").to_numpy()
    with torch.inference_mode():
        plain = PriceScorer.apply_torch(torch.from_numpy(
            price.to_numpy().astype(np.float32))).numpy().astype(np.float64)
    host = price.to_numpy() * 2.0 - 3.0
    pinned = MEMORY_LEDGER.snapshot()["model_cache_bytes"]
    out["k13"] = {"cold_s": cold, "warm_s": warm, "rows": len(got),
                  **{k: c.get(k, 0) for k in ("batches_formed", "batch_device_applies",
                                              "batch_device_fallbacks", "batch_flushes_budget",
                                              "batch_flushes_end")}}
    print(f"SF1 k13 " + json.dumps(out["k13"]), flush=True)
    ph.check(c.get("batches_formed", 0) >= K13_PARTS
             and c.get("batch_device_applies", 0) == c.get("batches_formed", 0)
             and c.get("batch_device_fallbacks", 0) == 0,
             f"SF1 k13: batch_device_applies {c.get('batch_device_applies', 0)} of "
             f"{c.get('batches_formed', 0)} batches formed, 0 fallbacks "
             f"({c.get('batch_device_fallbacks', 0)})")
    ph.check(got.view(np.int64).tolist() == plain.view(np.int64).tolist(),
             "SF1 k13: the output equals apply_torch over the float32 CPU tensors bit for bit")
    ph.check(bool(np.all(np.abs(got - host) <= RTOL * np.abs(host) + 1e-12)),
             f"SF1 k13: the output within rtol {RTOL} of the host instance (float64)")
    ph.check(MEMORY_LEDGER.snapshot()["batch_inflight"] == 0 and pinned == K13_WEIGHT_BYTES,
             f"SF1 k13: batch_inflight {MEMORY_LEDGER.snapshot()['batch_inflight']} after the "
             f"query, model_cache_bytes {pinned} while pinned (weight_bytes {K13_WEIGHT_BYTES})")
    shutdown_all_models()
    ph.check(MEMORY_LEDGER.snapshot()["model_cache_bytes"] == 0 and pinned_model_count() == 0,
             "SF1 k13: model_cache_bytes 0 and no pinned model after shutdown_all_models()")
    del frame

    out["wall_k13_s"] = time.perf_counter() - t_phase

    # --- (d) admission of a card request
    small_frame = dtt.from_pydict({"x": [1, 2, 3]})

    def gpu_udf(n):
        @dtt.udf(return_dtype=dtt.DataType.int64(), num_gpus=n)
        def f(x):
            return x
        return f

    dtt.set_execution_config(config())
    one = small_frame.select(gpu_udf(1)(dtt.col("x"))).to_pydict()
    ph.check(one == {"x": [1, 2, 3]}, f"admission: a num_gpus=1 UDF is admitted ({one})")
    try:
        small_frame.select(gpu_udf(2)(dtt.col("x"))).collect()
        raised = None
    except DaftResourceError as e:
        raised = str(e)
    ph.check(raised is not None and "accelerator" in raised,
             f"admission: a num_gpus=2 UDF raises DaftResourceError ({raised})")
    out["wall_s"] = time.perf_counter() - t_phase

    # --- (e) the fault sites: they inject faults, so the health window closes first
    ph.begin(None)
    head = dtt.from_arrow(pa.table({"v": price.slice(0, 400_000)})).into_partitions(4).collect()
    host_scorer = dtt.batch_udf(return_dtype=dtt.DataType.float64(), max_rows=250_000,
                                flush_ms=10_000.0)(PriceScorer)
    dtt.set_execution_config(config(dynamic_batching=False))
    unarmed = head.select(host_scorer(dtt.col("v")).alias("s")).to_arrow()
    dtt.set_execution_config(config())
    faults.arm("batch.coalesce", "always")
    try:
        df = head.select(host_scorer(dtt.col("v")).alias("s")).collect()
    finally:
        faults.disarm()
    c = df.stats.snapshot()["counters"]
    ph.check(df.to_arrow().equals(unarmed) and c.get("batch_coalesce_faults", 0) >= 1
             and c.get("batches_formed", 0) == 0
             and MEMORY_LEDGER.snapshot()["batch_inflight"] == 0,
             f"batch.coalesce always: byte-identical to the unbatched run through the degrade "
             f"path (batch_coalesce_faults {c.get('batch_coalesce_faults', 0)}, batches_formed "
             f"{c.get('batches_formed', 0)}, batch_inflight 0)")
    shutdown_all_models()
    faults.arm("actor.load", "always")
    try:
        head.select(host_scorer(dtt.col("v")).alias("s")).collect()
        raised = None
    except DaftResourceError as e:
        raised = str(e)
    finally:
        faults.disarm()
    ph.check(raised is not None and "PriceScorer" in raised and pinned_model_count() == 0
             and MEMORY_LEDGER.snapshot()["batch_inflight"] == 0,
             f"actor.load always: DaftResourceError naming the model, no pool left "
             f"({pinned_model_count()} pinned), batch_inflight 0")
    shutdown_all_models()
    print(f"SF1 sql/udf phase 15 wall {out['wall_s']:.1f}s before the fault sites, "
          f"{time.perf_counter() - t_phase:.1f}s in all; by the end of SF0.005 SQL "
          f"{out['wall_sf0.005_s']:.1f}s, the UDF {out['wall_udf_s']:.1f}s, K13 "
          f"{out['wall_k13_s']:.1f}s ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


def phase_sql_sf1(ph: Phases, data: dict, texts: dict, card: str) -> dict:
    """Phase 15's SF1 SQL leg, after phase 14: TPC-H Q1 and Q6 (of
    ``texts``) through daft_tpu_torch.sql over phase 4's SF1 tables
    (``data``), cold and warm, against pyarrow's Q1 and Q6 and against the
    port's host path of the same text, the aggregate on the card through
    K1."""
    import daft_tpu_torch as dtt
    from benchmarks import tpch

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}
    t_phase = time.perf_counter()
    run = sql_udf_runner(out)
    # --- (a) SQL Q1 and Q6 at SF1, one partition a table, against pyarrow
    # and the host path
    li_frame = dtt.from_arrow(data["lineitem"]).collect()
    oracles = {1: tpch.oracle_q1(data["lineitem"]),
               6: {"revenue": [tpch.oracle_q6(data["lineitem"])]}}
    for qn in SQL_SINGLE_TABLE:
        text = texts[qn]
        oracle = tpch22_rows(zip(*oracles[qn].values()))
        dtt.set_execution_config(config(use_deep_fusion_kernel=False, use_device_kernels=False,
                                        device="cpu"))
        want = tpch22_rows(zip(*dtt.sql(text, lineitem=li_frame).to_pydict().values()))
        rows, c, launches, cold, warm = run(lambda: dtt.sql(text, lineitem=li_frame))
        got = tpch22_rows(zip(*rows.values()))
        label = f"SF1 SQL Q{qn}"
        out[f"sql_q{qn}_sf1"] = {"cold_s": cold, "warm_s": warm, "launches": launches,
                                 "counters": {k: c.get(k, 0) for k in TPCH22_COUNTERS}}
        print(f"{label} " + json.dumps(out[f"sql_q{qn}_sf1"]), flush=True)
        ph.check(tpch22_match(got, oracle),
                 f"{label}: {len(got)} rows match pyarrow's Q{qn} under the suite's rule")
        ph.check(tpch22_match(got, want),
                 f"{label}: {len(got)} rows match the port's host path of the same text")
        ph.check(c.get("device_aggregations", 0) == 1 and c.get("device_agg_fallbacks", 0) == 0
                 and launches["k1"] == 1,
                 f"{label}: the aggregate on the card through K1 (launches {launches})")
    del li_frame
    out["oracles"] = {"q1": oracles[1], "q6": oracles[6]}  # phase 19's, over the same rows
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 SQL phase 15 SF1 leg wall {out['wall_s']:.1f}s ({card})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: observability around K1 and K2
# ---------------------------------------------------------------------------

OBS_PARTS = 4     # phase 16 cuts lineitem (and Q3's tables) into this many partitions
OBS_TURNS = 3     # profiled and unprofiled warm runs of each Q1, taken in turns
# the process metrics one phase-16 query at least folds (metrics_text)
OBS_METRICS = ("daft_tpu_queries_total", "daft_tpu_query_seconds_count",
               "daft_tpu_spilled_partitions_total", "daft_tpu_spill_write_bytes_total",
               "daft_tpu_faults_injected_total", "daft_tpu_device_breaker_trips_total",
               "daft_tpu_degraded_completions_total", "daft_tpu_rows_emitted_total")


def dispatch_phases_ok(qp, counters: dict) -> tuple:
    """Whether every device aggregate of a profiled query records its host
    staging and launch as a device_dispatch phase of its aggregate op's
    spans. The double-buffered map loop launches partition i + 1 in the
    pull that returns partition i, so each pull of an aggregate op but the
    last carries the phase (the one pull of a one-partition op carries it),
    and no device_dispatch lands outside a span. Returns (ok, detail)."""
    by_op = {}
    for s in qp.spans():
        if s.kind == "op" and ("Aggregate" in s.name or "DeviceSegment" in s.name):
            by_op.setdefault(s.name, []).append(s)
    launched = {}
    for name, spans in by_op.items():
        spans.sort(key=lambda s: s.part)
        flags = ["device_dispatch" in (s.phases or {}) for s in spans]
        if any(flags):
            launched[name] = flags
    stray = qp.to_dict()["unattributed_phases"].get("device_dispatch", 0)
    ok = (bool(launched) and counters.get("device_aggregations", 0) >= 1 and stray == 0
          and all(all(f[:-1]) and (f[-1] == (len(f) == 1)) for f in launched.values()))
    return ok, {"spans_with_dispatch": launched, "unattributed_ns": stray}


def self_time_ok(qp, stats) -> tuple:
    """The profile's per-op self time against RuntimeStats' op_wall_ns:
    within 5 % or 2 ms (tests/test_profile.py's rule)."""
    walls = stats.snapshot()["op_wall_ns"]
    gaps = {n: qp.ops.get(n, {}).get("self_ns", 0) - ns for n, ns in walls.items()}
    ok = bool(walls) and all(abs(g) <= max(0.05 * walls[n], 2_000_000) for n, g in gaps.items())
    return ok, gaps


def phase_observability(ph: Phases, lineitem, tables: dict, q3_oracle: tuple,
                        card: str) -> dict:
    """Phase 16: the observability layer (profile/, obs/, tracing.py) around
    K1 and K2 on the card, in the 32-bit mode, over phase 3's SF1 lineitem
    (6,000,000 rows, seed 42) and phase 7's SF1 tables.
    (a) Q1 composed (K1) and deep (K2), over 1 and 4 partitions: one cold
    unprofiled run, then OBS_TURNS profiled and OBS_TURNS unprofiled warm
    runs in turns. Every run gives the first run's rows bit for bit
    (pyarrow Table.equals) and its K1 and K2 launches; each profile
    validates, has no orphan span, records every device aggregate's
    staging and launch as device_dispatch (dispatch_phases_ok), and its
    per-op self time reconciles with op_wall_ns (self_time_ok). The warm
    walls, profiled and not, are printed (a finding, not a claim).
    (b) Q3 with hash joins over 4 partitions (broadcast threshold 0),
    profiled, inside tracing.chrome_trace: q3_parity against the oracle,
    join.build, shuffle.fanout and shuffle.merge spans, and the trace file
    parsed back with those spans in it.
    (c) the same Q3 under a memory budget of a quarter of (b)'s exchange
    bytes, profiled: it spills (spill events, spill.write or spill.read bg
    spans, none an orphan), q3_parity, and the ledger back at 0.
    (d) composed Q1 over 4 partitions with device.kernel armed first_n 3
    and a breaker threshold of 3, profiled: the rows of (a), three
    fault_injected events, one breaker event of transition trip into state
    open, the breaker_trip log line under the query's id, K1 never
    launched.
    (e) query_log(): one valid record per execution of the phase, each
    outcome ok or error (one UDF that raises makes the error).
    (f) health() validates while a query runs (the query listed) and after
    it ends (none listed).
    (g) metrics_text() carries OBS_METRICS, and daft_tpu_queries_total and
    daft_tpu_spilled_partitions_total moved by the phase's executions and
    spills.
    (h) Q6 with slow_query_threshold_s 0 and a temporary diagnostics_dir
    writes one valid bundle and arms the profiler for the next run of its
    plan."""
    import os
    import tempfile

    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch import faults, tracing
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.obs import capture as obs_capture
    from daft_tpu_torch.obs import log as obs_log
    from daft_tpu_torch.obs.health import validate_health
    from daft_tpu_torch.obs.querylog import QUERY_LOG, validate_record
    from daft_tpu_torch.profile import METRICS, validate_profile
    from daft_tpu_torch.spill import MEMORY_LEDGER

    t_phase = time.perf_counter()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0}
    dtt.set_execution_config(config())
    recs = []  # the QueryRecord of every execution of the phase
    log0, metrics0 = QUERY_LOG.total, METRICS.snapshot()

    def materialized(df):
        """A source frame, collected: an execution of the phase, unless the
        frame was born materialized (from_arrow)."""
        df = df.collect()
        if df.last_query_record() is not None:
            recs.append(df.last_query_record())
        return df

    def run(df, profile: bool):
        """One collect and fetch with the launches counted from 0: (frame,
        arrow result, seconds, launches)."""
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t = time.perf_counter()
        df = df.collect(profile=profile)
        got = df.to_arrow()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k, n in launches.items():
            out[f"{k}_launches"] += n
        recs.append(df.last_query_record())
        return df, got, secs, launches

    def check_profile(label, df):
        qp = df.profile()
        errs = validate_profile(qp.to_dict())
        ph.check(not errs and qp.orphan_spans == 0 and qp.to_dict()["dropped_spans"] == 0,
                 f"{label}: the profile validates ({errs[:3]}), {qp.orphan_spans} orphan spans, "
                 f"{len(qp.spans())} spans")
        return qp

    step = -(-lineitem.num_rows // OBS_PARTS)
    frames = {1: materialized(dtt.from_arrow(lineitem)),
              OBS_PARTS: materialized(dtt.from_arrow([lineitem.slice(i * step, step)
                                                      for i in range(OBS_PARTS)]))}

    # (a) Q1 composed and deep, over 1 and 4 partitions, profiled and not
    q1_rows = {}
    for deep in (False, True):
        for parts in (1, OBS_PARTS):
            label = f"SF1 obs q1 {'deep' if deep else 'composed'} {parts}p"
            # one thread: the double-buffered driver whose dispatch phases
            # the checks read (on the pool a declining first partition's
            # probe lands on the enclosing span, as in the reference, and
            # the workers' spans cover more than their map's own time)
            dtt.set_execution_config(config(use_deep_fusion_kernel=deep, **ONE_THREAD))
            _, want, cold, want_l = run(q1(frames[parts]), False)
            q1_rows[(deep, parts)] = want
            walls = {False: [], True: []}
            same_rows = same_launches = True
            for _ in range(OBS_TURNS):
                for profile in (True, False):
                    df, got, secs, launches = run(q1(frames[parts]), profile)
                    walls[profile].append(secs)
                    same_rows = same_rows and got.equals(want)
                    same_launches = same_launches and launches == want_l
                    if profile:
                        qp = check_profile(label, df)
                        c = df.stats.snapshot()["counters"]
                        ok, detail = dispatch_phases_ok(qp, c)
                        ph.check(ok, f"{label}: device_dispatch phases of every device "
                                     f"aggregate ({detail})")
                        ok, gaps = self_time_ok(qp, df.stats)
                        ph.check(ok, f"{label}: self time reconciles with op_wall_ns "
                                     f"(gaps ns {gaps})")
            kernel = "k2" if deep else "k1"
            ph.check(same_rows and same_launches and want_l[kernel] >= parts,
                     f"{label}: {2 * OBS_TURNS} warm runs, profiled and not, give the cold "
                     f"run's rows bit for bit and its launches {want_l}")
            res = {"cold_s": cold, "launches": want_l,
                   "profiled_warm_median_s": statistics.median(walls[True]),
                   "unprofiled_warm_median_s": statistics.median(walls[False]),
                   "profiled_warm_s": walls[True], "unprofiled_warm_s": walls[False],
                   "card": card}
            res["profiled_over_unprofiled"] = (res["profiled_warm_median_s"]
                                               / res["unprofiled_warm_median_s"])
            out[f"q1_{'deep' if deep else 'composed'}_{parts}p"] = res
            print(f"{label} " + json.dumps(res), flush=True)

    # (b) Q3 with hash joins over 4 partitions, profiled, into a chrome trace
    want3, groups3 = q3_oracle
    q3f = {k: materialized(dtt.from_arrow(tables[k]).into_partitions(OBS_PARTS))
           for k in ("customer", "orders", "lineitem")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        trace_path = os.path.join(tmp, "q3_trace.json")
        dtt.set_execution_config(config(broadcast_join_size_bytes_threshold=0))
        with tracing.chrome_trace(trace_path):
            df, got, secs, launches = run(q3(q3f["customer"], q3f["orders"], q3f["lineitem"]),
                                          True)
        qp = check_profile("SF1 obs q3", df)
        names = collections.Counter(s.name for s in qp.spans())
        ph.check(q3_parity(got.to_pydict(), want3, groups3, RTOL)
                 and all(names[n] >= 1 for n in ("join.build", "shuffle.fanout",
                                                 "shuffle.merge")),
                 f"SF1 obs q3: q3_parity, join.build {names['join.build']}, shuffle.fanout "
                 f"{names['shuffle.fanout']}, shuffle.merge {names['shuffle.merge']} spans")
        with open(trace_path) as f:
            trace = json.load(f)
        tnames = collections.Counter(e["name"] for e in trace["traceEvents"] if e["ph"] == "X")
        ph.check(tnames["join.build"] == names["join.build"]
                 and tnames["shuffle.merge"] == names["shuffle.merge"]
                 and sum(tnames.values()) == len(qp.spans()),
                 f"SF1 obs q3: the chrome trace parses back with {sum(tnames.values())} span "
                 f"events ({len(qp.spans())} spans) and {len(trace['traceEvents'])} events")
        exch = df.stats.snapshot()["counters"].get("exchange_bytes", 0)
        out["q3"] = {"wall_s": secs, "launches": launches, "spans": len(qp.spans()),
                     "trace_events": len(trace["traceEvents"]), "exchange_bytes": exch,
                     "card": card}
        print("SF1 obs q3 " + json.dumps(out["q3"]), flush=True)

        # (c) the same Q3 spilling under a quarter of its exchange bytes
        dtt.set_execution_config(config(broadcast_join_size_bytes_threshold=0,
                                        memory_budget_bytes=max(1, exch // 4), **ONE_THREAD))
        MEMORY_LEDGER.reset()
        df, got, secs, launches = run(q3(q3f["customer"], q3f["orders"], q3f["lineitem"]), True)
        qp = check_profile("SF1 obs q3 budgeted", df)
        c = df.stats.snapshot()["counters"]
        kinds = collections.Counter(e["kind"] for e in qp.events)
        bg = collections.Counter(s.name for s in qp.spans() if s.kind == "bg")
        led = MEMORY_LEDGER.snapshot()
        ph.check(q3_parity(got.to_pydict(), want3, groups3, RTOL)
                 and c.get("spilled_partitions", 0) > 0 and kinds["spill"] >= 1
                 and bg["spill.write"] + bg["spill.read"] >= 1
                 and led["current"] == 0 and led["async_spill_inflight"] == 0,
                 f"SF1 obs q3 budgeted: q3_parity, {c.get('spilled_partitions', 0)} spilled "
                 f"partitions, {kinds['spill']} spill events, bg spans {dict(bg)}, the ledger "
                 f"at {led['current']} (async {led['async_spill_inflight']})")
        out["q3_budgeted"] = {"wall_s": secs, "budget": exch // 4, "events": dict(kinds),
                              "bg_spans": dict(bg), "card": card}
        print("SF1 obs q3 budgeted " + json.dumps(out["q3_budgeted"]), flush=True)
        del q3f

        # (h) a slow query's bundle, and the profiler armed for its next run
        diag = os.path.join(tmp, "diagnostics")
        dtt.set_execution_config(config(slow_query_threshold_s=0.0, diagnostics_dir=diag))
        df, _, _, _ = run(q6(frames[1]), False)
        bundles = obs_capture.list_bundles(diag)
        rec = df.last_query_record()
        files = set(os.listdir(os.path.join(diag, bundles[0]))) if bundles else set()
        loaded = (json.load(open(os.path.join(diag, bundles[0], "record.json")))
                  if bundles else {})
        armed = obs_capture.take_arm(rec["plan_fingerprint"])
        ph.check(len(bundles) == 1 and {"record.json", "stats.txt", "log_tail.jsonl"} <= files
                 and validate_record(loaded) == [] and armed,
                 f"SF1 obs slow query: bundles {bundles} with {sorted(files)}, the next run "
                 f"armed: {armed}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    # (f) health while a query runs and after
    dtt.set_execution_config(config())
    it = q1(frames[OBS_PARTS]).iter_partitions()
    next(it)
    during = dtt.health()
    for _ in it:
        pass
    after = dtt.health()
    recs.append(QUERY_LOG.last())
    ph.check(validate_health(during) == [] and validate_health(after) == []
             and len(during["queries"]) == 1 and after["queries"] == [],
             f"SF1 obs health: validates during ({len(during['queries'])} query running) and "
             f"after ({len(after['queries'])}); breakers {after['breakers']}")

    # (d) device.kernel armed three times; the health checks stand down
    ph.begin(None)
    dtt.set_execution_config(config(device_breaker_threshold=3, **ONE_THREAD))
    faults.arm("device.kernel", "first_n", n=3)
    try:
        df, got, _, launches = run(q1(frames[OBS_PARTS]), True)
    finally:
        faults.disarm()
    qp = check_profile("SF1 obs q1 device.kernel", df)
    kinds = collections.Counter(e["kind"] for e in qp.events)
    trips = [e["attrs"] for e in qp.events if e["kind"] == "breaker"]
    qid = df.last_query_record()["query_id"]
    lines = [r["event"] for r in obs_log.tail(500, query_id=qid) if r["logger"] == "breaker"]
    ph.check(parity(got.to_pydict(), q1_rows[(False, OBS_PARTS)].to_pydict(), RTOL)
             and kinds["fault_injected"] == 3 and launches["k1"] == 0
             and [(t["transition"], t["state"]) for t in trips] == [("trip", "open")]
             and lines == ["breaker_trip"],
             f"SF1 obs q1 device.kernel first_n 3: rows at rtol {RTOL}, events {dict(kinds)}, "
             f"breaker events {trips}, breaker log lines {lines}, launches {launches}")

    # (e) the query log: one valid record per execution, ok or error
    @dtt.udf(return_dtype=dtt.DataType.float64())
    def fails(c):
        raise ValueError("phase 16's failing UDF")

    bad = frames[1].limit(10).select(fails(dtt.col("l_quantity")))
    try:
        bad.collect()
        raised = False
    except ValueError:
        raised = True
    recs.append(bad.last_query_record())
    logged = QUERY_LOG.records()[-len(recs):]
    outcomes = collections.Counter(r["outcome"] for r in logged)
    ph.check(raised and QUERY_LOG.total - log0 == len(recs)
             and [r["query_id"] for r in logged] == [r["query_id"] for r in recs]
             and all(validate_record(r) == [] for r in logged)
             and outcomes == {"ok": len(recs) - 1, "error": 1},
             f"SF1 obs query log: {QUERY_LOG.total - log0} records for {len(recs)} executions, "
             f"outcomes {dict(outcomes)}")

    # (g) the phase's metrics
    text = dtt.metrics_text()
    snap = METRICS.snapshot()

    def moved(name):
        return snap.get(name, 0) - metrics0.get(name, 0)

    spilled = sum(r["counters"].get("spilled_partitions", 0) for r in recs)
    missing = [m for m in OBS_METRICS if m not in text]
    ph.check(not missing and moved("daft_tpu_queries_total") == len(recs)
             and moved("daft_tpu_spilled_partitions_total") == spilled > 0,
             f"SF1 obs metrics_text: missing {missing}, queries_total moved "
             f"{moved('daft_tpu_queries_total')} ({len(recs)} executions), spilled partitions "
             f"moved {moved('daft_tpu_spilled_partitions_total')} ({spilled})")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 obs phase 16 wall {out['wall_s']:.1f}s ({card})", flush=True)
    del frames
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 17: the scheduler and the morsel pipeline
# ---------------------------------------------------------------------------

SCHED_PARTS = 8           # (a) and (b): Q1 over this many partitions, the first ...
SCHED_FIRST_ROWS = 100    # ... of this many rows, under device_min_rows
SCHED_EVEN_PARTS = 4      # (c), (d) and (f): this many even partitions
SCHED_DEEP_DATE = datetime.date(1998, 8, 17)  # (b)'s literal, used by no earlier phase
SCHED_LIMIT = 10          # (e)


def phase_scheduling(ph: Phases, lineitem, tables: dict, q3_oracle: tuple, card: str) -> dict:
    """Phase 17: the partition scheduler (scheduler.py) and the morsel
    pipeline (stream/) around K1, K2 and the scatter kernel on the card, in
    the 32-bit mode, over phase 3's SF1 lineitem (seed 42) and phase 7's SF1
    tables, under the port's defaults (executor_threads 0: one worker per
    core; streaming on).
    (a) composed Q1 over SCHED_PARTS partitions whose first holds
    SCHED_FIRST_ROWS rows: the first declines the card, so the stream goes
    to the pool and the other partitions launch K1 from its threads (at
    least 2 distinct thread ids). The rows equal executor_threads=1's bit
    for bit (pyarrow Table.equals) and the oracle's at RTOL; K1 launches,
    device_aggregations and host_aggregations are equal both ways.
    (b) the same deep (K2) with a predicate literal no earlier phase used:
    the pool's threads ask for one new program at once: at most one nvcc
    process starts (none where the library is already on disk), one new
    program is made and every thread's K2 call gets that one object; the
    rows equal one thread's bit for bit.
    (c) Q1 over SCHED_EVEN_PARTS even partitions: the first accepts, the
    double-buffered driver keeps the stream on the consumer's thread, K1
    launches SCHED_EVEN_PARTS times.
    (d) Q3 with hash joins over SCHED_EVEN_PARTS partitions (its stages
    through K1) and with broadcast joins over one partition (its groups
    through the scatter kernel), each with streaming on and off: its filters
    stream in device-morsel mode (stream_morsels > 0 on), q3_parity both
    ways, equal K1 and scatter launches.
    (e) a Limit of SCHED_LIMIT over a Filter/Project chain on the card over
    the one-partition lineitem: morsels_short_circuited > 0, the time to the
    first row printed.
    (f) DataFrame.cancel() from a second thread during (d)'s Q3: it raises
    QueryCancelledError, the query log records cancelled, the ledger's
    current, exec_inflight and stream_inflight and the scheduler's window
    read 0, and the next Q1 gives (a)'s rows.
    (g) after every query of the phase, exec_inflight and stream_inflight
    read 0.
    The warm walls of (a) at one thread and at the default, and of (d) with
    streaming on and off, are printed (findings, not claims), with a
    breakdown of one profiled warm run of each of those four (the port's
    per-op spans and the device's busy time)."""
    import threading

    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch.execution import QueryCancelledError
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import nvcc
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.obs.querylog import QUERY_LOG
    from daft_tpu_torch.scheduler import inflight_tasks
    from daft_tpu_torch.spill import MEMORY_LEDGER

    t_phase = time.perf_counter()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}
    windows_ok = []  # (g): (label, exec_inflight, stream_inflight) after each query

    def run(label, df):
        """Collect and fetch with the launches counted from 0: (frame, arrow
        result, seconds, launches, counters)."""
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t = time.perf_counter()
        df = df.collect()
        got = df.to_arrow()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k, n in launches.items():
            out[f"{k}_launches"] += n
        led = MEMORY_LEDGER.snapshot()
        windows_ok.append((label, led["exec_inflight"], led["stream_inflight"]))
        return df, got, secs, launches, df.stats.snapshot()["counters"]

    # the threads that call K1's and K2's wrappers on the config's device
    callers = []
    real_k1, real_k2 = ss.masked_segment_sums_padded, fes.fused_expr_sums
    dev_type = torch.device(config().device).type

    def k1_watch(codes, *a, **k):
        if codes.device.type == dev_type:
            callers.append((threading.get_ident(), threading.current_thread().name))
        return real_k1(codes, *a, **k)

    programs_used = []  # the program object of each K2 call on the card

    def k2_watch(prog, codes, *a, **k):
        if codes.device.type == dev_type:
            callers.append((threading.get_ident(), threading.current_thread().name))
            programs_used.append(prog)
        return real_k2(prog, codes, *a, **k)

    class CountingSubprocess:
        """nvcc's ``subprocess`` module, counting the nvcc processes it
        starts (``Popen``): none where the library is already on disk."""

        def __init__(self, real):
            self.real = real
            self.started = []

        def __getattr__(self, attr):
            return getattr(self.real, attr)

        def Popen(self, args, *a, **k):
            self.started.append(args)
            return self.real.Popen(args, *a, **k)

    rest = lineitem.num_rows - SCHED_FIRST_ROWS
    step = -(-rest // (SCHED_PARTS - 1))
    skewed = dtt.from_arrow([lineitem.slice(0, SCHED_FIRST_ROWS)] + [
        lineitem.slice(SCHED_FIRST_ROWS + i * step, step) for i in range(SCHED_PARTS - 1)])
    even_step = -(-lineitem.num_rows // SCHED_EVEN_PARTS)
    even = dtt.from_arrow([lineitem.slice(i * even_step, even_step)
                           for i in range(SCHED_EVEN_PARTS)])
    oracle = tpch.oracle_q1(lineitem)
    ss.masked_segment_sums_padded, fes.fused_expr_sums = k1_watch, k2_watch
    try:
        # (a) and (b): the pool's threads launch K1, then a new K2 program
        for deep in (False, True):
            kind = "deep" if deep else "composed"
            date = SCHED_DEEP_DATE if deep else datetime.date(1998, 9, 2)
            res = {}
            for threads in (1, 0):
                dtt.set_execution_config(config(use_deep_fusion_kernel=deep,
                                                executor_threads=threads))
                if deep and threads == 1:
                    # one thread goes second for the deep program: the pool
                    # builds it first, under concurrent first use
                    continue
                callers.clear()
                programs_used.clear()
                nprog = len(fes.programs())
                counting = nvcc.subprocess = CountingSubprocess(nvcc.subprocess)
                try:
                    df, got, cold, launches, c = run(f"(a/b) q1 {kind} {threads}t",
                                                     q1(skewed, date))
                finally:
                    nvcc.subprocess = counting.real
                cold_callers = list(callers)
                warm = [run(f"(a/b) q1 {kind} {threads}t warm", q1(skewed, date))[2]
                        for _ in range(2)]
                res[threads] = {"rows": got, "launches": launches, "cold_s": cold,
                                "warm_s": warm, "callers": cold_callers,
                                "nvcc_processes": len(counting.started),
                                "new_programs": len(fes.programs()) - nprog,
                                "program_objects": len({id(p) for p in programs_used}),
                                "routes": (c.get("device_aggregations", 0),
                                           c.get("host_aggregations", 0))}
            if deep:
                dtt.set_execution_config(config(use_deep_fusion_kernel=True, executor_threads=1))
                callers.clear()
                df, got, cold, launches, c = run("(b) q1 deep 1t", q1(skewed, date))
                res[1] = {"rows": got, "launches": launches, "cold_s": cold, "warm_s": [],
                          "callers": list(callers), "routes": (
                              c.get("device_aggregations", 0), c.get("host_aggregations", 0))}
            pool, one = res[0], res[1]
            pool_ids = {i for i, name in pool["callers"] if name.startswith("daft-torch-exec")}
            kernel = "k2" if deep else "k1"
            label = f"SF1 sched q1 {kind} {SCHED_PARTS}p (first {SCHED_FIRST_ROWS} rows)"
            ok = (pool["rows"].equals(one["rows"]) and pool["routes"] == one["routes"]
                  and pool["launches"][kernel] == one["launches"][kernel] == SCHED_PARTS - 1
                  and len(pool_ids) >= 2
                  and len(pool["callers"]) == SCHED_PARTS - 1
                  and all(name.startswith("daft-torch-exec") for _, name in pool["callers"]))
            if not deep:
                ok = ok and parity(pool["rows"].to_pydict(), oracle, RTOL)
                out["q1_rows"] = pool["rows"]
            else:
                ok = ok and pool["nvcc_processes"] <= 1 and pool["new_programs"] == 1 \
                    and pool["program_objects"] == 1 and not nvcc._RUNNING
            ph.check(ok, f"{label}: the pool's rows equal one thread's bit for bit"
                         + ("" if deep else f" and the oracle's at rtol {RTOL}")
                         + f", {kernel} launches {pool['launches'][kernel]} and "
                         f"{one['launches'][kernel]}, (device, host) aggregations "
                         f"{pool['routes']} and {one['routes']}, {kernel} called from "
                         f"{len(pool_ids)} pool threads"
                         + (f", {pool['nvcc_processes']} nvcc process (at most 1; 0 where "
                            f"the library was on disk), {pool['new_programs']} new program, "
                            f"{pool['program_objects']} program object across the threads"
                            if deep else ""))
            walls = {"one_thread_warm_s": one["warm_s"], "default_warm_s": pool["warm_s"],
                     "one_thread_cold_s": one["cold_s"], "default_cold_s": pool["cold_s"],
                     "pool_threads": len(pool_ids), "launches": pool["launches"], "card": card}
            out[f"q1_{kind}"] = walls
            print(f"{label} " + json.dumps(walls), flush=True)

        # (c) the first of 4 even partitions accepts: the sequential driver
        dtt.set_execution_config(config())
        callers.clear()
        df, got, secs, launches, c = run("(c) q1 4p", q1(even))
        on_pool = [name for _, name in callers if name.startswith("daft-torch-exec")]
        ph.check(launches["k1"] == SCHED_EVEN_PARTS and not on_pool
                 and c.get("device_agg_dispatches", 0) == SCHED_EVEN_PARTS
                 and parity(got.to_pydict(), oracle, RTOL),
                 f"SF1 sched q1 {SCHED_EVEN_PARTS}p even: K1 launches {launches['k1']}, "
                 f"{c.get('device_agg_dispatches', 0)} dispatches, {len(on_pool)} calls on pool "
                 f"threads (the double-buffered driver), rows at rtol {RTOL}")
    finally:
        ss.masked_segment_sums_padded, fes.fused_expr_sums = real_k1, real_k2

    # (d) Q3 with hash joins over 4 partitions (stage 1 and 2 through K1),
    # and with broadcast joins over one (its ~11,600 groups through the
    # scatter kernel), streaming on and off
    want3, groups3 = q3_oracle
    q3f = {k: dtt.from_arrow(tables[k]).into_partitions(SCHED_EVEN_PARTS).collect()
           for k in ("customer", "orders", "lineitem")}
    q3one = {k: dtt.from_arrow(tables[k]).collect() for k in ("customer", "orders", "lineitem")}
    for shape, frames3, threshold in (("hash joins 4p", q3f, 0), ("broadcast joins 1p", q3one,
                                                                  None)):
        runs3 = {}
        for streaming in (True, False):
            kw = {} if threshold is None else {"broadcast_join_size_bytes_threshold": threshold}
            dtt.set_execution_config(config(streaming_execution=streaming, **kw))
            walls = []
            for i in range(3):
                df, got, secs, launches, c = run(
                    f"(d) q3 {shape} stream {streaming}",
                    q3(frames3["customer"], frames3["orders"], frames3["lineitem"]))
                walls.append(secs)
            runs3[streaming] = {"rows": got, "launches": launches, "walls": walls,
                                "morsels": c.get("stream_morsels", 0)}
        on, off = runs3[True], runs3[False]
        kernel = "k1" if threshold == 0 else "scatter"
        ph.check(q3_parity(on["rows"].to_pydict(), want3, groups3, RTOL)
                 and q3_parity(off["rows"].to_pydict(), want3, groups3, RTOL)
                 and on["morsels"] > 0 and off["morsels"] == 0
                 and on["launches"]["k1"] == off["launches"]["k1"]
                 and on["launches"]["scatter"] == off["launches"]["scatter"]
                 and on["launches"][kernel] >= 1,
                 f"SF1 sched q3 {shape}: q3_parity with streaming on and off, "
                 f"{on['morsels']} morsels streamed on, launches {on['launches']} and "
                 f"{off['launches']}")
        key = "q3_" + shape.replace(" ", "_")
        out[key] = {"streaming_cold_s": on["walls"][0], "streaming_warm_s": on["walls"][1:],
                    "partition_cold_s": off["walls"][0], "partition_warm_s": off["walls"][1:],
                    "stream_morsels": on["morsels"], "launches": on["launches"], "card": card}
        print(f"SF1 sched q3 {shape} " + json.dumps(out[key]), flush=True)
    del q3one

    # where each driver's time goes: one warm run of each under the port's
    # profiler (per op: wall, self, queue_wait, the device_dispatch phase's
    # host time, background spans) and torch.profiler (the device's busy
    # time and idle share); the profiled run's wall includes the spans' cost
    def breakdown(label, make_df, **kw):
        dtt.set_execution_config(config(**kw))
        held = []
        dev, _ = device_profile(lambda: held.append(make_df().collect(profile=True)), reps=1)
        prof = held[-1].profile()
        ops = {name: {"wall_ms": o["wall_ns"] / 1e6, "self_ms": o["self_ns"] / 1e6,
                      "queue_wait_ms": o["queue_wait_ns"] / 1e6,
                      "device_dispatch_ms": o["device_ns"] / 1e6,
                      "partitions": o["partitions"],
                      "background_ms": {k: v / 1e6 for k, v in o["background"].items()}}
               for name, o in prof.ops.items()}
        res = {**dev, "profile_wall_ms": prof.wall_ns / 1e6, "ops": ops, "card": card}
        out.setdefault("breakdown", {})[label] = res
        print(f"SF1 sched breakdown {label} " + json.dumps(res), flush=True)
        held.clear()

    breakdown("q1 composed 8p one thread", lambda: q1(skewed), executor_threads=1)
    breakdown("q1 composed 8p pool", lambda: q1(skewed))
    for streaming in (False, True):
        breakdown(f"q3 hash joins 4p streaming {streaming}",
                  lambda: q3(q3f["customer"], q3f["orders"], q3f["lineitem"]),
                  streaming_execution=streaming, broadcast_join_size_bytes_threshold=0)

    # (e) a limit over a chain on the card: the morsel sink stops early
    one_frame = dtt.from_arrow(lineitem)
    dtt.set_execution_config(config())
    from daft_tpu_torch import col

    df, got, secs, launches, c = run("(e) limit", one_frame.where(col("l_quantity") > 10)
                                     .with_column("x", col("l_extendedprice") * 2.0)
                                     .limit(SCHED_LIMIT))
    short = c.get("morsels_short_circuited", 0)
    ttfr = c.get("time_to_first_row_ns", 0)
    want_e = [q > 10 for q in got.column("l_quantity").to_pylist()]
    ph.check(got.num_rows == SCHED_LIMIT and all(want_e) and short > 0
             and c.get("stream_morsels", 0) > 0 and ttfr > 0,
             f"SF1 sched limit {SCHED_LIMIT}: {got.num_rows} rows, "
             f"{c.get('stream_morsels', 0)} morsels streamed, {short} short-circuited, first "
             f"row after {ttfr / 1e6:.2f} ms")
    out["limit"] = {"wall_s": secs, "time_to_first_row_ms": ttfr / 1e6,
                    "morsels_short_circuited": short, "card": card}

    # (f) cancel from a second thread during Q3: once its first probe launches
    dtt.set_execution_config(config(broadcast_join_size_bytes_threshold=0))
    from daft_tpu_torch.execution import ExecutionContext

    real_probe = ExecutionContext.eval_join_dispatch
    holder = {}

    def probe_then_cancel(self, *a, **k):
        res = real_probe(self, *a, **k)
        if "cancelled_by" not in holder:
            t = threading.Thread(target=holder["df"].cancel)
            t.start()
            t.join()
            holder["cancelled_by"] = t.name
        return res

    df = holder["df"] = q3(q3f["customer"], q3f["orders"], q3f["lineitem"])
    ExecutionContext.eval_join_dispatch = probe_then_cancel
    raised = None
    try:
        df.collect()
    except QueryCancelledError as e:
        raised = e
    finally:
        ExecutionContext.eval_join_dispatch = real_probe
    torch.cuda.synchronize()
    rec = QUERY_LOG.last()
    led = MEMORY_LEDGER.snapshot()
    window = inflight_tasks()
    dtt.set_execution_config(config())
    _, again, _, _, _ = run("(f) q1 after the cancel", q1(skewed))
    ph.check(raised is not None and rec["outcome"] == "cancelled" and led["current"] == 0
             and led["exec_inflight"] == 0 and led["stream_inflight"] == 0 and window == 0
             and again.equals(out["q1_rows"]),
             f"SF1 sched cancel: {type(raised).__name__} from "
             f"{holder.get('cancelled_by')}, record {rec['outcome']}, ledger current "
             f"{led['current']} exec {led['exec_inflight']} stream {led['stream_inflight']}, "
             f"window {window}, the next Q1 gives (a)'s rows: {again.equals(out['q1_rows'])}")
    del q3f

    # (g) every query of the phase left the window accounts at 0
    bad = [w for w in windows_ok if w[1] or w[2]]
    ph.check(not bad, f"SF1 sched: {len(windows_ok)} queries left exec_inflight and "
                      f"stream_inflight at 0 ({bad[:3]})")
    del out["q1_rows"]
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 sched phase 17 wall {out['wall_s']:.1f}s ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: the mesh runner
# ---------------------------------------------------------------------------

MESH_SLOTS = 8            # default_mesh(8): 8 slots, on one card
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
              "l_tax", "l_shipdate")
SORT_COLUMNS = ("l_orderkey", "l_linenumber", "l_extendedprice", "l_shipmode")


def mesh_exchanges(native: dict) -> int:
    """The exchanges a mesh run of a plan must make over the mesh: every
    shuffle the NativeRunner run of the plan made on the host, and two for
    each sort-merge join that split its sides (one a side)."""
    return native.get("shuffles", 0) + 2 * native.get("aligned_boundary_shuffles", 0)


def q3_smj(customer, orders, lineitem):
    """Q3 with both joins as sort-merge joins (SortMergeJoinOp)."""
    from daft_tpu_torch import col

    cutoff = datetime.date(1995, 3, 15)
    c = customer.where(col("c_mktsegment") == "BUILDING")
    o = orders.where(col("o_orderdate") < cutoff)
    l = lineitem.where(col("l_shipdate") > cutoff)
    return (
        c.join(o, left_on="c_custkey", right_on="o_custkey", strategy="sort_merge")
        .join(l, left_on="o_orderkey", right_on="l_orderkey", strategy="sort_merge")
        .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
        .groupby("o_orderkey", "o_orderdate", "o_shippriority")
        .agg(col("revenue").sum().alias("revenue"))
        .select("o_orderkey", "revenue", "o_orderdate", "o_shippriority")
        .sort(["revenue", "o_orderdate"], desc=[True, False])
        .limit(10)
    )


MESH_STEPS = ("bucket", "stage", "scatter", "counts", "unstage")


def sync_profiler():
    """A query Profiler that synchronizes the card as each span of the mesh
    exchange (``collective.*``) opens and closes, so that each step's span
    holds its own device work: the breakdown run's, never a timed run's."""
    import torch

    from daft_tpu_torch.profile import Profiler

    class SyncProfiler(Profiler):
        def begin(self, name, op=None, part=None, kind="op"):
            if self.armed and name.startswith("collective."):
                torch.cuda.synchronize()
            return super().begin(name, op=op, part=part, kind=kind)

        def end(self, sp):
            if sp is not None and sp.name.startswith("collective."):
                torch.cuda.synchronize()
            super().end(sp)

    return SyncProfiler()


def exchange_steps(prof) -> tuple:
    """(exchanges, {step: ms}) from a profiled run: the exchanges that ran
    all five steps (``collective.exchange`` spans with a
    ``collective.unstage`` child), and each step's milliseconds summed over
    them."""
    spans = prof.spans_snapshot()
    top = {s.sid for s in spans if s.name == "collective.exchange"}
    done = {s.parent for s in spans if s.name == "collective.unstage" and s.parent in top}
    ms = {k: 0.0 for k in MESH_STEPS}
    for s in spans:
        if s.parent in done and s.name.startswith("collective."):
            ms[s.name.split(".", 1)[1]] += s.dur_ns / 1e6
    return len(done), ms


def phase_mesh(ph: Phases, lineitem, tables: dict, q3_oracle: tuple, card: str) -> dict:
    """Phase 18: the mesh runner (parallel/) on one card, in the 32-bit mode
    but where a leg says x64, over phase 3's SF1 lineitem
    (generate_lineitem_only(1.0, seed=42), Q1's) and phase 7's SF1 tables
    (generate_tables(1.0, seed=42), whose lineitem has l_orderkey), on
    default_mesh(8) (8 slots on the card) and default_mesh() (one slot).
    (a) build_exchange of l_orderkey's rows, cut into 8 source shards and
    bucketed by l_orderkey % 8: each destination's rows are the multiset of
    numpy's bucketing, and two launches are equal bit for bit.
    (b) build_exchange_groupby_sum of l_extendedprice (float32) by
    l_orderkey's dense rank (one group an order, at most 7 rows a group):
    the sums of two launches equal bit for bit and within RTOL of numpy's
    float64 sums of the same float32 values, the counts exact, one
    scatter-kernel launch a slot.
    (c) through MeshRunner: Q1 over repartition(8) (stage 1 through K1, one
    launch a partition, from the columns the exchange seeded), hash-join Q3
    over 8-partition sides (co-partitioned by the exchange), broadcast Q3
    (broadcast_replications), also on default_mesh(), sort-merge Q3
    (device_aligned_smj_exchanges) and, in x64, the global sort of lineitem
    by (l_orderkey, l_linenumber) and Q1 at RTOL_X64; each against the
    pyarrow oracles, every exchange of the plan over the mesh (device_shuffles
    as mesh_exchanges reads NativeRunner's run, no host shuffle), no
    collective breaker trip and no degraded shuffle. Each is timed warm beside
    NativeRunner warm on the same partitions (each runner's second run), and
    a third mesh run, profiled with the card synchronized at each step of
    every exchange (sync_profiler), breaks the exchange down; broadcast
    Q3 on one slot and Q1 in x64 run once, held to the exchange count of
    the same plan's timed leg.
    (d) collective.exchange armed always with device_breaker_threshold 1:
    broadcast Q3 still comes back with the unarmed run's rows at RTOL, the
    breaker trips once and the exchanges go to the host.
    (e) a one-process nccl group through init_distributed on localhost:
    global_mesh(), all_to_all_single and all_gather on CUDA tensors, then
    the group is destroyed."""
    import socket

    import numpy as np
    import pyarrow as pa
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch import col, faults
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.parallel.collectives import (build_exchange, build_exchange_groupby_sum,
                                                     exchange_capacity, shard_to_mesh)
    from daft_tpu_torch.runners import MeshRunner, NativeRunner

    t_phase = time.perf_counter()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}
    dtt.set_execution_config(config())
    mesh8 = default_mesh(MESH_SLOTS)
    ph.check(mesh8.size == MESH_SLOTS and len({str(d) for d in mesh8.devices})
             == min(MESH_SLOTS, max(1, torch.cuda.device_count())),
             f"SF1 mesh: default_mesh({MESH_SLOTS}) has {mesh8.size} slots on "
             f"{sorted({str(d) for d in mesh8.devices})}")

    # (a) the raw exchange of l_orderkey
    joined_li = tables["lineitem"]
    keys = joined_li.column("l_orderkey").to_numpy().astype(np.int64)
    n, total = MESH_SLOTS, len(keys)
    r = -(-total // n)
    vals = np.zeros(n * r, np.int64)
    vals[:total] = keys
    vals = vals.reshape(n, r)
    valid = (np.arange(n * r) < total).reshape(n, r)
    bucket = (vals % n).astype(np.int32)
    cap = exchange_capacity([bucket[i][valid[i]] for i in range(n)], [None] * n, n)
    fn = build_exchange(mesh8, cap)
    args = (shard_to_mesh(bucket, mesh8), shard_to_mesh(valid, mesh8), shard_to_mesh(vals, mesh8))
    first, second = fn(*args), fn(*args)
    same = all(torch.equal(a, b) for f1, f2 in zip(first, second) for a, b in zip(f1, f2))
    multiset = True
    for d in range(n):
        got = torch.sort(first[1][d].reshape(-1)[first[0][d].reshape(-1)]).values.cpu().numpy()
        multiset = multiset and np.array_equal(got, np.sort(keys[keys % n == d]))
    ex_ms = cuda_ms(lambda: fn(*args), iters=5)
    moved = total * (4 + 1 + 8) + n * n * cap * (1 + 8)
    out["exchange"] = {"rows": total, "capacity": cap, "ms": ex_ms, **bound(moved, 0),
                       "card": card}
    ph.check(same and multiset,
             f"SF1 mesh (a) build_exchange of {total} l_orderkey rows over {n} slots, capacity "
             f"{cap}: each destination's rows equal numpy's bucketing as a multiset, two "
             f"launches equal bit for bit; {ex_ms:.3f} ms a launch")
    del first, second, args

    # (b) the fused exchange and segment sum, one group an order
    _, codes = np.unique(keys, return_inverse=True)
    g = int(codes.max()) + 1
    price = joined_li.column("l_extendedprice").to_numpy().astype(np.float32)
    cv = np.zeros(n * r, np.int32)
    cv[:total] = codes
    cv = cv.reshape(n, r)
    pv = np.zeros(n * r, np.float32)
    pv[:total] = price
    pv = pv.reshape(n, r)
    gb = (cv % n).astype(np.int32)
    gcap = exchange_capacity([gb[i][valid[i]] for i in range(n)], [None] * n, n)
    step = build_exchange_groupby_sum(mesh8, gcap, g)
    gargs = (shard_to_mesh(gb, mesh8), shard_to_mesh(valid, mesh8), shard_to_mesh(cv, mesh8),
             shard_to_mesh(pv, mesh8))
    scs.LAUNCHES = 0
    s1, c1 = step(*gargs)
    s2, c2 = step(*gargs)
    torch.cuda.synchronize()
    launches_b = scs.LAUNCHES
    out["scatter_launches"] += launches_b
    bits = all(same_bits(a, b) for a, b in zip(s1, s2)) and all(
        torch.equal(a, b) for a, b in zip(c1, c2))
    idx = np.arange(g)
    sums = torch.stack(s1).cpu().numpy()[idx % n, idx].astype(np.float64)
    cnts = torch.stack(c1).cpu().numpy()[idx % n, idx]
    want = np.bincount(codes, weights=price.astype(np.float64), minlength=g)
    rel = float(np.max(np.abs(sums - want) / np.maximum(np.abs(want), 1e-30)))
    gb_ms = cuda_ms(lambda: step(*gargs), iters=3)
    out["groupby_sum"] = {"groups": g, "capacity": gcap, "ms": gb_ms, "max_rel": rel,
                          "card": card}
    ph.check(bits and rel <= RTOL and np.array_equal(cnts, np.bincount(codes, minlength=g))
             and launches_b == 2 * n,
             f"SF1 mesh (b) build_exchange_groupby_sum over {g} groups: two launches equal bit "
             f"for bit, sums within {rel:.2e} of numpy's float64 (RTOL {RTOL}), counts exact, "
             f"{launches_b} scatter-kernel launches (one a slot a launch); {gb_ms:.3f} ms")
    del gargs, s1, s2, c1, c2

    # (c) the mesh queries, each against NativeRunner on the same partitions
    c_t, o_t, l_t = tables["customer"], tables["orders"], tables["lineitem"]
    want3, groups3 = q3_oracle
    parts8 = {k: dtt.from_arrow(tables[k]).into_partitions(MESH_SLOTS).collect()
              for k in ("customer", "orders", "lineitem")}
    li_q1 = dtt.from_arrow(lineitem.select(list(Q1_COLUMNS))).collect()
    sort_src = joined_li.select(list(SORT_COLUMNS))
    li_sort = dtt.from_arrow(sort_src).into_partitions(MESH_SLOTS).collect()
    oracle1 = tpch.oracle_q1(lineitem)
    order = pa.compute.sort_indices(sort_src, [("l_orderkey", "ascending"),
                                               ("l_linenumber", "ascending")])
    want_sort = sort_src.take(order)

    def check_q1(rtol):
        return lambda got: parity(got.to_pydict(), oracle1, rtol)

    def check_q3(got):
        return q3_parity(got.to_pydict(), want3, groups3, RTOL)

    def q3b():
        return q3(parts8["customer"], parts8["orders"], parts8["lineitem"])

    # name -> (frame, config, mesh (None: default_mesh()), check, twin). A leg
    # without a twin is timed: a warm mesh run, a profiled one for its
    # exchange's steps, and a warm NativeRunner run beside them; a leg with
    # one runs once, held to the exchange count of its twin, an earlier timed
    # leg of the same plan
    queries = {
        "q1": (lambda: q1(li_q1.repartition(MESH_SLOTS)), {}, mesh8, check_q1(RTOL), None),
        "q3_hash": (q3b, {"broadcast_join_size_bytes_threshold": 0}, mesh8, check_q3, None),
        "q3_broadcast": (q3b, {}, mesh8, check_q3, None),
        "q3_broadcast_one_slot": (q3b, {}, None, check_q3, "q3_broadcast"),
        "q3_smj": (lambda: q3_smj(parts8["customer"], parts8["orders"], parts8["lineitem"]),
                   {}, mesh8, check_q3, None),
        "sort_x64": (lambda: li_sort.sort([col("l_orderkey"), col("l_linenumber")]),
                     {"device_x64": True}, mesh8,
                     lambda got: got.cast(want_sort.schema).equals(want_sort), None),
        "q1_x64": (lambda: q1(li_q1.repartition(MESH_SLOTS)), {"device_x64": True}, mesh8,
                   check_q1(RTOL_X64), "q1"),
    }
    ctx = dtt.get_context()

    def run(make_df, runner, kw, profiler=None):
        dtt.set_execution_config(config(**kw))
        ctx._runner = runner
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t = time.perf_counter()
        df = make_df()
        if profiler is not None:
            df.stats.profiler = profiler
        df = df.collect()
        got = df.to_arrow()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        return got, secs, launches, df.stats.snapshot()["counters"]

    unarmed = None
    exchanges = {}  # each timed leg's plan's exchanges
    try:
        for name, (make_df, kw, mesh, check, twin) in queries.items():
            timed = twin is None
            runner = MeshRunner(mesh)
            got, cold, launches, c = run(make_df, runner, kw)
            for k, v in launches.items():
                out[f"{k}_launches"] += v
            warm = native = native_cold = profiled = None
            steps_n, steps_ms = 0, {}
            if timed:
                _, warm, _, _ = run(make_df, runner, kw)
                prof = sync_profiler()
                _, profiled, _, _ = run(make_df, runner, kw, profiler=prof)
                steps_n, steps_ms = exchange_steps(prof)
                # the plan's exchanges (the cold run's counters), and its
                # warm time with the host shuffles
                native_runner = NativeRunner()
                _, native_cold, _, nc = run(make_df, native_runner, kw)
                _, native, _, _ = run(make_df, native_runner, kw)
            want_x = exchanges[name] = mesh_exchanges(nc) if timed else exchanges[twin]
            routes_ok = (c.get("device_shuffles", 0) == want_x and want_x >= 1
                         and c.get("shuffles", 0) == 0
                         and c.get("collective_breaker_trips", 0) == 0
                         and c.get("degraded_shuffles", 0) == 0
                         and (not timed or nc.get("device_shuffles", 0) == 0))
            extra = ""
            if name == "q1":
                routes_ok = routes_ok and launches["k1"] == MESH_SLOTS
                extra = f", K1 launches {launches['k1']} (one a partition)"
            elif name == "q3_broadcast":
                unarmed = got
                routes_ok = routes_ok and c.get("broadcast_replications", 0) >= 1
                extra = f", broadcast_replications {c.get('broadcast_replications', 0)}"
            elif name == "q3_smj":
                routes_ok = routes_ok and c.get("device_aligned_smj_exchanges", 0) == 2
                extra = (f", device_aligned_smj_exchanges "
                         f"{c.get('device_aligned_smj_exchanges', 0)}")
            elif name.endswith("x64"):
                routes_ok = routes_ok and launches["k1"] == 0 and launches["k2"] == 0
            routes_ok = routes_ok and (not timed or steps_n == want_x)
            res = {"mesh_cold_s": cold, "mesh_warm_s": warm, "native_cold_s": native_cold,
                   "native_warm_s": native, "device_shuffles": c.get("device_shuffles", 0),
                   "exchange_rows": c.get("exchange_rows", 0), "launches": launches,
                   "profiled_s": profiled, "exchanges_profiled": steps_n,
                   "exchange_ms": steps_ms, "card": card}
            out[name] = res
            ph.check(check(got) and routes_ok,
                     f"SF1 mesh (c) {name} on {'default_mesh()' if mesh is None else 'default_mesh(8)'}"
                     f": rows against the oracle, device_shuffles {res['device_shuffles']} (want "
                     f"{want_x}), launches {launches}{extra}"
                     + (f", {steps_n} exchanges profiled; warm {warm:.3f}s against "
                        f"NativeRunner's warm {native:.3f}s" if timed
                        else f"; cold {cold:.3f}s"))
            print(f"SF1 mesh {name} " + json.dumps(res), flush=True)

        # (d) the collective breaker: every exchange fails, the host takes over
        ph.begin(None)  # the armed leg's own checks read its failure counters
        faults.arm("collective.exchange", "always")
        try:
            got, secs, launches, c = run(q3b, MeshRunner(mesh8),
                                         {"device_breaker_threshold": 1})
        finally:
            faults.disarm()
        a = got.to_pydict()
        ph.check(check_q3(got) and parity(a, unarmed.to_pydict(), RTOL)
                 and c.get("collective_breaker_trips", 0) == 1
                 and c.get("device_shuffles", 0) == 0 and c.get("degraded_shuffles", 0) >= 1
                 and c.get("shuffles", 0) == exchanges["q3_broadcast"],
                 f"SF1 mesh (d) collective.exchange armed, broadcast Q3: its rows equal the "
                 f"unarmed run's at RTOL and q3_parity, collective_breaker_trips "
                 f"{c.get('collective_breaker_trips', 0)}, degraded_shuffles "
                 f"{c.get('degraded_shuffles', 0)}, host shuffles {c.get('shuffles', 0)}, "
                 f"device_shuffles {c.get('device_shuffles', 0)}")
        out["k1_launches"] += launches["k1"]
    finally:
        ctx._runner = None
        dtt.set_execution_config(config())

    # (e) a one-process nccl group over torch.distributed
    from daft_tpu_torch.parallel.multihost import (global_mesh, init_distributed,
                                                   shutdown_distributed)

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    t = time.perf_counter()
    try:
        import torch.distributed as dist

        up = init_distributed(f"localhost:{port}", 1, 0)
        gm = global_mesh()
        x = torch.arange(8, dtype=torch.int32, device="cuda")
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        gathered = [torch.empty(2, dtype=torch.int64, device="cuda")]
        dist.all_gather(gathered, torch.tensor([7, 9], dtype=torch.int64, device="cuda"))
        torch.cuda.synchronize()
        ok = (up and dist.get_backend() == "nccl" and gm.size == torch.cuda.device_count()
              and torch.equal(x, y) and gathered[0].tolist() == [7, 9])
        backend = dist.get_backend()
    finally:
        shutdown_distributed()
    import torch.distributed as dist

    ph.check(ok and not dist.is_initialized(),
             f"SF1 mesh (e) a one-process {backend} group on localhost: global_mesh() "
             f"{gm.size} slot(s), all_to_all_single and all_gather on CUDA tensors, destroyed "
             f"({time.perf_counter() - t:.1f}s)")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 mesh phase 18 wall {out['wall_s']:.1f}s ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 19: object stores, lake tables and Python scan sources
# ---------------------------------------------------------------------------

IO_BLOBS = 300          # phase 19 (f): objects uploaded and downloaded by url
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
              "l_discount", "l_tax", "l_shipdate")


class LoopbackS3:
    """A small S3 endpoint on 127.0.0.1 at a free port, for phase 19:
    path-style GET (with Range) and HEAD, ListObjectsV2 in one page, PUT
    (with put-if-absent), DELETE. An object is bytes or a local file (read
    at the asked range, so a large file is never held whole). Counts the
    body bytes it sends (``sent``). ``stop`` shuts it down."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, unquote, urlsplit

        self.objects = {}   # (bucket, key) -> bytes, or the path of a local file
        self.sent = 0
        lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _parse(self):
                u = urlsplit(self.path)
                bucket, _, key = unquote(u.path).lstrip("/").partition("/")
                return bucket, key, parse_qs(u.query, keep_blank_values=True)

            def _reply(self, status: int, body: bytes = b"", head: bool = False):
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body and not head:
                    self.wfile.write(body)
                    with lock:
                        outer.sent += len(body)

            def _size(self, obj) -> int:
                import os

                return os.path.getsize(obj) if isinstance(obj, str) else len(obj)

            def _serve(self, head: bool):
                bucket, key, q = self._parse()
                if "list-type" in q:
                    prefix = q.get("prefix", [""])[0]
                    items = "".join(
                        f"<Contents><Key>{k}</Key><Size>{self._size(o)}</Size></Contents>"
                        for (b, k), o in sorted(outer.objects.items())
                        if b == bucket and k.startswith(prefix))
                    return self._reply(200, (
                        "<?xml version='1.0'?><ListBucketResult><IsTruncated>false"
                        f"</IsTruncated>{items}</ListBucketResult>").encode())
                obj = outer.objects.get((bucket, key))
                if obj is None:
                    return self._reply(404)
                size = self._size(obj)
                lo, hi, status = 0, size, 200
                rng = self.headers.get("Range")
                if rng and not head:
                    a, b = rng.split("=")[1].split("-")
                    lo, hi, status = int(a), min(int(b) + 1, size), 206
                if head:
                    self.send_response(200)
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    return
                if isinstance(obj, str):
                    with open(obj, "rb") as f:
                        f.seek(lo)
                        body = f.read(hi - lo)
                else:
                    body = obj[lo:hi]
                self._reply(status, body)

            def do_GET(self):
                self._serve(head=False)

            def do_HEAD(self):
                self._serve(head=True)

            def do_PUT(self):
                bucket, key, _q = self._parse()
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                with lock:
                    if (self.headers.get("If-None-Match") == "*"
                            and (bucket, key) in outer.objects):
                        return self._reply(412)
                    outer.objects[(bucket, key)] = body
                self._reply(200)

            def do_DELETE(self):
                bucket, key, _q = self._parse()
                with lock:
                    outer.objects.pop((bucket, key), None)
                self._reply(204)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def delta_over(path: str, root: str) -> None:
    """A Delta table at ``root`` whose one data file is ``path`` (linked,
    not copied): one JSON commit with its add action, as the reference's
    tests/test_catalogs.py ``_write_delta`` writes them."""
    import os

    os.makedirs(f"{root}/_delta_log")
    os.symlink(path, f"{root}/part-00000.parquet")
    with open(f"{root}/_delta_log/{0:020d}.json", "w") as f:
        f.write(json.dumps({"add": {"path": "part-00000.parquet",
                                    "size": os.path.getsize(path),
                                    "partitionValues": {}}}) + "\n")


def iceberg_over(path: str, root: str) -> None:
    """An Iceberg v2 table at ``root`` whose one data file is ``path``
    (linked, not copied): its manifest and manifest list encoded by the
    port's avro codec, the metadata json and the version hint (the hadoop
    catalog's layout, as tests/test_catalogs.py ``_build_iceberg`` builds
    it)."""
    import os

    import pyarrow.parquet as papq

    from daft_tpu_torch.io.avro import write_avro_file
    from daft_tpu_torch.io.catalogs import _MANIFEST_ENTRY_SCHEMA, _MANIFEST_LIST_SCHEMA

    for d in ("metadata", "data"):
        os.makedirs(f"{root}/{d}")
    os.symlink(path, f"{root}/data/f0.parquet")
    write_avro_file(f"{root}/metadata/m0.avro", _MANIFEST_ENTRY_SCHEMA, [{
        "status": 1, "snapshot_id": 1,
        "data_file": {"content": 0, "file_path": f"file://{root}/data/f0.parquet",
                      "file_format": "PARQUET", "partition": {},
                      "record_count": papq.read_metadata(path).num_rows,
                      "file_size_in_bytes": os.path.getsize(path)}}])
    write_avro_file(f"{root}/metadata/snap-1.avro", _MANIFEST_LIST_SCHEMA, [{
        "manifest_path": f"file://{root}/metadata/m0.avro",
        "manifest_length": os.path.getsize(f"{root}/metadata/m0.avro"),
        "partition_spec_id": 0, "content": 0, "added_snapshot_id": 1}])
    meta = {"format-version": 2, "table-uuid": "0", "location": root,
            "current-snapshot-id": 1,
            "snapshots": [{"snapshot-id": 1, "timestamp-ms": 0,
                           "manifest-list": f"file://{root}/metadata/snap-1.avro"}],
            "schemas": [{"schema-id": 0, "type": "struct", "fields": []}],
            "current-schema-id": 0, "partition-specs": [{"spec-id": 0, "fields": []}]}
    with open(f"{root}/metadata/v1.metadata.json", "w") as f:
        json.dump(meta, f)
    with open(f"{root}/metadata/version-hint.text", "w") as f:
        f.write("1")


def row_group_operator(path: str):
    """A ScanOperator whose factories read one row group each of the parquet
    file at ``path`` (the columns the engine asks for)."""
    import pyarrow.parquet as papq

    from daft_tpu_torch.io.pyscan import FactoryScanTask, ScanOperator
    from daft_tpu_torch.schema import Schema

    md = papq.read_metadata(path)
    schema = Schema.from_arrow(papq.read_schema(path))

    class RowGroups(ScanOperator):
        def schema(self):
            return schema

        def can_absorb_select(self):
            return True

        def to_scan_tasks(self, pushdowns):
            for i in range(md.num_row_groups):
                def factory(pd, i=i):
                    return papq.ParquetFile(path).read_row_group(i, columns=pd.columns)

                yield FactoryScanTask(factory, schema, pushdowns,
                                      num_rows=md.row_group(i).num_rows,
                                      size_bytes=md.row_group(i).total_byte_size,
                                      label=f"{path}#row-group-{i}")

    return RowGroups()


def phase_io(ph: Phases, files: ParquetFiles, lineitem, oracles: dict, card: str) -> dict:
    """Phase 19: object stores, lake tables and Python scan sources around K1
    and K2, at SF1, over phase 12's file of phase 4's lineitem (``lineitem``:
    6 M rows, its 16 columns in 8 row groups; linked, never rewritten), Q1's
    and Q6's oracles given (phase 15's): (a) a Delta log over it read
    with read_deltalake, (b) an Iceberg table over it whose manifests the
    port's avro codec wrote, read with read_iceberg, and (c) the file served
    by a loopback S3 endpoint (LoopbackS3) and read with
    read_parquet("s3://.../*.parquet"): each with composed Q1 (K1), deep Q1
    (K2) and Q6 (K1) against the pyarrow oracle at rtol 1e-6, cold and warm
    once; (c) also holds the bytes the endpoint sent for Q1 under the file's
    size (ranged reads of 7 of its 16 columns), and reads Q1 again with io.get
    armed once (one retry, the same rows). (d) write_deltalake and
    write_iceberg of Q1's seven columns, each read back through Q1; (e) a
    ScanOperator of the file's row groups through Q1; (f) IO_BLOBS objects
    put with url.upload to the endpoint and fetched back with url.download,
    equal to the bytes put. Each query counts K1's, K2's and the scatter
    kernel's launches from 0 just before it."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as papq
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch import col, faults
    from daft_tpu_torch.io import IO_STATS
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}
    t_phase = time.perf_counter()
    li_path = files.path("lineitem")
    file_bytes = os.path.getsize(li_path)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    s3 = LoopbackS3()
    saved_env = {k: os.environ.get(k) for k in ("AWS_ENDPOINT_URL", "AWS_ACCESS_KEY_ID",
                                                "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN")}
    os.environ["AWS_ENDPOINT_URL"] = s3.endpoint  # every s3:// path of the phase goes there
    for k in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN"):
        os.environ.pop(k, None)

    def driven(build):
        """One driven query: (rows, seconds, launches, counters)."""
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        t0 = time.perf_counter()
        df = build().collect()
        rows = df.to_pydict()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
        for k, v in launches.items():
            out[f"{k}_launches"] += v
        return rows, secs, launches, df.stats.snapshot()["counters"]

    def leg(label: str, build, want: dict, kernel: str, warm: bool = True) -> dict:
        rows, cold, launches, c = driven(build)
        ph.check(parity(rows, want, RTOL), f"{label}: matches the pyarrow oracle at rtol {RTOL}")
        ph.check(launches[kernel] >= 1 and c.get("device_aggregations", 0) >= 1
                 and c.get("device_agg_fallbacks", 0) == 0,
                 f"{label}: aggregated on the card through {kernel.upper()} ({launches})")
        res = {"cold_s": cold, "launches": launches}
        if warm:
            rows, res["warm_s"], launches, _ = driven(build)
            res["warm_launches"] = launches
            ph.check(parity(rows, want, RTOL), f"{label}: the warm run matches too")
        print(f"{label} " + json.dumps({**res, "card": card}), flush=True)
        return res

    one_task = 1 << 40  # scan_tasks_min_size_bytes: the file's row groups in one task
    try:
        # --- (a), (b), (c): the same file through three readers
        delta_over(li_path, f"{tmp}/delta")
        iceberg_over(li_path, f"{tmp}/iceberg")
        s3.objects[("lake", "lineitem/part-00000.parquet")] = li_path
        readers = {
            "delta": lambda: dtt.read_deltalake(f"{tmp}/delta"),
            "iceberg": lambda: dtt.read_iceberg(f"{tmp}/iceberg"),
            "s3": lambda: dtt.read_parquet("s3://lake/lineitem/*.parquet", _split_row_groups=True),
        }
        for source, read in readers.items():
            for name, query, deep in (("q1", q1, False), ("q1", q1, True), ("q6", q6, False)):
                dtt.set_execution_config(config(use_deep_fusion_kernel=deep,
                                                scan_tasks_min_size_bytes=one_task))
                label = f"SF1 io {source} {name} {'deep' if deep else 'composed'}"
                sent0 = s3.sent
                IO_STATS.reset()
                res = leg(label, lambda query=query, read=read: query(read()), oracles[name],
                          "k2" if deep else "k1")
                out[label[len("SF1 io "):]] = res
                if source == "s3" and name == "q1" and not deep:
                    sent = (s3.sent - sent0) / 2  # a run: the leg ran cold and warm
                    ph.check(0 < sent < file_bytes and IO_STATS.snapshot()["retries"] == 0,
                             f"{label}: the endpoint sent {sent / 1e6:.1f} MB a run, under "
                             f"the file's {file_bytes / 1e6:.1f} MB (ranged reads of "
                             f"{SCAN_COLUMNS['q1']} of its {lineitem.num_columns} columns), "
                             f"no retry")
                    res["sent_bytes"] = sent
        # io.get armed once under S3 Q1: one retry, the same rows
        dtt.set_execution_config(config(scan_tasks_min_size_bytes=one_task))
        IO_STATS.reset()
        faults.arm("io.get", "first_n", n=1)
        try:
            rows, secs, launches, _ = driven(lambda: q1(readers["s3"]()))
            injected = faults.snapshot()["injected"].get("io.get", 0)
        finally:
            faults.disarm()
        retries = IO_STATS.snapshot()["retries"]
        ph.check(injected == 1 and retries == 1 and parity(rows, oracles["q1"], RTOL)
                 and launches["k1"] >= 1,
                 f"SF1 io s3 q1 with io.get armed once: {retries} retry, the oracle's rows, "
                 f"K1 launches {launches['k1']} ({secs:.2f}s)")

        # --- (d) the lake writers, each read back through Q1
        q1_table = lineitem.select(list(Q1_COLUMNS))
        dtt.set_execution_config(config())
        for fmt in ("deltalake", "iceberg"):
            uri = f"{tmp}/written_{fmt}"
            t0 = time.perf_counter()
            written = getattr(dtt.from_arrow(q1_table), f"write_{fmt}")(uri).to_pydict()["path"]
            write_s = time.perf_counter() - t0
            read = getattr(dtt, f"read_{fmt}")
            res = leg(f"SF1 io write_{fmt} q1", lambda read=read, uri=uri: q1(read(uri)),
                      oracles["q1"], "k1")
            res.update(write_s=write_s, files=len(written))
            ph.check(len(written) == 1, f"SF1 io write_{fmt}: {len(written)} data file of "
                                        f"{q1_table.num_rows} rows in {write_s:.2f}s")
            out[f"write_{fmt}"] = res

        # --- (e) a ScanOperator of the file's row groups
        op = row_group_operator(li_path)
        out["scan_operator q1"] = leg("SF1 io scan operator q1",
                                      lambda: q1(dtt.from_scan_operator(op)), oracles["q1"], "k1")

        # --- (f) url.upload then url.download through the endpoint
        rng = np.random.RandomState(19)
        blobs = [rng.bytes(int(n)) for n in rng.randint(512, 4096, IO_BLOBS)]
        frame = dtt.from_pydict({"data": pa.array(blobs, pa.binary())})
        t0 = time.perf_counter()
        paths = frame.select(col("data").url.upload("s3://blobs/up").alias("p")).to_pydict()["p"]
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = dtt.from_pydict({"u": paths}).select(
            col("u").url.download().alias("d")).to_pydict()["d"]
        down_s = time.perf_counter() - t0
        ph.check(got == blobs and len(set(paths)) == IO_BLOBS,
                 f"SF1 io url: {IO_BLOBS} objects uploaded ({up_s:.2f}s) and downloaded "
                 f"({down_s:.2f}s) equal to the bytes put")
        out["url"] = {"objects": IO_BLOBS, "upload_s": up_s, "download_s": down_s}
    finally:
        s3.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 io phase 19 wall {out['wall_s']:.1f}s, launches K1 {out['k1_launches']} K2 "
          f"{out['k2_launches']} scatter {out['scatter_launches']} ({card})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: approximate aggregations (K9, the register merge) and images (K11)
# ---------------------------------------------------------------------------

SKETCH_PARTS = 8         # phase 20 (b)-(e): into_partitions(8) of SF1 lineitem
K11_IMAGES = 4096        # phase 20 (f): RGB 256 x 256 images resized to 224 x 224
K11_PARTS = 4
K11_PLAIN_IMAGES = 512   # (f)'s subset held against the plain version on the CPU
LAION_IMAGES = 2048      # phase 20 (g): JPEGs served on 127.0.0.1
LAION_PLAIN_IMAGES = 256
H100_FP64_TC_FLOPS = 67e12  # fp64 on the tensor cores, H100 SXM data sheet


# an HLL estimate's relative gap to the exact count is held to three standard
# errors (3 x 1.04/sqrt(16384), 2.44 %): two (1.63 %) is a 95 % band, and SF1's
# l_orderkey lands past it in both packages (1.88 % by flag and status, 2.05 %
# globally; the reference's registers are the same bit for bit), as 20 other
# 64-bit mixes of SF1's l_orderkey, l_partkey and l_suppkey reach up to 1.98 %
# (tools/hll_spread.py)
HLL_SIGMAS = 3


def _hll_bound(rel_gap: float) -> bool:
    from daft_tpu_torch.sketch import HLL_STANDARD_ERROR

    return rel_gap <= HLL_SIGMAS * HLL_STANDARD_ERROR


def dashboard(frame, col):
    """Phase 20 (b): per (l_returnflag, l_linestatus) the sums and count of
    Q1's dashboard joined to the approximate distinct orders, parts and
    suppliers."""
    keys = ["l_returnflag", "l_linestatus"]
    sums = frame.groupby(*keys).agg(col("l_quantity").sum().alias("sum_qty"),
                                    col("l_extendedprice").sum().alias("sum_price"),
                                    col("l_quantity").count().alias("count_order"))
    return sums.join(distincts(frame, col), on=keys).sort(keys)


def distincts(frame, col):
    return frame.groupby("l_returnflag", "l_linestatus").agg(
        col("l_orderkey").approx_count_distinct().alias("orders"),
        col("l_partkey").approx_count_distinct().alias("parts"),
        col("l_suppkey").approx_count_distinct().alias("suppliers"))


def phase_sketch_image(ph: Phases, tables: dict, card: str) -> dict:
    """Phase 20: the approximate aggregations and the images, in the 32-bit
    mode over phase 7's SF1 tables (generate_tables(1.0, seed=42)), each leg
    cold and, where it prints a warm time, warm once.
    (a) K9 alone at the operands of approx_count_distinct(l_orderkey) by
    (l_shipmode, l_returnflag) (21 groups, 344,064 slots): equal to the host
    build_grouped_registers bit for bit; CUDA events, 20 launches.
    (b) the dashboard over into_partitions(8): the sums through K1 (one
    launch a partition) at RTOL against pyarrow, the distinct side's stage 1
    all HLL (K9 on every partition, device_sketch_builds 8), its estimates
    equal to the host path's (use_device_kernels=False) and within
    HLL_SIGMAS x 1.04/sqrt(16384) of pyarrow's exact count_distinct, the
    sketch side's exchange_rows at most partitions x groups.
    (c) approx_percentiles(l_extendedprice, [0.5, 0.9, 0.99]) by l_shipmode
    over 8 partitions (stage 1 on the host): each group's rank error within
    1/4096 against numpy's exact ranks, equal to the host path's on one
    thread (on the pool the host path builds stage 1 a morsel, and a
    quantile merge of more pieces compresses differently, within its rank
    error).
    (d) MeshRunner on default_mesh(8): a global approx_count_distinct of
    l_orderkey over repartition(8), collective_sketch_merges 1 and the
    register merge once on the card, equal to NativeRunner's estimate.
    (e) faults (outside the zero-failure checks): device.kernel armed once
    at a K9 launch (device_sketch_builds 7, the same estimates),
    collective.sketch armed (the host merge, the same estimate), sketch.merge
    armed first_n 1 (DaftTransientError, the ledger back at 0, then the same
    rows from a fresh run, one injection).
    (f) K11: 4,096 seeded RGB 256 x 256 images in a FixedShapeImage column
    over 4 partitions, image.resize(224, 224), then a cast to
    tensor(uint8, (224, 224, 3)): one K11 launch a partition, the first 512
    images within one count of the plain version on the CPU; an RGB16
    variable-shape batch (64 images, one launch each) within one count and
    an RGB32F fixed batch (256 images, 128 -> 64) within rtol 1e-5 of the
    CPU; one full chunk (2,048 images) timed by CUDA events.
    (g) where PIL imports: 2,048 JPEGs (benchmarks/laion.make_jpegs, encoded
    on a thread of their own from the start of the phase) served on
    127.0.0.1, url.download -> image.decode(mode="RGB") -> the fixed
    shape -> resize(224, 224) -> tensor, the first 256 within one count of
    the same pipeline on the CPU."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch

    import daft_tpu_torch as dtt
    from daft_tpu_torch import DataType, Series, col, faults, multimodal as mm
    from daft_tpu_torch.errors import DaftTransientError
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss
    from daft_tpu_torch.parallel import collectives as coll
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.runners import MeshRunner, NativeRunner
    from daft_tpu_torch.sketch import HLL_M, device as k9, hll
    from daft_tpu_torch.spill import MEMORY_LEDGER
    from daft_tpu_torch.table import Table, _group_codes

    t_phase = time.perf_counter()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "k9_launches": 0,
           "k11_launches": 0, "merge_launches": 0, "card": card}
    dtt.set_execution_config(config())
    dev = torch.device(dtt.get_context().execution_config.device)
    li = tables["lineitem"]
    try:  # (g)'s JPEGs are encoded on a thread of their own while (a)-(f) run
        import PIL  # noqa: F401

        import concurrent.futures

        from benchmarks import laion

        jpeg_pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="phase20-jpegs")
        jpegs = jpeg_pool.submit(laion.make_jpegs, LAION_IMAGES, 256, 0)
        jpeg_pool.shutdown(wait=False)
    except ImportError:
        jpegs = None

    def zero():
        ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
        k9.LAUNCHES = mm.LAUNCHES = coll.REGISTER_MERGE_LAUNCHES = 0

    def launches():
        return {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES,
                "k9": k9.LAUNCHES, "k11": mm.LAUNCHES,
                "merge": coll.REGISTER_MERGE_LAUNCHES}

    def count(launch):
        for k in ("k1", "k2", "scatter", "k9", "k11", "merge"):
            out[f"{k}_launches"] += launch[k]

    def run(make_df, **kw):
        """make_df() collected under config(**kw): (dict, seconds, launches,
        counters)."""
        dtt.set_execution_config(config(**kw))
        zero()
        t = time.perf_counter()
        df = make_df().collect()
        got = df.to_pydict()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return got, secs, launches(), df.stats.snapshot()["counters"]

    # (a) K9 alone at the operands of the distinct count by ship mode and flag
    key_tbl = Table.from_arrow(li.select(["l_shipmode", "l_returnflag"]))
    codes, uniq = _group_codes(key_tbl)
    g = len(uniq)
    okey = li.column("l_orderkey")
    gcodes, idx, rank = hll.scatter_operands(okey, codes)
    t = time.perf_counter()
    host = hll.build_grouped_registers(okey, codes, g)
    plain_s = time.perf_counter() - t
    total = g * HLL_M
    seg, rk = k9.stage_operands(gcodes, idx, rank, dev)  # as the engine stages them
    regs = k9.register_scatter(seg, rk, total)
    got_regs = regs.cpu().numpy().reshape(g, HLL_M)
    same = np.array_equal(got_regs, host)
    k9_ms = cuda_ms(lambda: k9.register_scatter(seg, rk, total), iters=20)
    # the library call on the same staged operands, with K9's casts
    lib_ms = cuda_ms(lambda: torch.zeros(total, dtype=torch.int32, device=dev).index_reduce_(
        0, seg.to(torch.int64), rk.to(torch.int32), "amax").to(torch.uint8), iters=20)
    n_rows = int(seg.shape[0])
    k9_entry = {"name": "hll_register_scatter", "route": "torch",
                "source": "daft_tpu_torch/sketch/device.py",
                "replaces": "daft_tpu/sketch/device.py:27",
                "max_abs_err": int(np.abs(got_regs.astype(np.int16) - host).max()),
                "ms": k9_ms, "plain_ms": plain_s * 1e3,
                **bound(n_rows * (4 + 1) + total, 0), "library_ms": lib_ms,
                "rows": n_rows, "groups": g, "slots": total, "card": card}
    k9_entry["x_bound"] = k9_ms / k9_entry["bound_ms"]
    ph.check(same and g == 21 and total == 344_064,
             f"SF1 sketch (a) K9 over {n_rows} rows into {g} groups x {HLL_M} = {total} slots: "
             f"equal to the host build bit for bit; {k9_ms:.4f} ms a launch against a "
             f"{k9_entry['bound_ms']:.4f} ms bound (index_reduce_ {lib_ms:.4f} ms, the host "
             f"build {plain_s * 1e3:.1f} ms)")
    print("SF1 sketch K9 " + json.dumps(k9_entry), flush=True)
    del seg, rk, regs, host, got_regs, gcodes, idx, rank, codes

    # (b) the dashboard over 8 partitions: K1 beside K9
    li8 = dtt.from_arrow(li.select(["l_returnflag", "l_linestatus", "l_quantity",
                                    "l_extendedprice", "l_orderkey", "l_partkey",
                                    "l_suppkey", "l_shipmode"])
                         ).into_partitions(SKETCH_PARTS).collect()
    keys = ["l_returnflag", "l_linestatus"]
    exact = li.group_by(keys).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"), ("l_quantity", "count"),
        ("l_orderkey", "count_distinct"), ("l_partkey", "count_distinct"),
        ("l_suppkey", "count_distinct")]).sort_by([(k, "ascending") for k in keys]).to_pydict()
    got, cold, launch, c = run(lambda: dashboard(li8, col))
    count(launch)
    _, warm, _, _ = run(lambda: dashboard(li8, col))
    host_got, host_s, _, hc = run(lambda: dashboard(li8, col), use_device_kernels=False)
    groups = len(exact["l_returnflag"])
    sums_ok = (got["l_returnflag"] == exact["l_returnflag"]
               and got["l_linestatus"] == exact["l_linestatus"]
               and parity({"q": got["sum_qty"], "p": got["sum_price"]},
                          {"q": exact["l_quantity_sum"], "p": exact["l_extendedprice_sum"]}, RTOL)
               and got["count_order"] == exact["l_quantity_count"])
    gaps = {}
    for name, src in (("orders", "l_orderkey"), ("parts", "l_partkey"), ("suppliers", "l_suppkey")):
        want = np.asarray(exact[f"{src}_count_distinct"], dtype=np.float64)
        gaps[name] = float(np.max(np.abs(np.asarray(got[name], dtype=np.float64) - want) / want))
    est_equal = all(got[k] == host_got[k] for k in ("orders", "parts", "suppliers"))
    routes = {"device_sketch_builds": c.get("device_sketch_builds", 0),
              "device_sketch_fallbacks": c.get("device_sketch_fallbacks", 0),
              "k1": launch["k1"], "k9": launch["k9"],
              "host_device_sketch_builds": hc.get("device_sketch_builds", 0)}
    out["dashboard"] = {"cold_s": cold, "warm_s": warm, "host_path_s": host_s,
                        "rel_gaps": gaps, "routes": routes, "launches": launch, "card": card}
    ph.check(sums_ok and est_equal and all(_hll_bound(v) for v in gaps.values())
             and routes["device_sketch_builds"] == SKETCH_PARTS
             and routes["device_sketch_fallbacks"] == 0 and launch["k1"] == SKETCH_PARTS
             and launch["k9"] == 3 * SKETCH_PARTS
             and routes["host_device_sketch_builds"] == 0,
             f"SF1 sketch (b) the dashboard over {SKETCH_PARTS} partitions: sums at RTOL "
             f"against pyarrow, estimates equal to the host path's and within "
             f"{max(gaps.values()):.4%} of pyarrow's exact count_distinct ({HLL_SIGMAS} "
             f"standard errors: {HLL_SIGMAS * 1.04 / 128:.4%}), routes {routes}; "
             f"cold {cold:.3f}s, warm {warm:.3f}s (host path {host_s:.3f}s)")
    print("SF1 sketch dashboard " + json.dumps(out["dashboard"]), flush=True)

    # (c) approx_percentiles by ship mode, stage 1 on the host
    qs = [0.5, 0.9, 0.99]

    def pct():
        return li8.groupby("l_shipmode").agg(
            col("l_extendedprice").approx_percentiles(qs).alias("p")).sort("l_shipmode")

    pgot, pcold, launch, _ = run(pct)
    count(launch)
    _, pwarm, _, _ = run(pct)
    phost, _, _, _ = run(pct, use_device_kernels=False, **ONE_THREAD)
    prices = li.column("l_extendedprice").to_numpy()
    modes = np.asarray(li.column("l_shipmode").to_pylist(), dtype=object)
    worst = 0.0
    for m, ests in zip(pgot["l_shipmode"], pgot["p"]):
        v = np.sort(prices[modes == m])
        for q, e in zip(qs, ests):
            worst = max(worst, abs(np.searchsorted(v, e) / len(v) - q))
    out["percentiles"] = {"cold_s": pcold, "warm_s": pwarm, "worst_rank_error": worst,
                          "groups": len(pgot["l_shipmode"]), "card": card}
    ph.check(pgot == phost and worst <= 1.0 / 4096 and len(pgot["l_shipmode"]) == 7,
             f"SF1 sketch (c) approx_percentiles({qs}) of l_extendedprice by l_shipmode over "
             f"{SKETCH_PARTS} partitions: equal to the host path's on one thread, the worst "
             f"rank error "
             f"{worst * 4096:.3f}/4096; cold {pcold:.3f}s, warm {pwarm:.3f}s")

    # (d) the mesh's register merge
    ok_frame = dtt.from_arrow(li.select(["l_orderkey"])).collect()
    ctx = dtt.get_context()

    def global_distinct():
        return ok_frame.repartition(SKETCH_PARTS).agg(
            col("l_orderkey").approx_count_distinct().alias("orders"))

    mesh8 = default_mesh(SKETCH_PARTS)
    try:
        ctx._runner = MeshRunner(mesh8)
        mgot, mcold, mlaunch, mc = run(global_distinct)
        count(mlaunch)
        _, mwarm, _, _ = run(global_distinct)
        ctx._runner = NativeRunner()
        ngot, _, _, _ = run(global_distinct)
    finally:
        ctx._runner = None
    exact_orders = len(pc.unique(li.column("l_orderkey")))
    mgap = abs(mgot["orders"][0] - exact_orders) / exact_orders
    out["mesh"] = {"cold_s": mcold, "warm_s": mwarm, "launches": mlaunch,
                   "collective_sketch_merges": mc.get("collective_sketch_merges", 0),
                   "device_shuffles": mc.get("device_shuffles", 0), "rel_gap": mgap,
                   "card": card}
    ph.check(mgot == ngot and mc.get("collective_sketch_merges", 0) == 1
             and mlaunch["merge"] == 1 and mlaunch["k9"] == SKETCH_PARTS
             and mc.get("device_shuffles", 0) == 1 and _hll_bound(mgap),
             f"SF1 sketch (d) MeshRunner on default_mesh({SKETCH_PARTS}): global "
             f"approx_count_distinct(l_orderkey) over repartition({SKETCH_PARTS}) "
             f"{mgot['orders'][0]} equal to NativeRunner's, {mgap:.4%} from the exact "
             f"{exact_orders}, collective_sketch_merges {out['mesh']['collective_sketch_merges']}, "
             f"launches {mlaunch}; cold {mcold:.3f}s, warm {mwarm:.3f}s")
    # the register merge alone, at the mesh's shape (one row a slot)
    rng = np.random.RandomState(20)
    rows_np = rng.randint(0, 30, (SKETCH_PARTS, HLL_M)).astype(np.uint8)
    rows = [torch.from_numpy(r).to(d) for r, d in zip(rows_np, mesh8.devices)]
    merge = coll.build_register_allmerge(mesh8, HLL_M)
    merged = merge(rows).cpu().numpy()
    t = time.perf_counter()
    want_rows = rows_np.max(axis=0)
    merge_plain_ms = (time.perf_counter() - t) * 1e3
    stacked = torch.stack(rows)
    merge_entry = {"name": "register_allmerge", "route": "torch",
                   "source": "daft_tpu_torch/parallel/collectives.py",
                   "replaces": "daft_tpu/parallel/collectives.py:196",
                   "max_abs_err": int(np.abs(merged.astype(np.int16) - want_rows).max()),
                   "ms": cuda_ms(lambda: merge(rows), iters=20), "plain_ms": merge_plain_ms,
                   **bound(SKETCH_PARTS * HLL_M + HLL_M, SKETCH_PARTS * HLL_M),
                   "library_ms": cuda_ms(lambda: stacked.max(dim=0).values, iters=20),
                   "slots": SKETCH_PARTS, "card": card}
    merge_entry["x_bound"] = merge_entry["ms"] / merge_entry["bound_ms"]
    ph.check(np.array_equal(merged, want_rows),
             f"SF1 sketch (d) the register merge of {SKETCH_PARTS} rows of {HLL_M}: equal to "
             f"numpy's max; {merge_entry['ms']:.4f} ms against a "
             f"{merge_entry['bound_ms']:.6f} ms bound")

    # (e) faults: each site armed, its own counters held
    ph.begin(None)
    want_d = {k: got[k] for k in ("orders", "parts", "suppliers")}
    with faults.inject("device.kernel", "first_n", n=1):
        fgot, _, flaunch, fc = run(lambda: distincts(li8, col).sort(keys))
    count(flaunch)
    ph.check({k: fgot[k] for k in want_d} == want_d
             and fc.get("device_sketch_builds", 0) == SKETCH_PARTS - 1
             and fc.get("device_attempt_failures", 0) == 1 and fc.get("faults_injected", 0) == 1,
             f"SF1 sketch (e) device.kernel armed once: the distinct side's estimates equal "
             f"(b)'s, device_sketch_builds {fc.get('device_sketch_builds', 0)}, "
             f"device_attempt_failures {fc.get('device_attempt_failures', 0)}, K9 launches "
             f"{flaunch['k9']}")
    try:
        ctx._runner = MeshRunner(mesh8)
        with faults.inject("collective.sketch", "always"):
            cgot, _, claunch, cc = run(global_distinct)
    finally:
        ctx._runner = None
    count(claunch)
    ph.check(cgot == ngot and cc.get("collective_sketch_merges", 0) == 0
             and claunch["merge"] == 0,
             f"SF1 sketch (e) collective.sketch armed: the host merge gives the same estimate "
             f"{cgot['orders'][0]}, collective_sketch_merges "
             f"{cc.get('collective_sketch_merges', 0)}")
    raised = False
    with faults.inject("sketch.merge", "first_n", n=1):
        dtt.set_execution_config(config())
        try:
            distincts(li8, col).collect()
        except DaftTransientError:
            raised = True
        held = MEMORY_LEDGER.current  # the failed fold's staged pieces released
        again, _, alaunch, ac = run(lambda: distincts(li8, col))
        injected = faults.snapshot()["injected"].get("sketch.merge", 0)
    count(alaunch)
    order = sorted(range(len(again["orders"])),
                   key=lambda i: (again["l_returnflag"][i], again["l_linestatus"][i]))
    xrows = ac.get("exchange_rows", 0)
    out["dashboard"]["routes"]["sketch_exchange_rows"] = xrows
    ph.check(raised and {k: [again[k][i] for i in order] for k in want_d} == want_d
             and injected == 1 and ac.get("device_sketch_builds", 0) == SKETCH_PARTS
             and xrows <= SKETCH_PARTS * groups and held == 0,
             f"SF1 sketch (e) sketch.merge armed first_n 1: DaftTransientError "
             f"{'raised' if raised else 'NOT raised'}, the ledger at {held} after it, a fresh "
             f"run gives (b)'s estimates "
             f"with exchange_rows {xrows} (at most partitions x groups, "
             f"{SKETCH_PARTS * groups}), {injected} injection")
    ph.begin("phase 20")

    # (f) K11 over 4,096 RGB 256 x 256 images
    rng = np.random.RandomState(11)
    side, size = 256, 224
    per = side * side * 3
    flat = np.frombuffer(rng.bytes(K11_IMAGES * per), dtype=np.uint8)
    imgs = flat.reshape(K11_IMAGES, side, side, 3)
    fsl = pa.FixedSizeListArray.from_arrays(pa.array(flat), per)
    frame = dtt.from_pydict({"img": Series.from_arrow(
        fsl, "img", DataType.image("RGB", side, side))}).into_partitions(K11_PARTS).collect()

    def laion_tail(df, src):
        return (df.select(col(src).image.resize(size, size).alias("r"))
                .select(col("r").cast(DataType.tensor(DataType.uint8(), (size, size, 3)))
                        .alias("t")))

    def tensors(d):
        return np.stack(d["t"]) if isinstance(d["t"], list) else d["t"]

    def run_images(make_df, **kw):
        dtt.set_execution_config(config(**kw))
        zero()
        t = time.perf_counter()
        df = make_df().collect()
        arr = df.to_table().get_column("t").to_numpy()
        torch.cuda.synchronize()
        return np.stack(arr) if arr.dtype == object else arr, time.perf_counter() - t, launches()

    card_out, fcold, flaunch = run_images(lambda: laion_tail(frame, "img"))
    count(flaunch)
    t = time.perf_counter()
    plain = mm._resize_batch(imgs[:K11_PLAIN_IMAGES], size, size, "cpu")
    plain_s = time.perf_counter() - t
    diff = np.abs(card_out[:K11_PLAIN_IMAGES].astype(np.int16) - plain.astype(np.int16))
    share = float((diff > 0).mean())
    # RGB16 variable shapes (one launch a row) and RGB32F fixed, card against CPU
    shapes = [(int(h), int(w)) for h, w in rng.randint(20, 90, (64, 2))]
    a16 = [rng.randint(0, 65536, (h, w, 3)).astype(np.uint16) for h, w in shapes]
    s16 = mm.image_series_from_arrays(a16, "i16")
    a32 = rng.rand(256, 128, 128, 3).astype(np.float32)
    s32 = Series.from_arrow(pa.FixedSizeListArray.from_arrays(pa.array(a32.reshape(-1)),
                                                              128 * 128 * 3),
                            "f32", DataType.image("RGB32F", 128, 128))
    dtt.set_execution_config(config())
    zero()
    r16 = mm.image_series_to_arrays(mm.image_resize(s16, 48, 40))
    r32 = np.stack(mm.image_series_to_arrays(mm.image_resize(s32, 64, 64)))
    hb_launch = launches()
    count(hb_launch)
    dtt.set_execution_config(config(device="cpu"))
    c16 = mm.image_series_to_arrays(mm.image_resize(s16, 48, 40))
    c32 = np.stack(mm.image_series_to_arrays(mm.image_resize(s32, 64, 64)))
    dtt.set_execution_config(config())
    d16 = max(int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max()) for x, y in zip(r16, c16))
    ok32 = bool(np.allclose(r32, c32, rtol=1e-5, atol=1e-6))
    # one full chunk on the card, its bound, the library call
    chunk = min(mm._RESIZE_CHUNK, K11_IMAGES)
    piece = torch.from_numpy(np.require(imgs[:chunk], requirements=["C", "W"])).to(dev)
    wh = torch.from_numpy(mm._resize_weight_mat(side, size)).to(dev, torch.float64)
    ww = wh
    k11_ms = cuda_ms(lambda: mm.resize_chunk(piece, wh, ww, None, 0, 255), iters=3, warmup=1)
    xf = piece.permute(0, 3, 1, 2).float().contiguous()
    lib_ms = cuda_ms(lambda: torch.nn.functional.interpolate(
        xf, size=(size, size), mode="bilinear", antialias=True, align_corners=False),
        iters=3, warmup=1)
    # the work the resize needs: each output reads only the nonzero taps of
    # its weight row (2-3 here), where the dense einsum runs all `side` of
    # them; the pixels read and written once as uint8
    taps = int(np.count_nonzero(mm._resize_weight_mat(side, size)))
    macs = chunk * 3 * (taps * side + size * taps)
    dense_macs = chunk * 3 * (size * side * side + size * size * side)
    k11_entry = {"name": "bilinear_resize", "route": "torch",
                 "source": "daft_tpu_torch/multimodal.py",
                 "replaces": "daft_tpu/multimodal.py:323",
                 "max_abs_err": int(diff.max()), "ms": k11_ms, "images": chunk,
                 "plain_ms": plain_s * 1e3, "plain_images": K11_PLAIN_IMAGES,
                 **bound(chunk * per + chunk * size * size * 3 + 2 * taps * 4,
                         2 * macs, H100_FP64_TC_FLOPS),
                 "library_ms": lib_ms, "taps": taps, "dense_over_needed": dense_macs / macs,
                 "card": card}
    k11_entry["x_bound"] = k11_ms / k11_entry["bound_ms"]
    del piece, xf
    torch.cuda.empty_cache()
    out["k11"] = {"cold_s": fcold, "launches": flaunch,
                  "differing_pixel_share": share, "rgb16_max_diff": d16,
                  "rgb16_launches": hb_launch["k11"], "card": card}
    ph.check(card_out.shape == (K11_IMAGES, size, size, 3) and int(diff.max()) <= 1
             and flaunch["k11"] == K11_PARTS,
             f"SF1 image (f) {K11_IMAGES} RGB {side}x{side} images over {K11_PARTS} "
             f"partitions, resize({size}, {size}) then a tensor cast: K11 launches "
             f"{flaunch['k11']}, the first {K11_PLAIN_IMAGES} within {int(diff.max())} count "
             f"of the CPU plain version ({share:.3%} of pixels differ); cold {fcold:.3f}s")
    ph.check(d16 <= 1 and ok32 and hb_launch["k11"] == len(a16) + 1,
             f"SF1 image (f) RGB16 variable shapes ({len(a16)} images, {hb_launch['k11'] - 1} "
             f"launches) within {d16} count and RGB32F fixed (256 images, 128 -> 64) within "
             f"rtol 1e-5 of the CPU")
    ph.check(k11_ms > 0,
             f"SF1 image (f) one K11 chunk of {chunk} images: {k11_ms:.3f} ms against a "
             f"{k11_entry['bound_ms']:.3f} ms bound ({k11_entry['bound_by']}: uint8 in and "
             f"out, {taps / size:.2f} nonzero taps an output a pass at the fp64 tensor-core "
             f"rate; the dense einsums do {dense_macs / macs:.0f}x those operations), "
             f"interpolate(antialias) {lib_ms:.3f} ms")
    print("SF1 image K11 " + json.dumps(k11_entry), flush=True)
    del frame, fsl, flat, imgs, card_out, plain

    # (g) the LAION pipeline, where PIL imports
    print(json.dumps({"pil": jpegs is not None}), flush=True)
    if jpegs is not None:
        t = time.perf_counter()
        blobs = jpegs.result()
        make_s = time.perf_counter() - t  # the wait for the encoding thread
        server, urls = laion.serve(blobs)
        try:
            def pipeline(u):
                df = (dtt.from_pydict({"url": u})
                      .select(col("url").url.download().alias("data"))
                      .select(col("data").image.decode(mode="RGB").alias("img"))
                      .select(col("img").cast(DataType.image("RGB", side, side)).alias("f")))
                return laion_tail(df, "f")

            lgot, lcold, llaunch = run_images(lambda: pipeline(urls))
            count(llaunch)
            lplain, _, _ = run_images(lambda: pipeline(urls[:LAION_PLAIN_IMAGES]), device="cpu")
        finally:
            laion.shutdown(server)
            dtt.set_execution_config(config())
        ldiff = int(np.abs(lgot[:LAION_PLAIN_IMAGES].astype(np.int16)
                           - lplain.astype(np.int16)).max())
        out["laion"] = {"images": LAION_IMAGES, "jpeg_wait_s": make_s, "cold_s": lcold,
                        "launches": llaunch, "max_diff": ldiff, "card": card}
        ph.check(lgot.shape == (LAION_IMAGES, size, size, 3) and ldiff <= 1
                 and llaunch["k11"] >= 1,
                 f"SF1 image (g) the LAION pipeline over {LAION_IMAGES} JPEGs from 127.0.0.1: "
                 f"the first {LAION_PLAIN_IMAGES} within {ldiff} count of the CPU path, K11 "
                 f"launches {llaunch['k11']}; cold {lcold:.3f}s")
    k9_entry["launches"] = out["dashboard"]["launches"]["k9"]
    k11_entry["launches"] = out["k11"]["launches"]["k11"]
    merge_entry["launches"] = out["mesh"]["launches"]["merge"]
    out["entries"] = [k9_entry, k11_entry, merge_entry]
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 sketch phase 20 wall {out['wall_s']:.1f}s, launches K1 {out['k1_launches']} "
          f"K9 {out['k9_launches']} K11 {out['k11_launches']} merge {out['merge_launches']} "
          f"({card})", flush=True)
    dtt.set_execution_config(config())
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 21: the distributed runner (worker processes on the card)
# ---------------------------------------------------------------------------

DIST_WORKERS = 2          # phase 21: distributed_workers
DIST_PARTS = 8            # phase 21: lineitem as 8 parquet files, and (b)'s partitions


def _peer_shuffles_dropped() -> int:
    """The driver's count of peer-hosted shuffles dropped at query ends: one
    a shuffle that took the peer-to-peer path."""
    from daft_tpu_torch.dist.peerplane import plane

    return plane().snapshot()["shuffles_dropped_total"]


def worker_imports_clean() -> list:
    """The modules of JAX or of the JAX package a fresh interpreter holds
    after importing the worker's entry module (an empty list is clean)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, daft_tpu_torch.dist.worker; print(','.join(sorted(m for m in "
            "('jax', 'jaxlib', 'daft_tpu') if m in sys.modules)))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": root})
    if res.returncode != 0:
        return [f"import failed: {res.stderr.strip()[-300:]}"]
    return [m for m in res.stdout.strip().split(",") if m]


def phase_distributed(ph: Phases, lineitem, tables: dict, q3_oracle: tuple,
                      card: str) -> dict:
    """Phase 21: the distributed runner (dist/) with DIST_WORKERS worker
    processes on the card, each holding its own CUDA context and launching
    K1 and K2 itself, in the 32-bit mode, under the port's defaults but
    PLAN_PINS. Phase 3's SF1 lineitem (generate_lineitem_only(1.0,
    seed=42)) is written as DIST_PARTS parquet files, as phase 13 writes
    them. (a) Q1 composed (K1), Q1 deep (K2) and Q6 over the files, one
    scan task a file that the workers read themselves, cold and warm; (b)
    Q1 over the in-memory lineitem (Q1's columns) in DIST_PARTS partitions,
    which ship as arrow; (c) hash-join Q3 over phase 7's SF1 tables in
    DIST_PARTS partitions (broadcast_join_size_bytes_threshold 0,
    runtime_join_filters off, so that its hash exchanges take the
    peer-to-peer branch), held by q3_parity to the oracle; (c2) Q1 over the
    files repartitioned by l_extendedprice: the workers split the files and host
    the pieces, and the stage-1 tasks pull them from each other. Each
    query's rows equal, to_arrow().equals, NativeRunner's over the same
    frames in this phase (each timed cold and warm too), with dist_tasks at
    least the partitions each query ships, dist_local_fallbacks 0, the
    workers' device_aggregations (folded back through the telemetry
    fragments) NativeRunner's, the driver's own K1/K2/scatter launches 0
    and the workers' (from their pongs) NativeRunner's. A profiled Q1
    breaks dist.remote into submit (to the frame on the wire) and
    remote_wait (to the reply). (d) Q1 of (a) with worker.exec armed nth 3:
    a worker holding the card is SIGKILLed, the query's rows equal, one
    worker_losses, at least one task_redispatches, and the slot respawns.
    (e) shutdown_worker_pool() leaves no worker process. Prints the spawn's
    cold time, torch.cuda.mem_get_info() before the spawn and after (d),
    each query's walls and the transport's bytes. A fresh interpreter that
    imports the worker's entry module holds no module of JAX or daft_tpu."""
    import os
    import shutil
    import tempfile

    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch import col, faults
    from daft_tpu_torch.dist import supervisor as sup
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import scatter_sums as scs
    from daft_tpu_torch.kernels import segment_sums as ss

    t_phase = time.perf_counter()
    out = {"k1_launches": 0, "k2_launches": 0, "scatter_launches": 0, "card": card}
    ctx = dtt.get_context()
    leaked = worker_imports_clean()
    ph.check(not leaked, "SF1 dist: a fresh interpreter importing daft_tpu_torch.dist.worker "
                         f"holds no module of JAX or daft_tpu ({', '.join(leaked) or 'none'})")
    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        dtt.set_execution_config(config())
        ctx.set_runner("native")
        paths = dtt.from_arrow(lineitem).into_partitions(DIST_PARTS).write_parquet(
            os.path.join(root, "lineitem")).to_pydict()["path"]
        li_q1 = dtt.from_arrow(lineitem.select(list(Q1_COLUMNS))).into_partitions(
            DIST_PARTS).collect()
        parts8 = {k: dtt.from_arrow(tables[k]).into_partitions(DIST_PARTS).collect()
                  for k in ("customer", "orders", "lineitem")}
        want3, groups3 = q3_oracle
        oracle1 = tpch.oracle_q1(lineitem)
        want = {"q1": oracle1, "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}

        def files():
            return dtt.read_parquet(paths)

        scan_kw = {"scan_tasks_min_size_bytes": 1}
        # name -> (make the query, config, partitions each stage ships at
        # least, the launches' kernel, the check against the oracle)
        queries = {
            "q1_files": (lambda: q1(files()), scan_kw, DIST_PARTS, "k1",
                         lambda g: parity(g, want["q1"], RTOL)),
            "q1_deep_files": (lambda: q1(files()), {**scan_kw, "use_deep_fusion_kernel": True},
                              DIST_PARTS, "k2", lambda g: parity(g, want["q1"], RTOL)),
            "q6_files": (lambda: q6(files()), scan_kw, DIST_PARTS, "k1",
                         lambda g: parity(g, want["q6"], RTOL)),
            "q1_arrow": (lambda: q1(li_q1), {}, DIST_PARTS, "k1",
                         lambda g: parity(g, want["q1"], RTOL)),
            "q3_hash": (lambda: q3(parts8["customer"], parts8["orders"], parts8["lineitem"]),
                        {"broadcast_join_size_bytes_threshold": 0,
                         "runtime_join_filters": False}, DIST_PARTS, None,
                        lambda g: q3_parity(g, want3, groups3, RTOL)),
            # by a column Q1 reads: the optimizers of both packages prune a
            # repartition key that nothing above the exchange reads
            "q1_peer_files": (lambda: q1(files().repartition(DIST_PARTS,
                                                             col("l_extendedprice"))),
                              scan_kw, DIST_PARTS, "k1",
                              lambda g: parity(g, want["q1"], RTOL)),
        }

        def run(make_df, kw, workers, profile=False):
            dtt.set_execution_config(config(distributed_workers=workers, **kw))
            ss.LAUNCHES = fes.LAUNCHES = scs.LAUNCHES = 0
            t0 = time.perf_counter()
            df = make_df().collect(profile=True) if profile else make_df().collect()
            got = df.to_arrow()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {"k1": ss.LAUNCHES, "k2": fes.LAUNCHES, "scatter": scs.LAUNCHES}
            for k, v in launches.items():
                out[f"{k}_launches"] += v
            return df, got, secs, launches, df.stats.snapshot()["counters"]

        # NativeRunner first: its rows, walls, launches and routing
        native = {}
        for name, (make_df, kw, _, _, _) in queries.items():
            _, got, cold, launches, c = run(make_df, kw, 0)
            _, _, warm, _, _ = run(make_df, kw, 0)
            native[name] = (got, cold, warm, launches, c)

        # the spawn, cold: DIST_WORKERS interpreters that import the port and
        # ready the card (worker.ready_device) before their hellos
        torch.cuda.synchronize()
        free0, total = torch.cuda.mem_get_info()
        dtt.set_execution_config(config(distributed_workers=DIST_WORKERS))
        t0 = time.perf_counter()
        pool = sup.get_worker_pool(ctx.execution_config)
        spawn_s = time.perf_counter() - t0
        free1, _ = torch.cuda.mem_get_info()
        snap = pool.snapshot()
        out["spawn"] = {"workers": DIST_WORKERS, "spawn_s": spawn_s,
                        "free_before_bytes": free0, "free_after_spawn_bytes": free1,
                        "total_bytes": total, "card": card}
        print("SF1 dist spawn " + json.dumps(out["spawn"]), flush=True)
        ph.check(snap["workers_alive"] == DIST_WORKERS and type(ctx.runner()).__name__
                 == "DistributedRunner",
                 f"SF1 dist: {snap['workers_alive']} of {DIST_WORKERS} workers up in "
                 f"{spawn_s:.2f}s, the runner is {type(ctx.runner()).__name__}")

        results = {}
        for name, (make_df, kw, min_tasks, kernel, check) in queries.items():
            n_got, n_cold, n_warm, n_launches, nc = native[name]
            before = pool.kernel_launches()
            bytes0 = pool.snapshot()["driver_payload_bytes_total"]
            peer0 = _peer_shuffles_dropped()
            df, got, cold, launches, c = run(make_df, kw, DIST_WORKERS)
            after = pool.kernel_launches()
            wire = pool.snapshot()["driver_payload_bytes_total"] - bytes0
            peer = _peer_shuffles_dropped() - peer0
            _, got_w, warm, _, _ = run(make_df, kw, DIST_WORKERS)
            worker_launches = {k: sum(after.get(w, {}).get(k, 0) - before.get(w, {}).get(k, 0)
                                      for w in after) for k in ("k1", "k2", "scatter")}
            rows = got.to_pydict()
            label = f"SF1 dist {name}"
            ph.check(got.equals(n_got) and got_w.equals(n_got) and check(rows),
                     f"{label}: cold and warm rows equal NativeRunner's (to_arrow().equals) "
                     f"and the oracle's")
            ph.check(c.get("dist_tasks", 0) >= min_tasks
                     and c.get("dist_local_fallbacks", 0) == 0,
                     f"{label}: dist_tasks {c.get('dist_tasks', 0)} (>= {min_tasks}), "
                     f"dist_local_fallbacks {c.get('dist_local_fallbacks', 0)}")
            ph.check(launches == {"k1": 0, "k2": 0, "scatter": 0}
                     and worker_launches == n_launches
                     and c.get("device_aggregations", 0) == nc.get("device_aggregations", 0)
                     and (kernel is None or worker_launches[kernel] >= 1),
                     f"{label}: the driver launched {launches}, the workers {worker_launches} "
                     f"(NativeRunner {n_launches}); device_aggregations "
                     f"{c.get('device_aggregations', 0)} folded back from the workers "
                     f"(NativeRunner {nc.get('device_aggregations', 0)})")
            if name in ("q3_hash", "q1_peer_files"):
                ph.check(peer >= 1, f"{label}: {peer} exchange(s) took the peer-to-peer path")
            if name == "q1_peer_files":
                ph.check(c.get("peer_fetches", 0) >= 1,
                         f"{label}: the stage-1 tasks pulled {c.get('peer_fetches', 0)} pieces "
                         f"({c.get('peer_bytes_fetched', 0)} bytes) from the workers hosting "
                         f"them")
            results[name] = {"cold_s": cold, "warm_s": warm, "native_cold_s": n_cold,
                             "native_warm_s": n_warm, "dist_tasks": c.get("dist_tasks", 0),
                             "driver_bytes": wire, "peer_shuffles": peer,
                             "peer_fetches": c.get("peer_fetches", 0),
                             "telemetry_merged": c.get("telemetry_merged", 0),
                             "worker_launches": worker_launches, "card": card}
            print(f"{label} " + json.dumps(results[name]), flush=True)
            del df
        out["queries"] = results

        # a profiled Q1: dist.remote's split
        df, got, _, _, _ = run(queries["q1_files"][0], scan_kw, DIST_WORKERS, profile=True)
        spans = [s for s in df.stats.profiler.spans_snapshot() if s.name == "dist.remote"]
        split = {k: sum((s.phases or {}).get(k, 0) for s in spans) / 1e6
                 for k in ("submit", "remote_wait")}
        wall = sum(s.dur_ns for s in spans) / 1e6
        worker_task = sum(s.dur_ns for s in df.stats.profiler.spans_snapshot()
                          if s.name == "worker.task") / 1e6
        out["remote_split"] = {"tasks": len(spans), "dist_remote_ms": wall,
                               "submit_ms": split["submit"], "remote_wait_ms":
                               split["remote_wait"], "worker_task_ms": worker_task,
                               "card": card}
        print("SF1 dist remote split " + json.dumps(out["remote_split"]), flush=True)
        ph.check(len(spans) >= DIST_PARTS and got.equals(native["q1_files"][0])
                 and split["remote_wait"] > 0 and worker_task > 0,
                 f"SF1 dist profiled Q1: {len(spans)} dist.remote spans, submit "
                 f"{split['submit']:.2f} ms, remote_wait {split['remote_wait']:.2f} ms, the "
                 f"workers' spliced worker.task spans {worker_task:.2f} ms")
        del df

        # (d) a worker SIGKILLed while it holds the card
        ph.begin(None)  # the armed leg injects a fault: its own checks read it
        make_df, kw = queries["q1_files"][0], queries["q1_files"][1]
        pids0 = dict(pool.worker_pids())
        faults.arm("worker.exec", "nth", n=3)
        try:
            df, got, secs, launches, c = run(make_df, kw, DIST_WORKERS)
        finally:
            faults.disarm()
        rec = df.last_query_record()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and pool.snapshot()["workers_alive"] < DIST_WORKERS:
            time.sleep(0.1)
        snap = pool.snapshot()
        pids1 = dict(pool.worker_pids())
        ph.check(got.equals(native["q1_files"][0])
                 and rec["events"].get("worker_losses", 0) == 1
                 and rec["events"].get("task_redispatches", 0) >= 1,
                 f"SF1 dist (d) worker.exec nth 3: the rows equal NativeRunner's, "
                 f"worker_losses {rec['events'].get('worker_losses', 0)}, task_redispatches "
                 f"{rec['events'].get('task_redispatches', 0)}, {secs:.2f}s")
        ph.check(snap["workers_alive"] == DIST_WORKERS and snap["restarts_used"] >= 1
                 and pids1 != pids0,
                 f"SF1 dist (d): the slot respawned ({snap['workers_alive']} alive, "
                 f"restarts_used {snap['restarts_used']}, pids {pids0} -> {pids1})")
        # past one more heartbeat deadline: the respawn ran beside the
        # supervision, so no live worker missed its pings meanwhile
        time.sleep(ctx.execution_config.worker_heartbeat_timeout_s + 1.0)
        losses = pool.snapshot()["worker_losses_total"]
        ph.check(losses == 1 and pool.snapshot()["workers_alive"] == DIST_WORKERS,
                 f"SF1 dist (d): worker_losses_total {losses} in the phase (the one SIGKILL): no "
                 f"worker missed its heartbeat deadline while the slot respawned")
        torch.cuda.synchronize()
        free2, _ = torch.cuda.mem_get_info()
        out["kill"] = {"wall_s": secs, "free_after_d_bytes": free2,
                       "worker_losses": rec["events"].get("worker_losses", 0),
                       "task_redispatches": rec["events"].get("task_redispatches", 0),
                       "card": card}
        print("SF1 dist kill " + json.dumps(out["kill"]), flush=True)
        del df
        ph.begin("phase 21")

        # (e) the pool's shutdown
        out["transport_bytes"] = pool.snapshot()["driver_payload_bytes_total"]
        sup.shutdown_worker_pool()
        live = sup.live_worker_process_count()
        ph.check(live == 0, f"SF1 dist (e): {live} worker processes after "
                            f"shutdown_worker_pool() (transport {out['transport_bytes']} bytes "
                            f"through the driver in the phase)")
    finally:
        faults.disarm()
        sup.shutdown_worker_pool()
        ctx.set_runner("native")
        dtt.set_execution_config(config())
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SF1 dist phase 21 wall {out['wall_s']:.1f}s, driver launches K1 "
          f"{out['k1_launches']} K2 {out['k2_launches']} scatter {out['scatter_launches']}; "
          "worker launches " + json.dumps({n: r["worker_launches"] for n, r in
                                          out["queries"].items()}) + f" ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


def _walk(p):
    yield p
    for c in p.children():
        yield from _walk(c)


def ab_times(tree: str, runs: int = 15) -> dict:
    """Warm SF1 times through the daft_tpu_torch of ``tree`` (a checkout or
    a ``git archive`` unpack of the repository), to compare two versions of
    the port inside one call to the card: run this once per tree, in turns
    (parent, change, change, parent), one process each. Phase 3's queries
    in the 32-bit mode: Q1 and Q6 over lineitem (seed 42) in one partition
    and in 4, and Q3 over generate_tables(1, seed=42) through its broadcast
    joins, each cold once, then ``runs`` times warm (``warm_median`` with
    every run and each operator's median wall time); then a cProfile of 5
    warm runs each of Q1 and Q6 over 4 partitions: the calls and own time
    of all functions, the 10 of the most own time, and every function of
    the executor and the fault registry."""
    import cProfile
    import os
    import pstats

    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import daft_tpu_torch as dtt
    from benchmarks import tpch

    came_from = os.path.dirname(os.path.dirname(os.path.abspath(dtt.__file__)))
    if came_from != tree:
        raise RuntimeError(f"daft_tpu_torch came from {came_from}, not from {tree}")
    li = tpch.generate_lineitem_only(scale=1.0, seed=42)
    tables = tpch.generate_tables(scale=1.0, seed=42)
    step = -(-li.num_rows // 4)
    one = dtt.from_arrow(li).collect()
    four = dtt.from_arrow([li.slice(i * step, step) for i in range(4)]).collect()
    t3 = {k: dtt.from_arrow(v).collect() for k, v in tables.items()}
    queries = {"q1": (q1, one), "q6": (q6, one), "q1_4_parts": (q1, four),
               "q6_4_parts": (q6, four),
               "q3": (lambda t: q3(t["customer"], t["orders"], t["lineitem"]), t3)}
    # the pins of phases 1-10 (PLAN_PINS), where the tree has those knobs
    fields = {f.name for f in dataclasses.fields(dtt.ExecutionConfig)}
    dtt.set_execution_config(dtt.ExecutionConfig(
        **{k: v for k, v in PLAN_PINS.items() if k in fields}))
    out = {"tree": tree, "card": card_line(), "torch": torch.__version__}
    for name, (query, frame) in queries.items():
        query(frame).collect().to_pydict()  # cold
        out[name] = warm_median(query, frame, runs, keep=True)
    for name in ("q1_4_parts", "q6_4_parts"):
        query, frame = queries[name]
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(5):
            query(frame).collect().to_pydict()
            torch.cuda.synchronize()
        prof.disable()

        def entry(key, val):
            (f, line, fn), (_, nc, tt, ct, _) = key, val
            where = os.path.relpath(f, tree) if f.startswith(tree) else f
            return {"fn": f"{where}:{line}({fn})", "calls_per_run": nc / 5,
                    "own_ms_per_run": tt * 200, "cum_ms_per_run": ct * 200}

        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])
        out[f"{name}_cprofile"] = {
            "calls_per_run": sum(v[1] for v in stats.values()) / 5,
            "own_ms_per_run": sum(v[2] for v in stats.values()) * 200,
            "top": [entry(k, v) for k, v in top[:10]],
            # the executor and the fault registry, where the breaker, the
            # fault check and the deadline check live
            "executor": [entry(k, v) for k, v in top
                         if k[0].endswith(("daft_tpu_torch/execution.py",
                                           "daft_tpu_torch/faults.py"))]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", default="1,10",
                    help="comma-separated TPC-H scale factors: phase 3's Q1/Q6 run at the "
                         "first, its joins and phase 7 at each")
    ap.add_argument("--profile", action="store_true",
                    help="trace warm Q1/Q6 (1 and 4 partitions), deep Q1, Q3 and Q5 at the "
                         "first scale with "
                         "torch.profiler, and time the phases of Q3 and Q5")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1 and 2 only (builds and kernel checks); launches print "
                         "as null")
    ap.add_argument("--ab", metavar="TREE",
                    help="run no phase: print one JSON line of warm SF1 times through the "
                         "daft_tpu_torch of TREE (ab_times) and exit")
    args = ap.parse_args(argv)
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        print(json.dumps(ab_times(args.ab)), flush=True)
        return 0
    ph = Phases()
    big = files = None
    try:
        from benchmarks import tpch

        ph.watch()

        torch.backends.cuda.matmul.allow_tf32 = False  # no float sum may round through TF32
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
        queries = tpch22_module()
        if not args.kernels_only:  # phase 4's SF1 tables (and SF10's join tables)
            big = BackgroundTables(1.0, 7, SCAN_TPCH_GROUPS,
                                   [float(x) for x in args.scales.split(",") if float(x) != 1.0])
        ph.begin("phase 1")
        edges = phase_build(ph)
        ph.begin("phase 2")
        k1_entry = phase_k1(ph)
        sc_entry = phase_scatter(ph)
        sc64_entry = phase_scatter(ph, torch.float64) if args.kernels_only else None
        scales = [] if args.kernels_only else [float(s) for s in args.scales.split(",")]
        tables = {}
        t0 = time.perf_counter()
        tables[1.0] = tpch.generate_lineitem_only(scale=1.0, seed=42)
        sf1_lineitem = tables[1.0]  # phases 6 and 12 run Q1 and Q6 over it again
        print(f"SF1: {tables[1.0].num_rows} rows generated in {time.perf_counter() - t0:.1f}s",
              flush=True)
        if 1.0 in scales:  # phase 12's sorted lineitem, written while phases 2-11 run
            files = ParquetFiles()
            files.write("lineitem_by_shipdate", sf1_lineitem, SCAN_LI_GROUPS,
                        sort_by="l_shipdate")
        k2_entry = phase_k2(ph, tables[1.0], edges)
        exchange = {}  # phase 7's results by scale
        # until phase 3 counts them
        k1_entry["launches"] = k2_entry["launches"] = sc_entry["launches"] = None
        for i, scale in enumerate(scales):
            print(f"elapsed {time.perf_counter() - started:.1f}s: phase 3 at SF{scale:g}",
                  flush=True)
            ph.begin(f"phase 3 at SF{scale:g}")
            if i == 0:
                # Q1/Q6 through K1 and K2 at the first scale alone: a later
                # scale repeated the same checks over more rows, and its
                # lineitem's generation, inside the 1200 s limit; the joins
                # below, whose scatter-kernel shape grows with the scale,
                # run at every scale
                if scale not in tables:
                    t0 = time.perf_counter()
                    tables = {scale: tpch.generate_lineitem_only(scale=scale, seed=42)}
                    print(f"SF{scale:g}: {tables[scale].num_rows} rows generated in "
                          f"{time.perf_counter() - t0:.1f}s", flush=True)
                res = phase_main_path(ph, scale, tables[scale], card, args.profile)
                if scale == 1.0:  # the two-stage aggregate over 4 partitions
                    res["k1_launches"] += phase_multi_partition(
                        ph, tables[scale], card, res, args.profile)["k1_launches"]
                    phase_single_ops(ph, tables[scale], card)
            tables = {}  # the join tables of this scale take the memory next
            joins = phase_joins(ph, scale, card, args.profile and i == 0, keep_tables=True,
                                tables=big.join_tables(scale))
            xtables = joins.pop("tables")
            # phase 7 over the same tables, at every scale
            print(f"elapsed {time.perf_counter() - started:.1f}s: phase 7 at SF{scale:g}",
                  flush=True)
            ph.begin(f"phase 7 at SF{scale:g}")
            q3_oracle = joins.pop("q3_oracle")
            exchange[scale] = phase_exchange(ph, scale, xtables, q3_oracle, card)
            if scale == 1.0:
                join_tables = xtables
                main_sf1, q3_oracle_sf1 = res, q3_oracle  # phase 8 reads them
            del q3_oracle
            del xtables
            if i == 0:
                k1_entry["launches"] = res["k1_launches"] + joins["q5"]["launches"]["k1"]
                k2_entry["launches"] = res["k2_launches"]
                sc_entry["launches"] = joins["q3"]["launches"]["scatter"]
                keep = ("name", "route", "source", "replaces", "launches")
                sc_entry["large_shape"] = {k: sc_entry.pop(k) for k in list(sc_entry)
                                           if k not in keep}
                sc_entry.update(joins["scatter_main"])
            else:  # the main path's shape at the later scales, checked and timed
                sc_entry[f"sf{scale:g}_shape"] = joins["scatter_main"]
        if scales:
            faults_out = relational = spill = adapt = scans = prefetch_write = columnar = None
            sql_udf = observability = scheduling = mesh = io_out = sketch_image = None
            distributed = None
            if 1.0 in scales:
                # phases 8-11 read phase 3's and phase 7's SF1 tables alone, so
                # they run while the 22-query tables are still being generated
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 8", flush=True)
                ph.begin(None)  # phase 8 arms faults: its own checks read its counters
                faults_out = phase_faults(ph, sf1_lineitem, join_tables, q3_oracle_sf1, main_sf1,
                                          card)
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 9", flush=True)
                ph.begin("phase 9")
                relational = phase_relational(ph, join_tables, card)
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 10", flush=True)
                ph.begin("phase 10")
                spill = phase_spill(ph, join_tables, card)
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 11", flush=True)
                ph.begin("phase 11")
                adapt = phase_adapt(ph, join_tables, q3_oracle_sf1, card)
                # phase 15 but its SF1 SQL leg: phase 3's SF1 lineitem and its
                # own SF0.005 tables, also while the 22-query tables generate
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 15", flush=True)
                ph.begin("phase 15")
                sql_udf = phase_sql_udf(ph, sf1_lineitem, queries.SQL, card)
                # phase 16 reads phase 3's SF1 lineitem and phase 7's SF1
                # tables, so it also runs before the wait for the generator
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 16", flush=True)
                ph.begin("phase 16")
                observability = phase_observability(ph, sf1_lineitem, join_tables,
                                                    q3_oracle_sf1, card)
                # phase 17 too: phase 3's SF1 lineitem and phase 7's SF1 tables
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 17", flush=True)
                ph.begin("phase 17")
                scheduling = phase_scheduling(ph, sf1_lineitem, join_tables, q3_oracle_sf1,
                                              card)
                # phase 18 too: phase 3's SF1 lineitem and phase 7's SF1 tables
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 18", flush=True)
                ph.begin("phase 18")
                mesh = phase_mesh(ph, sf1_lineitem, join_tables, q3_oracle_sf1, card)
                # phase 20 too: phase 7's SF1 tables
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 20", flush=True)
                ph.begin("phase 20")
                sketch_image = phase_sketch_image(ph, join_tables, card)
                # phase 21 too: phase 3's SF1 lineitem and phase 7's SF1 tables
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 21", flush=True)
                ph.begin("phase 21")
                distributed = phase_distributed(ph, sf1_lineitem, join_tables, q3_oracle_sf1,
                                                card)
            t0 = time.perf_counter()
            data = big.get()
            print(f"SF1: 22-query tables ready {time.perf_counter() - big.started:.1f}s after "
                  f"the generator started (waited {time.perf_counter() - t0:.1f}s; "
                  + ", ".join(f"{k} {v:.1f}s" for k, v in big.timing.items() if k != "pinned_core")
                  + f" after its start, on core {big.timing['pinned_core']}; "
                  + ", ".join(f"{k} {v.num_rows}" for k, v in data.items()) + ")", flush=True)
            if files is not None:  # phase 12's files, written by the generator's process
                for name in data:
                    files.adopt(name, big.parquet[name])
            print(f"elapsed {time.perf_counter() - started:.1f}s: phase 4", flush=True)
            ph.begin("phase 4")
            t22 = phase_tpch22(ph, queries, data, big.host_rows, card, args.profile)
            print(f"elapsed {time.perf_counter() - started:.1f}s: phase 5", flush=True)
            ph.begin("phase 5")
            lanes = phase_lanes(ph, data, card)
            print(f"elapsed {time.perf_counter() - started:.1f}s: phase 6", flush=True)
            ph.begin("phase 6")
            if 1.0 in scales:  # phase 6, the 64-bit device mode
                scatter32 = {qn: t22[f"q{qn}"]["launches"]["scatter"] for qn in queries.QUERIES}
                x64 = phase_x64(ph, sf1_lineitem, join_tables, queries, data,
                                t22.pop("host_rows"), scatter32, card)
                sc64_entry = x64["entry"]
                sc64_entry["launches"] = x64["scatter_f64_launches"]
                k1_entry["launches_x64"] = x64["k1_launches"]  # 0: the mode never runs K1
                k2_entry["launches_x64"] = x64["k2_launches"]
                del join_tables
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 12", flush=True)
                ph.begin("phase 12")
                scans = phase_scans(ph, files, data, t22.pop("card_rows"), sf1_lineitem,
                                    queries, card)
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 13", flush=True)
                ph.begin("phase 13")
                prefetch_write = phase_prefetch_write(ph, sf1_lineitem, card)
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 14", flush=True)
                ph.begin("phase 14")
                columnar = phase_columnar(ph, sf1_lineitem, card)
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 15, SF1 SQL",
                      flush=True)
                ph.begin("phase 15, SF1 SQL")
                sql_sf1 = phase_sql_sf1(ph, data, queries.SQL, card)
                for k in ("k1_launches", "k2_launches", "scatter_launches"):
                    sql_udf[k] += sql_sf1[k]
                # phase 19 reads phase 12's file of phase 4's lineitem, which
                # the run removes at its end
                print(f"elapsed {time.perf_counter() - started:.1f}s: phase 19", flush=True)
                ph.begin("phase 19")
                io_out = phase_io(ph, files, data["lineitem"], sql_sf1.pop("oracles"), card)
            del data, sf1_lineitem
            phase_outs = [("tpch22", t22), ("lanes", lanes)] + [
                (f"exchange_sf{sc:g}", ex) for sc, ex in exchange.items()] + (
                [("faults", faults_out), ("relational", relational), ("spill", spill),
                 ("adapt", adapt), ("scan", scans), ("prefetch_write", prefetch_write),
                 ("columnar", columnar), ("sql_udf", sql_udf),
                 ("observability", observability), ("scheduling", scheduling),
                 ("mesh", mesh), ("io", io_out), ("sketch_image", sketch_image),
                 ("distributed", distributed)]
                if faults_out is not None else [])
            for name, ph_out in phase_outs:
                k1_entry[f"launches_{name}"] = ph_out["k1_launches"]
                k2_entry[f"launches_{name}"] = ph_out["k2_launches"]
                sc_entry[f"launches_{name}"] = ph_out["scatter_launches"]
                k1_entry["launches"] += ph_out["k1_launches"]
                sc_entry["launches"] += ph_out["scatter_launches"]
                k2_entry["launches"] += ph_out["k2_launches"]
            k2_entry["timestamps_deep_shape"] = lanes["k2_shape"]
        if sc64_entry is not None and args.kernels_only:
            sc64_entry["launches"] = None
        ph.begin(None)
        loaded = sorted(m for m in ("jax", "jaxlib", "flax", "daft_tpu") if m in sys.modules)
        ph.check(not loaded, "no module of JAX or of the JAX package was loaded in this "
                             f"process (loaded: {', '.join(loaded) or 'none'})")
        kernels = [k1_entry, k2_entry, sc_entry] + ([sc64_entry] if sc64_entry else []) + (
            sketch_image["entries"] if sketch_image is not None else [])
        print(json.dumps({"kernels": kernels}), flush=True)
        print(f"chip_smoke: {len(scales)} scale(s) in {time.perf_counter() - started:.1f}s",
              flush=True)
    except Exception:
        traceback.print_exc()
        ph.failures.append("uncaught exception")
    finally:
        if big is not None:
            big.stop()
        if files is not None:
            files.remove()
    if ph.failures:
        print("chip_smoke FAILED: " + "; ".join(ph.failures), file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
