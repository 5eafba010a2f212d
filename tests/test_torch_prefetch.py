"""The scan readahead (io/prefetch.py) of daft_tpu_torch, held against
daft_tpu over the same parquet files (written by pyarrow from a numpy seed)
on the CPU, in the reference's 32-bit device mode.

The readahead moves where a scan task is read, never what it returns or
the order the partitions flow in: every depth gives the rows, partition
order, routing counters and IO counters of depth 0. The cases of
tests/test_pipelined_io.py's TestScanPrefetch are ported here, except the
pooled map-side fan-out, which the port does not have yet (ROADMAP, Queue
1, item 7). Floats compare at the tolerances of the tests they come from;
everything else exactly.
"""

import gc
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu_torch
from benchmarks import tpch
from test_torch_scan_queries import _io_snapshots, _reset_io, _write, q1, q6
from torch_parity import (COUNTERS, SPILL_BASE, SPILL_COUNTERS, assert_same_rows, counters,
                          fresh_ledgers_and_faults, restore_port_config, under_both)  # noqa: F401

# each run executes as planned cold: the whole-plan and sub-plan result
# caches are off (a case of its own holds the sub-plan cache's hit equal at
# both depths), and so is feedback planning, which would resize a repeated
# aggregate's exchange
BASE = {"enable_result_cache": False, "subplan_result_cache": False, "history_fdo": False,
        "scan_tasks_min_size_bytes": 1}
# which read a fetch serves (a hit) and which one the consumer makes itself
# (a miss, when the fetch is still queued) follows the pool's timing; the
# fetches submitted, the reads served either way and the throttles do not
PREFETCH_KEYS = ("prefetch_submitted", "prefetch_served", "prefetch_throttled")
EXEC_THREAD = "daft-torch-exec"


@pytest.fixture(autouse=True)
def fresh_state():
    """Both ledgers at 0 and both fault registries disarmed, before and
    after each case."""
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


def both(fn, knobs=None):
    """``fn(pkg)`` through both packages under ``BASE`` and ``knobs``."""
    return under_both(fn, {**BASE, **(knobs or {})})


def ledgers():
    from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
    from daft_tpu_torch.spill import MEMORY_LEDGER

    return REF_LEDGER, MEMORY_LEDGER


def assert_ledgers_settled():
    for led in ledgers():
        assert (led.current, led.prefetch_inflight) == (0, 0), led.snapshot()


def exec_threads():
    return [t for t in threading.enumerate() if t.name.startswith(EXEC_THREAD)]


def let_pools_go():
    """Collect the pools that served late reads and wait for their threads
    to end: a fetch still running when its partition was dropped settles
    its charge when it finishes."""
    gc.collect()
    deadline = time.monotonic() + 10
    while exec_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not exec_threads()


def prefetch_counters(df) -> dict:
    """The readahead's counters of a frame's (or a context's) stats, with
    hits and misses summed as ``prefetch_served``."""
    return prefetch_counters_from(df.stats.snapshot()["counters"])


def prefetch_counters_from(c: dict) -> dict:
    c = {**c, "prefetch_served": c.get("prefetch_hits", 0) + c.get("prefetch_misses", 0)}
    return {k: c.get(k, 0) for k in PREFETCH_KEYS}


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    """Six parquet files of 4000 rows (tests/test_pipelined_io.py's shape)."""
    rng = np.random.RandomState(11)
    d = tmp_path_factory.mktemp("scan")
    for i in range(6):
        papq.write_table(pa.table({
            "k": pa.array(rng.randint(0, 50, 4000)),
            "v": pa.array(rng.rand(4000)),
            "s": pa.array([f"r{i}_{j % 97}" for j in range(4000)]),
        }), str(d / f"part-{i:02d}.parquet"))
    return os.path.join(str(d), "*.parquet")


def partition_dicts(df) -> list:
    return [p.to_pydict() for p in df.collect()._result.partitions]


# ---------------------------------------------------------------------------
# tests/test_pipelined_io.py TestScanPrefetch
# ---------------------------------------------------------------------------

def test_prefetch_depths_identical_results_and_order(scan_dir):
    def run(depth):
        def q(pkg):
            df = (pkg.read_parquet(scan_dir).where(pkg.col("k") < 40)
                  .with_column("kv", pkg.col("k") * pkg.col("v")))
            return partition_dicts(df), counters(df)

        return both(q, {"scan_prefetch_depth": depth})

    (rwant, rc0), (want, gc0) = run(0)
    assert len(want) == 6  # one partition per file, in order
    for depth in (1, 2, 8):
        (rgot, rc), (got, gc_) = run(depth)
        assert got == want, f"depth={depth} changed the port's rows or order"
        assert rgot == rwant
        assert (gc_, rc) == (gc0, rc0), depth
    for g, r in zip(want, rwant):
        assert_same_rows(g, r, rtol=1e-6, ordered=True)
    assert_ledgers_settled()


def test_prefetch_identical_through_shuffle_agg(scan_dir):
    def run(depth):
        def q(pkg):
            df = (pkg.read_parquet(scan_dir).groupby("k")
                  .agg(pkg.col("v").sum().alias("s")).sort("k"))
            return df.to_pydict(), counters(df)

        return both(q, {"scan_prefetch_depth": depth})

    (rwant, rc0), (want, gc0) = run(0)
    # the aggregate's exchange and the sort's
    assert gc0["device_aggregations"] > 0 and gc0["shuffles"] == 2
    for depth in (1, 2, 8):
        (rgot, rc), (got, gc_) = run(depth)
        assert got["k"] == want["k"] == rgot["k"]
        np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)
        np.testing.assert_allclose(got["s"], rgot["s"], rtol=1e-5)
        assert (gc_, rc) == (gc0, rc0), depth
    assert_ledgers_settled()


def test_subplan_cache_hit_is_the_same_at_both_depths(scan_dir):
    # the cache keys on the logical plan's tasks, never on the wrappers: a
    # prefix run at depth 0 serves the same query at depth 2
    from daft_tpu.adapt import RESULT_CACHE as REF_RESULT_CACHE
    from daft_tpu_torch.adapt import RESULT_CACHE

    def q(pkg):
        return (pkg.read_parquet(scan_dir).where(pkg.col("k") < 40)
                .with_column("kv", pkg.col("k") * pkg.col("v")))

    def run(pkg):
        out = []
        for depth in (0, 2):
            pkg.get_context().execution_config.scan_prefetch_depth = depth
            df = q(pkg)
            out.append((partition_dicts(df), {k: v for k, v in df.stats.snapshot()[
                "counters"].items() if k.startswith("subplan_cache")}))
        return out

    for cache in (REF_RESULT_CACHE, RESULT_CACHE):
        cache.clear()
    ref, got = both(run, {"subplan_result_cache": True, "scan_prefetch_depth": 2})
    for cache in (REF_RESULT_CACHE, RESULT_CACHE):
        cache.clear()
    assert [c for _, c in got] == [c for _, c in ref] == [
        {"subplan_cache_misses": 1}, {"subplan_cache_hits": 1}]
    assert got[1][0] == got[0][0] and ref[1][0] == ref[0][0]


def test_prefetch_actually_engages(scan_dir):
    def q(pkg):
        df = pkg.read_parquet(scan_dir).select(pkg.col("k"), pkg.col("v"))
        df.to_pydict()
        return prefetch_counters(df)

    for c in both(q, {"scan_prefetch_depth": 2}):
        assert c["prefetch_submitted"] > 0, c
        assert c["prefetch_served"] > 0, c
    let_pools_go()


def test_prefetch_charges_settle(scan_dir):
    def q(pkg):
        return len(pkg.read_parquet(scan_dir).to_pydict()["k"])

    assert both(q, {"scan_prefetch_depth": 8}) == (6 * 4000, 6 * 4000)
    assert_ledgers_settled()
    let_pools_go()


def test_prefetch_budget_throttles_not_breaks(scan_dir):
    # a budget of 1 byte leaves no headroom: readahead throttles down to the
    # one fetch in flight that is always allowed
    rwant, want = both(lambda pkg: pkg.read_parquet(scan_dir).to_pydict(),
                       {"scan_prefetch_depth": 0})

    def q(pkg):
        df = pkg.read_parquet(scan_dir)
        return df, df.to_pydict()

    (rdf, rgot), (df, got) = both(q, {"scan_prefetch_depth": 4, "memory_budget_bytes": 1})
    assert got == want and rgot == rwant
    assert_same_rows(got, rgot, rtol=1e-6, ordered=True)
    for frame in (df, rdf):
        assert frame.stats.snapshot()["counters"].get("prefetch_throttled", 0) > 0
    assert prefetch_counters(df) == prefetch_counters(rdf)
    assert_ledgers_settled()


def test_prefetch_fetch_fault_propagates_to_caller(scan_dir):
    def q(pkg):
        with pkg.faults.inject("prefetch.fetch", "always"):
            with pytest.raises(pkg.errors.DaftTransientError):
                pkg.read_parquet(scan_dir).to_pydict()
        return pkg.faults.snapshot()["armed"]

    assert both(q, {"scan_prefetch_depth": 2}) == ({}, {})
    let_pools_go()
    assert_ledgers_settled()


def test_prefetch_fetch_transient_then_heal(scan_dir):
    # one background fetch dies and the query fails: a fetch is not retried
    # (the scan's retry policy runs inside the read, below the site)
    def q(pkg):
        with pkg.faults.inject("prefetch.fetch", "first_n", n=1):
            with pytest.raises(pkg.errors.DaftTransientError):
                pkg.read_parquet(scan_dir).to_pydict()
            injected = pkg.faults.snapshot()["injected"]["prefetch.fetch"]
            # healed: the same query completes
            return injected, len(pkg.read_parquet(scan_dir).to_pydict()["k"])

    assert both(q, {"scan_prefetch_depth": 2}) == ((1, 6 * 4000), (1, 6 * 4000))
    let_pools_go()
    assert_ledgers_settled()


def test_limit_narrowing_abandons_prefetch(scan_dir):
    def run(depth):
        return both(lambda pkg: pkg.read_parquet(scan_dir).limit(7).to_pydict(),
                          {"scan_prefetch_depth": depth})

    assert run(2) == run(0)
    ref, got = run(2)
    assert_same_rows(got, ref, rtol=1e-6, ordered=True)
    assert_ledgers_settled()


# ---------------------------------------------------------------------------
# the TPC-H queries over files at depths 0 and 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem_file(tmp_path_factory):
    li = tpch.generate_lineitem_only(0.002, seed=42).sort_by("l_shipdate")
    return li, _write(li, str(tmp_path_factory.mktemp("li") / "lineitem.parquet"), 16)


@pytest.mark.parametrize("query", [q1, q6], ids=["q1", "q6"])
def test_tpch_over_files_equal_at_depths_0_and_2(lineitem_file, query):
    from daft_tpu_torch.kernels import segment_sums

    li, path = lineitem_file
    runs = {}
    for depth in (0, 2):
        def build(pkg):
            _reset_io(pkg)
            df = query(pkg, pkg.read_parquet(path, _split_row_groups=True))
            return df.to_pydict(), df.stats.snapshot()["counters"]

        entries = segment_sums.ENTRIES
        (rrows, rc), (grows, gc_) = both(build, {"scan_prefetch_depth": depth})
        ref_io, port_io = _io_snapshots()
        assert port_io == ref_io
        assert segment_sums.ENTRIES > entries  # the float sums went through K1's wrapper
        assert_same_rows(grows, rrows, rtol=1e-5)
        # the routing over 16 tasks differs from the reference's by the
        # scan's pinned reason (tests/test_torch_scan_queries.py, FILE_PINS),
        # held there at one task; here each package's holds across depths
        runs[depth] = (grows, {k: gc_.get(k, 0) for k in COUNTERS},
                       {k: rc.get(k, 0) for k in COUNTERS}, port_io)
        if depth:
            c = prefetch_counters_from(gc_)
            assert c["prefetch_submitted"] > 0 and c["prefetch_served"] > 0
    assert runs[2] == runs[0]
    assert_ledgers_settled()


# ---------------------------------------------------------------------------
# a late read after collect(), a deadline, a timed-out query
# ---------------------------------------------------------------------------

def test_late_read_after_collect_serves_from_a_private_pool(scan_dir):
    # collect() over a bare scan keeps its partitions unloaded; reading them
    # afterwards drives the readahead on a pool made after the query's own
    # was shut down
    def q(pkg):
        df = pkg.read_parquet(scan_dir).collect()
        assert not any(p.is_loaded() for p in df._result.partitions)
        return df.to_pydict(), prefetch_counters(df)

    (rrows, rc), (rows, c) = both(q, {"scan_prefetch_depth": 2})
    assert rows == rrows
    assert c == rc
    assert c["prefetch_submitted"] == 5 and c["prefetch_served"] == 6
    # no pool thread is left once the partitions are gone
    let_pools_go()
    assert_ledgers_settled()


def test_deadline_stops_submission(scan_dir):
    from daft_tpu_torch.execution import ExecutionContext
    from daft_tpu_torch.io.prefetch import pipeline_scan_parts
    from daft_tpu_torch.micropartition import MicroPartition

    daft_tpu_torch.set_execution_config(device="cpu", scan_prefetch_depth=2,
                                        scan_tasks_min_size_bytes=1)
    cfg = daft_tpu_torch.get_context().execution_config
    tasks = daft_tpu_torch.read_parquet(scan_dir)._plan.tasks
    want = [MicroPartition.from_scan_task(t).to_pydict() for t in tasks]
    ctx = ExecutionContext(cfg, deadline=time.monotonic() - 1)
    parts = pipeline_scan_parts([MicroPartition.from_scan_task(t) for t in tasks], ctx)
    assert [p.to_pydict() for p in parts] == want
    c = ctx.stats.snapshot()["counters"]
    assert c.get("prefetch_submitted", 0) == 0 and c["prefetch_misses"] == 6
    # with time left, the same scan reads ahead
    ctx = ExecutionContext(cfg, deadline=time.monotonic() + 60)
    parts = pipeline_scan_parts([MicroPartition.from_scan_task(t) for t in tasks], ctx)
    assert [p.to_pydict() for p in parts] == want
    assert prefetch_counters(ctx)["prefetch_submitted"] == 5
    ctx.shutdown_pool()
    assert_ledgers_settled()


def test_narrowed_partition_reads_its_task_and_abandons_the_fetch(scan_dir):
    # select_columns and head narrow the wrapped task (the reader reads the
    # narrowed columns and rows) and return the full fetch's charge
    from daft_tpu_torch.execution import ExecutionContext
    from daft_tpu_torch.io import IO_STATS
    from daft_tpu_torch.io.prefetch import PrefetchedScanTask, pipeline_scan_parts
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.spill import MEMORY_LEDGER

    daft_tpu_torch.set_execution_config(device="cpu", scan_prefetch_depth=2,
                                        scan_tasks_min_size_bytes=1)
    cfg = daft_tpu_torch.get_context().execution_config
    tasks = daft_tpu_torch.read_parquet(scan_dir)._plan.tasks
    ctx = ExecutionContext(cfg)
    parts = pipeline_scan_parts([MicroPartition.from_scan_task(t) for t in tasks], ctx)
    assert all(isinstance(p.scan_task(), PrefetchedScanTask) for p in parts)
    assert (parts[0].num_rows_or_none(), parts[0].statistics()) == (
        tasks[0].num_rows(), tasks[0].stats)
    parts[0].table()  # submits the fetches of partitions 1 and 2
    assert MEMORY_LEDGER.prefetch_inflight == tasks[1].size_bytes() + tasks[2].size_bytes()
    IO_STATS.reset()
    narrow = parts[1].select_columns(["k"])
    short = parts[2].head(3)
    assert not isinstance(narrow.scan_task(), PrefetchedScanTask)
    assert narrow.to_pydict() == MicroPartition.from_scan_task(tasks[1]).select_columns(
        ["k"]).to_pydict()
    assert short.to_pydict() == MicroPartition.from_scan_task(tasks[2]).head(3).to_pydict()
    assert IO_STATS.snapshot()["columns_read"] >= 1
    ctx.shutdown_pool()  # waits for the running fetches: their charges settle
    assert MEMORY_LEDGER.prefetch_inflight == 0
    c = ctx.stats.snapshot()["counters"]
    assert c["prefetch_submitted"] == 2 and c.get("prefetch_hits", 0) == 0


def test_timed_out_query_leaves_no_fetch_charged(scan_dir):
    # each read sleeps 0.2 s, so the deadline passes with fetches in flight
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8, scan_prefetch_depth=2,
                                        scan_tasks_min_size_bytes=1, enable_result_cache=False,
                                        execution_timeout_s=0.5)
    q = daft_tpu_torch.read_parquet(scan_dir).groupby("k").agg(
        daft_tpu_torch.col("v").sum().alias("s"))
    with daft_tpu_torch.faults.inject("scan.read", "always", delay_s=0.2):
        with pytest.raises(daft_tpu_torch.errors.DaftTimeoutError):
            q.collect()
    c = q.stats.snapshot()["counters"]
    assert c["deadline_expired"] == 1 and c["prefetch_submitted"] >= 1
    let_pools_go()
    assert_ledgers_settled()


def test_concurrent_scans_settle_every_charge(scan_dir):
    # queries on several threads share the process ledger with their pools'
    # fetches: a lost update of prefetch_inflight would leave it off 0
    import sys

    from daft_tpu_torch.spill import MEMORY_LEDGER

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8, scan_prefetch_depth=8,
                                        scan_tasks_min_size_bytes=1, enable_result_cache=False)
    want = daft_tpu_torch.read_parquet(scan_dir).to_pydict()
    got, errors = [], []

    def work():
        try:
            for _ in range(4):
                got.append(daft_tpu_torch.read_parquet(scan_dir).to_pydict() == want)
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and got == [True] * 24
    let_pools_go()
    assert (MEMORY_LEDGER.prefetch_inflight, MEMORY_LEDGER.current) == (0, 0)


# ---------------------------------------------------------------------------
# lineage over a prefetched scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_corrupt_spilled_piece_recomputes_at_depth(tmp_path, monkeypatch, depth):
    # tests/test_torch_scan_queries.py's case at both depths: a recipe
    # captured over a prefetched partition re-reads its file
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rng = np.random.RandomState(11)
    path = _write(pa.table({"k": rng.randint(0, 50, 20_000).astype(np.int64),
                            "v": rng.rand(20_000)}), str(tmp_path / "kv.parquet"), 8)

    def q(pkg):
        df = (pkg.read_parquet(path, _split_row_groups=True).repartition(4, "k")
              .groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k"))
        return df.collect()

    knobs = {**SPILL_BASE, "memory_budget_bytes": 40_000, "scan_prefetch_depth": depth}
    ref_clean, got_clean = both(q, knobs)

    def corrupt(pkg):
        with pkg.faults.inject("spill.corrupt", "first_n", n=2):
            return q(pkg)

    ref, got = both(corrupt, knobs)
    gc_, rc = got.stats.snapshot()["counters"], ref.stats.snapshot()["counters"]
    for k in SPILL_COUNTERS + ("partitions_recomputed", "corruption_detected"):
        assert gc_.get(k, 0) == rc.get(k, 0), k
    assert prefetch_counters_from(gc_) == prefetch_counters_from(rc)
    assert gc_["spilled_partitions"] > 0 and gc_["partitions_recomputed"] >= 1
    assert (gc_.get("prefetch_submitted", 0) > 0) == (depth > 0)
    assert got.to_pydict() == got_clean.to_pydict()
    assert_same_rows(got.to_pydict(), ref_clean.to_pydict(), rtol=1e-5, ordered=True)
    assert_ledgers_settled()
