"""Queries over files through daft_tpu_torch, held against daft_tpu over the
same files (written by pyarrow) on the CPU, and against the port's own
in-memory run of the same data.

Over files the optimizer pushes a query's filter into the scan, where the
reader applies it on the host (``io/readers._residual_filter``), so the
routing over files differs from the routing over the same data in memory;
each case compares the routing with the reference's over the files. One
difference is pinned, with its reason: the reference routes a partition by
its row count without reading it (``MicroPartition.num_rows_or_none``,
daft_tpu/execution.py:670-673), and a scan partition with a pushed filter
has no count until it is read, so the reference sends it to the host path;
the port reads it and routes it by its rows, so its aggregate, projection
or group codes run on the device path there (``FILE_PINS``).
"""

import dataclasses
import datetime
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch, tpch_full, tpch_queries
from chip_smoke import tpch22_module
from daft_tpu.optimizer import optimize as ref_optimize
from daft_tpu_torch.kernels import segment_sums
from daft_tpu_torch.optimizer import optimize as port_optimize
from device_mode import real_tpu_mode_cfg
from test_torch_tpch22 import PINNED, PORT_COUNTERS, _assert_rows_match
from torch_parity import (SPILL_BASE, adapt_counters, assert_same_rows, clear_adapt, counters,
                          fresh_ledgers_and_faults, restore_port_config, run_both,
                          run_seq)  # noqa: F401

SCALE = 0.005

# the reference's partition-routing reason above, as (port, reference) values
_AGG = {"device_aggregations": (1, 0), "host_aggregations": (0, 1)}
_GROUPED = {**_AGG, "device_group_codes": (1, 0)}
FILE_PINS = {
    1: _GROUPED, 6: _AGG, 15: _GROUPED, 20: _GROUPED,
    22: {"device_projections": (2, 1), "device_projection_dispatches": (2, 1),
         "host_projections": (0, 1)},
    # and the in-memory pin of tests/test_torch_tpch22.py
    13: PINNED[13],
}

IO_KEYS = ("files_opened", "bytes_read", "rows_read", "row_groups_read", "row_groups_pruned",
           "columns_read", "retries")


def _io_both():
    from daft_tpu.io import IO_STATS as ref_io
    from daft_tpu_torch.io import IO_STATS as port_io

    return ref_io, port_io


def _sub(pkg, name: str):
    from importlib import import_module

    return import_module(f"{pkg.__name__}.{name}")


def _reset_io(pkg):
    _sub(pkg, "io").IO_STATS.reset()


def _io_snapshots():
    return tuple({k: s.snapshot()[k] for k in IO_KEYS} for s in _io_both())


def _write(tbl: pa.Table, path: str, groups: int) -> str:
    papq.write_table(tbl, path, row_group_size=max(1, -(-tbl.num_rows // groups)))
    return path


# ---------------------------------------------------------------------------
# Q1 and Q6 over lineitem, sorted by l_shipdate, in 16 row groups
# ---------------------------------------------------------------------------

def q1(pkg, li):
    col = pkg.col
    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    return (li.where(col("l_shipdate") <= datetime.date(1998, 9, 2))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 disc_price.sum().alias("sum_disc_price"),
                 (disc_price * (1 + col("l_tax"))).sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


def q6(pkg, li):
    col = pkg.col
    return (li.where((col("l_shipdate") >= datetime.date(1994, 1, 1))
                     & (col("l_shipdate") < datetime.date(1995, 1, 1))
                     & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                     & (col("l_quantity") < 24))
            .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue")))


QUERY_COLUMNS = {q1: 7, q6: 4}  # the lineitem columns each reads


@pytest.fixture(scope="module")
def lineitem_file(tmp_path_factory):
    li = tpch.generate_lineitem_only(0.002, seed=42).sort_by("l_shipdate")
    return li, _write(li, str(tmp_path_factory.mktemp("li") / "lineitem.parquet"), 16)


def _q6_groups_missing_the_year(path: str) -> int:
    md = papq.ParquetFile(path).metadata
    idx = papq.ParquetFile(path).schema_arrow.get_field_index("l_shipdate")
    lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
    n = 0
    for rg in range(md.num_row_groups):
        st = md.row_group(rg).column(idx).statistics
        n += st.max < lo or st.min >= hi
    return n


@pytest.mark.parametrize("x64", [False, True], ids=["32bit", "x64"])
@pytest.mark.parametrize("query", [q1, q6], ids=["q1", "q6"])
def test_q1_q6_over_parquet(lineitem_file, query, x64):
    li, path = lineitem_file

    def build(pkg):
        _reset_io(pkg)
        return query(pkg, pkg.read_parquet(path, _split_row_groups=True))

    entries = segment_sums.ENTRIES
    ref, got = run_both(build, x64=x64)
    ref_io, port_io = _io_snapshots()
    assert_same_rows(got.to_pydict(), ref.to_pydict(), rtol=1e-5 if not x64 else 1e-9)
    assert port_io == ref_io
    assert port_io["columns_read"] == QUERY_COLUMNS[query]
    if query is q6:
        assert port_io["row_groups_pruned"] == _q6_groups_missing_the_year(path) > 0
    pins = _GROUPED if query is q1 else _AGG
    gc, rc = counters(got), counters(ref)
    assert {k: (gc[k], rc[k]) for k in pins} == pins
    assert {k: v for k, v in gc.items() if k not in pins} == \
        {k: v for k, v in rc.items() if k not in pins}
    # the aggregate's float sums went through K1's wrapper (none in x64)
    assert (segment_sums.ENTRIES > entries) == (not x64)
    # and the rows are the port's in-memory run's
    mem = query(daft_tpu_torch, daft_tpu_torch.from_arrow(li)).collect()
    assert_same_rows(got.to_pydict(), mem.to_pydict(), rtol=1e-5 if not x64 else 1e-9)


# ---------------------------------------------------------------------------
# the 22 TPC-H queries over parquet, each table in 8 row groups
# ---------------------------------------------------------------------------

def _six_digit_literals(tree: str) -> str:
    """The float literals of a plan to 6 significant digits: Q11's, Q15's
    and Q22's come from an eager float aggregate of each package's own,
    which over a filtered scan the reference computes on the host in float64
    and the port on the device path in float32 (the pinned routing)."""
    return re.sub(r"lit\((-?\d+\.\d+(?:e-?\d+)?)\)",
                  lambda m: f"lit({float(m.group(1)):.6g})", tree)


@pytest.fixture(scope="module")
def tpch_files(tmp_path_factory):
    data = tpch_full.generate(scale=SCALE, seed=7)
    d = tmp_path_factory.mktemp("tpch")
    paths = {n: _write(t, str(d / f"{n}.parquet"), 8) for n, t in data.items()}
    return data, paths


@pytest.fixture(scope="module")
def port_queries():
    return tpch22_module()


@pytest.mark.parametrize("qn", sorted(tpch_queries.QUERIES))
def test_tpch_query_over_parquet(qn, tpch_files, port_queries):
    data, paths = tpch_files

    def frames(pkg):
        return {n: pkg.read_parquet(p, _split_row_groups=True) for n, p in paths.items()}

    with real_tpu_mode_cfg() as cfg:
        saved = cfg.enable_result_cache
        cfg.enable_result_cache = False
        try:
            _reset_io(daft_tpu)
            df = tpch_queries.QUERIES[qn](frames(daft_tpu))
            rtree = ref_optimize(df._plan).display_tree()
            ref = df.collect()
            d = dataclasses.asdict(cfg)
        finally:
            cfg.enable_result_cache = saved
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    _reset_io(daft_tpu_torch)
    df = port_queries.QUERIES[qn](frames(daft_tpu_torch))
    gtree = port_optimize(df._plan).display_tree()
    got = df.collect()
    ref_io, port_io = _io_snapshots()
    _assert_rows_match(qn, got.to_pydict(), ref.to_pydict())
    assert _six_digit_literals(gtree) == _six_digit_literals(rtree)
    assert port_io == ref_io
    gc, rc = got.stats.snapshot()["counters"], ref.stats.snapshot()["counters"]
    pins = FILE_PINS.get(qn, {})
    assert {k: gc.get(k, 0) for k in PORT_COUNTERS if k not in pins} == \
        {k: rc.get(k, 0) for k in PORT_COUNTERS if k not in pins}
    assert {k: (gc.get(k, 0), rc.get(k, 0)) for k in pins} == pins
    for k in ("scan_tasks_emitted", "scan_tasks_pruned"):
        assert gc.get(k, 0) == rc.get(k, 0), k
    # the port's in-memory rows of the same data (its host path, as
    # chip_smoke.py's phase 4 holds the card's SF1 rows)
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    mem = port_queries.QUERIES[qn]({n: daft_tpu_torch.from_arrow(t) for n, t in data.items()})
    _assert_rows_match(qn, got.to_pydict(), mem.to_pydict())


# ---------------------------------------------------------------------------
# the optimized plan of a scan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    rng = np.random.RandomState(3)
    n = 4000
    tbl = pa.table({"k": rng.randint(0, 7, n).astype(np.int64), "a": np.arange(n),
                    "v": rng.rand(n), "s": [f"s{i % 13}" for i in range(n)]})
    return tbl, _write(tbl, str(tmp_path_factory.mktemp("small") / "t.parquet"), 8)


SCAN_SHAPES = {
    "filter_project_limit": lambda pkg, df: df.where(pkg.col("a") > 2500).select("k", "v").limit(7),
    "limit_then_filter": lambda pkg, df: df.limit(100).where(pkg.col("a") > 50).select("a"),
    "two_filters_derived": lambda pkg, df: (df.where(pkg.col("k") < 3)
                                            .with_column("w", pkg.col("v") * 2)
                                            .where(pkg.col("a") % 2 == 0).select("w", "s")),
    "aggregate": lambda pkg, df: (df.where(pkg.col("s") == "s3").groupby("k")
                                  .agg(pkg.col("v").sum().alias("sv")).sort("k")),
}


@pytest.mark.parametrize("shape", list(SCAN_SHAPES))
def test_optimized_scan_plan_matches_reference(small_file, shape):
    _, path = small_file

    def build(pkg):
        _reset_io(pkg)
        return SCAN_SHAPES[shape](pkg, pkg.read_parquet(path))

    rtree = ref_optimize(build(daft_tpu)._plan).display_tree()
    gtree = port_optimize(build(daft_tpu_torch)._plan).display_tree()
    assert gtree == rtree
    assert build(daft_tpu_torch)._plan.display_tree() == build(daft_tpu)._plan.display_tree()
    assert "ScanSource" in gtree and "Pushdowns" in gtree
    ref, got = run_both(build)
    assert_same_rows(got.to_pydict(), ref.to_pydict(), rtol=1e-6,
                     ordered=shape != "aggregate")
    ref_io, port_io = _io_snapshots()
    assert port_io == ref_io


# ---------------------------------------------------------------------------
# the caches over files
# ---------------------------------------------------------------------------

def _kv_table(seed: int) -> pa.Table:
    rng = np.random.RandomState(seed)
    return pa.table({"k": rng.randint(0, 5, 3000).astype(np.int64), "v": rng.rand(3000)})


def test_overwritten_file_misses_the_plan_and_result_caches(tmp_path):
    path = str(tmp_path / "kv.parquet")

    def seq(pkg, set_knobs):
        _write(_kv_table(1), path, 4)

        def q():
            return (pkg.read_parquet(path).where(pkg.col("v") > 0.25).groupby("k")
                    .agg(pkg.col("v").sum().alias("s")).sort("k"))

        out = []
        set_knobs(enable_result_cache=False)
        for _ in range(2):
            df = q().collect()
            out.append((df.to_pydict(), adapt_counters(df)))
        _write(_kv_table(2), path, 4)  # another size and mtime
        df = q().collect()
        out.append((df.to_pydict(), adapt_counters(df)))
        # the whole-plan result cache of collect
        set_knobs(enable_result_cache=True)
        keep = q().collect()
        again = q().collect()
        _write(_kv_table(3), path, 4)
        fresh = q().collect()
        out += [(d.to_pydict(), adapt_counters(d)) for d in (keep, again, fresh)]
        return out

    ref, got = run_seq(seq)
    assert len(ref) == len(got)
    for (rrows, rc), (grows, gc) in zip(ref, got):
        assert_same_rows(grows, rrows, rtol=1e-5, ordered=True)
        assert {k: gc[k] for k in ("plan_cache_hits", "plan_cache_misses", "result_cache_hits")} \
            == {k: rc[k] for k in ("plan_cache_hits", "plan_cache_misses", "result_cache_hits")}
    (r1, c1), (r2, c2), (r3, c3), (r4, c4), (r5, c5), (r6, c6) = got
    assert c2["plan_cache_hits"] == 1 and r2 == r1
    assert c3["plan_cache_hits"] == 0 and c3["plan_cache_misses"] == 1 and r3 != r1
    assert c5["result_cache_hits"] == 1 and r5 == r4
    assert c6["result_cache_hits"] == 0 and r6 != r4


def _prefix(pkg, path):
    col = pkg.col
    return (pkg.read_parquet(path).where(col("v") > 0.3)
            .with_column("w", col("v") * 2 + col("k")))


SUBPLAN_KEYS = ("subplan_cache_hits", "subplan_cache_misses", "subplan_cache_errors",
                "device_aggregations", "host_aggregations")


def test_subplan_cache_hits_and_its_ledger_account(tmp_path):
    from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
    from daft_tpu_torch.adapt import RESULT_CACHE
    from daft_tpu_torch.spill import MEMORY_LEDGER

    path = _write(_kv_table(4), str(tmp_path / "kv.parquet"), 4)

    def seq(pkg, set_knobs):
        # no resident segment: the aggregate runs over the Project's output,
        # the prefix the cache keeps
        set_knobs(enable_result_cache=False, device_residency=False)
        out = []
        for agg in ("sum", "max", "sum"):
            df = (_prefix(pkg, path).groupby("k")
                  .agg(getattr(pkg.col("w"), agg)().alias("x")).sort("k").collect())
            c = df.stats.snapshot()["counters"]
            out.append((df.to_pydict(), {k: c.get(k, 0) for k in SUBPLAN_KEYS}))
        ledger = REF_LEDGER if pkg is daft_tpu else MEMORY_LEDGER
        out.append(ledger.subplan_cache_bytes)
        return out

    ref, got = run_seq(seq)
    for (rrows, rc), (grows, gc) in zip(ref[:3], got[:3]):
        assert_same_rows(grows, rrows, rtol=1e-5, ordered=True)
        # the reference aggregates its first, filtered scan partition on the
        # host (the pinned routing reason); its replayed partitions are loaded
        assert {k: gc[k] for k in SUBPLAN_KEYS[:3]} == {k: rc[k] for k in SUBPLAN_KEYS[:3]}
    assert [c["subplan_cache_hits"] for _, c in got[:3]] == [0, 1, 1]
    assert [c["subplan_cache_misses"] for _, c in got[:3]] == [1, 0, 0]
    assert got[0][0] == got[2][0]
    assert all(c["device_aggregations"] == 1 for _, c in got[:3])
    assert got[3] == RESULT_CACHE.snapshot()["bytes"] > 0 and ref[3] > 0
    RESULT_CACHE.clear()
    assert MEMORY_LEDGER.subplan_cache_bytes == 0


def test_subplan_cache_lookup_fault_fails_open(tmp_path):
    path = _write(_kv_table(5), str(tmp_path / "kv.parquet"), 4)

    def seq(pkg, set_knobs):
        set_knobs(enable_result_cache=False, device_residency=False)

        def q():
            return _prefix(pkg, path).select("k", "w").sort("w")

        first = q().collect()
        with _sub(pkg, "faults").inject("resultcache.lookup", "always"):
            armed = q().collect()
        after = q().collect()
        return [(d.to_pydict(), {k: d.stats.snapshot()["counters"].get(k, 0)
                                 for k in SUBPLAN_KEYS[:3] + ("faults_injected",)})
                for d in (first, armed, after)]

    ref, got = run_seq(seq)
    for (rrows, rc), (grows, gc) in zip(ref, got):
        assert_same_rows(grows, rrows, rtol=1e-6, ordered=True)
        assert gc == rc
    assert got[1][1]["subplan_cache_errors"] == 1 and got[1][1]["faults_injected"] == 1
    assert got[2][1]["subplan_cache_hits"] == 1
    assert got[0][0] == got[1][0] == got[2][0]


def test_scan_read_retries_in_a_query(small_file):
    _, path = small_file

    def seq(pkg, set_knobs):
        set_knobs(enable_result_cache=False, scan_retry_backoff_s=0.0)
        io = _sub(pkg, "io").IO_STATS
        io.reset()
        with _sub(pkg, "faults").inject("scan.read", "first_n", n=2):
            ok = q6_like(pkg).collect().to_pydict()
        retries = io.snapshot()["retries"]
        with _sub(pkg, "faults").inject("scan.read", "always"):
            with pytest.raises(OSError):
                q6_like(pkg).collect()
        return ok, retries, io.snapshot()["retries"] - retries

    def q6_like(pkg):
        return (pkg.read_parquet(path).where(pkg.col("a") < 1000)
                .agg(pkg.col("v").sum().alias("s")))

    ref, got = run_seq(seq)
    # a read that fails every attempt: in both packages the scheduler runs
    # the partition's task 3 times (task_retry_attempts 2), each read 3
    # attempts (scan_retry_attempts): 9 retries of the reads and 3 of the task
    assert got[1:] == ref[1:] == (2, 12)
    assert_same_rows(got[0], ref[0], rtol=1e-5)


# ---------------------------------------------------------------------------
# feedback-directed planning over a scan
# ---------------------------------------------------------------------------

def test_join_with_a_filtered_scan_side_flips(tmp_path):
    rng = np.random.RandomState(7)
    dim_path = _write(pa.table({"k": np.arange(2000, dtype=np.int64),
                                "w": [rng.bytes(50).hex() for _ in range(2000)]}),
                      str(tmp_path / "dim.parquet"), 4)
    fact_path = _write(pa.table({"k": (np.arange(5000) % 500).astype(np.int64),
                                 "v": np.arange(5000, dtype=np.int64)}),
                       str(tmp_path / "fact.parquet"), 4)

    def seq(pkg, set_knobs):
        set_knobs(enable_result_cache=False, broadcast_join_size_bytes_threshold=20_000,
                  scan_tasks_min_size_bytes=1)
        out = []
        for _ in range(2):
            fact = pkg.read_parquet(fact_path, _split_row_groups=True)
            dim = pkg.read_parquet(dim_path).where(pkg.col("k") < 5)
            df = (fact.join(dim, on="k").groupby("k")
                  .agg(pkg.col("v").sum().alias("s"), pkg.col("w").count().alias("n"))
                  .sort("k").collect())
            out.append((df.to_pydict(), adapt_counters(df)))
        return out

    ref, got = run_seq(seq)
    keys = ("fdo_join_flips", "broadcast_joins", "plan_cache_hits", "shuffles")
    for (rrows, rc), (grows, gc) in zip(ref, got):
        assert grows == rrows
        assert {k: gc[k] for k in keys} == {k: rc[k] for k in keys}
    assert got[0][1]["fdo_join_flips"] == 0 and got[0][1]["broadcast_joins"] == 0
    assert got[1][1]["fdo_join_flips"] == 1 and got[1][1]["broadcast_joins"] >= 1


def test_scan_fingerprints_mask_literals_not_files(small_file, tmp_path):
    from daft_tpu_torch.adapt.fdo import _shrinkable
    from daft_tpu_torch.adapt.fingerprint import canonical_fingerprint

    tbl, path = small_file
    other = _write(tbl, str(tmp_path / "copy.parquet"), 8)
    col = daft_tpu_torch.col

    def fp(p, lit):
        return canonical_fingerprint(port_optimize(
            daft_tpu_torch.read_parquet(p).where(col("a") > lit)._plan))

    assert fp(path, 5) == fp(path, 9)
    assert fp(path, 5) != fp(other, 5)
    pushed = port_optimize(daft_tpu_torch.read_parquet(path).where(col("a") > 5)._plan)
    plain = port_optimize(daft_tpu_torch.read_parquet(path).select("a")._plan)
    assert _shrinkable(pushed) and not _shrinkable(plain)


# ---------------------------------------------------------------------------
# lineage: a spilled shuffle piece over a scan recomputes from its file
# ---------------------------------------------------------------------------

def test_corrupt_spilled_piece_over_a_scan_recomputes(tmp_path, monkeypatch):
    import tempfile

    from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
    from daft_tpu_torch.spill import MEMORY_LEDGER

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    # the spill counts follow the ledgers, which earlier tests in the
    # process may have left charged
    fresh_ledgers_and_faults()
    rng = np.random.RandomState(11)
    path = _write(pa.table({"k": rng.randint(0, 50, 20_000).astype(np.int64),
                            "v": rng.rand(20_000)}), str(tmp_path / "kv.parquet"), 8)

    def q(pkg):
        return (pkg.read_parquet(path, _split_row_groups=True).repartition(4, "k")
                .groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k"))

    knobs = {**SPILL_BASE, "enable_result_cache": False, "scan_tasks_min_size_bytes": 1,
             "memory_budget_bytes": 40_000}
    ref_clean, got_clean = run_both(q, knobs=knobs)
    with daft_tpu.faults.inject("spill.corrupt", "first_n", n=2), \
            daft_tpu_torch.faults.inject("spill.corrupt", "first_n", n=2):
        ref, got = run_both(q, knobs=knobs)
    gc, rc = got.stats.snapshot()["counters"], ref.stats.snapshot()["counters"]
    assert gc["spilled_partitions"] > 0
    for k in ("partitions_recomputed", "corruption_detected", "spilled_partitions"):
        assert gc.get(k, 0) == rc.get(k, 0), k
    assert gc["partitions_recomputed"] >= 1 and gc.get("lineage_truncated", 0) == 0
    assert got.to_pydict() == got_clean.to_pydict()
    assert_same_rows(got.to_pydict(), ref_clean.to_pydict(), rtol=1e-5, ordered=True)
    assert MEMORY_LEDGER.current == 0 and REF_LEDGER.current == 0


# ---------------------------------------------------------------------------
# a fault of both packages, pinned: Q2's float equality over files
# ---------------------------------------------------------------------------

def test_q2_narrowed_min_equality_over_files_is_pinned(tmp_path, port_queries):
    # Q2 keeps the rows whose ps_supplycost equals its part's min(cost). In
    # the 32-bit mode the device min is float32. In memory a pruning
    # Project on the device path narrows ps_supplycost to float32 too, so
    # the two agree; over files the scan reads ps_supplycost at float64 and,
    # at this size, the final filter runs on the host: no row is equal. Both
    # packages give the same rows over the files (ROADMAP, Queue 3).
    data = tpch_full.generate(scale=SCALE, seed=1)
    paths = {n: _write(data[n], str(tmp_path / f"{n}.parquet"), 8)
             for n in ("part", "partsupp", "supplier", "nation", "region")}

    def frames(pkg, files):
        if files:
            return {n: pkg.read_parquet(p, _split_row_groups=True) for n, p in paths.items()}
        return {n: pkg.from_arrow(data[n]) for n in paths}

    with real_tpu_mode_cfg() as cfg:
        saved = cfg.enable_result_cache
        cfg.enable_result_cache = False
        try:
            ref = tpch_queries.QUERIES[2](frames(daft_tpu, True)).collect().to_pydict()
            d = dataclasses.asdict(cfg)
        finally:
            cfg.enable_result_cache = saved
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = port_queries.QUERIES[2](frames(daft_tpu_torch, True)).collect()
    mem = port_queries.QUERIES[2](frames(daft_tpu_torch, False)).collect().to_pydict()
    c = got.stats.snapshot()["counters"]
    assert got.to_pydict() == ref
    assert len(ref["p_partkey"]) == 0 and len(mem["p_partkey"]) == 2
    assert c.get("host_filters", 0) == 1 and c.get("device_aggregations", 0) == 1
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    host = port_queries.QUERIES[2](frames(daft_tpu_torch, True)).collect().to_pydict()
    assert host == mem


def test_sort_over_a_scan_recomputes_where_the_reference_truncates(tmp_path, monkeypatch):
    # A difference pinned (ROADMAP, Queue 3): the reference captures a scan
    # partition's task after sampling its keys has loaded it, so neither the
    # buffered input of its range shuffle nor its pieces have a recipe and a
    # damaged spill file fails the query. The port captures the task first:
    # every damaged file recomputes from the parquet file.
    import tempfile

    from daft_tpu_torch.spill import MEMORY_LEDGER

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rng = np.random.RandomState(3)
    path = _write(pa.table({"k": rng.randint(0, 10**6, 20_000), "v": rng.rand(20_000)}),
                  str(tmp_path / "kv.parquet"), 8)

    def q(pkg):
        return pkg.read_parquet(path, _split_row_groups=True).sort("k")

    knobs = {**SPILL_BASE, "enable_result_cache": False, "scan_tasks_min_size_bytes": 1,
             "memory_budget_bytes": 40_000}
    _, clean = run_both(q, knobs=knobs)
    with daft_tpu.faults.inject("spill.corrupt", "always"):
        with pytest.raises(daft_tpu.errors.DaftError, match="integrity"):
            run_both(q, knobs=knobs)
    with daft_tpu_torch.faults.inject("spill.corrupt", "always"):
        got = q(daft_tpu_torch).collect()
    c = got.stats.snapshot()["counters"]
    assert c["spilled_partitions"] > 0 and c["shuffles"] == 1
    assert c["partitions_recomputed"] == c["corruption_detected"] == c["spilled_partitions"]
    assert c.get("lineage_truncated", 0) == 0
    assert got.to_pydict() == clean.to_pydict()
    assert MEMORY_LEDGER.current == 0
