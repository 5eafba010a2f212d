"""The memory ledger and the spill of partition buffers, held against
daft_tpu on the CPU (tests/test_spill.py, tests/test_pipelined_io.py
TestAsyncSpill and TestMemoryLedgerHygiene, tests/test_integrity.py's
checksum helpers, the spill integrity cases without parquet and the lineage
log, and tests/test_faults.py's two spill tests).

Each engine case runs one input, built from a seed with numpy, through both
packages under one budget and one set of knobs (``execution_config_from_dict``
with ``device="cpu"``, the reference on one executor thread, the 32-bit
device mode at ``device_min_rows=8``, synchronous spill writes unless a case
turns async ones on): equal rows, and equal ``spilled_partitions``,
``spill_write_failures``, ``unspill_readahead_submitted``,
``corruption_detected``, ``lineage_truncated`` and routing counters, but
for the counts async writes make follow the writer thread's timing in both
packages (``ASYNC_TIMED``, and the number of failed async writes). After every budgeted query,
failures included, the port's ledger reads 0 and its spill directory is gone.
"""

import errno
import os

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import faults as ref_faults
from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
from daft_tpu_torch import faults
from daft_tpu_torch.errors import DaftCorruptionError, DaftError, DaftTransientError
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.spill import MEMORY_LEDGER, MemoryLedger, PartitionBuffer, SpillScope
from torch_parity import SPILL_BASE as BASE
from torch_parity import assert_same_rows, restore_port_config, run_both  # noqa: F401
from torch_parity import spill_counters as _counters
from torch_parity import spill_dirs as _spill_dirs


@pytest.fixture(autouse=True)
def clean_ledgers(tmp_path, monkeypatch):
    """Both ledgers from 0, every fault plan disarmed after the case, and the
    port's spill directories as the case found them. Spill directories go
    to the case's own temp directory: test workers share the system one,
    where another worker's query could add a directory meanwhile."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = _spill_dirs()
    MEMORY_LEDGER.reset()
    REF_LEDGER.reset()
    yield
    faults.disarm()
    ref_faults.disarm()
    assert MEMORY_LEDGER.current == 0
    assert MEMORY_LEDGER.async_spill_inflight == 0
    assert _spill_dirs() == before


# what async writes make follow the writer thread's timing, in both
# packages (tests/torch_parity.py SPILL_BASE)
ASYNC_TIMED = ("unspill_readahead_submitted",)


def check_budgeted(build, budget: int, ordered: bool = False, timed=(), **knobs):
    """``build(pkg)`` through both packages under ``budget``: equal rows and
    counters (but ``timed``, counters that follow a background thread's
    timing in both packages, and ASYNC_TIMED with async writes on), a
    balanced ledger afterwards. Returns (reference, port)."""
    knobs = {**BASE, "memory_budget_bytes": budget, **knobs}
    if knobs["async_spill_writes"]:
        timed = tuple(timed) + ASYNC_TIMED
    ref, got = run_both(build, knobs=knobs)
    assert_same_rows(got.to_pydict(), ref.to_pydict(), ordered=ordered)
    mine, theirs = _counters(got), _counters(ref)
    for k in timed:
        mine.pop(k)
        theirs.pop(k)
    assert mine == theirs
    assert MEMORY_LEDGER.current == 0 and MEMORY_LEDGER.negative_releases == 0
    return ref, got


def _sort_data(n: int, seed: int, keys: int = 2000) -> dict:
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, keys, n), "v": rng.rand(n)}


# ---------------------------------------------------------------------------
# the buffer: tests/test_spill.py TestPartitionBuffer
# ---------------------------------------------------------------------------

def _parts(pkg, n: int, rows: int, seed: int):
    rng = np.random.RandomState(seed)
    return [pkg.micropartition.MicroPartition.from_pydict(
        {"x": rng.randint(0, 100, rows), "y": rng.rand(rows)}) for _ in range(n)]


def test_buffer_spills_past_budget_and_restores_content():
    import daft_tpu.micropartition  # noqa: F401
    import daft_tpu.spill as ref_spill
    import daft_tpu_torch.micropartition  # noqa: F401

    out = {}
    for pkg, spill in ((daft_tpu, ref_spill), (daft_tpu_torch, daft_tpu_torch.spill)):
        spill.MEMORY_LEDGER.reset()
        scope = spill.SpillScope()
        parts = _parts(pkg, 6, 5000, 1)
        per = parts[0].size_bytes()
        buf = spill.PartitionBuffer(budget_bytes=2 * per + 100, scope=scope)
        for p in parts:
            buf.append(p)
        got = buf.parts()
        out[pkg.__name__] = ([q.is_loaded() for q in got], spill.MEMORY_LEDGER.spilled_partitions,
                             per)
        assert [q.table().to_pydict() for q in got] == [p.table().to_pydict() for p in parts]
        assert spill.MEMORY_LEDGER.current <= 2 * per + 100
        buf.release()
        assert spill.MEMORY_LEDGER.current == 0
        scope.cleanup()
    assert out["daft_tpu_torch"] == out["daft_tpu"]
    assert sum(not x for x in out["daft_tpu_torch"][0]) >= 3


def test_spill_slots_recycle_after_task_gc():
    scope = SpillScope()
    buf = PartitionBuffer(budget_bytes=1, scope=scope)  # everything spills
    buf.append(MicroPartition.from_pydict({"x": list(range(4000))}))
    (s1,) = buf.parts()
    assert not s1.is_loaded()
    task1 = s1.scan_task()
    path1 = task1.path
    assert s1.table().to_pydict()["x"] == list(range(4000))
    # task1 is still referenced: the slot is not reused yet
    buf2 = PartitionBuffer(budget_bytes=1, scope=scope)
    buf2.append(MicroPartition.from_pydict({"y": [1.5] * 1000}))
    (s2,) = buf2.parts()
    assert s2.scan_task().path != path1
    assert task1.read().to_pydict() == {"x": list(range(4000))}
    # the last reference goes: the finalizer recycles, the next spill reuses
    del task1, s1
    buf.release()
    buf3 = PartitionBuffer(budget_bytes=1, scope=scope)
    buf3.append(MicroPartition.from_pydict({"z": [7] * 500}))
    (s3,) = buf3.parts()
    assert s3.scan_task().path == path1
    assert s3.table().to_pydict() == {"z": [7] * 500}
    buf2.release()
    buf3.release()
    scope.cleanup()


def test_spilled_partition_head_and_select_keep_original_readable():
    scope = SpillScope()
    buf = PartitionBuffer(budget_bytes=1, scope=scope)
    buf.append(MicroPartition.from_pydict(
        {"a": list(range(1000)), "b": [float(i) for i in range(1000)]}))
    (s,) = buf.parts()
    assert not s.is_loaded() and len(s) == 1000 and not s.is_loaded()
    assert s.head(5).table().to_pydict() == {"a": [0, 1, 2, 3, 4], "b": [0.0, 1.0, 2.0, 3.0, 4.0]}
    sel = s.select_columns(["a"])
    assert sel.schema.field_names() == ["a"]
    assert sel.table().to_pydict() == {"a": list(range(1000))}
    full = s.table().to_pydict()
    assert full["a"] == list(range(1000)) and len(full["b"]) == 1000
    buf.release()
    scope.cleanup()


def test_retaken_slot_read_is_loud():
    scope = SpillScope()
    buf = PartitionBuffer(budget_bytes=1, scope=scope)
    buf.append(MicroPartition.from_pydict({"x": list(range(2000))}))
    (s,) = buf.parts()
    task = s.scan_task()
    # force the live task's slot back onto the free list and take it again
    scope.recycle(task.path)
    assert scope.take_slot() == task.path
    with pytest.raises(RuntimeError, match="re-taken"):
        task.read()
    buf.release()
    scope.cleanup()


def test_multi_chunk_bucket_spills_and_restores():
    from daft_tpu_torch.table import Table

    scope = SpillScope()
    chunks = [Table.from_pydict({"x": list(range(i * 100, i * 100 + 100))}) for i in range(5)]
    buf = PartitionBuffer(budget_bytes=1, scope=scope)
    buf.append(MicroPartition(chunks[0].schema, chunks))
    (s,) = buf.parts()
    assert not s.is_loaded()
    assert s.table().to_pydict()["x"] == list(range(500))
    buf.release()
    scope.cleanup()


def test_no_budget_never_spills():
    buf = PartitionBuffer(budget_bytes=None)
    for _ in range(4):
        buf.append(MicroPartition.from_pydict({"x": list(range(1000))}))
    assert all(p.is_loaded() for p in buf.parts())
    assert MEMORY_LEDGER.spilled_partitions == 0
    buf.release()


@pytest.mark.parametrize("dtypes", ["numeric", "strings_dates"])
def test_spilled_partition_keeps_its_engine_schema(dtypes):
    """The read-back is the partition's engine schema exactly (large
    strings, dates, nulls), not what the IPC file infers."""
    import datetime

    n = 3000
    data = ({"i": [None if i % 7 == 0 else i for i in range(n)], "f": [i / 3 for i in range(n)]}
            if dtypes == "numeric" else
            {"s": [None if i % 5 == 0 else f"s{i % 9}" for i in range(n)],
             "d": [datetime.date(2024, 1, 1 + i % 28) for i in range(n)]})
    part = MicroPartition.from_pydict(data)
    scope = SpillScope()
    buf = PartitionBuffer(budget_bytes=1, scope=scope, integrity=True)
    buf.append(part)
    (s,) = buf.parts()
    assert not s.is_loaded()
    back = s.table()
    assert back.schema == part.schema
    assert back.to_arrow().equals(part.table().to_arrow())
    buf.release()
    scope.cleanup()


# ---------------------------------------------------------------------------
# the engine: tests/test_spill.py TestEngineSpill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_spill", [False, True], ids=["sync", "async"])
def test_sort_spills_with_parity(async_spill):
    data = _sort_data(40_000, 42)
    ref, got = check_budgeted(lambda pkg: pkg.from_pydict(data).repartition(6).sort("k"),
                              64 * 1024, async_spill_writes=async_spill)
    c = _counters(got)
    assert c["spilled_partitions"] > 0 and c["device_sorts"] == 6
    assert got.to_pydict()["k"] == sorted(data["k"].tolist())


def test_hash_join_spills_with_parity():
    rng = np.random.RandomState(3)
    nl, nr = 16_000, 10_000
    ldata = {"k": rng.randint(0, 3000, nl), "lv": rng.rand(nl)}
    rdata = {"k2": rng.randint(0, 3000, nr), "rv": rng.rand(nr)}

    def build(pkg):
        return (pkg.from_pydict(ldata).repartition(4)
                .join(pkg.from_pydict(rdata).repartition(4), left_on="k", right_on="k2"))

    ref, got = check_budgeted(build, 32 * 1024)
    c = _counters(got)
    assert c["spilled_partitions"] > 0 and c["device_join_probes"] == 4


def test_groupby_shuffle_spills_with_parity():
    rng = np.random.RandomState(4)
    n = 24_000
    data = {"g": rng.randint(0, 50, n), "v": rng.rand(n), "c": rng.randint(0, 9, n)}

    def build(pkg):
        return (pkg.from_pydict(data).repartition(6).groupby("g")
                .agg(pkg.col("c").sum().alias("s"), pkg.col("v").count().alias("n")).sort("g"))

    ref, got = check_budgeted(build, 32 * 1024, ordered=True)
    assert _counters(got)["spilled_partitions"] > 0

    def distinct(pkg):
        return pkg.from_pydict(data).repartition(6).agg(pkg.col("c").count_distinct().alias("nd"))

    check_budgeted(distinct, 32 * 1024)


def test_high_water_bounded_at_four_times_the_budget():
    n, parts, budget = 100_000, 8, 256 * 1024
    data = _sort_data(n, 5, keys=1 << 30)
    ref, got = check_budgeted(lambda pkg: pkg.from_pydict(data).repartition(parts).sort("k"),
                              budget, ordered=True)
    assert _counters(got)["spilled_partitions"] > 0
    per_part = (n // parts) * 16 * 2  # rows x 2 columns x 8 bytes, twice over
    assert MEMORY_LEDGER.high_water <= budget + per_part
    assert MEMORY_LEDGER.high_water == REF_LEDGER.high_water


def test_limit_early_stop_releases_ledger():
    data = _sort_data(30_000, 6, keys=1000)
    ref, got = check_budgeted(lambda pkg: pkg.from_pydict(data).repartition(6).sort("k").limit(5),
                              32 * 1024, ordered=True)
    assert got.to_pydict()["k"] == sorted(data["k"].tolist())[:5]
    assert MEMORY_LEDGER.negative_releases == 0


def test_abandoned_join_releases_ledger():
    rng = np.random.RandomState(7)
    ldata = {"k": rng.randint(0, 2000, 20_000), "lv": rng.rand(20_000)}
    rdata = {"k2": rng.randint(0, 2000, 12_000), "rv": rng.rand(12_000)}
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        memory_budget_bytes=32 * 1024)
    q = (daft_tpu_torch.from_pydict(ldata).repartition(4)
         .join(daft_tpu_torch.from_pydict(rdata).repartition(4), left_on="k", right_on="k2")
         .limit(3))
    assert len(q.to_pydict()["k"]) == 3
    assert q.stats.snapshot()["counters"].get("spilled_partitions", 0) > 0


@pytest.mark.parametrize("how", ["sort_merge", "hash"])
def test_budgeted_join_over_three_partitions_equals_unbudgeted(how):
    rng = np.random.RandomState(8)
    ldata = {"k": rng.randint(0, 500, 9000), "a": rng.rand(9000)}
    rdata = {"k": rng.randint(0, 500, 6000), "b": rng.randint(0, 99, 6000)}

    def build(pkg):
        return (pkg.from_pydict(ldata).into_partitions(3)
                .join(pkg.from_pydict(rdata).into_partitions(3), on="k", strategy=how))

    ref, got = check_budgeted(build, 16 * 1024)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
    plain = build(daft_tpu_torch).collect()
    assert_same_rows(got.to_pydict(), plain.to_pydict())
    assert _counters(got)["spilled_partitions"] > 0


# ---------------------------------------------------------------------------
# async writes and readahead: tests/test_pipelined_io.py TestAsyncSpill
# ---------------------------------------------------------------------------

def test_async_spill_parity_with_sync_and_readahead_engages():
    data = _sort_data(40_000, 9)

    def build(pkg):
        return pkg.from_pydict(data).repartition(6).sort("k")

    sync_ref, sync = check_budgeted(build, 64 * 1024, ordered=True, async_spill_writes=False,
                                    unspill_readahead=False)
    ref, got = check_budgeted(build, 64 * 1024, ordered=True, async_spill_writes=True,
                              unspill_readahead=True)
    assert got.to_pydict() == sync.to_pydict()
    c = _counters(got)
    assert c["spilled_partitions"] > 0 and c["unspill_readahead_submitted"] > 0
    assert _counters(sync)["unspill_readahead_submitted"] == 0


def test_async_spill_write_failure_holds_in_memory():
    data = _sort_data(20_000, 10, keys=500)
    for pkg_faults in (ref_faults, faults):
        pkg_faults.arm("spill.write", "always")
    # a failed async write moves its bytes into the ledger when the writer
    # thread gets to it, and until then a later append sees the budget free
    # and tries to spill too: how many writes fail follows the writer's
    # timing, in both packages
    ref, got = check_budgeted(lambda pkg: pkg.from_pydict(data).repartition(4).sort("k"),
                              32 * 1024, ordered=True, timed=("spill_write_failures",),
                              async_spill_writes=True)
    for df in (ref, got):
        c = _counters(df)
        assert c["spill_write_failures"] > 0 and c["spilled_partitions"] == 0


@pytest.mark.parametrize("readahead", [False, True])
def test_spill_readback_fault_propagates(readahead):
    data = _sort_data(20_000, 11, keys=500)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        memory_budget_bytes=16 * 1024,
                                        unspill_readahead=readahead)
    with faults.inject("spill.readback", "always"):
        with pytest.raises(DaftTransientError):
            daft_tpu_torch.from_pydict(data).repartition(4).sort("k").to_pydict()


def test_io_breakdown_surface():
    data = _sort_data(20_000, 12, keys=500)
    # synchronous writes: an async one's partition may be read back from
    # memory before it lands, and then no file read is timed
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        memory_budget_bytes=32 * 1024, async_spill_writes=False)
    q = daft_tpu_torch.from_pydict(data).repartition(4).sort("k")
    q.collect()
    io = q.stats.io_breakdown()
    assert set(io) >= {"io_wait_share", "spill_write_mbps", "spill_read_mbps"}
    assert 0.0 <= io["io_wait_share"] <= 1.0
    assert io["spill_write_mbps"] > 0 and io["spill_read_mbps"] > 0


# ---------------------------------------------------------------------------
# the ledger: tests/test_pipelined_io.py TestMemoryLedgerHygiene
# ---------------------------------------------------------------------------

def test_double_release_clamps_and_counts():
    for led in (MEMORY_LEDGER, REF_LEDGER):
        led.reset()
        led.add(100)
        led.sub(100)
        led.sub(100)
        assert (led.current, led.negative_releases) == (0, 1)
        led.sub(1)
        assert (led.current, led.negative_releases) == (0, 2)
        led.add(50)
        led.sub(80)
        assert (led.current, led.negative_releases) == (0, 3)
        led.reset()
        assert led.negative_releases == 0 and led.snapshot()["high_water"] == 0


def test_snapshot_covers_the_reference_accounts():
    mine = set(MemoryLedger().snapshot())
    ref = set(REF_LEDGER.snapshot())
    # every account of the reference is the port's since the distributed
    # runner brought dist_inflight (the sub-plan result cache's came with the
    # scans, the scan readahead's and the working set's with io/prefetch, the
    # batching executor's and the model actors' with batch/, the stream
    # channels' and the dispatch window's with stream/ and scheduler.py)
    later = set()
    assert mine == ref - later


def test_engine_queries_never_double_release():
    data = _sort_data(30_000, 13, keys=1000)
    check_budgeted(lambda pkg: pkg.from_pydict(data).repartition(6).sort("k").limit(5),
                   32 * 1024, ordered=True, async_spill_writes=True, unspill_readahead=True)
    assert MEMORY_LEDGER.negative_releases == 0


def test_failed_query_releases_ledger_and_directory():
    data = _sort_data(20_000, 14, keys=500)
    # readahead off: a background read's failure is retrieved by the
    # consumer's own read, which an nth plan lets through
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        memory_budget_bytes=16 * 1024, unspill_readahead=False)
    with faults.inject("spill.readback", "nth", n=3):
        with pytest.raises(DaftTransientError):
            daft_tpu_torch.from_pydict(data).repartition(4).sort("k").to_pydict()


def test_unbudgeted_query_leaves_no_spill_and_counts_as_before():
    data = _sort_data(20_000, 15, keys=500)
    ref, got = run_both(lambda pkg: pkg.from_pydict(data).repartition(4).sort("k"),
                        knobs=BASE)
    assert_same_rows(got.to_pydict(), ref.to_pydict(), ordered=True)
    assert _counters(got) == _counters(ref)
    assert _counters(got)["spilled_partitions"] == 0 and MEMORY_LEDGER.high_water > 0


# ---------------------------------------------------------------------------
# integrity: tests/test_integrity.py
# ---------------------------------------------------------------------------

def test_checksum_helpers_equal_the_reference(tmp_path):
    from daft_tpu.integrity import checksum as ref_ck

    from daft_tpu_torch.integrity import checksum as ck

    data = b"the quick brown fox" * 100
    assert ck.crc32_bytes(data) == ref_ck.crc32_bytes(data)
    flipped = ck.flip_payload_bits(data)
    assert flipped == ref_ck.flip_payload_bits(data) and flipped != data
    assert ck.crc32_bytes(flipped) != ck.crc32_bytes(data)
    t1 = pa.table({"a": [1, 2, 3], "s": ["x", "y", None]})
    t2 = pa.table({"a": [1, 2, 4], "s": ["x", "y", None]})
    assert ck.crc32_table(t1) == ref_ck.crc32_table(t1) != ck.crc32_table(t2)
    d1 = pa.table({"g": pa.array(["a", "b", "a"]).dictionary_encode()})
    d2 = pa.table({"g": pa.array(["a", "Z", "a"]).dictionary_encode()})
    assert ck.crc32_table(d1) == ref_ck.crc32_table(d1) != ck.crc32_table(d2)
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as f:
        f.write(b"spilled bytes" * 1000)
    before = ck.crc32_file(p)
    assert before == ref_ck.crc32_file(p)
    ck.flip_file_bits(p)
    assert ck.crc32_file(p) != before


def test_lineage_log_bounds_and_forget():
    from daft_tpu_torch.integrity.lineage import LineageLog

    log = LineageLog(depth=2)
    k1 = log.record(lambda: [1])
    k2 = log.record(lambda: [2])
    k3 = log.record(lambda: [3])
    assert log.get(k1) is None  # evicted: truncated lineage
    assert log.get(k2) is not None and log.get(k3) is not None
    assert log.evicted == 1
    log.forget(k2)
    assert log.get(k2) is None
    assert LineageLog(depth=0).record(lambda: []) is None
    assert log.snapshot() == {"depth": 2, "live": 1, "recorded": 3, "evicted": 1}


class _FakeScanTask:
    """A re-readable scan-task surface (stable storage in the test)."""

    def __init__(self, tbl):
        self._tbl = tbl
        self.schema = tbl.schema

    @property
    def materialized_schema(self):
        return self._tbl.schema

    def num_rows(self):
        return len(self._tbl)

    def size_bytes(self):
        return self._tbl.size_bytes()

    def read(self):
        return self._tbl

    def read_chunks(self):
        return [self._tbl]


@pytest.mark.parametrize("damage", ["missing", "flipped"])
def test_damaged_spill_file_recomputes_through_lineage(damage):
    from daft_tpu_torch.execution import RuntimeStats
    from daft_tpu_torch.integrity.checksum import flip_file_bits
    from daft_tpu_torch.integrity.lineage import LineageLog
    from daft_tpu_torch.table import Table

    tbl = Table.from_pydict({"a": list(range(5000))})
    stats = RuntimeStats()
    buf = PartitionBuffer(1, stats, ledger=MemoryLedger(), integrity=True, lineage=LineageLog())
    buf.append(MicroPartition.from_scan_task(_FakeScanTask(tbl)))
    spilled = buf.parts()[0]
    assert not spilled.is_loaded()
    path = spilled.scan_task().path
    if damage == "missing":
        os.remove(path)
    else:
        flip_file_bits(path)
    del spilled
    out = list(buf.drain())[0].table()
    assert out.to_arrow().equals(tbl.to_arrow())
    c = stats.snapshot()["counters"]
    assert c["partitions_recomputed"] == 1
    assert c.get("corruption_detected", 0) == (damage == "flipped")
    buf.scope.cleanup()


def test_corrupt_spill_over_in_memory_source_raises_corruption():
    """Truncated lineage: an in-memory source has nothing to recompute from,
    so the corruption reaches the caller as DaftCorruptionError (a
    DaftError), counted as lineage_truncated, never a garbled result. The
    reference raises a DaftError too, after its transient task retries.
    Synchronous writes in both: an async write's bits flip when the writer
    thread gets to it, and a read before that is served from memory."""
    n = 30_000
    data = {"a": list(range(n)), "b": [i % 7 for i in range(n)]}

    def build(pkg):
        return (pkg.from_pydict(data).repartition(4, "b").groupby("b")
                .agg(pkg.col("a").sum().alias("s")).sort("b"))

    from daft_tpu.context import get_context

    with ref_faults.inject("spill.corrupt", "always"):
        cfg = get_context().execution_config
        saved = (cfg.memory_budget_bytes, cfg.enable_result_cache, cfg.async_spill_writes)
        cfg.memory_budget_bytes, cfg.enable_result_cache, cfg.async_spill_writes = (
            20_000, False, False)
        try:
            with pytest.raises(daft_tpu.errors.DaftError):
                build(daft_tpu).collect()
        finally:
            cfg.memory_budget_bytes, cfg.enable_result_cache, cfg.async_spill_writes = saved
    ref_events = daft_tpu.query_log()[-1]["events"]
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        memory_budget_bytes=20_000, async_spill_writes=False)
    q = build(daft_tpu_torch)
    with faults.inject("spill.corrupt", "always"):
        with pytest.raises(DaftCorruptionError) as e:
            q.collect()
    assert isinstance(e.value, DaftError)
    assert ref_events.get("lineage_truncated", 0) >= 1
    c = q.stats.snapshot()["counters"]
    assert c.get("lineage_truncated", 0) >= 1 and c.get("corruption_detected", 0) >= 1


def test_integrity_off_skips_checksums_and_counters():
    data = _sort_data(20_000, 16, keys=500)
    ref, got = check_budgeted(lambda pkg: pkg.from_pydict(data).repartition(4).sort("k"),
                              32 * 1024, ordered=True, partition_integrity=False,
                              lineage_recomputation=False, async_spill_writes=False)
    assert _counters(got)["spilled_partitions"] > 0
    part = MicroPartition.from_pydict({"a": list(range(500))})
    buf = PartitionBuffer(1, integrity=False)
    buf.append(part)
    assert buf.parts()[0].scan_task().expected_crc is None
    buf.release()
    buf.scope.cleanup()


def test_disk_full_classified_and_partial_file_removed(monkeypatch):
    import daft_tpu_torch.spill as spill_mod
    from daft_tpu_torch.execution import RuntimeStats

    written = []

    def enospc_write(path, tbls):
        with open(path, "wb") as f:
            f.write(b"partial")  # the torn write ENOSPC leaves behind
        written.append(path)
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(spill_mod, "_write_spill_ipc", enospc_write)
    stats = RuntimeStats()
    ledger = MemoryLedger()
    buf = PartitionBuffer(1, stats, ledger=ledger, integrity=True)
    buf.append(MicroPartition.from_pydict({"a": list(range(4000))}))
    c = stats.snapshot()["counters"]
    assert c.get("spill_disk_full", 0) == 1 and c.get("spill_write_failures", 0) == 1
    assert ledger.disk_full_events == 1 == ledger.snapshot()["disk_full_events"]
    assert written and not os.path.exists(written[0])
    out = list(buf.drain())[0]
    assert out.is_loaded() and len(out) == 4000
    buf.scope.cleanup()


def test_a_defect_in_the_write_reaches_the_caller(monkeypatch):
    """The hold-in-memory catch takes the disk, arrow and the injected fault
    only: any other exception of the write reaches the caller."""
    import daft_tpu_torch.spill as spill_mod

    def broken(path, tbls):
        raise KeyError("a defect")

    monkeypatch.setattr(spill_mod, "_write_spill_ipc", broken)
    buf = PartitionBuffer(1)
    with pytest.raises(KeyError):
        buf.append(MicroPartition.from_pydict({"a": list(range(100))}))
    buf.scope.cleanup()


# ---------------------------------------------------------------------------
# tests/test_faults.py TestSpillFaults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["always", "first_n"])
def test_spill_write_fault_holds_in_memory_then_heals(mode):
    from daft_tpu.execution import RuntimeStats as RefStats
    from daft_tpu.micropartition import MicroPartition as RefPart
    from daft_tpu.spill import PartitionBuffer as RefBuffer

    from daft_tpu_torch.execution import RuntimeStats

    out = []
    for fm, Stats, Part, Buffer in ((ref_faults, RefStats, RefPart, RefBuffer),
                                    (faults, RuntimeStats, MicroPartition, PartitionBuffer)):
        stats = Stats()
        buf = Buffer(budget_bytes=1, stats=stats)
        part = Part.from_pydict({"a": list(range(1000))})
        fm.arm("spill.write", mode, n=1)
        buf.append(part)
        buf.append(part)
        fm.disarm()
        assert all(p.table().to_pydict()["a"] == list(range(1000)) for p in buf.parts())
        out.append({k: stats.counters.get(k, 0)
                    for k in ("spill_write_failures", "spilled_partitions", "faults_injected")})
        buf.release()
        buf.scope.cleanup()
    assert out[1] == out[0]
    assert out[1]["spill_write_failures"] == (2 if mode == "always" else 1)
