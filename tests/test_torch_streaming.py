"""The port's morsel pipeline (daft_tpu_torch/stream/) against the
reference's (daft_tpu/stream/, tests/test_streaming.py, the streaming legs
of tests/test_segment.py and tests/test_batch.py).

Every query runs through both packages from one numpy seed under one
config (``torch_parity.run_seq``: the reference's 32-bit config with the
case's knobs, the port's mapped from it, on the CPU) and holds the same
rows, the routing counters of ``torch_parity.COUNTERS`` and the streaming
counters (``stream_morsels``, ``morsels_short_circuited``,
``task_retries``), with streaming on and off. The host-path cases set
``use_device_kernels`` off, as the reference's streaming tests run; the
device-morsel cases keep it on. The channel and morsel cases drive both
packages' units the same way. No case depends on a duration: a blocked
put is observed through the channel's own state.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu.spill
import daft_tpu.stream
import daft_tpu_torch
import daft_tpu_torch.spill
import daft_tpu_torch.stream
from torch_parity import (COUNTERS, fresh_ledgers_and_faults, restore_port_config,  # noqa: F401
                          run_seq)

STREAM_COUNTERS = ("stream_morsels", "morsels_short_circuited", "task_retries")
HOST = {"use_device_kernels": False, "enable_result_cache": False, "subplan_result_cache": False,
        "scan_tasks_min_size_bytes": 1, "scan_retry_backoff_s": 0.0,
        "task_retry_backoff_s": 0.0}


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


def _parquet_dir(tmp_path, nfiles=4, rows_per=900, seed=23, row_group_size=None):
    rng = np.random.RandomState(seed)
    d = tmp_path / "scan"
    d.mkdir(exist_ok=True)
    for i in range(nfiles):
        papq.write_table(pa.table({
            "k": pa.array(rng.randint(0, 30, rows_per)),
            "v": pa.array(rng.randint(0, 10 ** 6, rows_per)),
            "f": pa.array(rng.rand(rows_per)),
            "s": pa.array([f"r{i}_{j % 61}" for j in range(rows_per)]),
        }), str(d / f"part-{i:02d}.parquet"), row_group_size=row_group_size)
    return os.path.join(str(d), "*.parquet")


def _counts(df, keys=COUNTERS + STREAM_COUNTERS):
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in keys}


def _parts(df):
    return [p.to_pydict() for p in df.iter_partitions()]


# ---------------------------------------------------------------------------
# the same rows and counters, streaming on and off, at several morsel sizes
# ---------------------------------------------------------------------------

MORSEL_SIZES = (7, 1024, 128 * 1024, 10 ** 9)

SHAPES = {
    "scan_map_agg": lambda pkg, path: (
        pkg.read_parquet(path).where(pkg.col("k") < 25)
        .with_column("w", pkg.col("v") * 2 + pkg.col("k"))
        .groupby("k").agg(pkg.col("w").sum().alias("s"), pkg.col("v").count().alias("n"))
        .sort("k")),
    "map_chain": lambda pkg, path: (
        pkg.read_parquet(path).where(pkg.col("f") < 0.9)
        .with_column("fv", pkg.col("f") * pkg.col("v"))),
    "limit": lambda pkg, path: (
        pkg.read_parquet(path).with_column("w", pkg.col("v") + 1)
        .where(pkg.col("w") % 3 != 0).limit(1234)),
    "fused_chain": lambda pkg, path: (
        pkg.read_parquet(path).where(pkg.col("k") > 2)
        .with_column("a", pkg.col("v") * 3).with_column("b", pkg.col("a") - pkg.col("k"))
        .where(pkg.col("b") % 2 == 0).select("k", "b")),
}


@pytest.mark.parametrize("morsel", MORSEL_SIZES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rows_and_counters_as_the_reference(shape, morsel, tmp_path):
    path = _parquet_dir(tmp_path)

    def seq(pkg, set_knobs):
        out = []
        for streaming in (False, True):
            set_knobs(streaming_execution=streaming, morsel_size_rows=morsel)
            df = SHAPES[shape](pkg, path)
            rows = _parts(df) if shape != "scan_map_agg" else df.to_pydict()
            # under a limit, how many morsels the 8 producers made before the
            # stop depends on their timing: the routing counters only there
            c = _counts(df, COUNTERS if shape == "limit" else COUNTERS + STREAM_COUNTERS)
            out.append((rows, c, _counts(df)["stream_morsels"] > 0))
        return out

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    (off_rows, _, off_streamed), (on_rows, _, on_streamed) = got
    assert on_rows == off_rows  # streaming changes nothing a query returns
    assert not off_streamed and on_streamed


def test_limit_zero_and_smaller_than_a_morsel(tmp_path):
    path = _parquet_dir(tmp_path)

    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=500)
        out = []
        for n in (0, 3, 499, 501):
            df = pkg.read_parquet(path).with_column("w", pkg.col("v") - 1).limit(n)
            out.append((df.to_pydict(), _counts(df, COUNTERS)))
        return out

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    assert [len(r["w"]) for r, _ in got] == [0, 3, 499, 501]


def test_streaming_off_means_off():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=False)
        df = (pkg.from_pydict({"x": list(range(500))}).into_partitions(2)
              .with_column("y", pkg.col("x") * 2))
        df.collect()
        return "stream_morsels" in df.stats.snapshot()["counters"]

    assert run_seq(seq, knobs=HOST) == [False, False]


def test_udf_chain_declines():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True)

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def plus1(x):
            return [v + 1 for v in x.to_pylist()]

        df = (pkg.from_pydict({"x": list(range(200))}).into_partitions(2)
              .with_column("y", plus1(pkg.col("x"))))
        return df.to_pydict()["y"], "stream_morsels" in df.stats.snapshot()["counters"]

    ref, got = run_seq(seq, knobs=HOST)
    assert ref == got == ([v + 1 for v in range(200)], False)


def test_breaker_above_reads_rechunked_partitions():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=32)
        df = (pkg.from_pydict({"x": list(range(1000))}).into_partitions(3)
              .with_column("y", (pkg.col("x") * 37) % 101).sort("y"))
        return df.to_pydict()["y"], _counts(df)

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    assert got[0] == sorted((x * 37) % 101 for x in range(1000))
    assert got[1]["stream_morsels"] > 0


# ---------------------------------------------------------------------------
# the limit sink and its short-circuits
# ---------------------------------------------------------------------------

def test_scan_partitions_beyond_the_limit_are_never_read(tmp_path):
    # one producer in flight and one morsel a file. The optimizer puts the
    # limit under the projection, so two segments stream: the limit's over
    # the scan and the projection's over it. The first file's morsel
    # satisfies the limit: one file is read (its open and its one chunk, two
    # scan.read checks), each segment streams one morsel, and the seven
    # other files are short-circuited unread, in both packages
    path = _parquet_dir(tmp_path, nfiles=8, rows_per=600)

    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=1000, stream_producer_window=1,
                  scan_prefetch_depth=0)
        pkg.faults.arm("scan.read", "first_n", n=0)  # counts the reads, fires none
        try:
            df = (pkg.read_parquet(path).with_column("w", pkg.col("v") + 1)
                  .where(pkg.col("w") > 0).limit(100))
            n = len(df.to_pydict()["w"])
            reads = pkg.faults.snapshot()["calls"].get("scan.read", 0)
        finally:
            pkg.faults.disarm()
        return n, reads, _counts(df)

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    n, reads, c = got
    assert (n, reads, c["stream_morsels"], c["morsels_short_circuited"]) == (100, 2, 2, 7)


def test_limit_leaves_no_live_channel():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=64, stream_channel_capacity=2,
                  executor_threads=4)
        df = (pkg.from_pydict({"x": list(range(20000))}).into_partitions(8)
              .with_column("y", pkg.col("x") * 2).where(pkg.col("y") >= 0).limit(50))
        n = len(df.to_pydict()["y"])
        snap = pkg.stream.channels_snapshot()
        return n, snap["active_channels"], snap["queued_bytes"]

    assert run_seq(seq, knobs=HOST) == [(50, 0, 0), (50, 0, 0)]


# ---------------------------------------------------------------------------
# bounded memory: the channels' bytes are charged and settled
# ---------------------------------------------------------------------------

def test_budgeted_stream_settles_its_charges():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=512, stream_channel_capacity=64,
                  stream_producer_window=2, executor_threads=4,
                  memory_budget_bytes=256 * 1024)
        rows = 24000
        df = (pkg.from_pydict({"x": list(range(rows)),
                               "s": [f"payload-{i:08d}" * 4 for i in range(rows)]})
              .into_partitions(2).with_column("y", pkg.col("x") + 1))
        total = sum(len(p) for p in df.iter_partitions())
        led = pkg.spill.MEMORY_LEDGER.snapshot()
        return total, _counts(df)["stream_morsels"], led["stream_inflight"], led["current"]

    assert run_seq(seq, knobs=HOST) == [(24000, 48, 0, 0)] * 2


# ---------------------------------------------------------------------------
# failures reach the consumer
# ---------------------------------------------------------------------------

def test_scan_fault_surfaces_on_the_consumer(tmp_path):
    path = _parquet_dir(tmp_path)

    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, task_retry_attempts=0)
        df = pkg.read_parquet(path).with_column("w", pkg.col("v") + 1).where(pkg.col("w") > 0)
        with pkg.faults.inject("scan.read", "always"):
            with pytest.raises(pkg.errors.DaftTransientError):
                df.to_pydict()
        return (pkg.stream.channels_snapshot()["active_channels"],
                pkg.query_log()[-1]["outcome"])

    assert run_seq(seq, knobs=HOST) == [(0, "error")] * 2


def test_scan_fault_beyond_io_retries_reruns_the_partition(tmp_path):
    # the scan's own retries are spent on the first partition read; the
    # producer re-runs the partition (nothing was pushed yet)
    path = _parquet_dir(tmp_path, nfiles=1)

    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, task_retry_attempts=2, scan_prefetch_depth=0)
        attempts = pkg.get_context().execution_config.scan_retry_attempts
        df = pkg.read_parquet(path).with_column("w", pkg.col("v") + 1).where(pkg.col("w") >= 0)
        with pkg.faults.inject("scan.read", "first_n", n=attempts):
            n = len(df.to_pydict()["w"])
        return n, _counts(df)

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    assert got[0] == 900 and got[1]["task_retries"] == 1


def test_map_stage_error_propagates():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True)
        df = (pkg.from_pydict({"x": [1, 2, 0, 4] * 100}).into_partitions(2)
              .with_column("y", pkg.col("x").cast(pkg.DataType.string())
                           .cast(pkg.DataType.date())))
        with pytest.raises(Exception) as ei:
            df.to_pydict()
        return type(ei.value).__name__

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref


def test_deadline_expires_instead_of_hanging():
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=16, execution_timeout_s=0.0)
        df = (pkg.from_pydict({"x": list(range(50000))}).into_partitions(8)
              .with_column("y", pkg.col("x") * 3).where(pkg.col("y") % 7 != 0))
        with pytest.raises(pkg.errors.DaftTimeoutError):
            df.to_pydict()
        return pkg.query_log()[-1]["outcome"]

    assert run_seq(seq, knobs=HOST) == ["timeout", "timeout"]


def test_kernel_error_in_a_stream_producer_reaches_the_caller(monkeypatch):
    # device-morsel mode: a Filter/Project chain over an in-memory partition
    # above the morsel size stages each morsel; a launch that fails as a
    # kernel that does not build fails the query from the producer
    from daft_tpu_torch.errors import DaftKernelError
    from daft_tpu_torch.kernels import device

    seen = []

    def broken(*a, **k):
        import threading

        seen.append(threading.current_thread().name)
        raise DaftKernelError("the projection kernel did not build")

    monkeypatch.setattr(device, "eval_projection_device_async", broken)
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
        device="cpu", device_min_rows=8, morsel_size_rows=64, enable_result_cache=False))
    df = (daft_tpu_torch.from_pydict({"x": list(range(1000))})
          .where(daft_tpu_torch.col("x") % 3 != 0)
          .with_column("y", daft_tpu_torch.col("x") * 2))
    with pytest.raises(DaftKernelError, match="did not build"):
        df.collect()
    assert seen and all(n.startswith("daft-torch-exec") for n in seen)
    assert daft_tpu_torch.query_log()[-1]["outcome"] == "error"
    assert daft_tpu_torch.stream.channels_snapshot()["active_channels"] == 0


# ---------------------------------------------------------------------------
# device-morsel mode (the streaming legs of tests/test_segment.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True], ids=["nostream", "stream"])
@pytest.mark.parametrize("residency", [False, True], ids=["staged", "resident"])
def test_device_morsel_mode_as_the_reference(streaming, residency):
    rng = np.random.RandomState(11)
    n = 1000
    tbl = pa.table({"k": pa.array(rng.randint(0, 6, n)), "v": pa.array(rng.randint(0, 999, n)),
                    "f": pa.array(rng.rand(n))})

    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=streaming, morsel_size_rows=64,
                  device_residency=residency)
        df = (pkg.from_arrow(tbl).where(pkg.col("v") > 100)
              .with_column("w", pkg.col("f") * 2.0).with_column("u", pkg.col("v") + 1))
        mapped = df.to_pydict()
        agg = (pkg.from_arrow(tbl).where(pkg.col("v") > 100)
               .with_column("w", pkg.col("f") * 2.0)
               .groupby("k").agg(pkg.col("w").sum().alias("s"), pkg.col("v").count().alias("c"))
               .sort("k"))
        return mapped, _counts(df), agg.to_pydict(), _counts(agg)

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert got[0] == ref[0] and got[1] == ref[1] and got[3] == ref[3]
    assert got[2]["k"] == ref[2]["k"] and got[2]["c"] == ref[2]["c"]
    np.testing.assert_allclose(got[2]["s"], ref[2]["s"], rtol=1e-6)
    # the map chain alone streams in device-morsel mode when residency is on
    assert (got[1]["stream_morsels"] > 0) == (streaming and residency)
    assert got[1]["device_fused_maps"] > 0


def test_device_morsel_mode_keeps_the_aggregate_launches():
    # the aggregate above a streamed chain sees whole partitions: K1's
    # entries do not move with streaming
    from daft_tpu_torch.kernels import segment_sums

    rng = np.random.RandomState(3)
    tbl = pa.table({"k": pa.array(rng.randint(0, 9, 4000)), "f": pa.array(rng.rand(4000))})
    entries = []
    for streaming in (False, True):
        daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
            device="cpu", device_min_rows=8, morsel_size_rows=256, streaming_execution=streaming,
            enable_result_cache=False))
        e0 = segment_sums.ENTRIES
        df = (daft_tpu_torch.from_arrow([tbl, tbl])
              .with_column("g", daft_tpu_torch.col("f") * 3.0)
              .where(daft_tpu_torch.col("g") > 0.5)
              .groupby("k").agg(daft_tpu_torch.col("g").sum().alias("s")).sort("k"))
        out = df.to_pydict()
        entries.append((segment_sums.ENTRIES - e0, out["k"]))
    assert entries[0] == entries[1] and entries[0][0] > 0


# ---------------------------------------------------------------------------
# batch-declared UDFs in a stream (the streaming legs of tests/test_batch.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "nostream"])
def test_batch_udf_streams_as_the_reference(streaming):
    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=streaming, morsel_size_rows=250, batch_max_rows=300)

        @pkg.batch_udf(return_dtype=pkg.DataType.int64(), max_rows=300)
        def plus(x):
            import pyarrow.compute as pc

            return pc.add(x.to_arrow(), 7)

        df = (pkg.from_pydict({"x": list(range(4000))}).into_partitions(4)
              .with_column("y", plus(pkg.col("x"))))
        parts = _parts(df)
        c = df.stats.snapshot()["counters"]
        return (parts, c.get("stream_morsels", 0), c.get("batches_formed", 0),
                pkg.spill.MEMORY_LEDGER.batch_inflight)

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    assert (got[1] > 0) == streaming and got[3] == 0


# ---------------------------------------------------------------------------
# observability of a streamed query
# ---------------------------------------------------------------------------

def test_record_health_and_explain_of_a_streamed_query(tmp_path):
    from daft_tpu.obs.health import validate_health
    from daft_tpu.obs.querylog import validate_record

    path = _parquet_dir(tmp_path)

    def seq(pkg, set_knobs):
        set_knobs(streaming_execution=True, morsel_size_rows=300, executor_threads=2)
        df = (pkg.read_parquet(path).where(pkg.col("k") < 28)
              .with_column("w", pkg.col("v") * 2)
              .groupby("k").agg(pkg.col("w").sum().alias("s")).sort("k"))
        text = df.explain_analyze()
        rec = df.last_query_record()
        h = pkg.health()
        return (validate_record(rec), sorted(rec["streaming"]), rec["streaming"]["morsels"],
                rec["ledger"]["stream_inflight"], rec["ledger"]["exec_inflight"],
                rec["streaming"]["ttfr_ms"] > 0, "streaming:" in text, "first row" in text,
                validate_health(h), h["streaming"]["active_channels"],
                h["scheduler"]["inflight_tasks"], "daft_tpu_stream_channels" in pkg.metrics_text())

    ref, got = run_seq(seq, knobs=HOST)
    assert got == ref
    assert got[0] == [] and got[2] > 0 and got[5:8] == (True, True, True)


def test_morsel_spans_parent_to_an_op(tmp_path):
    path = _parquet_dir(tmp_path)
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
        device="cpu", use_device_kernels=False, streaming_execution=True, morsel_size_rows=300,
        executor_threads=2, scan_tasks_min_size_bytes=1, enable_result_cache=False))
    from daft_tpu.profile import validate_profile

    q = (daft_tpu_torch.read_parquet(path).where(daft_tpu_torch.col("k") < 28)
         .with_column("w", daft_tpu_torch.col("v") * 2)).collect(profile=True)
    qp = q.profile()
    assert validate_profile(qp.to_dict()) == [] and qp.orphan_spans == 0
    spans = qp.spans()
    by_id = {s.sid: s for s in spans}
    morsels = [s for s in spans if s.name == "morsel"]
    assert morsels
    for s in morsels:
        cur = s
        while cur.parent is not None and cur.kind != "op":
            cur = by_id[cur.parent]
        assert cur.kind == "op"


# ---------------------------------------------------------------------------
# the units: channel and morsels, both packages
# ---------------------------------------------------------------------------

def _stream_mods(which):
    pkg = daft_tpu if which == "ref" else daft_tpu_torch
    from importlib import import_module

    return (import_module(pkg.__name__ + ".stream.channel"),
            import_module(pkg.__name__ + ".stream.morsel"), pkg)


@pytest.mark.parametrize("which", ["ref", "port"])
def test_channel_fifo_finish_and_wait(which):
    ch_mod, _, _ = _stream_mods(which)
    ch = ch_mod.BoundedChannel(capacity=4)
    ch.put(1, 10)
    ch.put(2, 10)
    ch.finish()
    assert [ch.get(), ch.get(), ch.get(), ch.get()] == [1, 2, None, None]
    assert ch_mod.BoundedChannel(capacity=1).get(timeout=0.0) is ch_mod.WAIT


@pytest.mark.parametrize("which", ["ref", "port"])
def test_channel_charges_and_settles_the_ledger(which):
    ch_mod, _, pkg = _stream_mods(which)
    led = pkg.spill.MemoryLedger()
    ch = ch_mod.BoundedChannel(capacity=8, max_bytes=None, ledger=led)
    ch.put("a", 100)
    ch.put("b", 50)
    seen = [led.stream_inflight]
    assert ch.get() == "a"
    seen.append(led.stream_inflight)
    ch.close()
    seen.append(led.stream_inflight)
    assert seen == [150, 50, 0] and led.stream_inflight_high_water == 150


@pytest.mark.parametrize("which", ["ref", "port"])
def test_channel_close_wakes_a_blocked_producer(which):
    import threading

    ch_mod, _, _ = _stream_mods(which)
    ch = ch_mod.BoundedChannel(capacity=1)
    ch.put("a", 1)
    raised = threading.Event()

    def producer():
        try:
            ch.put("b", 1)
        except ch_mod.ChannelClosed:
            raised.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    ch.close()
    assert raised.wait(30) and len(ch) == 0


@pytest.mark.parametrize("which", ["ref", "port"])
def test_channel_error_and_oversized_morsel(which):
    ch_mod, _, pkg = _stream_mods(which)
    ch = ch_mod.BoundedChannel(capacity=2)
    ch.put("a", 1)
    ch.fail(pkg.errors.DaftTransientError("boom"))
    with pytest.raises(pkg.errors.DaftTransientError, match="boom"):
        ch.get()
    big = ch_mod.BoundedChannel(capacity=4, max_bytes=10)
    big.put("big", 1000)  # an empty channel admits any morsel
    assert not big._has_room()  # the byte cap binds for the next
    assert big.get() == "big" and big._has_room()
    assert big.high_water == 1 and big.pushed == 1


@pytest.mark.parametrize("which", ["ref", "port"])
def test_iter_morsels(which):
    _, m_mod, pkg = _stream_mods(which)
    MP = pkg.micropartition.MicroPartition
    T = pkg.table.Table
    part = MP.from_table(T.from_pydict({"x": list(range(10))}))
    sizes = [[len(m) for m in m_mod.iter_morsels(part, r)] for r in (4, 1, 10 ** 9, 0)]
    empty = list(m_mod.iter_morsels(MP.from_table(T.from_pydict({"x": []})), 4))
    vals = [v for m in m_mod.iter_morsels(part, 3) for v in m.to_pydict()["x"]]
    src = T.from_pydict({"x": list(range(1000))})
    m = next(m_mod.iter_morsels(MP.from_table(src), 100))
    shared = (m.to_arrow().column("x").chunk(0).buffers()[1].address
              == src.to_arrow().column("x").chunk(0).buffers()[1].address)
    assert sizes == [[4, 4, 2], [1] * 10, [10], [1] * 10]
    assert [len(e) for e in empty] == [0] and vals == list(range(10)) and shared


# ---------------------------------------------------------------------------
# FDO's streaming stand-down (adapt/fdo.py apply_query_hints)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stall_ms, runs", [(900.0, 2), (400.0, 2), (900.0, 1), (0.0, 3)])
def test_stall_heavy_shape_stands_streaming_down(stall_ms, runs):
    # a recorded shape whose producers stalled more than half its wall, over
    # at least two runs, runs with streaming off: the same decision in both
    # packages (the history seeded directly, so no timing enters)
    import dataclasses

    out = []
    for pkg in (daft_tpu, daft_tpu_torch):
        from importlib import import_module

        hist = import_module(pkg.__name__ + ".adapt.history").HISTORY
        fdo = import_module(pkg.__name__ + ".adapt.fdo")
        stats = import_module(pkg.__name__ + ".execution").RuntimeStats()
        hist.clear()
        with hist._lock:
            hist._queries["shape-fp"] = {"wall_s": 1.0, "ttfr_ms": 1.0, "stream_morsels": 40,
                                         "backpressure_ms": stall_ms, "runs": runs}
        cfg = (dataclasses.replace(daft_tpu.context.get_context().execution_config,
                                   streaming_execution=True, history_fdo=True)
               if pkg is daft_tpu else daft_tpu_torch.ExecutionConfig(device="cpu"))
        got = fdo.apply_query_hints("shape-fp", cfg, stats)
        out.append((got.streaming_execution,
                    stats.snapshot()["counters"].get("fdo_stream_hints", 0)))
        hist.clear()
    assert out[0] == out[1] == ((False, 1) if stall_ms > 500 and runs >= 2 else (True, 0))
