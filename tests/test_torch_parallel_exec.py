"""The port's pooled map fan-out and cancellation (daft_tpu_torch/
execution.py ``_parallel_map``/``_adaptive_device_map``, scheduler.py)
against the reference's (tests/test_parallel_exec.py and the executor's
routing, daft_tpu/execution.py:1450-1697).

Each query runs through both packages from one numpy seed under one
config (``torch_parity.run_seq``) on 4 worker threads and on one, and
holds the same rows and the same routing counters (``COUNTERS``) both
ways. The aggregate cases hold what ``chip_smoke.py`` phase 17 holds on
the card: a first partition below ``device_min_rows`` sends the stream to
the pool, whose threads call K1's wrapper (the plain version on the CPU)
for every other partition; a first partition that accepts keeps the
double-buffered sequential driver. Cancellation from a second thread
raises ``QueryCancelledError`` with a ``cancelled`` record in both
packages, and leaves the ledger and the scheduler's window at 0.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu.scheduler  # noqa: F401  (the cases read pkg.scheduler and pkg.spill)
import daft_tpu.spill  # noqa: F401
import daft_tpu_torch
import daft_tpu_torch.scheduler  # noqa: F401
import daft_tpu_torch.spill  # noqa: F401
from torch_parity import (COUNTERS, actor_pools_down, fresh_ledgers_and_faults,  # noqa: F401
                          restore_port_config, run_seq)

N = 10_000


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()
    actor_pools_down()


def _frame(pkg):
    rng = np.random.RandomState(0)
    return pkg.from_pydict({"k": rng.randint(0, 20, N), "v": rng.randn(N),
                            "s": np.array([f"id{i % 97}" for i in range(N)])})


def _counts(df, extra=()):
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS + tuple(extra)}


QUERIES = {
    "filter_project": lambda pkg: _frame(pkg).where(pkg.col("v") > 0).select(
        pkg.col("k"), (pkg.col("v") * 2).alias("w")),
    "groupby_agg": lambda pkg: _frame(pkg).groupby("k").agg(
        pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("c")).sort("k"),
    "global_agg": lambda pkg: _frame(pkg).sum("v"),
    "sort_limit": lambda pkg: _frame(pkg).sort("v", desc=True).limit(17),
    "join_agg": lambda pkg: _frame(pkg).join(
        pkg.from_pydict({"k": np.arange(20), "name": [f"g{i}" for i in range(20)]}), on="k")
        .groupby("name").agg(pkg.col("v").mean().alias("m")).sort("name"),
    "repartitioned_map": lambda pkg: _frame(pkg).repartition(6, "k").with_column(
        "w", pkg.col("v") * 3).where(pkg.col("k") != 4),
}


def _close(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        if a[k] and isinstance(a[k][0], float):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_pooled_as_sequential_and_as_the_reference(query, device):
    def seq(pkg, set_knobs):
        out = []
        for threads in (4, 1):
            set_knobs(executor_threads=threads, default_morsel_size=1000)
            df = QUERIES[query](pkg)
            out.append((df.to_pydict(), _counts(df)))
        return out

    ref, got = run_seq(seq, knobs={"use_device_kernels": device, "enable_result_cache": False})
    for (r_rows, r_c), (g_rows, g_c) in zip(ref, got):
        _close(g_rows, r_rows)
        assert g_c == r_c
    # pooled and sequential: the same rows in each package
    (pooled, _), (sequential, _) = got
    _close(pooled, sequential)


def test_global_agg_over_empty_input():
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4)
        df = pkg.from_pydict({"v": np.arange(100.0)}).where(pkg.col("v") < -1)
        return df.count("v").to_pydict()

    assert run_seq(seq, knobs={"use_device_kernels": False}) == [{"v": [0]}] * 2


def test_monotonic_ids_follow_row_order():
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4, default_morsel_size=1000)
        return _frame(pkg)._add_monotonic_id("rid").to_pydict()["rid"]

    ref, got = run_seq(seq, knobs={"use_device_kernels": False})
    assert got == ref == sorted(got)


def test_error_in_a_worker_propagates():
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4)
        df = pkg.from_pydict({"x": ["a", "b"] * 50}).into_partitions(4)
        with pytest.raises(Exception) as ei:
            df.select((pkg.col("x") * 2).alias("y")).to_pydict()
        return type(ei.value).__name__

    ref, got = run_seq(seq, knobs={"use_device_kernels": False})
    assert got == ref


def test_function_udf_stays_in_order():
    # a function UDF has no thread-safety contract: it runs partition after
    # partition on the consumer's thread in both packages
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4, default_morsel_size=1000)
        order, threads = [], set()

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def tracker(s):
            vals = s.to_pylist()
            order.append(vals[0])
            threads.add(threading.current_thread().name)
            return vals

        df = pkg.from_pydict({"x": list(range(8000))}).into_partitions(8)
        out = df.select(tracker(pkg.col("x")).alias("y")).to_pydict()["y"]
        return out == list(range(8000)), order == sorted(order), len(threads)

    assert run_seq(seq, knobs={"use_device_kernels": False}) == [(True, True, 1)] * 2


def test_worker_side_stats_are_recorded():
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4, default_morsel_size=1000)
        q = _frame(pkg).into_partitions(4).where(pkg.col("v") > 0).select(
            (pkg.col("v") * 2).alias("w"))
        q.collect()
        snap = q.stats.snapshot()
        return (snap["op_rows"].get("FusedMapOp", 0), snap["op_wall_ns"].get("FusedMapOp", 0) > 0,
                snap["counters"].get("fused_chains", 0))

    ref, got = run_seq(seq, knobs={"use_device_kernels": False, "enable_result_cache": False})
    assert got == ref and got[0] > 0 and got[1] and got[2] == 1


def test_host_morsel_split_as_the_reference():
    # one in-memory partition of 10,000 rows under an aggregate splits at
    # plan time into morsels of about default_morsel_size rows on the host
    # path (the two-stage aggregate then runs them on the pool)
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4, default_morsel_size=1000)
        df = _frame(pkg).groupby("k").agg(pkg.col("v").count().alias("c")).sort("k")
        out = df.to_pydict()
        return out, _counts(df)

    ref, got = run_seq(seq, knobs={"use_device_kernels": False, "enable_result_cache": False})
    assert got == ref and got[1]["shuffles"] == 2 and got[1]["host_aggregations"] > 2


# ---------------------------------------------------------------------------
# the aggregate's driver: phase 17 (a) and (c) of chip_smoke.py on the CPU
# ---------------------------------------------------------------------------

def _q1_parts(first_rows):
    rng = np.random.RandomState(42)
    return [pa.table({"g": rng.randint(0, 4, n), "q": rng.randint(1, 50, n).astype(np.float64),
                      "p": rng.rand(n) * 1000.0})
            for n in [first_rows] + [3000] * 7]


@pytest.mark.parametrize("first_rows", [100, 3000], ids=["first_declines", "first_accepts"])
def test_aggregate_driver_as_the_reference(first_rows, monkeypatch):
    from daft_tpu_torch.kernels import segment_sums

    names = []
    orig = segment_sums.masked_segment_sums_padded

    def watched(*a, **k):
        names.append(threading.current_thread().name)
        return orig(*a, **k)

    monkeypatch.setattr(segment_sums, "masked_segment_sums_padded", watched)
    tabs = _q1_parts(first_rows)

    def seq(pkg, set_knobs):
        out = []
        for threads in (0, 1):
            set_knobs(executor_threads=threads)
            names.clear()
            df = (pkg.from_arrow(tabs).where(pkg.col("q") < 40)
                  .groupby("g").agg(pkg.col("p").sum().alias("s"), pkg.col("q").sum().alias("sq"),
                                    pkg.col("p").count().alias("c")).sort("g"))
            rows = df.to_pydict()
            out.append((rows, _counts(df, ("device_agg_dispatches",)), list(names)))
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False, "device_min_rows": 1000})
    for (r_rows, r_c, _), (g_rows, g_c, _) in zip(ref, got):
        _close(g_rows, r_rows)
        assert g_c == r_c
    (pooled, pc, pnames), (single, sc, snames) = got
    assert pooled == single  # bit for bit, the pool against one thread
    assert pc["device_aggregations"] == sc["device_aggregations"] == 8 - (first_rows < 1000)
    assert len(pnames) == len(snames) == pc["device_aggregations"]
    if first_rows < 1000:
        # the stream went to the pool: every K1 call ran on a worker
        assert all(n.startswith("daft-torch-exec") for n in pnames)
        assert pc["device_agg_dispatches"] == 0
    else:
        # the double-buffered driver on the consumer's thread
        assert not any(n.startswith("daft-torch-exec") for n in pnames)
        assert pc["device_agg_dispatches"] == 8
    assert not any(n.startswith("daft-torch-exec") for n in snames)


# ---------------------------------------------------------------------------
# cancellation from a second thread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", [4, 1])
def test_cancel_from_a_second_thread(threads):
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=threads)
        holder = {}

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def cancel_at_third(s):
            vals = s.to_pylist()
            if vals[0] == 200 and not holder.get("done"):
                # the third partition of the first run: cancel from another thread
                holder["done"] = True
                t = threading.Thread(target=holder["df"].cancel)
                t.start()
                t.join()
            return vals

        df = (pkg.from_pydict({"x": list(range(800))}).into_partitions(8)
              .select(cancel_at_third(pkg.col("x")).alias("y")))
        holder["df"] = df
        with pytest.raises(pkg.execution.QueryCancelledError):
            df.collect()
        rec = pkg.query_log()[-1]
        led = pkg.spill.MEMORY_LEDGER.snapshot()
        again = df.collect().to_pydict()["y"]  # collect re-arms the handle
        return (rec["outcome"], led["current"], led["exec_inflight"], led["stream_inflight"],
                pkg.scheduler.inflight_tasks(), again == list(range(800)))

    assert run_seq(seq, knobs={"use_device_kernels": False, "enable_result_cache": False}) \
        == [("cancelled", 0, 0, 0, 0, True)] * 2


def test_queue_wait_and_tasks_inflight_are_observed():
    # a pooled query's tasks carry the queue_wait phase in the profile, and
    # its progress counts its tasks in flight while they run
    def seq(pkg, set_knobs):
        set_knobs(executor_threads=4, default_morsel_size=1000)
        inflight = []

        @pkg.udf(return_dtype=pkg.DataType.int64(), concurrency=2)
        class Peek:
            def __call__(self, s):
                inflight.extend(q["tasks_inflight"] for q in pkg.health()["queries"])
                return s.to_pylist()

        q = (_frame(pkg).into_partitions(6).select(Peek(pkg.col("k")).alias("k2"))
             .collect(profile=True))
        ops = q.profile().to_dict()["ops"]
        return (all("queue_wait_ns" in o for o in ops.values()), min(inflight) >= 1,
                len(q.to_pydict()["k2"]))

    ref, got = run_seq(seq, knobs={"use_device_kernels": False, "enable_result_cache": False})
    assert got == ref == (True, True, N)
