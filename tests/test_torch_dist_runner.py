"""The port's distributed runner (daft_tpu_torch/dist/) held against the
reference's on the CPU: the cases of tests/test_dist_runner.py through the
port, at ``device="cpu"``.

- The identity matrix: the rows of every plan shape at 1 and 3 workers
  equal NativeRunner's byte for byte (``to_arrow().equals``) and the
  reference's; at 3 workers the dispatch counters equal the reference's
  distributed run over the same plans (computed once a module).
- Scans read by the workers, UDF closures staying in the driver, a worker
  SIGKILLed by the ``worker.exec`` fault and from outside, the poison task,
  an exhausted restart budget degrading to in-process execution, the fault
  sites, exactly-once results, the cluster surfaces (health, gauges, the
  carved budget, the record's ``dist_inflight``), the deadline, the
  transport unit, runner selection, the handshake hardening and the
  threads' names.
- The port's own: the worker's entry module imports no module of JAX or of
  daft_tpu (a fresh interpreter), the workers run the device path of each
  query's config (the routing counters folded back from them equal
  NativeRunner's), and no tensor crosses the transport.

Each case that spawns a pool tears it down and checks that no worker
process is left; every wait on a process is bounded.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import daft_tpu
import daft_tpu_torch as dtt
from daft_tpu_torch import col, faults
from daft_tpu_torch.context import get_context, set_execution_config
from daft_tpu_torch.dist import supervisor as sup
from daft_tpu_torch.errors import DaftError, DaftTimeoutError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset():
    ctx = get_context()
    cfg_before, runner_name = ctx.execution_config, ctx._runner_name
    faults.disarm()
    set_execution_config(device="cpu", enable_result_cache=False)
    yield
    faults.disarm()
    ctx.execution_config = cfg_before
    ctx.set_runner(runner_name)


@pytest.fixture(scope="module", autouse=True)
def _module_teardown():
    yield
    sup.shutdown_worker_pool()
    assert sup.live_worker_process_count() == 0


def _data(n=8000):
    return {"a": list(range(n)), "b": [i % 13 for i in range(n)],
            "s": [None if i % 11 == 0 else f"g{i % 5}" for i in range(n)]}


def _queries(pkg, df):
    other = pkg.from_pydict({"b": list(range(13)), "w": [i * 10 for i in range(13)]})
    c = pkg.col
    return {
        "map_agg": (df.select(c("a"), (c("a") * c("b") + 1).alias("ab"))
                    .where(c("ab") % 5 != 0)
                    .groupby("ab").agg(c("a").sum().alias("s")).sort("ab")),
        "shuffle_groupby": (df.repartition(5, "b").groupby("b")
                            .agg(c("a").sum().alias("s"), c("a").count().alias("c")).sort("b")),
        "join": df.join(other, on="b").select(c("a"), c("w")).sort("a"),
        "sort": df.sort("a", desc=True).select(c("a"), c("s")),
        "distinct": df.select(c("b"), c("s")).distinct().sort("b"),
    }


def _collect_all(reparts):
    return {name: q.collect() for name, q in
            _queries(dtt, dtt.from_pydict(_data()).repartition(reparts)).items()}


def _rows(d: dict) -> list:
    return sorted(zip(*d.values()), key=lambda r: tuple((v is None, repr(v)) for v in r))


# the counters of the distributed runner each identity case holds equal to
# the reference's distributed run: those of the dispatch. A worker lost to
# a missed heartbeat on a loaded host re-dispatches its task and drops its
# fragment in either package, so worker_losses, task_redispatches and the
# telemetry split follow the host's load; every task's fragment is still
# accounted for (merged or dropped)
DIST_COUNTERS = ("dist_tasks", "dist_local_fallbacks", "tasks_speculated", "peer_fetches",
                 "peer_refetches")


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's rows of every plan shape under its NativeRunner and
    its distributed runner at 3 workers over 6 partitions, with the
    distributed run's counters, computed once."""
    from daft_tpu.context import get_context as ref_ctx
    from daft_tpu.context import set_execution_config as ref_set
    from daft_tpu.dist import supervisor as ref_sup

    saved = ref_ctx().execution_config
    try:
        ref_set(enable_result_cache=False, distributed_workers=0)
        frames = _queries(daft_tpu, daft_tpu.from_pydict(_data()).repartition(6))
        local = {k: q.collect().to_pydict() for k, q in frames.items()}
        # speculation off in both packages: a duplicate follows the host's
        # load, and the counters compared here are the dispatch's
        ref_set(enable_result_cache=False, distributed_workers=3,
                speculative_execution=False)
        dist = {}
        for k, q in _queries(daft_tpu, daft_tpu.from_pydict(_data()).repartition(6)).items():
            r = q.collect()
            c = r.stats.snapshot()["counters"]
            dist[k] = (r.to_pydict(), {n: c.get(n, 0) for n in DIST_COUNTERS})
            assert c.get("telemetry_merged", 0) + c.get("telemetry_dropped", 0) >= \
                c.get("dist_tasks", 0)
    finally:
        ref_sup.shutdown_worker_pool()
        ref_ctx().execution_config = saved
        ref_ctx().set_runner("native")
    assert ref_sup.live_worker_process_count() == 0
    return local, dist


class TestIdentityMatrix:
    def test_byte_identical_across_worker_counts(self, reference_runs):
        ref_local, ref_dist = reference_runs
        local = {k: r.to_arrow() for k, r in _collect_all(6).items()}
        for name, tbl in local.items():
            assert _rows(tbl.to_pydict()) == _rows(ref_local[name]), name
        for workers in (1, 3):
            set_execution_config(distributed_workers=workers, speculative_execution=False)
            got = _collect_all(6)
            assert type(get_context().runner()).__name__ == "DistributedRunner"
            for name, tbl in local.items():
                assert got[name].to_arrow().equals(tbl), (workers, name)
                c = got[name].stats.snapshot()["counters"]
                assert c.get("dist_local_fallbacks", 0) == 0
                if workers == 3:
                    rows, want = ref_dist[name]
                    assert _rows(got[name].to_pydict()) == _rows(rows), name
                    assert {n: c.get(n, 0) for n in DIST_COUNTERS} == want, name
                    assert c.get("telemetry_merged", 0) + c.get("telemetry_dropped", 0) >= \
                        c.get("dist_tasks", 0)
        sup.shutdown_worker_pool()
        assert sup.live_worker_process_count() == 0

    def test_scan_partitions_read_by_workers(self, tmp_path):
        import pyarrow as pa
        import pyarrow.parquet as papq

        for i in range(4):
            papq.write_table(pa.table({"a": list(range(i * 100, i * 100 + 100))}),
                             str(tmp_path / f"f{i}.parquet"))
        pat = str(tmp_path / "*.parquet")
        set_execution_config(scan_tasks_min_size_bytes=0)
        local = dtt.read_parquet(pat).select((col("a") * 3).alias("t")).sort("t").collect()
        set_execution_config(distributed_workers=2)
        res = dtt.read_parquet(pat).select((col("a") * 3).alias("t")).sort("t").collect()
        assert res.to_arrow().equals(local.to_arrow())
        # the scan tasks themselves shipped: the workers did the reads
        assert res.stats.snapshot()["counters"].get("dist_tasks", 0) >= 1
        ref = daft_tpu.read_parquet(pat).select((daft_tpu.col("a") * 3).alias("t")).sort("t")
        assert res.to_pydict() == ref.to_pydict()

    def test_udf_tasks_stay_local(self):
        @dtt.udf(return_dtype=dtt.DataType.int64())
        def plus1(c):
            return [v + 1 for v in c.to_pylist()]

        set_execution_config(distributed_workers=2)
        df = dtt.from_pydict({"a": [1, 2, 3]}).repartition(2)
        out = df.select(plus1(col("a")).alias("p")).sort("p").collect()
        assert out.to_pydict()["p"] == [2, 3, 4]


class TestDevicePathInWorkers:
    def test_workers_run_the_device_path_of_each_querys_config(self):
        """With device_min_rows 1 the aggregates take the device path, on
        the workers: the routing counters folded back through the telemetry
        fragments equal NativeRunner's; the next query, under the default
        threshold, reaches the same workers with its own config and takes
        the host path there, as NativeRunner does."""
        q = lambda: _queries(dtt, dtt.from_pydict(_data()).repartition(6))["map_agg"]  # noqa: E731
        routing = ("device_aggregations", "host_aggregations", "device_group_codes",
                   "device_agg_fallbacks")
        for min_rows in (1, 4096):
            set_execution_config(device_min_rows=min_rows, distributed_workers=0)
            local = q().collect()
            set_execution_config(device_min_rows=min_rows, distributed_workers=2)
            got = q().collect()
            assert got.to_arrow().equals(local.to_arrow()), min_rows
            lc, gc = local.stats.snapshot()["counters"], got.stats.snapshot()["counters"]
            assert {k: gc.get(k, 0) for k in routing} == {k: lc.get(k, 0) for k in routing}
            assert (gc.get("device_aggregations", 0) > 0) == (min_rows == 1)
            assert gc.get("dist_tasks", 0) >= 6
        sup.shutdown_worker_pool()

    def test_no_tensor_crosses_the_transport(self):
        """A partition whose columns were staged for the device path pickles
        to its arrow tables alone: the staged tensors (device_stage_cache)
        stay in the process that staged them."""
        import pickle

        from daft_tpu_torch.micropartition import MicroPartition

        set_execution_config(device_min_rows=1)
        frame = dtt.from_pydict({"k": [1, 2, 1, 2] * 50, "v": [1.0] * 200}).collect()
        part = frame._result.partitions[0]
        frame.groupby("k").agg(col("v").sum().alias("s")).collect()
        assert part.device_stage_cache()  # the aggregate staged its columns
        blob = pickle.dumps(part)
        assert b"_rebuild_tensor" not in blob and b"torch.storage" not in blob
        assert isinstance(pickle.loads(pickle.dumps(MicroPartition.from_pydict({"a": [1]}))),
                          MicroPartition)
        clone = pickle.loads(blob)
        assert clone.device_stage_cache() == {}
        assert clone.table().to_arrow().equals(part.table().to_arrow())

    def test_worker_entry_imports_no_jax(self):
        code = ("import sys, daft_tpu_torch.dist.worker; print(sorted(m for m in sys.modules "
                "if m.split('.')[0] in ('jax', 'jaxlib', 'daft_tpu')))")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", out.stdout


class TestKillAWorker:
    def test_fault_sigkill_mid_query_recovers_byte_identical(self):
        local = _collect_all(8)["map_agg"].to_arrow()
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=4)
        # warm the pool so the kill hits a running fleet
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        pids_before = dict(pool.worker_pids())
        assert len(pids_before) == 4
        faults.arm("worker.exec", "nth", n=3)  # the third dispatch dies
        try:
            res = _queries(dtt, dtt.from_pydict(_data()).repartition(8))["map_agg"].collect()
        finally:
            faults.disarm()
        assert res.to_arrow().equals(local)
        rec = res.last_query_record()
        assert rec["events"].get("worker_losses", 0) >= 1, rec["events"]
        assert rec["events"].get("task_redispatches", 0) >= 1, rec["events"]
        assert pool.snapshot()["worker_losses_total"] >= 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and pool.snapshot()["workers_alive"] < 4:
            time.sleep(0.1)
        snap = pool.snapshot()
        assert snap["workers_alive"] == 4, snap  # respawned
        assert snap["restarts_used"] >= 1
        sup.shutdown_worker_pool()
        assert sup.live_worker_process_count() == 0

    def test_external_sigkill_mid_query(self):
        big = {"a": list(range(60000)), "b": [i % 7 for i in range(60000)]}

        def q(df):
            return (df.select(col("a"), (col("a") * col("b")).alias("ab"))
                    .where(col("ab") % 3 != 1)
                    .groupby("ab").agg(col("a").sum().alias("s")).sort("ab"))

        local = q(dtt.from_pydict(big).repartition(64)).collect().to_arrow()
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=4)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        killed = []

        def killer():
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not killed:
                for _, d in pool.snapshot()["worker_detail"].items():
                    if d["state"] == "ready" and d["inflight"] > 0 and d["pid"]:
                        try:
                            os.kill(d["pid"], signal.SIGKILL)
                        except OSError:
                            continue
                        killed.append(d["pid"])
                        return
                time.sleep(0.002)

        t = threading.Thread(target=killer)
        t.start()
        res = q(dtt.from_pydict(big).repartition(64)).collect()
        t.join(timeout=35)
        assert res.to_arrow().equals(local)
        assert killed, "the killer never saw an in-flight worker"
        assert pool.snapshot()["worker_losses_total"] >= 1
        sup.shutdown_worker_pool()
        assert sup.live_worker_process_count() == 0


class TestPoisonTask:
    def test_poison_task_fails_query_with_daft_error(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=3, worker_restart_budget=6)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        faults.arm("worker.exec", "always")
        t0 = time.monotonic()
        try:
            with pytest.raises(DaftError, match=r"poison task \w+#\d+"):
                dtt.from_pydict(_data(3000)).repartition(4).select(
                    (col("a") * 2).alias("c")).collect()
        finally:
            faults.disarm()
        assert time.monotonic() - t0 < 90, "poison detection hung"
        assert sup.worker_pool_snapshot()["restarts_used"] <= 6  # within the budget
        sup.shutdown_worker_pool()
        assert sup.live_worker_process_count() == 0

    def test_restart_budget_exhaustion_degrades_to_local(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2, worker_restart_budget=0,
                             worker_heartbeat_interval_s=0.1)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        # both workers die outside any task (missed heartbeats) and budget 0
        # respawns none: the pool degrades, no task is poisoned, and queries
        # complete in-process
        faults.arm("worker.heartbeat", "first_n", n=2)
        try:
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and pool.snapshot()["workers_alive"] != 0:
                time.sleep(0.05)
        finally:
            faults.disarm()
        snap = pool.snapshot()
        assert snap["workers_alive"] == 0 and snap["degraded"] is True
        res = dtt.from_pydict(_data(3000)).repartition(4).select(
            (col("a") * 2).alias("c")).collect()
        assert sorted(res.to_pydict()["c"]) == [v * 2 for v in range(3000)]
        assert res.stats.snapshot()["counters"].get("dist_local_fallbacks", 0) >= 1
        sup.shutdown_worker_pool()
        assert sup.live_worker_process_count() == 0


class TestFaultSites:
    def test_spawn_fault_consumes_budget_then_heals(self):
        sup.shutdown_worker_pool()
        faults.arm("worker.spawn", "first_n", n=1)
        try:
            set_execution_config(distributed_workers=2)
            res = dtt.from_pydict(_data(2000)).repartition(3).select(
                (col("a") + 1).alias("c")).collect()
        finally:
            faults.disarm()
        # the query completed although one slot failed its initial spawn
        assert sorted(res.to_pydict()["c"]) == [v + 1 for v in range(2000)]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            snap = sup.worker_pool_snapshot()
            if snap and snap["workers_alive"] == 2:
                break
            time.sleep(0.1)
        assert sup.worker_pool_snapshot()["workers_alive"] == 2
        sup.shutdown_worker_pool()

    def test_heartbeat_fault_declares_worker_dead_not_hang(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2, worker_heartbeat_interval_s=0.1)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        faults.arm("worker.heartbeat", "nth", n=1)
        try:
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and pool.snapshot()["worker_losses_total"] < 1:
                time.sleep(0.05)
        finally:
            faults.disarm()
        assert pool.snapshot()["worker_losses_total"] >= 1
        # queries keep completing through the loss and the respawn
        res = dtt.from_pydict(_data(2000)).repartition(3).select(
            (col("a") + 2).alias("c")).collect()
        assert sorted(res.to_pydict()["c"]) == [v + 2 for v in range(2000)]
        sup.shutdown_worker_pool()

    def test_transport_send_fault_redispatches(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        # sever the link under the 3rd frame sent (task sends and pings share
        # the site): the failed send reads as a worker loss and the task
        # re-dispatches, never a hang
        faults.arm("transport.send", "nth", n=3)
        try:
            res = dtt.from_pydict(_data(4000)).repartition(6).select(
                (col("a") * 5).alias("c")).collect()
        finally:
            faults.disarm()
        assert sorted(res.to_pydict()["c"]) == [v * 5 for v in range(4000)]
        sup.shutdown_worker_pool()

    def test_sites_registered(self):
        from daft_tpu import faults as ref_faults

        for site in ("worker.spawn", "worker.exec", "worker.heartbeat", "transport.send"):
            assert site in faults.SITES and site in ref_faults.SITES


class TestExactlyOnce:
    def test_acked_results_never_rerun(self):
        sup.shutdown_worker_pool()
        # speculation off: a duplicate of a task slowed by the host's load
        # is a dispatch no completion answers (tests/test_torch_dist_integrity.py
        # holds speculation)
        set_execution_config(distributed_workers=2, speculative_execution=False)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        res = dtt.from_pydict(_data(4000)).repartition(5).select(
            (col("a") + 9).alias("c")).collect()
        assert sorted(res.to_pydict()["c"]) == [v + 9 for v in range(4000)]
        snap = pool.snapshot()
        # nothing failed: dispatches equal completions, nothing re-ran
        assert snap["tasks_dispatched_total"] == snap["tasks_completed_total"]
        assert snap["task_redispatches_total"] == 0
        # after a loss mid-query only the lost task re-dispatches
        faults.arm("worker.exec", "nth", n=2)
        try:
            res2 = dtt.from_pydict(_data(4000)).repartition(5).select(
                (col("a") + 9).alias("c")).collect()
        finally:
            faults.disarm()
        assert sorted(res2.to_pydict()["c"]) == [v + 9 for v in range(4000)]
        c = res2.stats.snapshot()["counters"]
        snap2 = pool.snapshot()
        done_delta = snap2["tasks_completed_total"] - snap["tasks_completed_total"]
        dispatched_delta = snap2["tasks_dispatched_total"] - snap["tasks_dispatched_total"]
        assert dispatched_delta - done_delta <= (c.get("task_redispatches", 0)
                                                 + c.get("dist_local_fallbacks", 0) + 1)
        sup.shutdown_worker_pool()


class TestClusterSurfaces:
    def test_health_cluster_section_and_gauges(self):
        from daft_tpu.obs.health import validate_health as ref_validate
        from daft_tpu_torch.obs.health import validate_health

        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2)
        _ = dtt.from_pydict(_data(1000)).repartition(2).select(col("a")).collect()
        h = dtt.health()
        assert validate_health(h) == [] and ref_validate(h) == []
        clu = h["cluster"]
        assert clu["workers"] == 2 and clu["workers_alive"] == 2
        assert clu["restart_budget_remaining"] == clu["restart_budget"]
        assert clu["degraded"] is False
        assert set(clu["worker_detail"]) == {"0", "1"}
        mt = dtt.metrics_text()
        assert "daft_tpu_cluster_workers_alive 2" in mt
        assert "daft_tpu_cluster_worker_losses_total" in mt
        sup.shutdown_worker_pool()
        h2 = dtt.health()
        assert validate_health(h2) == [] and ref_validate(h2) == []
        assert h2["cluster"]["workers"] == 0  # the idle shape after the teardown

    def test_worker_budget_carved_and_reported(self):
        sup.shutdown_worker_pool()
        budget = 64 * 1024 * 1024
        set_execution_config(distributed_workers=3, memory_budget_bytes=budget)
        _ = dtt.from_pydict(_data(1000)).repartition(2).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        wcfg = pool._worker_cfg()
        assert wcfg.memory_budget_bytes == budget // 4  # N workers and the driver
        assert wcfg.distributed_workers == 0  # never nested
        assert wcfg.device == "cpu"  # the driver's device
        # heartbeat pongs report the workers' ledger balances into health
        deadline = time.monotonic() + 10
        seen = False
        while time.monotonic() < deadline and not seen:
            seen = all("ledger_current" in d for d in pool.snapshot()["worker_detail"].values())
            time.sleep(0.05)
        assert seen
        sup.shutdown_worker_pool()

    def test_record_ledger_has_dist_inflight(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2)
        res = dtt.from_pydict(_data(2000)).repartition(3).select(col("a")).collect()
        rec = res.last_query_record()
        assert "dist_inflight" in rec["ledger"]
        assert rec["ledger"]["dist_inflight"] == 0  # settled at the query's end
        from daft_tpu_torch.spill import MEMORY_LEDGER

        assert MEMORY_LEDGER.snapshot()["dist_inflight_high_water"] > 0
        sup.shutdown_worker_pool()

    def test_deadline_respected_while_remote(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2, execution_timeout_s=0.0001)
        try:
            with pytest.raises(DaftTimeoutError):
                dtt.from_pydict(_data(4000)).repartition(6).select(
                    (col("a") * 2).alias("c")).collect()
        finally:
            set_execution_config(execution_timeout_s=None)
        sup.shutdown_worker_pool()


class TestTransportUnit:
    def test_roundtrip_and_eof(self):
        import socket as _socket

        from daft_tpu_torch.dist.transport import TransportClosed, recv_msg, send_msg

        a, b = _socket.socketpair()
        try:
            send_msg(a, {"type": "x", "blob": b"\x00" * 100000, "n": [1, 2, 3]})
            msg = recv_msg(b)
            assert msg["type"] == "x" and len(msg["blob"]) == 100000
            a.close()
            with pytest.raises(TransportClosed):
                recv_msg(b)
        finally:
            b.close()

    def test_frames_equal_the_references(self):
        """One message frames to the same header, flags and crc in both
        packages, in full and in stripes."""
        from daft_tpu.dist.transport import _payload_crc as ref_crc
        from daft_tpu_torch.dist.transport import _payload_crc

        for n in (10, 256 * 1024, 5 * 1024 * 1024 + 7):
            data = bytes(range(256)) * (n // 256) + b"x" * (n % 256)
            assert _payload_crc(data) == ref_crc(data)

    def test_runner_selection(self):
        from daft_tpu_torch.dist.runner import DistributedRunner
        from daft_tpu_torch.runners import NativeRunner

        ctx = get_context()
        set_execution_config(distributed_workers=0)
        ctx.set_runner("native")
        assert type(ctx.runner()) is NativeRunner
        set_execution_config(distributed_workers=2)
        assert type(ctx.runner()) is DistributedRunner
        set_execution_config(distributed_workers=0)
        assert type(ctx.runner()) is NativeRunner
        ctx.set_runner("distributed")
        assert type(ctx.runner()) is DistributedRunner
        ctx.set_runner("native")

    def test_runner_selection_from_the_environment(self):
        code = ("import daft_tpu_torch as d; print(type(d.get_context().runner()).__name__)")
        env = dict(os.environ, DAFT_TPU_TORCH_RUNNER="distributed", PYTHONPATH=ROOT)
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "DistributedRunner"


class TestSpawnHandshakeHardening:
    def test_silent_client_does_not_wedge_respawn(self):
        import socket as _socket

        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=1)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        silent = _socket.create_connection(("127.0.0.1", pool._port))
        try:
            os.kill(pool.workers[0].pid, signal.SIGKILL)
            # the respawn's spawner accepts the silent connection first; its
            # read deadline discards it and goes on to the real hello
            deadline = time.monotonic() + 45
            while time.monotonic() < deadline:
                snap = pool.snapshot()
                if snap["worker_losses_total"] >= 1 and snap["workers_alive"] >= 1:
                    break
                time.sleep(0.1)
            snap = pool.snapshot()
            assert snap["worker_losses_total"] >= 1 and snap["workers_alive"] >= 1, snap
            res = dtt.from_pydict(_data(2000)).repartition(3).select(
                (col("a") + 7).alias("c")).collect()
            assert sorted(res.to_pydict()["c"]) == [v + 7 for v in range(2000)]
        finally:
            silent.close()
            sup.shutdown_worker_pool()

    def test_driver_pool_threads_carry_the_ports_prefix(self):
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        try:
            names = {t.name for t in threading.enumerate()}
            assert "daft-torch-dist-supervisor" in names
            assert any(n.startswith("daft-torch-dist-rx-") for n in names)
            # no thread of the port takes a name of the reference's
            assert not [n for n in names if n.startswith(("daft-dist", "daft-peer"))]
        finally:
            sup.shutdown_worker_pool()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(
                t.name.startswith("daft-torch-dist") for t in threading.enumerate()):
            time.sleep(0.05)
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("daft-torch-dist")]

    def test_worker_announce_thread_is_named_daemon(self):
        import ast
        import inspect

        from daft_tpu_torch.dist import worker as worker_mod

        announce = None
        for node in ast.walk(ast.parse(inspect.getsource(worker_mod))):
            if isinstance(node, ast.Call):
                kwargs = {kw.arg: kw.value for kw in node.keywords}
                name = kwargs.get("name")
                if isinstance(name, ast.Constant) and name.value == "daft-torch-dist-announce":
                    announce = kwargs
        assert announce is not None, "the announce thread lost its name"
        daemon = announce.get("daemon")
        assert isinstance(daemon, ast.Constant) and daemon.value is True
