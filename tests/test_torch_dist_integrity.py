"""The integrity and speculation cases of the port's distributed runner held
against the reference's on the CPU: tests/test_integrity.py's transport
frames (TestTransportIntegrity), speculative straggler mitigation
(TestSpeculation) and the environment's fault plans (``arm_from_env``,
TestRegistryAndSurfaces), through the port at ``device="cpu"``.
"""

import json
import os
import socket
import time
from collections import deque

import pytest

import daft_tpu
import daft_tpu_torch as dtt
from daft_tpu_torch import col, faults
from daft_tpu_torch.context import get_context, set_execution_config
from daft_tpu_torch.dist import supervisor as sup
from daft_tpu_torch.errors import DaftCorruptionError


@pytest.fixture(autouse=True)
def _reset():
    ctx = get_context()
    cfg_before, runner_name = ctx.execution_config, ctx._runner_name
    faults.disarm()
    set_execution_config(device="cpu", enable_result_cache=False)
    yield
    faults.disarm()
    os.environ.pop(faults.ENV_FAULT_SPEC, None)
    ctx.execution_config = cfg_before
    ctx.set_runner(runner_name)


@pytest.fixture(scope="module", autouse=True)
def _module_teardown():
    yield
    sup.shutdown_worker_pool()
    assert sup.live_worker_process_count() == 0


def _counters(df) -> dict:
    return df.stats.snapshot()["counters"]


class TestTransportIntegrity:
    def _pair(self):
        a, b = socket.socketpair()
        a.settimeout(5)
        b.settimeout(5)
        return a, b

    def test_clean_roundtrip_checksummed(self):
        from daft_tpu_torch.dist.transport import recv_msg, send_msg

        a, b = self._pair()
        try:
            msg = {"type": "task", "payload": list(range(1000))}
            send_msg(a, msg)
            assert recv_msg(b) == msg
        finally:
            a.close()
            b.close()

    def test_frames_cross_between_the_packages(self):
        """A frame either package sends, the other receives: one wire."""
        from daft_tpu.dist.transport import recv_msg as ref_recv
        from daft_tpu.dist.transport import send_msg as ref_send
        from daft_tpu_torch.dist.transport import recv_msg, send_msg

        import threading

        a, b = self._pair()
        try:
            for n in (100, 400 * 1024):  # a frame in full, one in stripes
                msg = {"type": "x", "blob": bytes(range(256)) * (n // 256)}
                t = threading.Thread(target=send_msg, args=(a, msg))
                t.start()
                assert ref_recv(b) == msg
                t.join(timeout=10)
                t = threading.Thread(target=ref_send, args=(b, msg))
                t.start()
                assert recv_msg(a) == msg
                t.join(timeout=10)
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("size", [4096, 2 * 1024 * 1024])
    def test_corrupt_frame_raises_corruption_error(self, size):
        from daft_tpu_torch.dist.transport import recv_msg, send_msg

        a, b = self._pair()
        a.setblocking(True)
        b.setblocking(True)
        try:
            import threading

            got = {}

            def reader():
                try:
                    recv_msg(b)
                except Exception as e:
                    got["e"] = e

            t = threading.Thread(target=reader)
            t.start()
            with faults.inject("transport.corrupt", "always"):
                send_msg(a, {"type": "task", "payload": b"x" * size})
            t.join(timeout=30)
            assert isinstance(got.get("e"), DaftCorruptionError), got
        finally:
            a.close()
            b.close()

    def test_checksum_off_flag_zero_roundtrip(self):
        from daft_tpu_torch.dist.transport import recv_msg, send_msg

        a, b = self._pair()
        try:
            send_msg(a, {"k": 1}, checksum=False)
            msg, flags = recv_msg(b, with_flags=True)
            assert msg == {"k": 1} and flags == 0
        finally:
            a.close()
            b.close()

    def test_corrupt_frame_e2e_redispatches(self):
        """A corrupted frame on a live worker link reads as a dead link: the
        worker is replaced and the query completes with the same rows."""
        set_execution_config(worker_heartbeat_interval_s=0.2)
        df = dtt.from_pydict({"a": list(range(20_000)), "b": [i % 9 for i in range(20_000)]})
        q = df.repartition(6).select((col("a") * 2).alias("c")).sort("c")
        want = q.collect().to_arrow()
        set_execution_config(worker_heartbeat_interval_s=0.2, distributed_workers=2)
        _ = df.repartition(2).select(col("a")).collect()  # warm the pool
        before = sup.worker_pool_snapshot()["worker_losses_total"]
        with faults.inject("transport.corrupt", "first_n", n=1):
            r = q.collect()
            deadline = time.monotonic() + 10
            while (sup.worker_pool_snapshot()["worker_losses_total"] <= before
                   and time.monotonic() < deadline):
                time.sleep(0.1)
        assert r.to_arrow().equals(want)
        assert sup.worker_pool_snapshot()["worker_losses_total"] > before
        sup.shutdown_worker_pool()


class TestSpeculation:
    def test_straggler_speculates_first_result_wins_and_off_is_zero(self):
        """One worker slowed by a worker.task delay plan: with speculation
        off the counters stay 0; on, the straggling task gets a duplicate,
        the fast worker wins, and the rows are the same."""
        sup.shutdown_worker_pool()  # the environment's plan binds at spawn
        os.environ[faults.ENV_FAULT_SPEC] = json.dumps(
            {"site": "worker.task", "mode": "always", "delay_s": 0.5, "worker_id": 0})
        try:
            def q():
                df = dtt.from_pydict({"a": list(range(30_000)),
                                      "b": [i % 9 for i in range(30_000)]})
                return df.repartition(8).select((col("a") * 3).alias("c")).sort("c")

            want = q().collect().to_arrow()
            knobs = dict(distributed_workers=2, worker_heartbeat_interval_s=0.2,
                         speculation_min_s=0.1, speculation_quantile_factor=2.0)
            set_execution_config(speculative_execution=False, **knobs)
            r_off = q().collect()
            assert r_off.to_arrow().equals(want)
            assert _counters(r_off).get("tasks_speculated", 0) == 0
            assert sup.worker_pool_snapshot()["tasks_speculated_total"] == 0
            # a seeded wall history makes the p75 threshold deterministic
            pool = sup._POOL
            with pool._cond:
                for op in list(pool._op_walls) + ["ProjectOp"]:
                    pool._op_walls[op] = deque([0.01] * 8, maxlen=64)
            set_execution_config(speculative_execution=True, **knobs)
            r_on = q().collect()
            assert r_on.to_arrow().equals(want)
            c = _counters(r_on)
            assert c.get("tasks_speculated", 0) >= 1 and c.get("speculation_wins", 0) >= 1
            snap = sup.worker_pool_snapshot()
            assert snap["tasks_speculated_total"] >= 1
            assert snap["speculation_wins_total"] >= 1
            assert snap["speculation_inflight"] == 0
            assert r_on.last_query_record()["events"].get("tasks_speculated", 0) >= 1
            from daft_tpu.obs.health import validate_health as ref_validate
            from daft_tpu_torch.obs.health import engine_health, validate_health

            h = engine_health()
            assert validate_health(h) == [] and ref_validate(h) == []
            assert h["cluster"]["tasks_speculated_total"] >= 1
            assert h["cluster"]["speculation_wins_total"] >= 1
            assert "daft_tpu_cluster_speculation_wins_total" in dtt.metrics_text()
        finally:
            os.environ.pop(faults.ENV_FAULT_SPEC, None)
            sup.shutdown_worker_pool()

    def test_speculation_bounded_by_max_inflight(self):
        """speculation_max_inflight 0 turns duplicates off with the knob on."""
        sup.shutdown_worker_pool()
        os.environ[faults.ENV_FAULT_SPEC] = json.dumps(
            {"site": "worker.task", "mode": "always", "delay_s": 0.4, "worker_id": 0})
        try:
            set_execution_config(distributed_workers=2, worker_heartbeat_interval_s=0.2,
                                 speculative_execution=True, speculation_min_s=0.05,
                                 speculation_quantile_factor=1.0, speculation_max_inflight=0)
            df = dtt.from_pydict({"a": list(range(10_000))})
            r = df.repartition(4).select((col("a") + 1).alias("c")).sort("c").collect()
            assert _counters(r).get("tasks_speculated", 0) == 0
        finally:
            os.environ.pop(faults.ENV_FAULT_SPEC, None)
            sup.shutdown_worker_pool()


class TestRegistryAndSurfaces:
    def test_new_sites_registered(self):
        for site in ("spill.corrupt", "transport.corrupt", "worker.task"):
            assert site in faults.SITES and site in daft_tpu.faults.SITES

    def test_delay_plan_sleeps_instead_of_raising(self):
        faults.arm("test.delay_site", "always", delay_s=0.05)
        try:
            t0 = time.monotonic()
            faults.check("test.delay_site")  # does not raise
            assert time.monotonic() - t0 >= 0.04
            assert faults.snapshot()["injected"]["test.delay_site"] == 1
        finally:
            faults.disarm()

    def test_arm_from_env_scopes_by_worker_id(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_FAULT_SPEC, json.dumps(
            {"site": "worker.task", "mode": "always", "worker_id": 3}))
        try:
            assert faults.arm_from_env(worker_id=1) == 0
            assert faults.arm_from_env(worker_id=3) == 1
            assert "worker.task" in faults.snapshot()["armed"]
        finally:
            faults.disarm()

    def test_arm_from_env_malformed_is_noop(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_FAULT_SPEC, "{not json")
        assert faults.arm_from_env(worker_id=0) == 0

    def test_arm_from_env_list_and_bad_entries(self, monkeypatch):
        """A list of plans arms each valid one and skips the rest, as the
        reference's does; the port reads its own variable."""
        from daft_tpu import faults as ref_faults

        spec = json.dumps([{"site": "peer.fetch", "mode": "rate", "rate": 0.5, "seed": 2},
                           {"mode": "always"}, "junk",
                           {"site": "worker.task", "mode": "nope"}])
        monkeypatch.setenv(faults.ENV_FAULT_SPEC, spec)
        monkeypatch.setenv(ref_faults.ENV_FAULT_SPEC, spec)
        try:
            assert faults.arm_from_env(worker_id=0) == ref_faults.arm_from_env(worker_id=0) == 1
        finally:
            faults.disarm()
            ref_faults.disarm()
        assert faults.ENV_FAULT_SPEC != ref_faults.ENV_FAULT_SPEC
