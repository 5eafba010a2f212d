"""The port's cluster-wide observability (daft_tpu_torch/obs/cluster.py:
worker telemetry fragments, their merge, live query progress) held against
the reference's on the CPU: the cases of tests/test_cluster_obs.py through
the port, at ``device="cpu"``, beside the reference's own functions where a
case is a unit.

- One trace: a profiled query under 2 workers validates (the port's and the
  reference's ``validate_profile``) with no orphan span, a spliced span on
  each worker's lane, ``dist.remote`` spans with their phase split, and the
  per-op rows of NativeRunner.
- Fail-open: an injected ``telemetry.fragment`` fault, a corrupt and an
  oversized fragment change counters only; a SIGKILLed worker's lost
  fragment is counted and orphans no span; a worker's log lines reach the
  driver's ring with their query id.
- The fragment and splice units (built, validated and merged alike by both
  packages), live progress and the health surfaces.

Left out: ``test_serving_handle_progress``, which needs the serving runtime
(``serve/``, ROADMAP Queue 1, item 10).
"""

import json
import os

import pytest

import daft_tpu
import daft_tpu_torch as dtt
from daft_tpu.obs import cluster as ref_cluster
from daft_tpu.obs.health import validate_health as ref_validate_health
from daft_tpu.obs.querylog import validate_record as ref_validate_record
from daft_tpu.profile.export import validate_profile as ref_validate_profile
from daft_tpu_torch import col, faults
from daft_tpu_torch.context import get_context, set_execution_config
from daft_tpu_torch.dist import supervisor as sup
from daft_tpu_torch.obs import cluster as obs_cluster
from daft_tpu_torch.obs import log as obs_log
from daft_tpu_torch.obs.cluster import (TELEMETRY_VERSION, build_fragment, merge_fragment,
                                        validate_fragment)
from daft_tpu_torch.obs.health import validate_health
from daft_tpu_torch.obs.querylog import validate_record
from daft_tpu_torch.profile.export import validate_profile


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


def _frame(n=8000):
    return dtt.from_pydict({"a": list(range(n)), "b": [i % 13 for i in range(n)]})


def _query(df):
    return (df.select(col("b"), (col("a") * col("b") + 1).alias("ab"))
            .where(col("ab") % 5 != 0)
            .groupby("b").agg(col("ab").sum().alias("s")).sort("b"))


@pytest.fixture(scope="module")
def local4():
    """NativeRunner's run over 4 partitions, once."""
    ctx = get_context()
    saved = ctx.execution_config
    try:
        set_execution_config(device="cpu", enable_result_cache=False, distributed_workers=0)
        return _query(_frame().repartition(4)).collect()
    finally:
        ctx.execution_config = saved


class TestMergedTrace:
    def test_profiled_query_one_truthful_trace(self, local4):
        local_rows = local4.stats.snapshot()["op_rows"]
        set_execution_config(distributed_workers=2)
        got = _query(_frame().repartition(4)).collect(profile=True)
        assert got.to_arrow().equals(local4.to_arrow())
        data = got.profile().to_dict()
        assert validate_profile(data) == [] and ref_validate_profile(data) == []
        assert data["orphan_spans"] == 0
        # a span on each worker's lane of the chrome trace
        lanes = {s["thread"] for s in data["spans"] if s["thread"].startswith("worker-")}
        assert lanes >= {"worker-0", "worker-1"}, lanes
        names = {s["name"] for s in data["spans"]}
        assert "dist.remote" in names and "worker.task" in names
        for s in data["spans"]:
            if s["thread"].startswith("worker-"):
                assert s["kind"] != "op", s
        assert got.stats.snapshot()["op_rows"] == local_rows
        c = got.stats.snapshot()["counters"]
        assert c.get("telemetry_merged", 0) >= 1 and not c.get("telemetry_dropped")
        rec = got.last_query_record()
        assert validate_record(rec) == [] and ref_validate_record(rec) == []
        assert rec["op_rows"] == local_rows
        assert rec["counters"].get("dist_tasks", 0) >= 1

    def test_dist_remote_span_carries_phase_split(self):
        set_execution_config(distributed_workers=2)
        got = _query(_frame().repartition(4)).collect(profile=True)
        remote = [s for s in got.profile().to_dict()["spans"] if s["name"] == "dist.remote"]
        assert remote
        assert any("remote_wait" in (s.get("phases") or {}) for s in remote), remote[:3]
        assert all((s.get("attrs") or {}).get("worker") is not None for s in remote)

    def test_unprofiled_query_still_folds_counters(self):
        set_execution_config(distributed_workers=2)
        got = _query(_frame().repartition(4)).collect()
        assert got.stats.snapshot()["counters"].get("telemetry_merged", 0) >= 1


class TestFailOpen:
    def test_injected_fragment_fault_changes_counters_only(self, local4):
        set_execution_config(distributed_workers=2)
        faults.arm("telemetry.fragment", "always")
        try:
            got = _query(_frame().repartition(4)).collect()
        finally:
            faults.disarm()
        assert got.to_arrow().equals(local4.to_arrow())
        c = got.stats.snapshot()["counters"]
        assert c.get("telemetry_dropped", 0) >= 1 and not c.get("telemetry_merged")
        # nothing re-dispatched or retried because of telemetry
        assert not c.get("task_redispatches") and not c.get("task_retries")
        rec = got.last_query_record()
        assert rec["outcome"] == "ok" and rec["events"].get("telemetry_dropped", 0) >= 1

    GARBAGE = (None, 42, [], {"v": 99}, {"v": TELEMETRY_VERSION},
               {"v": TELEMETRY_VERSION, "counters": "nope", "spans": [], "events": [],
                "logs": [], "t0_ns": 0, "dur_ns": 0},
               {"v": TELEMETRY_VERSION, "counters": {}, "spans": [{"bad": 1}], "events": [],
                "logs": [], "t0_ns": 0, "dur_ns": 0})

    def test_corrupt_fragment_dropped_not_fatal(self):
        from daft_tpu_torch.execution import ExecutionContext

        ctx = ExecutionContext(get_context().execution_config)
        for garbage in self.GARBAGE:
            assert merge_fragment(ctx, garbage, 0) is False
            assert validate_fragment(garbage) == ref_cluster.validate_fragment(garbage)
        c = ctx.stats.snapshot()["counters"]
        assert c.get("telemetry_dropped") == 7 and not c.get("telemetry_merged")

    def test_oversized_fragment_truncated_not_fatal(self):
        from daft_tpu_torch.execution import ExecutionContext

        logs = [{"event": "x" * 2000, "level": "info"} for _ in range(50)]
        spans = [{"id": i + 1, "parent": None, "name": "n" * 500, "kind": "bg", "thread": "t",
                  "t0_ns": 0, "dur_ns": 1} for i in range(50)]
        args = ("q-x", "op", 0, 0, 10, {"host_filters": 3}, spans, [], logs)
        frag = build_fragment(*args, max_bytes=4096)
        assert frag == ref_cluster.build_fragment(*args, max_bytes=4096)
        assert frag["truncated"] is True and frag["counters"] == {"host_filters": 3}
        assert validate_fragment(frag) == []
        ctx = ExecutionContext(get_context().execution_config)
        assert merge_fragment(ctx, frag, 1) is True
        c = ctx.stats.snapshot()["counters"]
        assert c.get("host_filters") == 3 and c.get("telemetry_truncated") == 1
        assert c.get("telemetry_merged") == 1

    def test_sigkilled_worker_lost_fragments_never_orphan_spans(self):
        set_execution_config(distributed_workers=0)
        local = _query(_frame().repartition(8)).collect()
        sup.shutdown_worker_pool()
        set_execution_config(distributed_workers=2)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()  # warm
        faults.arm("worker.exec", "nth", n=3)
        try:
            got = _query(_frame().repartition(8)).collect(profile=True)
        finally:
            faults.disarm()
        assert got.to_arrow().equals(local.to_arrow())
        data = got.profile().to_dict()
        assert validate_profile(data) == [] and data["orphan_spans"] == 0
        rec = got.last_query_record()
        assert validate_record(rec) == []
        assert rec["events"].get("worker_losses", 0) >= 1
        # the killed worker's in-flight fragment was counted, not chased
        assert rec["events"].get("telemetry_dropped", 0) >= 1
        assert sup.worker_pool_snapshot()["telemetry_dropped_total"] >= 1

    def test_worker_task_error_relays_worker_log_with_query_id(self):
        sup.shutdown_worker_pool()
        os.environ[faults.ENV_FAULT_SPEC] = json.dumps(
            {"site": "worker.task", "mode": "first_n", "n": 1})
        set_execution_config(distributed_workers=2)
        try:
            got = _query(_frame().repartition(4)).collect()
        finally:
            os.environ.pop(faults.ENV_FAULT_SPEC, None)
        # the injected failure in the worker retried to success...
        rec = got.last_query_record()
        assert rec["outcome"] == "ok" and rec["events"].get("task_retries", 0) >= 1
        # ...and the worker's own line about it reached the driver's ring
        relayed = [r for r in obs_log.tail(2000) if "relay_worker" in r]
        assert any(r["event"] == "worker_task_failed" for r in relayed)
        assert all("query_id" in r for r in relayed), relayed[:3]
        sup.shutdown_worker_pool()

    def test_fault_site_registered(self):
        assert "telemetry.fragment" in faults.SITES
        assert "telemetry.fragment" in daft_tpu.faults.SITES


class TestFragmentUnits:
    def test_build_fragment_bounds_entries(self):
        logs = [{"event": f"e{i}"} for i in range(500)]
        frag = build_fragment("q", "op", 1, 100, 50, {}, [], [], logs)
        assert frag == ref_cluster.build_fragment("q", "op", 1, 100, 50, {}, [], [], logs)
        assert len(frag["logs"]) <= obs_cluster.MAX_FRAGMENT_LOGS
        assert frag["truncated"] is True and validate_fragment(frag) == []

    def test_splice_remaps_ids_and_reparents_roots(self):
        from daft_tpu.profile.spans import Profiler as RefProfiler
        from daft_tpu_torch.profile.spans import Profiler

        def run(cls):
            prof = cls(query_id="t")
            anchor = prof.begin("op0", op="op0")
            # a worker subtree in END order (the child first), with ids that
            # collide with the driver's
            child = {"id": 1, "parent": 2, "name": "phasey", "kind": "phase",
                     "thread": "MainThread", "t0_ns": 50, "dur_ns": 10}
            root = {"id": 2, "parent": None, "name": "worker.task", "kind": "op",
                    "thread": "MainThread", "t0_ns": 0, "dur_ns": 100}
            n = prof.splice([child, root], [{"t_ns": 60, "kind": "spill"}], anchor.sid, 1000,
                            thread="worker-7")
            prof.end(anchor)
            spans = {s.name: s for s in prof.spans_snapshot()}
            return n, anchor.sid, spans, prof.events_snapshot()

        n, anchor, spans, evs = run(Profiler)
        assert n == 2
        assert spans["worker.task"].parent == anchor
        assert spans["phasey"].parent == spans["worker.task"].sid
        assert spans["worker.task"].kind == "bg"  # never doubles the per-op rollup
        assert spans["worker.task"].thread == "worker-7"
        assert spans["worker.task"].t0_ns == 1000
        assert evs and evs[0]["t_ns"] == 1060
        rn, ranchor, rspans, revs = run(RefProfiler)
        spliced = ("phasey", "worker.task")
        assert {k: (spans[k].kind, spans[k].thread, spans[k].t0_ns, spans[k].dur_ns)
                for k in spliced} == {k: (rspans[k].kind, rspans[k].thread, rspans[k].t0_ns,
                                          rspans[k].dur_ns) for k in spliced}
        assert [(e["t_ns"], e["kind"]) for e in evs] == [(e["t_ns"], e["kind"]) for e in revs]

    def test_splice_respects_span_cap(self):
        from daft_tpu_torch.profile.spans import Profiler

        prof = Profiler(query_id="t", max_spans=2)
        spans = [{"id": i + 1, "parent": None, "name": f"s{i}", "kind": "bg", "thread": "x",
                  "t0_ns": 0, "dur_ns": 1} for i in range(5)]
        assert prof.splice(spans, [], None, 0) == 2
        assert prof.dropped_spans == 3

    def test_collector_never_entered_builds_nothing(self):
        from daft_tpu_torch.execution import RuntimeStats

        assert obs_cluster.TelemetryCollector("q", "op", 0, RuntimeStats()).fragment() is None

    def test_inject_publishes_as_recorded(self):
        seen = []
        obs_log.add_sink(seen.append)
        try:
            rec = {"ts": 1.5, "level": "warning", "logger": "dist.worker",
                   "event": "relayed", "query_id": "q-9", "relay_worker": 3}
            obs_log.inject(rec)
        finally:
            obs_log.remove_sink(seen.append)
        assert seen == [rec]
        assert obs_log.tail(1)[-1] == rec


class TestQueryProgress:
    def test_progress_unit_lifecycle(self):
        from daft_tpu.execution import RuntimeStats as RefStats
        from daft_tpu_torch.execution import RuntimeStats

        def run(mod, stats):
            p = mod.QueryProgress("q-p", stats, {"ScanOp": 1, "ProjectOp": 2})
            p.task_started()
            p.op_done("ScanOp")
            p.op_done("ScanOp")  # capped at the plan's one instance
            p.add_rows(10)
            first = p.snapshot()
            p.op_done("ProjectOp")
            p.op_done("ProjectOp")
            second = p.snapshot()["ops_completed"]
            p.task_finished()
            p.task_finished()  # clamped, never negative
            return ({k: first[k] for k in ("ops_total", "ops_completed", "tasks_inflight",
                                           "rows_emitted", "workers")},
                    second, p.snapshot()["tasks_inflight"])

        got = run(obs_cluster, RuntimeStats())
        assert got == ({"ops_total": 3, "ops_completed": 1, "tasks_inflight": 1,
                        "rows_emitted": 10, "workers": {}}, 3, 0)
        assert got == run(ref_cluster, RefStats())

    def test_progress_visible_during_execution_and_health_validates(self):
        seen = []

        @dtt.udf(return_dtype=dtt.DataType.int64())
        def sample(c):
            seen.append(dtt.query_progress())
            h = dtt.health()
            seen.append(("health", validate_health(h), ref_validate_health(h),
                         len(h["queries"])))
            return c.to_pylist()

        _frame(2000).repartition(2).select(sample(col("a")).alias("a")).collect()
        progress_lists = [s for s in seen if isinstance(s, list)]
        entry = next(pl for pl in progress_lists if pl)[0]
        for key in ("query_id", "elapsed_s", "ops_total", "ops_completed", "rows_flowed",
                    "bytes_flowed", "rows_emitted", "tasks_inflight", "workers", "channels"):
            assert key in entry, (key, entry)
        probes = [s for s in seen if isinstance(s, tuple)]
        assert probes
        for _tag, errs, ref_errs, n_queries in probes:
            assert errs == [] and ref_errs == [] and n_queries >= 1

    def test_progress_workers_read_the_live_pool(self):
        """Under a pool a running query's progress names each worker's
        in-flight count (the reference's ``_worker_inflight``)."""
        set_execution_config(distributed_workers=2)
        seen = []

        @dtt.udf(return_dtype=dtt.DataType.int64())
        def sample(c):
            seen.append(dtt.query_progress())
            return c.to_pylist()

        _ = _query(_frame(1000).repartition(2)).collect()  # the pool is up
        _frame(2000).repartition(2).select(sample(col("a")).alias("a")).collect()
        entry = next(pl for pl in seen if pl)[0]
        assert set(entry["workers"]) == {"0", "1"}

    def test_progress_unregistered_after_completion(self):
        assert _query(_frame(1000).repartition(2)).collect() is not None
        assert dtt.query_progress() == []

    def test_active_query_stats_names_the_running_queries(self):
        seen = []

        @dtt.udf(return_dtype=dtt.DataType.int64())
        def sample(c):
            seen.append(list(obs_cluster.active_query_stats()))
            return c.to_pylist()

        df = _frame(500).select(sample(col("a")).alias("a")).collect()
        assert seen and any(df.stats is s for s in seen[0])
        assert obs_cluster.active_query_stats() == []


class TestHealthSurfaces:
    def test_cluster_health_carries_telemetry_detail_and_gauges(self):
        set_execution_config(distributed_workers=2)
        _ = _query(_frame(2000).repartition(4)).collect()
        h = dtt.health()
        assert validate_health(h) == [] and ref_validate_health(h) == []
        clu = h["cluster"]
        assert "telemetry_dropped_total" in clu
        for w in clu["worker_detail"].values():
            assert "telemetry_rx" in w and "telemetry_dropped" in w
        assert sum(w["telemetry_rx"] for w in clu["worker_detail"].values()) >= 1
        text = dtt.metrics_text()
        for g in ("daft_tpu_cluster_telemetry_dropped_total", "daft_tpu_query_progress_active",
                  "daft_tpu_query_progress_tasks_inflight"):
            assert g in text

    def test_idle_cluster_health_still_validates(self):
        sup.shutdown_worker_pool()
        h = dtt.health()
        assert validate_health(h) == [] and ref_validate_health(h) == []
        assert h["cluster"]["telemetry_dropped_total"] == 0
        assert isinstance(h["queries"], list)
