"""The port's query profiler (daft_tpu_torch/profile/, tracing.py) held
against daft_tpu's on the CPU.

- The span tree: over a profiled query of each shape (a Q1-shaped
  aggregate over 1 and 3 partitions, a hash join, a multi-partition sort, a
  budgeted spill, a scan with readahead, a batched UDF and an armed
  ``device.kernel`` fault), the multiset of ``(name, kind, op, part)``, the
  spans that carry a ``device_dispatch`` phase and the event kinds equal
  the reference's, in the 32-bit mode at ``device="cpu"``; the reference's
  ``validate_profile`` accepts the port's profile, and the port's has no
  orphan span. Both packages run with one executor thread and streaming
  off, so each span tree is the same whatever the pool's timing.
- ``explain_analyze``'s counters equal the reference's once times are
  masked, and ``metrics_text()``'s metric names equal the reference's.
- A profiled query returns the unprofiled run's rows and counters.
- tests/test_profile.py's cases, run over both packages: the background
  attribution with the pooled shuffle fan-out on two executor threads, and
  the scheduler's worker spans with their ``queue_wait`` phase.
"""

import collections
import dataclasses
import importlib
import json
import os
import re
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from torch_parity import (SPILL_BASE, actor_pools_down, fresh_ledgers_and_faults,  # noqa: F401
                          restore_port_config, under_both)

pytestmark = pytest.mark.usefixtures("restore_port_config")


def sub(pkg, name: str):
    """``pkg``'s submodule ``name``."""
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.fixture(autouse=True)
def _clean():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()
    actor_pools_down()


# ---------------------------------------------------------------------------
# the span tree against the reference
# ---------------------------------------------------------------------------

_RNG = np.random.RandomState(11)
_N = 3000
DATA = {"k": _RNG.randint(0, 40, _N).astype(np.int64),
        "g": _RNG.choice(["a", "b", "c"], _N),
        "v": _RNG.rand(_N),
        "w": _RNG.randint(0, 1000, _N).astype(np.int64),
        "d": _RNG.rand(_N) * 0.1}
DIM = {"k": np.arange(40, dtype=np.int64), "name": np.array([f"n{i}" for i in range(40)])}

# both packages: one executor thread, streaming off, no cache serving a
# result or a plan (the span tree of a cold run)
SPAN_BASE = {"executor_threads": 1, "streaming_execution": False,
             "enable_result_cache": False, "plan_cache": False}


def _frame(pkg, d, parts: int = 1):
    df = pkg.from_pydict({k: v.tolist() for k, v in d.items()})
    return df.into_partitions(parts) if parts > 1 else df


def _q1(pkg, parts: int):
    col = pkg.col
    return (_frame(pkg, DATA, parts).where(col("w") < 800)
            .groupby("g").agg(col("w").sum().alias("sw"), col("v").mean().alias("mv"),
                              (col("v") * (1 - col("d"))).sum().alias("rev"),
                              col("w").count().alias("c"))
            .sort("g"))


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_profile_scan")
    for i in range(4):
        sl = slice(i * _N // 4, (i + 1) * _N // 4)
        papq.write_table(pa.table({k: v[sl] for k, v in DATA.items()}),
                         str(d / f"part-{i}.parquet"))
    return str(d)


class Scorer:
    """A batch-declared model: a host instance and each package's device
    apply, which the 32-bit mode runs on the CPU."""

    weight_bytes = 1024

    def __call__(self, v):
        return np.asarray(v.to_numpy(), dtype=np.float64) * 2.0 - 3.0

    @staticmethod
    def apply_jax(v):
        return v * 2.0 - 3.0

    @staticmethod
    def apply_torch(v):
        return v * 2.0 - 3.0


def _batched(pkg):
    model = pkg.batch_udf(return_dtype=pkg.DataType.float64(), max_rows=700,
                          flush_ms=10_000.0, device=True)(Scorer)
    return _frame(pkg, DATA, 4).select(model(pkg.col("v")).alias("s"))


def _shapes(scan_dir):
    return {
        "q1_1part": (lambda pkg: _q1(pkg, 1), {}, None),
        "q1_3parts": (lambda pkg: _q1(pkg, 3), {}, None),
        "hash_join": (lambda pkg: _frame(pkg, DATA, 2).join(_frame(pkg, DIM), on="k")
                      .groupby("name").agg(pkg.col("v").sum().alias("s")),
                      {"broadcast_join_size_bytes_threshold": 0}, None),
        "sort": (lambda pkg: _frame(pkg, DATA, 3).sort(["w", "k"]), {}, None),
        "spill": (lambda pkg: _frame(pkg, DATA, 4).repartition(4, "k")
                  .groupby("k").agg(pkg.col("v").sum().alias("s")),
                  {**SPILL_BASE, "memory_budget_bytes": 20_000}, None),
        "scan": (lambda pkg: pkg.read_parquet(os.path.join(scan_dir, "*.parquet"))
                 .groupby("g").agg(pkg.col("v").sum().alias("s")),
                 {"scan_prefetch_depth": 2, "scan_tasks_min_size_bytes": 1,
                  "subplan_result_cache": False}, None),
        "batched_udf": (_batched, {"dynamic_batching": True}, None),
        "device_fault": (lambda pkg: _frame(pkg, DATA, 4).groupby("g")
                         .agg(pkg.col("v").sum().alias("s")),
                         {"device_breaker_threshold": 2}, ("device.kernel", "always")),
    }


SHAPES = ("q1_1part", "q1_3parts", "hash_join", "sort", "spill", "scan", "batched_udf",
          "device_fault")


def _profiled_both(shape: str, scan_dir: str):
    build, knobs, fault = _shapes(scan_dir)[shape]

    def run(pkg):
        faults = sub(pkg, "faults")
        if fault is not None:
            faults.arm(*fault)
        try:
            return build(pkg).collect(profile=True)
        finally:
            faults.disarm()

    return under_both(run, {**SPAN_BASE, **knobs})


def _tree(df):
    qp = df.profile()
    spans = collections.Counter((s.name, s.kind, s.op, s.part) for s in qp.spans())
    dispatched = collections.Counter(
        (s.name, s.op, s.part) for s in qp.spans() if "device_dispatch" in (s.phases or {}))
    events = collections.Counter(e["kind"] for e in qp.events)
    return spans, dispatched, events


@pytest.mark.parametrize("shape", SHAPES)
def test_span_tree_as_the_reference(shape, parquet_dir):
    from daft_tpu.profile import validate_profile

    ref, got = _profiled_both(shape, parquet_dir)
    assert got.to_pydict().keys() == ref.to_pydict().keys()
    r_spans, r_disp, r_events = _tree(ref)
    p_spans, p_disp, p_events = _tree(got)
    assert p_spans == r_spans
    assert p_disp == r_disp
    assert p_events == r_events
    qp = got.profile()
    assert qp.orphan_spans == 0
    # the reference's validator accepts the port's artifact, as built and
    # after a JSON round trip
    assert validate_profile(qp.to_dict()) == []
    assert validate_profile(json.loads(qp.to_json())) == []
    # and the query log's record and the health snapshot
    from daft_tpu.obs.health import validate_health
    from daft_tpu.obs.querylog import validate_record

    rec = got.last_query_record()
    assert rec["profiled"] is True and validate_record(rec) == []
    assert rec["outcome"] == ref.last_query_record()["outcome"] == "ok"
    assert validate_health(daft_tpu_torch.health()) == []
    if shape in ("q1_1part", "q1_3parts"):
        # every partition aggregated on the card records its staging and
        # launch in the op span that launched it
        c = got.stats.snapshot()["counters"]
        assert sum(p_disp.values()) >= c["device_aggregations"] > 0


def test_shapes_exercise_their_layers(parquet_dir):
    """The cases above see what they are there for: background spans of the
    spill and the readahead, the batching spans, the fault's events."""
    names = {}
    for shape in ("spill", "scan", "batched_udf", "device_fault"):
        _, got = _profiled_both(shape, parquet_dir)
        qp = got.profile()
        names[shape] = ({s.name for s in qp.spans()}, {e["kind"] for e in qp.events})
    assert "spill.read" in names["spill"][0] and "spill" in names["spill"][1]
    assert "prefetch.fetch" in names["scan"][0] and "scan.plan" in names["scan"][0]
    assert {"batch.coalesce", "actor.apply"} <= names["batched_udf"][0]
    assert {"fault_injected", "breaker"} <= names["device_fault"][1]


def test_explain_analyze_counters_as_the_reference():
    def run(pkg):
        df = _q1(pkg, 3).collect(profile=True)
        return sub(pkg, "obs.capture").render_runtime_stats(df.stats)

    ref, got = under_both(run, SPAN_BASE)

    def counters(text):
        line = next(ln for ln in text.splitlines() if ln.startswith("counters: "))
        return re.sub(r"(_ns=)\d+", r"\1#", line)

    assert counters(got) == counters(ref)
    assert "== Runtime Stats ==" in got and "planning: " in got


def test_metric_names_as_the_reference():
    """One query's fold into a fresh registry (the query metrics and the
    health gauges) names the reference's metrics."""
    def run(pkg):
        df = _q1(pkg, 3).collect()
        reg = sub(pkg, "profile.metrics").MetricsRegistry()
        sub(pkg, "profile.metrics").record_query_metrics(df.stats, 1_000_000, registry=reg)
        return {ln.split()[2] for ln in reg.render_prometheus().splitlines()
                if ln.startswith("# TYPE ")}

    ref, got = under_both(run, SPAN_BASE)
    assert got == ref
    assert {"daft_tpu_queries_total", "daft_tpu_query_seconds",
            "daft_tpu_device_breaker_state", "daft_tpu_collective_breaker_state"} <= got


@pytest.mark.parametrize("deep", [False, True], ids=["composed", "deep"])
@pytest.mark.parametrize("parts", [1, 3])
def test_profiled_run_keeps_the_rows_and_counters(deep, parts):
    """Profiling observes: the rows and every counter but the clocks are
    the unprofiled run's (Q1 through K1 or K2 on the CPU, in the 32-bit
    mode)."""
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
        device="cpu", device_min_rows=8, use_deep_fusion_kernel=deep,
        enable_result_cache=False, plan_cache=False))
    plain = _q1(daft_tpu_torch, parts).collect()
    prof = _q1(daft_tpu_torch, parts).collect(profile=True)
    assert prof.to_pydict() == plain.to_pydict()

    def c(df):
        return {k: v for k, v in df.stats.snapshot()["counters"].items()
                if not k.endswith("_ns")}

    assert c(prof) == c(plain) and c(plain)["device_aggregations"] > 0
    assert plain.profile() is None and prof.profile() is not None


# ---------------------------------------------------------------------------
# tests/test_profile.py's cases over both packages
# ---------------------------------------------------------------------------

@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """The package under test with a config as tests/test_profile.py's
    fixture sets it (the port on the CPU); restored afterwards."""
    if request.param == "reference":
        cfg = daft_tpu.context.get_context().execution_config
        saved = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        cfg.enable_result_cache = False
        cfg.scan_tasks_min_size_bytes = 1
        yield daft_tpu
        for k, v in saved.items():
            setattr(cfg, k, v)
    else:
        # restore_port_config gives the config back
        daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
            device="cpu", enable_result_cache=False, scan_tasks_min_size_bytes=1))
        yield daft_tpu_torch


def _set(pkg, **kw):
    """Change the package's config (knobs both packages have)."""
    if pkg is daft_tpu:
        cfg = daft_tpu.context.get_context().execution_config
        for k, v in kw.items():
            setattr(cfg, k, v)
    else:
        daft_tpu_torch.set_execution_config(**kw)


def _query(pkg, n=2000):
    df = pkg.from_pydict({"k": ["a", "b", "c", "d"] * (n // 4), "v": list(range(n))})
    col = pkg.col
    return df.where(col("v") > 5).groupby("k").agg(col("v").sum().alias("s")).sort("k")


def _write_parquet_dir(tmp_path, nfiles=5, rows_per=3000):
    rng = np.random.RandomState(7)
    d = tmp_path / "scan"
    d.mkdir()
    for i in range(nfiles):
        tbl = pa.table({"k": pa.array(rng.randint(0, 40, rows_per)),
                        "v": pa.array(rng.rand(rows_per)),
                        "s": pa.array(["x" * 40 + str(j % 83) for j in range(rows_per)])})
        papq.write_table(tbl, str(d / f"part-{i:02d}.parquet"))
    return str(d)


BG_NAMES = {"spill.write", "spill.read", "prefetch.fetch"}


class TestQueryProfile:
    def test_collect_profile_builds_valid_artifact(self, pkg, tmp_path):
        validate = sub(pkg, "profile").validate_profile
        path = str(tmp_path / "prof.json")
        q = _query(pkg).collect(profile=path)
        qp = q.profile()
        assert qp is not None
        assert validate(qp.to_dict()) == []
        assert qp.ops and qp.critical_path_op in qp.ops
        assert qp.orphan_spans == 0
        loaded = json.load(open(path))
        assert validate(loaded) == []
        assert loaded["query_id"] == qp.query_id
        assert pkg.last_profile() is qp

    def test_profile_off_by_default(self, pkg):
        q = _query(pkg).collect()
        assert q.profile() is None
        assert q.stats.profiler is sub(pkg, "profile.spans").DISARMED

    def test_enable_profiling_config_knob(self, pkg):
        _set(pkg, enable_profiling=True)
        assert _query(pkg).collect().profile() is not None

    def test_partition_counts_exact(self, pkg):
        col = pkg.col
        df = pkg.from_pydict({"v": list(range(100))}).into_partitions(4)
        ops = df.select((col("v") * 2).alias("w")).collect(profile=True).profile().ops
        proj = [o for name, o in ops.items() if "Project" in name or "FusedMap" in name]
        assert proj and proj[0]["partitions"] == 4

    def test_self_time_reconciles_with_runtime_stats(self, pkg):
        q = _query(pkg, 20_000).collect(profile=True)
        qp = q.profile()
        stats_wall = q.stats.snapshot()["op_wall_ns"]
        assert stats_wall
        for name, ns in stats_wall.items():
            prof_self = qp.ops.get(name, {}).get("self_ns", 0)
            assert abs(prof_self - ns) <= max(0.05 * ns, 2_000_000), (name, prof_self, ns)
        total_stats = sum(stats_wall.values())
        total_prof = sum(o["self_ns"] for n, o in qp.ops.items() if n in stats_wall)
        assert abs(total_prof - total_stats) <= max(0.05 * total_stats, 2_000_000)

    def test_explain_analyze_has_timeline_section(self, pkg, capsys):
        text = _query(pkg).explain_analyze()
        assert "== Profile (" in text
        assert "critical path:" in text

    def test_events_recorded_for_injected_faults(self, pkg):
        faults = sub(pkg, "faults")
        try:
            with faults.inject("scan.read", "first_n", n=1):
                # an in-memory source never reaches scan.read: the armed
                # registry must not disturb execution
                q = _query(pkg).collect(profile=True)
        finally:
            faults.disarm()
        assert sub(pkg, "profile").validate_profile(q.profile().to_dict()) == []


class TestCrossThreadAttribution:
    def test_background_spans_attributed_no_orphans(self, pkg, tmp_path):
        path = _write_parquet_dir(tmp_path)
        _set(pkg, scan_prefetch_depth=2, async_spill_writes=True, unspill_readahead=True,
             parallel_shuffle_fanout=True, executor_threads=2, memory_budget_bytes=200_000)
        col = pkg.col
        df = (pkg.read_parquet(os.path.join(path, "*.parquet")).repartition(4, "k")
              .groupby("k").agg(col("v").sum().alias("s")))
        qp = df.collect(profile=True).profile()
        assert qp.orphan_spans == 0
        spans = qp.spans()
        by_id = {s.sid: s for s in spans}
        bg = [s for s in spans if s.kind == "bg"]
        assert bg, "expected background spans (spill/prefetch active)"
        assert {s.name for s in bg} & BG_NAMES
        for s in bg:
            cur, hops = s, 0
            while cur.parent is not None and hops < 100:
                cur = by_id[cur.parent]
                if cur.kind == "op":
                    break
                hops += 1
            assert cur.kind == "op", f"orphan bg span {s!r}"
        assert any(o["background"] for o in qp.ops.values())

    def test_worker_spans_carry_queue_wait(self, pkg):
        # the scheduler's worker-task spans (streaming off: with it on this
        # plan shape runs through the morsel pipeline)
        _set(pkg, executor_threads=2, streaming_execution=False)
        df = pkg.from_pydict({"v": list(range(4000))}).into_partitions(8)
        q = df.select((pkg.col("v") * 3).alias("w")).collect(profile=True)
        worker = [s for s in q.profile().spans()
                  if s.kind == "op" and s.phases and "queue_wait" in s.phases]
        assert worker, "a pooled map records queue_wait phases"

    def test_shuffle_phase_spans_present(self, pkg):
        col = pkg.col
        df = pkg.from_pydict({"k": list(range(200)), "v": list(range(200))})
        q = df.repartition(4, "k").groupby("k").agg(col("v").sum().alias("s")).collect(
            profile=True)
        assert "shuffle.fanout" in {s.name for s in q.profile().spans()}

    def test_io_wait_total_reconciles(self, pkg, tmp_path):
        path = _write_parquet_dir(tmp_path, nfiles=3)
        # synchronous reads on one thread: a fixed io_wait
        _set(pkg, scan_prefetch_depth=0, executor_threads=1)
        col = pkg.col
        q = pkg.read_parquet(os.path.join(path, "*.parquet")).groupby("k").agg(
            col("v").sum().alias("s")).collect(profile=True)
        counter = q.stats.snapshot()["counters"].get("io_wait_ns", 0)
        d = q.profile().to_dict()
        prof_total = (sum(o["io_wait_ns"] for o in d["ops"].values())
                      + d["unattributed_phases"].get("io_wait", 0))
        assert abs(prof_total - counter) <= max(0.01 * counter, 50_000)


class TestDisarmedOverhead:
    def test_disarmed_hot_path_allocates_nothing(self, pkg):
        import tracemalloc

        prof = sub(pkg, "profile.spans").DISARMED
        stats = sub(pkg, "execution").RuntimeStats()

        def hot_iter():
            if prof.armed:  # the guard every hot caller uses
                raise AssertionError
            with prof.span("x"):
                pass
            prof.phase("io_wait", 1)
            prof.event("nope")
            prof.capture()

        for _ in range(1000):
            hot_iter()
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        for _ in range(50_000):
            hot_iter()
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
        growth = sum(s.size_diff for s in after.compare_to(before, "filename") if s.size_diff > 0)
        assert growth < 4096, f"disarmed hot path leaked {growth} bytes"
        assert not stats.profiler.armed

    def test_disarmed_span_returns_shared_noop(self, pkg):
        disarmed = sub(pkg, "profile.spans").DISARMED
        assert disarmed.span("a") is disarmed.span("b", part=3)
        assert disarmed.capture() is None
        assert disarmed.begin("x") is None


class TestRuntimeStatsConcurrency:
    def test_bump_hammer_exact_totals(self, pkg):
        stats = sub(pkg, "execution").RuntimeStats()
        n_threads, n_iter = 8, 10_000
        start = threading.Barrier(n_threads)

        def worker(i):
            start.wait()
            for j in range(n_iter):
                stats.bump("shared")
                stats.bump(f"key{j % 3}", 2)
                stats.record_op("op", 1, 10, 5)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        snap = stats.snapshot()
        assert snap["counters"]["shared"] == n_threads * n_iter
        assert sum(snap["counters"][f"key{i}"] for i in range(3)) == 2 * n_threads * n_iter
        assert snap["op_rows"]["op"] == n_threads * n_iter
        assert snap["op_wall_ns"]["op"] == 10 * n_threads * n_iter
        assert snap["op_bytes"]["op"] == 5 * n_threads * n_iter

    def test_io_wait_helper_feeds_counter_and_phase(self, pkg):
        stats = sub(pkg, "execution").RuntimeStats()
        stats.profiler = sub(pkg, "profile").Profiler(query_id="t")
        sp = stats.profiler.begin("op1", op="op1")
        stats.io_wait(1234)
        stats.profiler.end(sp)
        assert stats.snapshot()["counters"]["io_wait_ns"] == 1234
        assert sp.phases["io_wait"] == 1234


class TestProfilerCore:
    def test_capture_activate_parents_across_threads(self, pkg):
        prof = sub(pkg, "profile").Profiler(query_id="t")
        sp = prof.begin("op", op="OpA")
        token = prof.capture()

        def bg():
            with prof.activate(token):
                with prof.span("spill.write", kind="bg"):
                    pass

        t = threading.Thread(target=bg)
        t.start()
        t.join()
        prof.end(sp)
        bg_span = next(s for s in prof.spans_snapshot() if s.name == "spill.write")
        assert bg_span.parent == sp.sid

    def test_span_cap_drops_and_counts(self, pkg):
        prof = sub(pkg, "profile").Profiler(query_id="t", max_spans=5)
        for i in range(9):
            prof.end(prof.begin(f"s{i}"))
        assert len(prof.spans_snapshot()) == 5
        assert prof.dropped_spans == 4

    def test_event_cap_drops_and_counts(self, pkg):
        prof = sub(pkg, "profile").Profiler(query_id="t", max_events=3)
        for i in range(7):
            prof.event("e", i=i)
        assert len(prof.events_snapshot()) == 3
        assert prof.dropped_events == 4

    def test_event_allows_kind_attr(self, pkg):
        prof = sub(pkg, "profile").Profiler(query_id="t")
        prof.event("breaker", kind="device", transition="trip", state="open")
        ev = prof.events_snapshot()[0]
        assert ev["kind"] == "breaker" and ev["attrs"]["kind"] == "device"

    def test_breaker_transitions_emit_events_while_profiled(self, pkg):
        ex = sub(pkg, "execution")
        stats = ex.RuntimeStats()
        stats.profiler = sub(pkg, "profile").Profiler(query_id="t")
        h = ex.DeviceHealth(threshold=2, cooldown_s=0.0)
        h.record_failure(stats)
        h.record_failure(stats)  # trips
        assert h.state == "open"
        assert h.allow(stats)  # cooldown 0: a half-open probe
        h.record_success(stats)  # recovery
        kinds = [e["attrs"].get("transition") for e in stats.profiler.events_snapshot()]
        assert kinds == ["trip", "probe", "recovery"]

    def test_unbalanced_end_degrades_not_raises(self, pkg):
        prof = sub(pkg, "profile").Profiler(query_id="t")
        a = prof.begin("a")
        b = prof.begin("b")
        prof.end(a)  # out of order: tolerated
        prof.end(b)
        assert len(prof.spans_snapshot()) == 2


class TestTracingBuffer:
    def test_ring_cap_evicts_and_counts(self, pkg, tmp_path):
        tracing = sub(pkg, "tracing")
        path = str(tmp_path / "t.json")
        tracing.enable(path)
        try:
            tracing.set_buffer_cap(10)
            for i in range(25):
                tracing.add_event(f"e{i}", float(i), 1.0)
            assert tracing.dropped_events() == 15
            data = json.load(open(tracing.flush()))
            assert len(data["traceEvents"]) == 10
            assert data["droppedEvents"] == 15
            assert data["traceEvents"][-1]["name"] == "e24"
        finally:
            tracing.disable()
            tracing.set_buffer_cap(tracing.DEFAULT_BUFFER_CAP)

    def test_flush_atomic_with_concurrent_emits(self, pkg, tmp_path):
        """Every event emitted while flushes race the emits lands in exactly
        one flushed batch: the batch sizes sum to the events emitted."""
        tracing = sub(pkg, "tracing")
        path = str(tmp_path / "t.json")
        tracing.enable(path)
        batches = []
        try:
            n_threads, n_iter = 4, 2000
            stop = threading.Event()

            def flusher():
                while not stop.is_set():
                    if tracing.flush() is not None:
                        batches.append(len(json.load(open(path))["traceEvents"]))

            def emitter(t):
                for i in range(n_iter):
                    tracing.add_event(f"ev-{t}-{i}", 0.0, 1.0)

            ft = threading.Thread(target=flusher)
            ft.start()
            ts = [threading.Thread(target=emitter, args=(t,)) for t in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            stop.set()
            ft.join()
            tracing.flush()
            batches.append(len(json.load(open(path))["traceEvents"]))
            assert tracing.dropped_events() == 0
            assert sum(batches) == n_threads * n_iter
        finally:
            tracing.disable()

    def test_flush_keep_preserves_buffer(self, pkg, tmp_path):
        tracing = sub(pkg, "tracing")
        tracing.enable(str(tmp_path / "t.json"))
        try:
            tracing.add_event("a", 0.0, 1.0)
            tracing.flush(keep=True)
            tracing.add_event("b", 1.0, 1.0)
            out = json.load(open(tracing.flush()))
            assert [e["name"] for e in out["traceEvents"]] == ["a", "b"]
        finally:
            tracing.disable()

    def test_chrome_trace_rendered_from_span_tree(self, pkg, tmp_path):
        tracing = sub(pkg, "tracing")
        path = str(tmp_path / "trace.json")
        with tracing.chrome_trace(path):
            _query(pkg).collect()
        evs = json.load(open(path))["traceEvents"]
        assert any("Aggregate" in e["name"] for e in evs)
        spans = [e for e in evs if e["ph"] == "X"]
        assert spans and all("args" in e and "span" in e["args"] for e in spans)


class TestMetrics:
    def test_counter_gauge_histogram_render(self, pkg):
        reg = sub(pkg, "profile.metrics").MetricsRegistry()
        reg.counter("t_total", "a counter").inc(3)
        reg.gauge("t_gauge").set(2.5)
        h = reg.histogram("t_seconds", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(5.0)
        text = reg.render_prometheus()
        assert "# TYPE t_total counter" in text
        assert "t_total 3" in text
        assert "t_gauge 2.5" in text
        assert 't_seconds_bucket{le="0.1"} 1' in text
        assert 't_seconds_bucket{le="+Inf"} 2' in text
        assert "t_seconds_count 2" in text

    def test_kind_conflict_raises(self, pkg):
        reg = sub(pkg, "profile.metrics").MetricsRegistry()
        reg.counter("dup")
        with pytest.raises(sub(pkg, "errors").DaftValueError):
            reg.gauge("dup")

    def test_queries_recorded_process_wide(self, pkg):
        metrics = sub(pkg, "profile").METRICS
        before = metrics.snapshot().get("daft_tpu_queries_total", 0)
        _query(pkg).collect()
        assert metrics.snapshot().get("daft_tpu_queries_total", 0) >= before + 1
        assert "daft_tpu_queries_total" in pkg.metrics_text()

    def test_invalid_metric_name_rejected(self, pkg):
        with pytest.raises(sub(pkg, "errors").DaftValueError):
            sub(pkg, "profile.metrics").MetricsRegistry().counter("bad name!")


class TestValidation:
    def test_missing_keys_flagged(self, pkg):
        errs = sub(pkg, "profile").validate_profile({"query_id": "x"})
        assert any("missing key" in e for e in errs)

    def test_dangling_parent_flagged(self, pkg):
        d = json.loads(json.dumps(_query(pkg).collect(profile=True).profile().to_dict()))
        d["spans"][0]["parent"] = 10_000_000
        assert any("parent" in e for e in sub(pkg, "profile").validate_profile(d))

    def test_profile_json_roundtrip_stays_valid(self, pkg, tmp_path):
        p = str(tmp_path / "q.json")
        _query(pkg).collect(profile=p)
        assert sub(pkg, "profile").validate_profile(json.load(open(p))) == []
