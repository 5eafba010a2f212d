"""The port's flight recorder (daft_tpu_torch/obs/: the query log, the slow
and failed query capture, health, live progress, the structured log) held
against daft_tpu's on the CPU.

- The log lines of the breaker, the spill and the fail-open catches of
  ``adapt/`` carry the reference's logger names, event names and fields
  (in the 32-bit mode at ``device="cpu"``), and the reference's
  ``validate_record`` and ``validate_health`` accept the port's records and
  snapshot, while a query runs and after it ends.
- tests/test_flight_recorder.py's and tests/test_observability.py's cases,
  run over both packages, but the HTML preview and viz hooks (ROADMAP
  Queue 1, item 10). ``test_config_delta_records_tuned_knobs_only`` tunes
  ``scan_prefetch_depth``, a knob both packages have, where the reference
  tunes ``executor_threads``.

The differences that stay: the admission and persist sections report the
reference's idle values until their subsystems come (ROADMAP Queue 1,
item 10). The cluster section is the live pool's since the distributed
runner (tests/test_torch_dist_runner.py holds it under a pool); without one
it equals the reference's idle section. The collective breaker is built and registered with
each query beside the device breaker, as in the reference. The scheduler and streaming sections, the
record's ``exec_inflight``/``stream_inflight`` and the ``cancelled``
outcome read what the reference's read.
"""

import collections
import dataclasses
import importlib
import json
import os
import threading
import time

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
# log lines and artifacts against the reference
# ---------------------------------------------------------------------------

_RNG = np.random.RandomState(5)
_N = 2000
DATA = {"k": _RNG.randint(0, 30, _N).astype(np.int64),
        "g": _RNG.choice(["a", "b", "c", "d"], _N),
        "v": _RNG.rand(_N)}
BASE = {"executor_threads": 1, "streaming_execution": False, "enable_result_cache": False}


def _frame(pkg, parts: int = 4):
    return pkg.from_pydict({k: v.tolist() for k, v in DATA.items()}).into_partitions(parts)


def _agg(pkg, df=None):
    df = _frame(pkg) if df is None else df
    return df.groupby("g").agg(pkg.col("v").sum().alias("s")).sort("g")


@pytest.fixture(scope="module")
def parquet_glob(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_obs_scan")
    for i in range(2):
        sl = slice(i * _N // 2, (i + 1) * _N // 2)
        papq.write_table(pa.table({k: v[sl] for k, v in DATA.items()}), str(d / f"p{i}.parquet"))
    return os.path.join(str(d), "*.parquet")


def _lines(pkg, logger: str):
    """The multiset of (level, logger, event, field names) of one logger's
    records in ``pkg``'s ring."""
    return collections.Counter(
        (r["level"], r["logger"], r["event"], tuple(sorted(set(r) - {"ts", "thread"})))
        for r in sub(pkg, "obs.log").tail(10_000) if r["logger"] == logger)


def _case_breaker(pkg, _glob):
    return _agg(pkg).collect(), "breaker"


def _case_spill(pkg, _glob):
    df = _frame(pkg).repartition(4, "k").groupby("k").agg(pkg.col("v").sum().alias("s"))
    return df.collect(), "spill"


def _case_plancache(pkg, _glob):
    return _agg(pkg).collect(), "plancache"


def _case_resultcache(pkg, glob):
    col = pkg.col
    df = (pkg.read_parquet(glob).where(col("v") > 0.5).with_column("w", col("v") * 2)
          .select("g", "w").sort("w"))
    return df.collect(), "resultcache"


LOG_CASES = {
    # the breaker trips after two injected failures (breaker_trip)
    "breaker": (_case_breaker, {"device_breaker_threshold": 2}, ("device.kernel", "always", {})),
    # every spill write fails and the partition stays in memory
    # (spill_write_failed)
    "spill": (_case_spill, {**SPILL_BASE, "memory_budget_bytes": 20_000},
              ("spill.write", "always", {})),
    # the plan cache's lookup fails open (plan_cache_lookup_failed)
    "plancache": (_case_plancache, {"plan_cache": True}, ("plancache.lookup", "always", {})),
    # the sub-plan result cache's key fails open (subplan_cache_key_failed)
    "resultcache": (_case_resultcache, {"subplan_result_cache": True},
                    ("resultcache.lookup", "always", {})),
}


@pytest.mark.parametrize("case", sorted(LOG_CASES))
def test_log_lines_as_the_reference(case, parquet_glob):
    build, knobs, (site, mode, kw) = LOG_CASES[case]

    def run(pkg):
        faults = sub(pkg, "faults")
        faults.arm(site, mode, **kw)
        try:
            df, logger = build(pkg, parquet_glob)
        finally:
            faults.disarm()
        return df.to_pydict(), _lines(pkg, logger), df.last_query_record()

    (r_rows, r_lines, _), (p_rows, p_lines, p_rec) = under_both(run, {**BASE, **knobs})
    assert p_lines and p_lines == r_lines
    assert list(p_rows) == list(r_rows)
    from daft_tpu.obs.querylog import validate_record

    assert validate_record(p_rec) == [] and p_rec["outcome"] == "ok"
    assert p_rec["events"].get("faults_injected", 0) >= 1


def test_failed_query_record_as_the_reference():
    """A query whose UDF raises records ``error`` with the error's type in
    both packages."""
    def run(pkg):
        @pkg.udf(return_dtype=pkg.DataType.int64())
        def boom(c):
            raise ValueError("kaboom")

        df = _frame(pkg).select(boom(pkg.col("k")))
        with pytest.raises(ValueError):
            df.collect()
        return df.last_query_record()

    ref, got = under_both(run, BASE)
    from daft_tpu.obs.querylog import validate_record

    assert validate_record(got) == []
    assert (got["outcome"], got["error_type"]) == (ref["outcome"], ref["error_type"]) == (
        "error", "ValueError")
    assert got["plan_ops"] == ref["plan_ops"]
    assert set(got) == set(ref)


def test_cancelled_query_record_as_the_reference():
    """A query cancelled from a second thread records ``cancelled`` with
    ``QueryCancelledError`` in both packages, its ledger's window accounts
    at 0."""
    def run(pkg):
        holder = {}

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def cancel_once(c):
            if not holder.get("done"):
                holder["done"] = True
                t = threading.Thread(target=holder["df"].cancel)
                t.start()
                t.join()
            return c.to_pylist()

        df = holder["df"] = _frame(pkg).select(cancel_once(pkg.col("k")))
        with pytest.raises(sub(pkg, "execution").QueryCancelledError):
            df.collect()
        return df.last_query_record()

    ref, got = under_both(run, BASE)
    from daft_tpu.obs.querylog import validate_record

    assert validate_record(got) == []
    assert (got["outcome"], got["error_type"]) == (ref["outcome"], ref["error_type"]) == (
        "cancelled", "QueryCancelledError")
    assert ({k: got["ledger"][k] for k in ("exec_inflight", "stream_inflight")}
            == {k: ref["ledger"][k] for k in ("exec_inflight", "stream_inflight")}
            == {"exec_inflight": 0, "stream_inflight": 0})
    assert set(got) == set(ref)


def test_health_validates_while_a_query_runs_and_after():
    """The reference's validator accepts the port's snapshot mid-query (the
    query listed with its progress) and after it ends (none listed)."""
    from daft_tpu.obs.health import validate_health

    under_both(lambda pkg: None, BASE)  # the port's config, mapped
    seen = []
    it = _frame(daft_tpu_torch).select((daft_tpu_torch.col("v") * 2).alias("w")).iter_partitions()
    next(it)
    seen.append(daft_tpu_torch.health())
    running = daft_tpu_torch.query_progress()
    for _ in it:
        pass
    seen.append(daft_tpu_torch.health())
    assert [validate_health(h) for h in seen] == [[], []]
    assert len(seen[0]["queries"]) == 1 and seen[1]["queries"] == []
    assert running[0]["ops_total"] >= 2 and running[0]["rows_emitted"] > 0
    assert daft_tpu_torch.query_progress(running[0]["query_id"]) is None
    assert set(seen[1]) == set(daft_tpu.health())
    # no pool is up: the cluster section is the reference's idle one
    assert seen[1]["cluster"] == daft_tpu.health()["cluster"]
    # the mesh breaker is the query's, registered beside the device breaker
    assert seen[1]["breakers"]["collective"] == seen[1]["breakers"]["device"]


# ---------------------------------------------------------------------------
# tests/test_flight_recorder.py's and tests/test_observability.py's cases
# over both packages
# ---------------------------------------------------------------------------

@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """The package under test with the config tests/test_flight_recorder.py's
    fixture sets (the port on the CPU); restored afterwards."""
    if request.param == "reference":
        cfg = daft_tpu.context.get_context().execution_config
        saved = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        cfg.enable_result_cache = False
        yield daft_tpu
        for k, v in saved.items():
            setattr(cfg, k, v)
    else:
        # restore_port_config gives the config back
        daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
            device="cpu", enable_result_cache=False))
        yield daft_tpu_torch


def _cfg(pkg):
    return sub(pkg, "context").get_context().execution_config


def _set(pkg, **kw):
    if pkg is daft_tpu:
        for k, v in kw.items():
            setattr(_cfg(pkg), k, v)
    else:
        daft_tpu_torch.set_execution_config(**kw)


def _query(pkg, n=200):
    df = pkg.from_pydict({"k": ["a", "b", "c", "d"] * (n // 4), "v": list(range(n))})
    col = pkg.col
    return df.where(col("v") > 5).groupby("k").agg(col("v").sum().alias("s")).sort("k")


def _timeout_frame(pkg, mult=2):
    col = pkg.col
    return (pkg.from_pydict({"v": list(range(5000))}).into_partitions(8)
            .select((col("v") * mult).alias("w")))


class TestQueryLog:
    def test_record_appended_on_plain_collect(self, pkg):
        ql = sub(pkg, "obs.querylog")
        before = ql.QUERY_LOG.total
        rec = _query(pkg).collect().last_query_record()
        assert ql.QUERY_LOG.total == before + 1
        assert rec is not None and ql.validate_record(rec) == []
        assert rec["outcome"] == "ok"
        assert rec["plan_fingerprint"] and rec["plan_ops"] and rec["counters"]
        assert pkg.query_log()[-1] is rec
        assert rec["wall_s"] > 0

    def test_disabled_by_knob(self, pkg):
        _set(pkg, enable_query_log=False)
        ql = sub(pkg, "obs.querylog")
        before = ql.QUERY_LOG.total
        q = _query(pkg).collect()
        assert ql.QUERY_LOG.total == before
        assert q.last_query_record() is None

    def test_config_delta_records_tuned_knobs_only(self, pkg):
        _set(pkg, scan_prefetch_depth=1)
        rec = _query(pkg).collect().last_query_record()
        assert rec["config_delta"].get("scan_prefetch_depth") == 1
        assert "device_min_rows" not in rec["config_delta"]

    def test_error_query_still_records_with_partial_stats(self, pkg):
        @pkg.udf(return_dtype=pkg.DataType.int64())
        def boom(c):
            raise ValueError("kaboom")

        df = pkg.from_pydict({"v": [1, 2, 3]}).select(boom(pkg.col("v")))
        with pytest.raises(ValueError):
            df.collect()
        rec = df.last_query_record()
        assert rec is not None and sub(pkg, "obs.querylog").validate_record(rec) == []
        assert rec["outcome"] == "error" and rec["error_type"] == "ValueError"
        assert "kaboom" in rec["error_message"]
        assert rec in pkg.query_log()

    def test_timeout_query_records_via_finally_path(self, pkg):
        _set(pkg, execution_timeout_s=0.000001)
        df = _timeout_frame(pkg)
        with pytest.raises(sub(pkg, "errors").DaftTimeoutError):
            df.collect()
        rec = df.last_query_record()
        assert rec is not None and sub(pkg, "obs.querylog").validate_record(rec) == []
        assert rec["outcome"] == "timeout"
        assert rec["events"].get("deadline_expired", 0) >= 1

    def test_depth_bounds_the_ring(self, pkg):
        _set(pkg, query_log_depth=3)
        for _ in range(5):
            pkg.from_pydict({"v": [1]}).select((pkg.col("v") + 1).alias("w")).collect()
        ql = sub(pkg, "obs.querylog").QUERY_LOG
        assert len(ql) <= 3 and ql.capacity == 3

    def test_fingerprint_stable_across_runs_of_same_plan(self, pkg):
        r1 = _query(pkg).collect().last_query_record()
        r2 = _query(pkg).collect().last_query_record()
        assert r1["plan_fingerprint"] == r2["plan_fingerprint"]
        assert r1["query_id"] != r2["query_id"]

    def test_concurrent_collects_distinct_complete_records(self, pkg):
        n_threads = 6
        results = [None] * n_threads
        errs = []
        start = threading.Barrier(n_threads)

        def worker(i):
            try:
                start.wait()
                n = 40 + 4 * i
                df = pkg.from_pydict({"v": list(range(n))}).into_partitions(2).select(
                    (pkg.col("v") * 2).alias("w"))
                df.collect()
                results[i] = (n, df.last_query_record())
            except Exception as e:
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        validate = sub(pkg, "obs.querylog").validate_record
        qids = set()
        for n, rec in results:
            assert rec is not None and validate(rec) == []
            assert rec["outcome"] == "ok" and rec["rows_emitted"] == n
            qids.add(rec["query_id"])
        assert len(qids) == n_threads
        assert qids <= {r["query_id"] for r in pkg.query_log()}


class TestOverheadGuard:
    def test_record_fold_allocates_nothing_net(self, pkg):
        """50k record builds and ring appends grow memory by < 4 KiB net."""
        import gc
        import tracemalloc

        ql = sub(pkg, "obs.querylog")
        cfg = _cfg(pkg)
        stats = sub(pkg, "execution").RuntimeStats()
        stats.bump("io_wait_ns", 123)
        stats.record_op("ProjectOp", 10, 1000, 64)
        log = ql.QueryLog(depth=64)

        def fold(i):
            log.append(ql.build_record(f"q-{i}", "fp0123456789abcd", {"ProjectOp": 1}, cfg,
                                       stats, 1_000_000, "ok", rows_emitted=10))

        for i in range(2000):
            fold(i)
        log.clear()
        gc.collect()
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        for i in range(50_000):
            fold(i)
        assert len(log) == 64
        log.clear()
        gc.collect()
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
        growth = sum(s.size_diff for s in after.compare_to(before, "filename") if s.size_diff > 0)
        assert growth < 4096, f"record fold leaked {growth} bytes"


class TestAutoCapture:
    def test_slow_query_bundle_and_auto_arm(self, pkg, tmp_path):
        list_bundles = sub(pkg, "obs.capture").list_bundles
        _set(pkg, slow_query_threshold_s=0.0, diagnostics_dir=str(tmp_path))
        r1 = _query(pkg).collect().last_query_record()
        assert r1["profiled"] is False
        bundles = list_bundles(str(tmp_path))
        assert len(bundles) == 1
        files = set(os.listdir(tmp_path / bundles[0]))
        assert {"record.json", "stats.txt", "log_tail.jsonl"} <= files
        assert "profile.json" not in files
        loaded = json.load(open(tmp_path / bundles[0] / "record.json"))
        assert sub(pkg, "obs.querylog").validate_record(loaded) == []
        assert "== Runtime Stats ==" in open(tmp_path / bundles[0] / "stats.txt").read()
        r2 = _query(pkg).collect().last_query_record()
        assert r2["plan_fingerprint"] == r1["plan_fingerprint"]
        assert r2["profiled"] is True
        bundles = list_bundles(str(tmp_path))
        assert len(bundles) == 2
        assert "profile.json" in os.listdir(tmp_path / bundles[-1])

    def test_failed_query_bundle_without_threshold(self, pkg, tmp_path):
        _set(pkg, diagnostics_dir=str(tmp_path), execution_timeout_s=0.000001)
        with pytest.raises(sub(pkg, "errors").DaftTimeoutError):
            _timeout_frame(pkg, 3).collect()
        bundles = sub(pkg, "obs.capture").list_bundles(str(tmp_path))
        assert len(bundles) == 1 and bundles[0].endswith("_timeout")
        assert json.load(open(tmp_path / bundles[0] / "record.json"))["outcome"] == "timeout"

    def test_retention_keeps_last_k(self, pkg, tmp_path):
        _set(pkg, slow_query_threshold_s=0.0, diagnostics_dir=str(tmp_path),
             diagnostics_keep_last=3)
        for i in range(6):
            pkg.from_pydict({"v": list(range(10 + i))}).select(
                (pkg.col("v") + i).alias("w")).collect()
        assert len(sub(pkg, "obs.capture").list_bundles(str(tmp_path))) <= 3

    def test_capture_contract_survives_disabled_query_log(self, pkg, tmp_path):
        _set(pkg, enable_query_log=False, diagnostics_dir=str(tmp_path))

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def boom(c):
            raise ValueError("still captured")

        df = pkg.from_pydict({"v": [1, 2]}).select(boom(pkg.col("v")))
        ql = sub(pkg, "obs.querylog").QUERY_LOG
        before = ql.total
        with pytest.raises(ValueError):
            df.collect()
        assert ql.total == before
        assert df.last_query_record() is None
        bundles = sub(pkg, "obs.capture").list_bundles(str(tmp_path))
        assert len(bundles) == 1 and bundles[0].endswith("_error")

    def test_retention_ignores_unrelated_directories(self, pkg, tmp_path):
        (tmp_path / "precious").mkdir()
        (tmp_path / "precious" / "data.txt").write_text("keep me")
        _set(pkg, slow_query_threshold_s=0.0, diagnostics_dir=str(tmp_path),
             diagnostics_keep_last=1)
        for i in range(3):
            pkg.from_pydict({"v": [i]}).select((pkg.col("v") + 1).alias("w")).collect()
        assert (tmp_path / "precious" / "data.txt").read_text() == "keep me"
        assert len(sub(pkg, "obs.capture").list_bundles(str(tmp_path))) <= 1

    def test_no_bundle_without_diagnostics_dir(self, pkg, tmp_path):
        _set(pkg, slow_query_threshold_s=0.0)
        list_bundles = sub(pkg, "obs.capture").list_bundles
        before = len(list_bundles(str(tmp_path)))
        _query(pkg).collect()
        assert len(list_bundles(str(tmp_path))) == before

    def test_capture_never_fails_the_query(self, pkg, tmp_path):
        # an unwritable diagnostics dir degrades to an error log line
        bad = tmp_path / "file_not_dir"
        bad.write_text("x")
        _set(pkg, slow_query_threshold_s=0.0, diagnostics_dir=str(bad))
        q = _query(pkg).collect()
        assert q.last_query_record() is not None
        assert any(r["event"] == "query_record_failed"
                   for r in sub(pkg, "obs.log").tail(100, level="error"))


class TestHealth:
    def test_health_validates_and_names_breakers(self, pkg):
        _query(pkg).collect()
        h = pkg.health()
        assert sub(pkg, "obs.health").validate_health(h) == []
        assert {"device", "collective"} <= set(h["breakers"])
        assert h["query_log"]["depth"] >= 1
        assert h["queries_total"] >= 1
        assert h["scheduler"]["inflight_tasks"] == 0

    def test_scheduler_and_streaming_sections_while_tasks_run(self, pkg):
        # mid-task, the scheduler's window and the query's progress count the
        # running tasks (the UDF waits for a second one, an event, not a
        # duration); after the query both read 0
        _set(pkg, executor_threads=2, streaming_execution=False)
        seen, two = [], threading.Event()
        lock = threading.Lock()
        count = [0]

        @pkg.udf(return_dtype=pkg.DataType.int64(), concurrency=2)
        class Peek:
            def __call__(self, s):
                with lock:
                    count[0] += 1
                    if count[0] == 2:
                        two.set()
                two.wait(30)
                h = pkg.health()
                seen.append((h["scheduler"]["inflight_tasks"],
                             [q["tasks_inflight"] for q in h["queries"]]))
                return s.to_pylist()

        df = pkg.from_pydict({"v": list(range(400))}).into_partitions(4)
        assert df.select(Peek(pkg.col("v")).alias("w")).to_pydict()["w"] == list(range(400))
        h = pkg.health()
        assert sub(pkg, "obs.health").validate_health(h) == []
        assert all(n >= 1 and q and q[0] >= 1 for n, q in seen)
        assert h["scheduler"]["inflight_tasks"] == 0
        assert h["streaming"] == {"active_channels": 0, "queued_morsels": 0, "queued_bytes": 0}

    def test_health_gauges_in_metrics_text(self, pkg):
        _query(pkg).collect()
        text = pkg.metrics_text()
        for name in ("daft_tpu_query_log_depth", "daft_tpu_device_breaker_state",
                     "daft_tpu_collective_breaker_state", "daft_tpu_scheduler_inflight_tasks",
                     "daft_tpu_actor_pools", "daft_tpu_leaked_threads"):
            assert name in text, name

    def test_ledger_gauges_without_profiled_run(self, pkg):
        _query(pkg).collect()
        text = pkg.metrics_text()
        for name in ("daft_tpu_memory_ledger_bytes", "daft_tpu_memory_ledger_high_water_bytes",
                     "daft_tpu_memory_ledger_prefetch_inflight_bytes",
                     "daft_tpu_memory_ledger_async_spill_inflight_bytes",
                     "daft_tpu_memory_ledger_negative_releases"):
            assert name in text, name


class TestStructuredLog:
    def test_bg_thread_lines_carry_query_id_zero_orphans(self, pkg):
        obs_log = sub(pkg, "obs.log")
        _set(pkg, memory_budget_bytes=20_000, async_spill_writes=True)
        t0 = time.time()
        faults = sub(pkg, "faults")
        with faults.inject("spill.write", "always"):
            q = (pkg.from_pydict({"k": list(range(2000)), "v": list(range(2000))})
                 .repartition(8, "k").groupby("k").agg(pkg.col("v").sum().alias("s"))).collect()
        qid = q.last_query_record()["query_id"]
        recs = [r for r in obs_log.tail(10_000)
                if r["event"] == "spill_write_failed" and r["ts"] >= t0]
        bg = [r for r in recs if r["thread"] != "MainThread"]
        assert bg, "expected writer-thread log lines"
        assert [r for r in bg if r.get("query_id") != qid] == []

    def test_deadline_line_attributed(self, pkg):
        _set(pkg, execution_timeout_s=0.000001)
        df = _timeout_frame(pkg)
        with pytest.raises(sub(pkg, "errors").DaftTimeoutError):
            df.collect()
        qid = df.last_query_record()["query_id"]
        lines = sub(pkg, "obs.log").tail(100, query_id=qid)
        assert any(r["event"] == "deadline_expired" for r in lines)

    def test_ring_cap_evicts_and_counts(self, pkg):
        obs_log = sub(pkg, "obs.log")
        try:
            obs_log.clear()
            obs_log.set_ring_cap(10)
            lg = obs_log.get_logger("test")
            for i in range(25):
                lg.debug("e", i=i)
            assert obs_log.ring_size() == 10
            assert obs_log.dropped_records() == 15
            assert obs_log.tail(5)[-1]["i"] == 24
        finally:
            obs_log.set_ring_cap(obs_log.DEFAULT_RING_CAP)
            obs_log.clear()

    def test_interleaved_lazy_streams_never_leak_context(self, pkg):
        obs_log = sub(pkg, "obs.log")
        col = pkg.col
        df1 = pkg.from_pydict({"v": list(range(20))}).into_partitions(4).select(
            (col("v") + 1).alias("w"))
        df2 = pkg.from_pydict({"v": list(range(20))}).into_partitions(4).select(
            (col("v") + 2).alias("w"))
        it1, it2 = df1.iter_partitions(), df2.iter_partitions()
        next(it1)
        assert obs_log.current_query_id() is None
        next(it2)
        assert obs_log.current_query_id() is None
        next(it1)
        assert obs_log.current_query_id() is None
        it1.close()
        it2.close()
        assert obs_log.current_query_id() is None

    def test_query_context_nests_and_restores(self, pkg):
        obs_log = sub(pkg, "obs.log")
        assert obs_log.current_query_id() is None
        with obs_log.query_context("q-a"):
            assert obs_log.current_query_id() == "q-a"
            with obs_log.query_context("q-b"):
                assert obs_log.current_query_id() == "q-b"
            assert obs_log.current_query_id() == "q-a"
        assert obs_log.current_query_id() is None

    def test_sink_and_file_outputs(self, pkg, tmp_path):
        obs_log = sub(pkg, "obs.log")
        seen = []
        obs_log.add_sink(seen.append)
        path = str(tmp_path / "engine.jsonl")
        obs_log.log_to_file(path)
        try:
            obs_log.get_logger("test").info("hello", x=1)
        finally:
            obs_log.remove_sink(seen.append)
            obs_log.close_file()
        assert seen and seen[-1]["event"] == "hello"
        line = json.loads(open(path).read().strip().splitlines()[-1])
        assert line["event"] == "hello" and line["x"] == 1

    def test_engine_log_tail_api(self, pkg):
        qid = _query(pkg).collect().last_query_record()["query_id"]
        assert isinstance(pkg.engine_log_tail(10, query_id=qid), list)


class TestRecordValidation:
    def test_missing_keys_flagged(self, pkg):
        errs = sub(pkg, "obs.querylog").validate_record({"query_id": "x"})
        assert any("missing key" in e for e in errs)

    def test_bad_outcome_flagged(self, pkg):
        rec = dict(_query(pkg).collect().last_query_record())
        rec["outcome"] = "exploded"
        assert any("outcome" in e for e in sub(pkg, "obs.querylog").validate_record(rec))

    def test_error_outcome_requires_error_type(self, pkg):
        rec = dict(_query(pkg).collect().last_query_record())
        rec["outcome"] = "error"
        assert any("error_type" in e for e in sub(pkg, "obs.querylog").validate_record(rec))

    def test_record_json_roundtrips(self, pkg):
        rec = _query(pkg).collect().last_query_record()
        validate = sub(pkg, "obs.querylog").validate_record
        assert validate(json.loads(json.dumps(rec, default=str))) == []


def _obs_query(pkg):
    df = pkg.from_pydict({"k": ["a", "b", "a", "c"] * 25, "v": list(range(100))})
    col = pkg.col
    return df.where(col("v") > 10).groupby("k").agg(col("v").sum().alias("s")).sort("k")


class TestObservability:
    """tests/test_observability.py's chrome-trace, explain_analyze and
    progress cases."""

    def test_trace_file_written(self, pkg, tmp_path):
        tracing = sub(pkg, "tracing")
        path = str(tmp_path / "trace.json")
        with tracing.chrome_trace(path):
            _obs_query(pkg).collect()
        evs = json.load(open(path))["traceEvents"]
        assert evs
        assert any("Aggregate" in e["name"] for e in evs)
        for e in evs:
            assert e["ph"] == "X" and "ts" in e and "dur" in e

    def test_disabled_by_default(self, pkg):
        assert not sub(pkg, "tracing").active()
        _obs_query(pkg).collect()

    def test_reports_ops_and_rows(self, pkg, capsys):
        text = _obs_query(pkg).explain_analyze()
        assert "Runtime Stats" in text and "Aggregate" in text and "rows out" in text

    def test_counters_section(self, pkg):
        q = pkg.from_pydict({"v": list(range(50))}).select(
            (pkg.col("v") + 1).alias("w")).collect()
        text = q.explain_analyze()
        assert "counters:" in text and "projections" in text

    def test_progress_callback(self, pkg):
        tracing = sub(pkg, "tracing")
        seen = []
        tracing.set_progress_callback(lambda name, rows: seen.append((name, rows)))
        try:
            _obs_query(pkg).collect()
        finally:
            tracing.set_progress_callback(None)
        assert seen and any(rows > 0 for _, rows in seen)
