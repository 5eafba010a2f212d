"""Cluster-wide observability: worker telemetry fragments and live query
progress (the port's copy of daft_tpu/obs/cluster.py).

The distributed runner (dist/) ships map-class partition tasks to worker
processes, which puts a process boundary through the observability stack:
the spans, counters and log lines a worker produces would vanish from the
driver's span tree, RuntimeStats, QueryRecord and log ring. Three pieces
close the boundary:

**Telemetry fragments** (in the worker, :class:`TelemetryCollector`): each
remote task runs in a scope that arms a local Profiler (when the driver's
query is profiled), snapshots the worker's RuntimeStats counters before and
after, and captures the log records the task emitted. The *fragment* is a
bounded, versioned plain dict (``TELEMETRY_VERSION``; size and entry caps
that truncate, never fail) riding the ``result``/``task_error`` reply.

**The merge** (in the driver, :func:`merge_fragment`): worker spans splice
under the ``dist.remote`` span that caused the dispatch
(``Profiler.splice``, one ``worker-N`` lane each in the chrome trace),
counter deltas fold into the driver's RuntimeStats (so the routing
counters a worker bumped, ``device_aggregations`` among them, read as under
NativeRunner), and worker log records land in the driver's ring with their
query id (``log.inject``). Per-op rows and walls are not folded: the
scheduler's ``run_one`` records them from the reply, so a lost fragment
never makes the rollup lie.

**Fail-open**: a dropped, oversized, corrupt or unparseable fragment costs a
counter (``telemetry_dropped``/``telemetry_truncated``), never a task
failure, a re-dispatch or a changed result. The ``telemetry.fragment``
fault site fires per merge.

:class:`QueryProgress` tracks one running query: registered by
``execution.execute_plan`` for the execution's lifetime, it answers
``daft_tpu_torch.health()["queries"]``, ``query_progress()`` and the
``daft_tpu_query_progress_*`` gauges (operators completed against the
plan's total, rows and bytes flowed, tasks in flight, the live pool's
per-worker in-flight counts, the stream channels' depths).
``active_query_stats`` hands the supervisor the running queries' stats (a
graceful worker drain counts ``workers_drained`` on each).
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Dict, List, Optional

from .log import get_logger, query_context

__all__ = ["TELEMETRY_VERSION", "TelemetryCollector", "build_fragment",
           "validate_fragment", "merge_fragment", "QueryProgress",
           "register_progress", "unregister_progress", "query_progress",
           "queries_snapshot", "active_query_stats"]

logger = get_logger("obs.cluster")

# fragment wire-format version: the merge drops (counts, never fails on)
# any fragment whose version it does not speak
TELEMETRY_VERSION = 1

# fragment bounds — a pathological task degrades ITS telemetry, never the
# reply frame or the driver. Spans/events are capped at collection time
# (the worker profiler's own buffer caps), logs at the sink, and the
# whole fragment is shrunk under MAX_FRAGMENT_BYTES before it rides the
# reply (logs dropped first, then events, then spans; counters last).
MAX_FRAGMENT_BYTES = 256 * 1024
MAX_FRAGMENT_SPANS = 512
MAX_FRAGMENT_EVENTS = 128
MAX_FRAGMENT_LOGS = 64


# ---------------------------------------------------------------------------
# worker side: per-task collection
# ---------------------------------------------------------------------------

class TelemetryCollector:
    """Per-task telemetry scope on a worker process.

    ``with TelemetryCollector(...)`` binds the task's query id as log
    context, snapshots the worker's RuntimeStats counters, arms a bounded
    local Profiler when the driver's query is profiled, and captures the
    log records emitted while the task ran. :meth:`fragment` then builds
    the bounded reply payload — returning ``None`` on ANY internal defect
    (fail-open: telemetry must never fail a task)."""

    def __init__(self, query_id: Optional[str], op_name: str, seq: int,
                 stats, profile: bool = False,
                 max_bytes: int = MAX_FRAGMENT_BYTES,
                 max_logs: int = MAX_FRAGMENT_LOGS):
        self.query_id = query_id
        self.op_name = op_name
        self.seq = seq
        self.stats = stats
        self.profile = profile
        self.max_bytes = max_bytes
        self.max_logs = max_logs
        self.profiler = None
        self._prev_profiler = None
        self._qctx = None
        self._snap0: Dict[str, int] = {}
        self._logs: List[dict] = []
        self._log_overflow = False
        self._t0 = 0
        self._dur_ns = 0

    # every engine log record emitted while the task runs is captured here
    # (the worker executes one task at a time, so the window is the task)
    def _on_log(self, rec: dict) -> None:
        if len(self._logs) < self.max_logs:
            self._logs.append(dict(rec))
        else:
            self._log_overflow = True

    def __enter__(self) -> "TelemetryCollector":
        from . import log as obs_log

        self._t0 = time.perf_counter_ns()
        self._qctx = query_context(self.query_id)
        self._qctx.__enter__()
        try:
            self._snap0 = dict(self.stats.snapshot()["counters"])
        except Exception:
            self._snap0 = {}
        if self.profile:
            try:
                from ..profile.spans import Profiler

                self.profiler = Profiler(
                    query_id=self.query_id or "task",
                    max_spans=MAX_FRAGMENT_SPANS,
                    max_events=MAX_FRAGMENT_EVENTS)
                self._prev_profiler = self.stats.profiler
                self.stats.profiler = self.profiler
            except Exception:
                self.profiler = None
        try:
            obs_log.add_sink(self._on_log)
        except Exception:
            pass  # fail-open: the fragment ships without a log tail
        return self

    def __exit__(self, *exc) -> bool:
        from . import log as obs_log

        self._dur_ns = time.perf_counter_ns() - self._t0
        try:
            obs_log.remove_sink(self._on_log)
        except Exception:
            pass  # fail-open: a sink that never installed has no removal
        if self._prev_profiler is not None:
            self.stats.profiler = self._prev_profiler
            self._prev_profiler = None
        if self._qctx is not None:
            self._qctx.__exit__(None, None, None)
            self._qctx = None
        return False

    def fragment(self) -> Optional[dict]:
        """The bounded telemetry fragment for the finished task, or None
        when building it failed (fail-open — the reply ships without)."""
        if not self._t0:
            return None  # scope never entered: nothing true to report
        try:
            counters: Dict[str, int] = {}
            snap1 = self.stats.snapshot()["counters"]
            for k, v in snap1.items():
                d = v - self._snap0.get(k, 0)
                if d:
                    counters[str(k)] = int(d)
            spans: List[dict] = []
            events: List[dict] = []
            if self.profiler is not None:
                spans = [s.as_dict() for s in self.profiler.spans_snapshot()]
                events = self.profiler.events_snapshot()
            logs = []
            for rec in self._logs:
                r = dict(rec)
                r.setdefault("query_id", self.query_id)
                logs.append(r)
            return build_fragment(
                self.query_id, self.op_name, self.seq, self._t0,
                self._dur_ns, counters, spans, events, logs,
                truncated=self._log_overflow, max_bytes=self.max_bytes)
        except Exception:
            return None


def build_fragment(query_id: Optional[str], op_name: str, seq: int,
                   t0_ns: int, dur_ns: int, counters: Dict[str, int],
                   spans: List[dict], events: List[dict], logs: List[dict],
                   truncated: bool = False,
                   max_bytes: int = MAX_FRAGMENT_BYTES) -> dict:
    """Assemble + bound one telemetry fragment. Oversized content is
    TRUNCATED, never fatal: logs shed first, then events, then spans —
    the counters delta (the rollup-bearing part) survives to the end."""
    frag = {
        "v": TELEMETRY_VERSION,
        "query_id": query_id,
        "op": op_name,
        "seq": int(seq),
        "t0_ns": int(t0_ns),
        "dur_ns": int(dur_ns),
        "counters": counters,
        "spans": list(spans)[:MAX_FRAGMENT_SPANS],
        "events": list(events)[:MAX_FRAGMENT_EVENTS],
        "logs": list(logs)[:MAX_FRAGMENT_LOGS],
        "truncated": bool(truncated
                          or len(spans) > MAX_FRAGMENT_SPANS
                          or len(events) > MAX_FRAGMENT_EVENTS
                          or len(logs) > MAX_FRAGMENT_LOGS),
    }
    for victim in ("logs", "events", "spans"):
        if _fragment_size(frag) <= max_bytes:
            return frag
        if frag[victim]:
            frag[victim] = []
            frag["truncated"] = True
    if _fragment_size(frag) > max_bytes:
        # even the counters are pathological: keep the envelope only
        frag["counters"] = {}
        frag["truncated"] = True
    return frag


def _fragment_size(frag: dict) -> int:
    return len(pickle.dumps(frag, protocol=pickle.HIGHEST_PROTOCOL))


# ---------------------------------------------------------------------------
# driver side: validation + merge
# ---------------------------------------------------------------------------

_SPAN_KEYS = ("id", "name", "kind", "t0_ns", "dur_ns")


def validate_fragment(frag) -> List[str]:
    """Schema check for an incoming fragment — empty list means
    mergeable. Anything else reads as corrupt and is dropped (counted)."""
    errs: List[str] = []
    if not isinstance(frag, dict):
        return ["fragment is not an object"]
    if frag.get("v") != TELEMETRY_VERSION:
        return [f"fragment version {frag.get('v')!r} != "
                f"{TELEMETRY_VERSION}"]
    if not isinstance(frag.get("counters"), dict):
        errs.append("counters missing or non-dict")
    for key in ("spans", "events", "logs"):
        if not isinstance(frag.get(key), list):
            errs.append(f"{key} missing or non-list")
    if not isinstance(frag.get("t0_ns"), int) \
            or not isinstance(frag.get("dur_ns"), int):
        errs.append("t0_ns/dur_ns missing or non-int")
    if not errs:
        for i, s in enumerate(frag["spans"]):
            if not isinstance(s, dict) or \
                    any(k not in s for k in _SPAN_KEYS):
                errs.append(f"spans[{i}] mistyped")
                break
    return errs


def merge_fragment(ctx, frag, worker_id: int) -> bool:
    """Fold one worker telemetry fragment into the driver query's
    observability state: counters into RuntimeStats, spans/events spliced
    under the causing op span (``worker-<id>`` lane), log records into
    the driver's ring with query_id intact.

    Strictly fail-open: a fault-injected, unparseable, version-skewed, or
    internally-failing merge bumps ``telemetry_dropped`` and returns
    False — the task result is untouched and nothing re-dispatches. An
    oversized fragment was already truncated at build; driver-side clips
    are counted as ``telemetry_truncated``, not dropped."""
    from .. import faults
    from ..errors import DaftTransientError

    stats = ctx.stats
    try:
        faults.check("telemetry.fragment", stats)
    except DaftTransientError:
        stats.bump("telemetry_dropped")
        return False
    try:
        errs = validate_fragment(frag)
        if errs:
            stats.bump("telemetry_dropped")
            logger.debug("telemetry_fragment_invalid", worker=worker_id,
                         errors=errs[:3])
            return False
        truncated = bool(frag.get("truncated"))
        spans = frag["spans"]
        events = frag["events"]
        logs = frag["logs"]
        if len(spans) > MAX_FRAGMENT_SPANS or \
                len(events) > MAX_FRAGMENT_EVENTS or \
                len(logs) > MAX_FRAGMENT_LOGS:
            spans = spans[:MAX_FRAGMENT_SPANS]
            events = events[:MAX_FRAGMENT_EVENTS]
            logs = logs[:MAX_FRAGMENT_LOGS]
            truncated = True
        for k, v in frag["counters"].items():
            if isinstance(k, str) and isinstance(v, int) and v:
                stats.bump(k, v)
        prof = stats.profiler
        if prof.armed and (spans or events):
            # rebase the worker's clock onto the driver's: anchor the
            # subtree so it ENDS at merge time, inside the still-open
            # dist.remote span it splices under
            offset = (time.perf_counter_ns() - frag["t0_ns"]
                      - frag["dur_ns"])
            prof.splice(spans, events, prof.capture(), offset,
                        thread=f"worker-{worker_id}")
        if logs:
            from . import log as obs_log

            qid = frag.get("query_id")
            for rec in logs:
                if not isinstance(rec, dict):
                    continue
                r = dict(rec)
                if qid is not None:
                    r.setdefault("query_id", qid)
                # distinct from the supervisor's own `worker=` field: this
                # marks a RELAYED worker-process record, the zero-orphan
                # worker-log acceptance filter
                r["relay_worker"] = worker_id
                obs_log.inject(r)
        if truncated:
            stats.bump("telemetry_truncated")
        stats.bump("telemetry_merged")
        return True
    except Exception as e:
        # observability must never fail the task it describes
        stats.bump("telemetry_dropped")
        logger.warning("telemetry_merge_failed", worker=worker_id,
                       error=repr(e))
        return False




def _channel_depths() -> Dict[str, int]:
    """The stream channels' occupancy (process-wide registry)."""
    from ..stream.channel import channels_snapshot

    s = channels_snapshot()
    return {"queued_morsels": s["queued_morsels"], "queued_bytes": s["queued_bytes"]}


class QueryProgress:
    """Live progress of one running query. Updates are O(1) on the execution
    path; the snapshot does the aggregation at read time."""

    __slots__ = ("query_id", "stats", "plan_ops", "ops_total", "started",
                 "_lock", "_ops_done", "rows_emitted", "_tasks_inflight")

    def __init__(self, query_id: str, stats, plan_ops: Dict[str, int]):
        self.query_id = query_id
        self.stats = stats
        self.plan_ops = dict(plan_ops) if plan_ops else {}
        self.ops_total = sum(self.plan_ops.values())
        self.started = time.monotonic()
        self._lock = threading.Lock()
        # op name -> exhausted-instance count: a plan repeats op classes (two
        # ProjectOps are two plan_ops entries), so completion counts
        # INSTANCES, capped per name at what the plan holds
        self._ops_done: Dict[str, int] = {}
        self.rows_emitted = 0
        self._tasks_inflight = 0

    def task_started(self) -> None:
        """A partition task of this query was dispatched."""
        with self._lock:
            self._tasks_inflight += 1

    def task_finished(self) -> None:
        """A dispatched task ended (or was cancelled before it ran)."""
        with self._lock:
            self._tasks_inflight = max(0, self._tasks_inflight - 1)

    def op_done(self, name: str) -> None:
        """One operator instance's stream is exhausted."""
        with self._lock:
            self._ops_done[name] = self._ops_done.get(name, 0) + 1

    def add_rows(self, n: int) -> None:
        with self._lock:
            self.rows_emitted += n

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        counters = snap["counters"]
        with self._lock:
            done = sum(min(n, self.plan_ops.get(name, n))
                       for name, n in self._ops_done.items())
            rows_emitted = self.rows_emitted
            inflight = self._tasks_inflight
        return {
            "query_id": self.query_id,
            "elapsed_s": round(time.monotonic() - self.started, 3),
            "ops_total": self.ops_total,
            "ops_completed": min(done, self.ops_total) if self.ops_total else done,
            "rows_flowed": sum(snap["op_rows"].values()),
            "bytes_flowed": sum(snap["op_bytes"].values()),
            "rows_emitted": rows_emitted,
            "tasks_inflight": inflight,
            "tasks_speculated": counters.get("tasks_speculated", 0),
            "dist_tasks": counters.get("dist_tasks", 0),
            "workers": _worker_inflight(),
            "channels": _channel_depths(),
        }


def _worker_inflight() -> Dict[str, int]:
    """Per-worker in-flight task counts of the live pool (empty without
    one). Process-wide: concurrent queries share the split."""
    try:
        from ..dist.supervisor import worker_pool_snapshot

        snap = worker_pool_snapshot()
        if not snap:
            return {}
        return {wid: d.get("inflight", 0) for wid, d in snap.get("worker_detail", {}).items()}
    except Exception:
        return {}


_progress_lock = threading.Lock()
_progress: "Dict[str, QueryProgress]" = {}


def register_progress(p: QueryProgress) -> None:
    """Track a running query's progress (the last registration of a query
    id wins: an AQE query registers again per stage under one id)."""
    with _progress_lock:
        _progress[p.query_id] = p


def unregister_progress(p: QueryProgress) -> None:
    with _progress_lock:
        if _progress.get(p.query_id) is p:
            del _progress[p.query_id]


def query_progress(query_id: str) -> Optional[dict]:
    """One running query's progress snapshot, or None when it is not
    executing now (a finished query is in the query log)."""
    with _progress_lock:
        p = _progress.get(query_id)
    if p is None:
        return None
    return p.snapshot()


def active_query_stats() -> List:
    """The RuntimeStats of every executing query: the supervisor's hook for
    attributing a cluster event (a graceful worker drain) to the queries
    running while it happened."""
    with _progress_lock:
        return [p.stats for p in _progress.values()]


def queries_snapshot() -> List[dict]:
    """Every executing query's progress, oldest first: the
    ``health()["queries"]`` section."""
    with _progress_lock:
        items = sorted(_progress.values(), key=lambda p: p.started)
    return [p.snapshot() for p in items]
