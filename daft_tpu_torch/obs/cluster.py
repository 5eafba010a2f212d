"""Live query progress (the port's copy of the live-progress half of
daft_tpu/obs/cluster.py).

:class:`QueryProgress` tracks one running query: registered by
``execution.execute_plan`` for the execution's lifetime, it holds the
operators completed against the plan's total, the rows and bytes that
flowed and the rows emitted, and answers ``daft_tpu_torch.health()
["queries"]``, ``daft_tpu_torch.query_progress()`` and the
``daft_tpu_query_progress_*`` gauges: "is it stuck or slow?" becomes a
snapshot instead of a guess.

The snapshot's keys are the reference's. ``tasks_inflight`` counts the
query's dispatched, unfinished partition tasks (scheduler.dispatch calls
``task_started``/``task_finished``) and ``channels`` the morsels and bytes
queued in the stream channels (stream/channel.py, process-wide). Its
distributed part reports what the reference reports with that subsystem
idle: ``workers`` is empty and ``dist_tasks``/``tasks_speculated`` are 0
until the distributed runner (ROADMAP Queue 1, item 10, ``dist/``).

Waiting for ``dist/`` (item 10): the other half of the reference module,
the worker telemetry fragments (``TelemetryCollector``, ``build_fragment``,
``validate_fragment``, ``merge_fragment``), the fault site
``telemetry.fragment`` and ``active_query_stats``. Their only callers are
the distributed runner and its supervisor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["QueryProgress", "register_progress", "unregister_progress",
           "query_progress", "queries_snapshot"]


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
            "workers": {},
            "channels": _channel_depths(),
        }


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


def queries_snapshot() -> List[dict]:
    """Every executing query's progress, oldest first: the
    ``health()["queries"]`` section."""
    with _progress_lock:
        items = sorted(_progress.values(), key=lambda p: p.started)
    return [p.snapshot() for p in items]
