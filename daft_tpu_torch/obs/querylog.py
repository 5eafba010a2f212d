"""Always-on QueryLog: a bounded ring of QueryRecords, one per completed
plan execution (the port's copy of daft_tpu/obs/querylog.py).

``execution.execute_plan`` appends a record on EVERY completion (success,
error, deadline, an abandoned stream), built only from data the stats
already hold (the RuntimeStats counters and op rollups, the memory
ledger's snapshot, the ExecutionConfig), so the steady-state cost is one
dict build and one ring append per query (guard-tested, as the DISARMED
profiler is).

- One record per *plan execution*: an AQE query finishes one execute_plan
  per stage and logs one record per stage (as ``daft_tpu_queries_total``
  counts them); counters are cumulative over the stages of one stats
  handle.
- Result-cache hits never reach execute_plan and are not recorded: the
  log records executions, not lookups.
- ``plan_fingerprint`` is a stable hash of the physical plan's display
  tree, the identity the slow-query capture arms the profiler under for
  the NEXT run of the same plan. ``plan_fingerprint_canonical`` is the
  literal-masked shape fingerprint of adapt/fingerprint.py that the
  planner stamps on the plan (the plan cache's and FDO's key).

The field names, outcomes and ``RECORD_SCHEMA_VERSION`` are the
reference's: its ``validate_record`` accepts the port's records. The
record's ``ledger`` carries ``dist_inflight``, the payload bytes of tasks
still out on distributed workers (dist/supervisor.py). A query that
streamed morsels carries the optional ``streaming`` rollup.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RECORD_SCHEMA_VERSION", "QueryLog", "QUERY_LOG", "build_record",
           "plan_signature", "config_delta", "validate_record",
           "OUTCOMES", "DEFAULT_DEPTH"]

RECORD_SCHEMA_VERSION = 1
DEFAULT_DEPTH = 256

OUTCOMES = ("ok", "error", "timeout", "cancelled", "abandoned", "shed")

# RuntimeStats counters surfaced as the record's resilience-event rollup
_EVENT_COUNTERS = (
    "device_breaker_trips", "device_breaker_reopens",
    "device_breaker_recoveries", "collective_breaker_trips",
    "collective_breaker_reopens", "collective_breaker_recoveries",
    "faults_injected", "degraded_completions", "deadline_expired",
    "prefetch_throttled", "preload_throttled", "spill_write_failures",
    "task_retries", "dispatch_backpressure_stalls",
    "task_redispatches", "worker_losses", "dist_local_fallbacks",
    "corruption_detected", "partitions_recomputed", "lineage_truncated",
    "spill_disk_full", "tasks_speculated", "speculation_wins",
    "telemetry_dropped", "telemetry_truncated",
    "peer_fetches", "peer_refetches", "workers_drained",
    "batches_formed", "batch_flushes_timer", "batch_rows_padded",
    "segment_fallbacks",
    "persist_hits", "persist_inserts", "persist_refreshes",
    "persist_partitions_refreshed", "persist_peer_fetches",
    "persist_load_failures", "persist_store_failures",
    "persist_artifact_loads", "persist_artifact_saves",
)


class QueryLog:
    """Thread-safe bounded ring of QueryRecord dicts (newest last)."""

    def __init__(self, depth: int = DEFAULT_DEPTH):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=max(1, depth))
        self.total = 0  # appended ever, including evicted

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._records.maxlen or 0

    def append(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            self.total += 1

    def records(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            recs = list(self._records)
        if limit is not None:
            return recs[-limit:]
        return recs

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._records[-1] if self._records else None

    def resize(self, depth: int) -> None:
        """Apply a changed ``cfg.query_log_depth`` (keeps the newest)."""
        with self._lock:
            if (self._records.maxlen or 0) == max(1, depth):
                return
            old = list(self._records)
            self._records = deque(old[-depth:] if depth > 0 else [],
                                  maxlen=max(1, depth))

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


QUERY_LOG = QueryLog()


def plan_signature(root) -> Tuple[str, Dict[str, int]]:
    """(fingerprint, op-name counts) for a physical plan — computed once
    per plan object (cached on the root) so repeated executions of a
    collected plan pay one dict lookup."""
    sig = getattr(root, "_obs_signature", None)
    if sig is not None:
        return sig
    ops: Dict[str, int] = {}

    def walk(op):
        name = op.name()
        ops[name] = ops.get(name, 0) + 1
        for c in op.children:
            walk(c)

    walk(root)
    fp = hashlib.sha256(root.display_tree().encode()).hexdigest()[:16]
    root._obs_signature = (fp, ops)
    return fp, ops


def config_delta(cfg) -> Dict[str, Any]:
    """The ExecutionConfig fields that differ from their defaults — the
    record carries what was TUNED, not the whole config."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        if f.default is dataclasses.MISSING:
            continue
        v = getattr(cfg, f.name)
        if v != f.default:
            out[f.name] = v
    return out


def build_record(query_id: str, fingerprint: str, plan_ops: Dict[str, int],
                 cfg, stats, wall_ns: int, outcome: str,
                 error: Optional[BaseException] = None,
                 profiled: bool = False,
                 rows_emitted: int = 0,
                 canonical: str = "") -> dict:
    """One QueryRecord from already-collected state.

    ``canonical`` is the literal-masked shape fingerprint
    (adapt/fingerprint.py): ``WHERE x > 5`` and ``WHERE x > 9`` share it
    while ``plan_fingerprint`` keeps them apart; the plan cache and the FDO
    history key on the former, the slow-query capture on the latter. Empty
    when the execution bypassed the planner (a direct execute_plan)."""
    snap = stats.snapshot()
    counters = snap["counters"]
    try:
        from ..spill import MEMORY_LEDGER

        led = MEMORY_LEDGER.snapshot()
        ledger = {k: led[k] for k in (
            "current", "high_water", "spilled_bytes", "spilled_partitions",
            "prefetch_inflight", "async_spill_inflight", "stream_inflight",
            "exec_inflight", "dist_inflight", "negative_releases",
            "disk_full_events")}
    except Exception:
        ledger = {}
    events = {k: counters[k] for k in _EVENT_COUNTERS if counters.get(k)}
    rec = {
        "schema_version": RECORD_SCHEMA_VERSION,
        "query_id": query_id,
        "unix_time": round(time.time(), 3),
        "wall_s": round(wall_ns / 1e9, 6),
        "outcome": outcome,
        "plan_fingerprint": fingerprint,
        "plan_fingerprint_canonical": canonical,
        "plan_ops": dict(plan_ops),
        "config_delta": config_delta(cfg),
        # planning time made visible (the very cost the plan cache
        # removes): optimize+translate+fuse wall on a cold plan, cache
        # lookup+rehydrate wall on a warm one; compile_ms is the
        # fuse-compile share
        "planning_ms": round(counters.get("planning_wall_ns", 0) / 1e6, 3),
        "compile_ms": round(counters.get("compile_wall_ns", 0) / 1e6, 3),
        "rows_emitted": int(rows_emitted),
        "op_rows": dict(snap["op_rows"]),
        "op_wall_ms": {k: round(v / 1e6, 3)
                       for k, v in snap["op_wall_ns"].items()},
        "counters": dict(counters),
        "exchange_rows": counters.get("exchange_rows", 0),
        "exchange_bytes": counters.get("exchange_bytes", 0),
        "io_wait_ms": round(counters.get("io_wait_ns", 0) / 1e6, 3),
        "events": events,
        "ledger": ledger,
        "profiled": bool(profiled),
    }
    if counters.get("stream_morsels"):
        # the streaming rollup; optional: absent when no morsel streamed
        rec["streaming"] = {
            "morsels": counters.get("stream_morsels", 0),
            "channel_high_water": counters.get("stream_channel_high_water", 0),
            "backpressure_stalls": counters.get("stream_backpressure_stalls", 0),
            "backpressure_ms": round(counters.get("stream_backpressure_ns", 0) / 1e6, 3),
            "short_circuited": counters.get("morsels_short_circuited", 0),
            "ttfr_ms": round(counters.get("time_to_first_row_ns", 0) / 1e6, 3),
        }
    if counters.get("batches_formed"):
        # the dynamic-batching rollup; optional: absent when no batch
        # formed, so schema_version 1 records stay valid
        rec["batching"] = {
            "batches": counters.get("batches_formed", 0),
            "rows": counters.get("batch_rows", 0),
            "capacity_rows": counters.get("batch_capacity_rows", 0),
            "rows_padded": counters.get("batch_rows_padded", 0),
            "flushes_budget": counters.get("batch_flushes_budget", 0),
            "flushes_timer": counters.get("batch_flushes_timer", 0),
            "flushes_end": counters.get("batch_flushes_end", 0),
            "coalesce_faults": counters.get("batch_coalesce_faults", 0),
        }
    if counters.get("device_resident_segments"):
        # the device-residency rollup; optional: absent when no segment
        # ran resident
        rec["residency"] = {
            "resident_segments": counters.get("device_resident_segments", 0),
            "handoffs_elided": counters.get("device_handoffs_elided", 0),
            "hbm_high_water_bytes": counters.get(
                "hbm_resident_bytes_high_water", 0),
            "segment_compiles": counters.get("segment_compiles", 0),
            "segment_fallbacks": counters.get("segment_fallbacks", 0),
        }
    if error is not None:
        rec["error_type"] = type(error).__name__
        rec["error_message"] = str(error)[:400]
    return rec


# required top-level keys -> type checks for validate_record
_TOP_KEYS = {
    "schema_version": int,
    "query_id": str,
    "unix_time": (int, float),
    "wall_s": (int, float),
    "outcome": str,
    "plan_fingerprint": str,
    "plan_fingerprint_canonical": str,
    "planning_ms": (int, float),
    "compile_ms": (int, float),
    "plan_ops": dict,
    "config_delta": dict,
    "op_rows": dict,
    "op_wall_ms": dict,
    "counters": dict,
    "events": dict,
    "ledger": dict,
    "profiled": bool,
}


def validate_record(d: dict) -> List[str]:
    """Schema check for a QueryRecord dict (as stored or JSON-loaded).
    Returns violation strings; empty means valid."""
    errs: List[str] = []
    if not isinstance(d, dict):
        return ["record is not an object"]
    for key, typ in _TOP_KEYS.items():
        if key not in d:
            errs.append(f"missing key {key!r}")
        elif not isinstance(d[key], typ):
            errs.append(f"{key!r} has type {type(d[key]).__name__}")
    if errs:
        return errs
    if d["schema_version"] != RECORD_SCHEMA_VERSION:
        errs.append(f"schema_version {d['schema_version']} != "
                    f"{RECORD_SCHEMA_VERSION}")
    if d["outcome"] not in OUTCOMES:
        errs.append(f"outcome {d['outcome']!r} not in {OUTCOMES}")
    if d["outcome"] in ("error", "timeout") and "error_type" not in d:
        errs.append(f"outcome {d['outcome']!r} carries no error_type")
    for k, v in d["plan_ops"].items():
        if not isinstance(k, str) or not isinstance(v, int):
            errs.append(f"plan_ops[{k!r}] mistyped")
    return errs
