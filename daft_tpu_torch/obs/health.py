"""Engine health snapshot: breakers, ledger, pools, plan cache, batching,
device residency, the distributed runner's cluster, running queries and the
query log (the port's copy of daft_tpu/obs/health.py).

``daft_tpu_torch.health()`` returns one JSON-able dict that answers "is
the engine healthy now?" without running a query: the circuit breaker of
each kind (the runner registers each query's breaker here), the memory
ledger's balances, the actor-pool and leaked-thread counts, the plan
cache, the batching and device-residency counts, the running queries'
progress, the query log's depth and last outcome and the structured-log
ring. The same snapshot is mirrored as gauges in the process metrics
registry (``refresh_health_gauges``), so ``daft_tpu_torch.metrics_text()``
exports it. The keys, types and gauge names are the reference's: its
``validate_health`` accepts the port's snapshot.

The ``cluster`` section is the live WorkerPool's snapshot (dist/supervisor.py,
registered weakly by the pool as it starts), its workers, tasks, restarts,
peer-shuffle plane and elastic controller; without a pool (or once it shut
down) it is the idle shape the reference reports. The sections of
subsystems the port does not have yet report what the reference reports
while those subsystems are idle, as fixed values: ``admission`` until
``serve/`` and ``persist`` until ``persist/`` (both ROADMAP Queue 1,
item 10).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional

__all__ = ["HEALTH_SCHEMA_VERSION", "engine_health", "register_breaker",
           "register_cluster", "breaker_states", "admission_state",
           "cluster_state", "refresh_health_gauges", "validate_health"]

HEALTH_SCHEMA_VERSION = 1

_lock = threading.Lock()
# breaker kind -> weakref to the most recently registered DeviceHealth of
# that kind (per-query objects; a dead ref reads as "idle")
_breakers: Dict[str, "weakref.ref"] = {}

# the serving runtime's admission controller, idle until serve/ (item 10)
_ADMISSION_IDLE = {"slots": 0, "queue_depth": 0, "active_queries": 0,
                   "queued_queries": 0, "admitted_total": 0,
                   "shed_total": 0, "draining": False}

# the distributed runner's pool, its peer-shuffle plane and its elastic
# controller while no pool is up
_PEER_IDLE = {"pieces_hosted": 0, "piece_bytes_hosted": 0,
              "pieces_stored_total": 0, "pieces_served_total": 0,
              "peer_bytes_served_total": 0, "pieces_fetched_total": 0,
              "pieces_refetched_total": 0, "peer_bytes_fetched_total": 0,
              "shuffles_dropped_total": 0, "shuffles_active": 0}

_ELASTIC_IDLE = {"enabled": 0, "workers_target": 0, "workers_min": 0,
                 "workers_max": 0, "draining": 0, "workers_drained_total": 0,
                 "scale_ups_total": 0, "scale_downs_total": 0,
                 "last_scale_decision": "idle"}

_CLUSTER_IDLE = {"workers": 0, "workers_alive": 0, "workers_restarting": 0,
                 "workers_tripped": 0, "tasks_inflight": 0,
                 "tasks_dispatched_total": 0, "tasks_completed_total": 0,
                 "task_redispatches_total": 0, "worker_losses_total": 0,
                 "tasks_speculated_total": 0, "speculation_wins_total": 0,
                 "speculation_inflight": 0, "telemetry_dropped_total": 0,
                 "local_fallbacks_total": 0, "restarts_used": 0,
                 "restart_budget": 0, "restart_budget_remaining": 0,
                 "driver_payload_bytes_total": 0, "workers_drained_total": 0,
                 "peer_plane": dict(_PEER_IDLE),
                 "elastic": dict(_ELASTIC_IDLE),
                 "degraded": False, "worker_detail": {}}

# the latest WorkerPool (weakly held: a dead or shut pool reads as idle)
_cluster: Optional["weakref.ref"] = None


def _cluster_idle() -> dict:
    return {**_CLUSTER_IDLE, "peer_plane": dict(_PEER_IDLE),
            "elastic": dict(_ELASTIC_IDLE), "worker_detail": {}}


def register_cluster(pool) -> None:
    """Track the latest distributed WorkerPool (weakly), so that health()
    answers its worker, task and restart state without a reference."""
    global _cluster
    with _lock:
        _cluster = weakref.ref(pool)


def cluster_state() -> dict:
    """The live pool's snapshot, or the idle shape."""
    with _lock:
        ref = _cluster
    pool = ref() if ref is not None else None
    if pool is None or getattr(pool, "_closed", False):
        return _cluster_idle()
    try:
        return pool.snapshot()
    except Exception:
        return _cluster_idle()  # the pool mid-teardown


def admission_state() -> dict:
    """The serving runtime's admission controller: idle until serve/ (the
    elastic pool controller reads its queue depth as demand)."""
    return dict(_ADMISSION_IDLE)


# breaker state -> gauge value (0 healthy .. 2 open)
_BREAKER_GAUGE = {"closed": 0.0, "half_open": 1.0, "open": 2.0, "idle": 0.0}


def register_breaker(breaker) -> None:
    """Track the latest breaker per kind (called by the runner once per
    query; weakly held so health never pins a finished query's state)."""
    with _lock:
        _breakers[breaker.kind] = weakref.ref(breaker)


def breaker_states() -> Dict[str, str]:
    with _lock:
        items = list(_breakers.items())
    out: Dict[str, str] = {}
    for kind, ref in items:
        b = ref()
        out[kind] = b.state if b is not None else "idle"
    return out



def _scheduler_snapshot() -> dict:
    """The scheduler's window: dispatched, unfinished partition tasks."""
    from ..scheduler import inflight_tasks

    return {"inflight_tasks": inflight_tasks()}


def _streaming_snapshot() -> dict:
    """The stream channels' occupancy (process-wide)."""
    from ..stream.channel import channels_snapshot

    return channels_snapshot()



_PLAN_CACHE_IDLE = {"entries": 0, "bindings": 0, "bytes": 0, "hits": 0,
                    "misses": 0, "evictions": 0, "demotions": 0,
                    "errors": 0, "result_entries": 0, "result_bytes": 0,
                    "result_hits": 0, "result_misses": 0,
                    "result_evictions": 0, "history_sites": 0,
                    "history_queries": 0, "history_mispredicts": 0}


def _plan_cache_snapshot() -> dict:
    """The plan cache's, the sub-plan result cache's and the FDO history's
    view, shared by the health snapshot and the gauge mirror."""
    from ..adapt.history import HISTORY
    from ..adapt.plancache import PLAN_CACHE
    from ..adapt.resultcache import RESULT_CACHE

    pc = PLAN_CACHE.snapshot()
    rc = RESULT_CACHE.snapshot()
    h = HISTORY.snapshot()
    return {
        "entries": pc["entries"], "bindings": pc["bindings"],
        "bytes": pc["bytes"], "hits": pc["hits"],
        "misses": pc["misses"], "evictions": pc["evictions"],
        "demotions": pc["demotions"], "errors": pc["errors"],
        "result_entries": rc["entries"], "result_bytes": rc["bytes"],
        "result_hits": rc["hits"], "result_misses": rc["misses"],
        "result_evictions": rc["evictions"],
        "history_sites": h["sites"], "history_queries": h["queries"],
        "history_mispredicts": h["mispredicts"],
    }


_BATCHING_IDLE = {
    "active_actor_pools": 0, "pinned_models": 0, "resident_weight_bytes": 0,
    "batch_inflight_bytes": 0, "batches_formed": 0, "flushes_budget": 0,
    "flushes_timer": 0, "flushes_end": 0, "coalesce_faults": 0,
}


def _batching_snapshot() -> dict:
    """The dynamic-batching view (batch/), shared by the health snapshot
    and the gauge mirror."""
    from ..actor_pool import pool_count
    from ..batch.actors import pinned_model_count, resident_weight_bytes
    from ..batch.executor import process_counters
    from ..spill import MEMORY_LEDGER

    c = process_counters()
    return {
        "active_actor_pools": pool_count(),
        "pinned_models": pinned_model_count(),
        "resident_weight_bytes": resident_weight_bytes(),
        "batch_inflight_bytes": int(MEMORY_LEDGER.snapshot()["batch_inflight"]),
        "batches_formed": c["batches_formed"],
        "flushes_budget": c["flushes_budget"],
        "flushes_timer": c["flushes_timer"],
        "flushes_end": c["flushes_end"],
        "coalesce_faults": c["coalesce_faults"],
    }


_DEVICE_IDLE = {
    "resident_segments": 0, "handoffs_elided": 0, "segment_fallbacks": 0,
    "segment_compiles": 0, "hbm_resident_bytes_high_water": 0,
}


# the persistent cache store, idle until persist/ (item 10)
_PERSIST_IDLE = {
    "artifact_entries": 0, "artifact_bytes": 0, "artifact_loads": 0,
    "artifact_saves": 0, "load_failures": 0, "store_failures": 0,
    "evictions": 0, "disk_entries": 0, "disk_bytes": 0, "hits": 0,
    "misses": 0, "inserts": 0, "refreshes": 0, "partitions_refreshed": 0,
    "peer_serves": 0, "peer_fetches": 0,
}


def _device_snapshot() -> dict:
    """The device-residency view (fuse/segment.py), shared by the health
    snapshot and the gauge mirror."""
    from ..fuse.segment import process_counters

    c = process_counters()
    return {k: int(c[k]) for k in _DEVICE_IDLE}


def engine_health() -> dict:
    """One snapshot of engine-wide state (see the module docstring). The
    gauge mirror is kept by ``refresh_health_gauges`` (at every query end
    and every ``metrics_text()`` scrape)."""
    from ..actor_pool import leaked_thread_count, pool_count
    from ..spill import MEMORY_LEDGER
    from . import log as obs_log
    from .cluster import queries_snapshot
    from .querylog import QUERY_LOG

    last = QUERY_LOG.last()
    from ..profile.metrics import METRICS

    snap = METRICS.snapshot()
    data = {
        "schema_version": HEALTH_SCHEMA_VERSION,
        "unix_time": round(time.time(), 3),
        "breakers": breaker_states(),
        "ledger": MEMORY_LEDGER.snapshot(),
        "scheduler": _scheduler_snapshot(),
        "pools": {"actor_pools": pool_count(),
                  "leaked_threads": leaked_thread_count()},
        "admission": dict(_ADMISSION_IDLE),
        "cluster": cluster_state(),
        "streaming": _streaming_snapshot(),
        "batching": _batching_snapshot(),
        "device": _device_snapshot(),
        "queries": queries_snapshot(),
        "plan_cache": _plan_cache_snapshot(),
        "persist": dict(_PERSIST_IDLE),
        "query_log": {
            "depth": len(QUERY_LOG),
            "capacity": QUERY_LOG.capacity,
            "total": QUERY_LOG.total,
            "last_outcome": last["outcome"] if last else None,
        },
        "log": {
            "records": obs_log.ring_size(),
            "dropped": obs_log.dropped_records(),
        },
        "queries_total": int(snap.get("daft_tpu_queries_total", 0)),
    }
    return data


def refresh_health_gauges(registry=None) -> None:
    """Mirror the health snapshot as gauges in the metrics registry, the
    memory ledger's balances among them: the memory-pressure view that
    ``metrics_text()`` exposes without any profiled run."""
    from ..actor_pool import leaked_thread_count, pool_count
    from ..profile.metrics import METRICS
    from ..spill import MEMORY_LEDGER
    from .cluster import queries_snapshot

    reg = registry if registry is not None else METRICS
    led = MEMORY_LEDGER.snapshot()
    reg.gauge("daft_tpu_memory_ledger_bytes",
              "engine-held partition bytes").set(led["current"])
    reg.gauge("daft_tpu_memory_ledger_high_water_bytes",
              "peak engine-held partition bytes").set(led["high_water"])
    reg.gauge("daft_tpu_memory_ledger_prefetch_inflight_bytes",
              "scan-prefetch bytes in flight").set(
        led["prefetch_inflight"])
    reg.gauge("daft_tpu_memory_ledger_async_spill_inflight_bytes",
              "async-spill bytes awaiting writeback").set(
        led["async_spill_inflight"])
    reg.gauge("daft_tpu_memory_ledger_negative_releases",
              "double-release clamps (engine bugs)").set(
        led["negative_releases"])
    reg.gauge("daft_tpu_memory_ledger_stream_inflight_bytes",
              "streaming-channel morsel bytes in flight").set(
        led["stream_inflight"])
    reg.gauge("daft_tpu_memory_ledger_exec_inflight_bytes",
              "materialized task outputs parked in the dispatch "
              "window").set(led["exec_inflight"])
    reg.gauge("daft_tpu_spill_disk_full_events",
              "ENOSPC spill writes degraded to hold-in-memory").set(
        led["disk_full_events"])
    for kind, st in breaker_states().items():
        reg.gauge(f"daft_tpu_{kind}_breaker_state",
                  "circuit breaker: 0 closed, 1 half-open, 2 open").set(
            _BREAKER_GAUGE.get(st, 0.0))
    reg.gauge("daft_tpu_scheduler_inflight_tasks",
              "partition tasks dispatched, not yet finished").set(
        _scheduler_snapshot()["inflight_tasks"])
    pools, leaked = pool_count(), leaked_thread_count()
    reg.gauge("daft_tpu_actor_pools", "live actor pools").set(pools)
    reg.gauge("daft_tpu_leaked_threads",
              "actor workers that outlived shutdown").set(leaked)
    strm = _streaming_snapshot()
    reg.gauge("daft_tpu_stream_channels",
              "live streaming channels (undrained)").set(
        strm["active_channels"])
    reg.gauge("daft_tpu_stream_queued_morsels",
              "morsels queued in streaming channels").set(
        strm["queued_morsels"])
    reg.gauge("daft_tpu_stream_queued_bytes",
              "bytes queued in streaming channels").set(
        strm["queued_bytes"])
    bat = _batching_snapshot()
    reg.gauge("daft_tpu_batch_actor_pools",
              "live actor pools (batching view)").set(
        bat["active_actor_pools"])
    reg.gauge("daft_tpu_batch_pinned_models",
              "model actor pools pinned across queries").set(
        bat["pinned_models"])
    reg.gauge("daft_tpu_batch_resident_weight_bytes",
              "declared weight bytes resident in pinned models").set(
        bat["resident_weight_bytes"])
    reg.gauge("daft_tpu_batch_inflight_bytes",
              "coalesce-buffer bytes awaiting a batch flush").set(
        bat["batch_inflight_bytes"])
    reg.gauge("daft_tpu_batch_batches_formed_total",
              "dynamic batches formed by the coalescer").set(
        bat["batches_formed"])
    reg.gauge("daft_tpu_batch_flushes_budget_total",
              "batches flushed on the row/byte budget").set(
        bat["flushes_budget"])
    reg.gauge("daft_tpu_batch_flushes_timer_total",
              "batches flushed by the max-latency timer").set(
        bat["flushes_timer"])
    reg.gauge("daft_tpu_batch_flushes_end_total",
              "batches flushed at source end").set(bat["flushes_end"])
    reg.gauge("daft_tpu_batch_coalesce_faults_total",
              "coalesce failures degraded to the per-partition path").set(
        bat["coalesce_faults"])
    dev = _device_snapshot()
    reg.gauge("daft_tpu_device_resident_segments_total",
              "plan segments executed HBM-resident end to end").set(
        dev["resident_segments"])
    reg.gauge("daft_tpu_device_handoffs_elided_total",
              "operator-boundary Arrow round-trips elided by residency"
              ).set(dev["handoffs_elided"])
    reg.gauge("daft_tpu_device_segment_fallbacks_total",
              "resident attempts degraded to the staged per-op path").set(
        dev["segment_fallbacks"])
    reg.gauge("daft_tpu_device_segment_compiles_total",
              "plan-segment compiles (warm plan-cache runs add zero)").set(
        dev["segment_compiles"])
    reg.gauge("daft_tpu_device_hbm_resident_high_water_bytes",
              "largest resident intermediate env of any segment").set(
        dev["hbm_resident_bytes_high_water"])
    clu = cluster_state()
    reg.gauge("daft_tpu_cluster_workers_alive",
              "distributed workers currently serving tasks").set(
        clu["workers_alive"])
    reg.gauge("daft_tpu_cluster_workers_restarting",
              "distributed worker slots awaiting respawn").set(
        clu["workers_restarting"])
    reg.gauge("daft_tpu_cluster_workers_tripped",
              "worker slots with an open WorkerHealth breaker").set(
        clu["workers_tripped"])
    reg.gauge("daft_tpu_cluster_tasks_inflight",
              "tasks currently executing on distributed workers").set(
        clu["tasks_inflight"])
    reg.gauge("daft_tpu_cluster_task_redispatches_total",
              "tasks re-dispatched after a worker loss").set(
        clu["task_redispatches_total"])
    reg.gauge("daft_tpu_cluster_worker_losses_total",
              "worker deaths observed by the supervisor").set(
        clu["worker_losses_total"])
    reg.gauge("daft_tpu_cluster_restart_budget_remaining",
              "worker respawns the pool may still spend").set(
        clu["restart_budget_remaining"])
    reg.gauge("daft_tpu_cluster_tasks_speculated_total",
              "straggler tasks that got a speculative duplicate").set(
        clu.get("tasks_speculated_total", 0))
    reg.gauge("daft_tpu_cluster_speculation_wins_total",
              "speculative duplicates that beat the original").set(
        clu.get("speculation_wins_total", 0))
    reg.gauge("daft_tpu_cluster_telemetry_dropped_total",
              "worker telemetry fragments lost in flight (pong-gap + "
              "worker-death detections; fail-open by contract)").set(
        clu.get("telemetry_dropped_total", 0))
    peer = clu.get("peer_plane") or _PEER_IDLE
    reg.gauge("daft_tpu_cluster_peer_pieces_hosted",
              "shuffle pieces currently hosted on worker piece-servers"
              ).set(peer.get("pieces_hosted", 0))
    reg.gauge("daft_tpu_cluster_peer_piece_bytes_hosted",
              "bytes currently hosted on worker piece-servers").set(
        peer.get("piece_bytes_hosted", 0))
    reg.gauge("daft_tpu_cluster_peer_pieces_served_total",
              "piece fetches served to peers").set(
        peer.get("pieces_served_total", 0))
    reg.gauge("daft_tpu_cluster_peer_pieces_fetched_total",
              "pieces pulled from peer workers").set(
        peer.get("pieces_fetched_total", 0))
    reg.gauge("daft_tpu_cluster_peer_pieces_refetched_total",
              "pieces recomputed from lineage after a failed peer fetch"
              ).set(peer.get("pieces_refetched_total", 0))
    reg.gauge("daft_tpu_cluster_peer_bytes_served_total",
              "payload bytes served peer-to-peer").set(
        peer.get("peer_bytes_served_total", 0))
    reg.gauge("daft_tpu_cluster_peer_bytes_fetched_total",
              "payload bytes pulled from peer workers").set(
        peer.get("peer_bytes_fetched_total", 0))
    ela = clu.get("elastic") or _ELASTIC_IDLE
    reg.gauge("daft_tpu_cluster_elastic_workers_target",
              "elastic controller's current worker target").set(
        ela.get("workers_target", 0))
    reg.gauge("daft_tpu_cluster_elastic_workers_min",
              "elastic pool floor (distributed_workers_min)").set(
        ela.get("workers_min", 0))
    reg.gauge("daft_tpu_cluster_elastic_workers_max",
              "elastic pool ceiling (distributed_workers_max)").set(
        ela.get("workers_max", 0))
    reg.gauge("daft_tpu_cluster_elastic_draining",
              "workers currently draining (graceful quiesce)").set(
        ela.get("draining", 0))
    reg.gauge("daft_tpu_cluster_elastic_workers_drained_total",
              "workers retired by graceful drain (scale-down/SIGTERM)"
              ).set(ela.get("workers_drained_total", 0))
    reg.gauge("daft_tpu_cluster_elastic_scale_ups_total",
              "elastic scale-up decisions taken").set(
        ela.get("scale_ups_total", 0))
    reg.gauge("daft_tpu_cluster_elastic_scale_downs_total",
              "elastic scale-down decisions taken").set(
        ela.get("scale_downs_total", 0))
    qsnaps = queries_snapshot()
    reg.gauge("daft_tpu_query_progress_active",
              "queries currently executing").set(len(qsnaps))
    reg.gauge("daft_tpu_query_progress_tasks_inflight",
              "partition tasks in flight across running queries").set(
        sum(q.get("tasks_inflight", 0) for q in qsnaps))
    reg.gauge("daft_tpu_query_progress_rows_flowed",
              "rows flowed through operators of running queries").set(
        sum(q.get("rows_flowed", 0) for q in qsnaps))
    pc = _plan_cache_snapshot()
    reg.gauge("daft_tpu_plan_cache_entries",
              "plan/program cache entries (canonical shapes)").set(
        pc["entries"])
    reg.gauge("daft_tpu_plan_cache_bytes",
              "estimated bytes held by the plan/program cache").set(
        pc["bytes"])
    reg.gauge("daft_tpu_plan_cache_hits_total",
              "plan-cache hits (warm plans served)").set(pc["hits"])
    reg.gauge("daft_tpu_plan_cache_misses_total",
              "plan-cache misses (cold plans built)").set(pc["misses"])
    reg.gauge("daft_tpu_plan_cache_evictions_total",
              "plan-cache entries shed by the LRU byte cap").set(
        pc["evictions"])
    reg.gauge("daft_tpu_plan_cache_demotions_total",
              "plan-cache entries demoted (FDO mispredict/"
              "revalidation)").set(pc["demotions"])
    reg.gauge("daft_tpu_subplan_cache_entries",
              "sub-plan result-cache entries (memoized prefixes)").set(
        pc["result_entries"])
    reg.gauge("daft_tpu_subplan_cache_bytes",
              "bytes held by the sub-plan result cache").set(
        pc["result_bytes"])
    reg.gauge("daft_tpu_subplan_cache_hits_total",
              "sub-plan result-cache hits (prefixes replayed)").set(
        pc["result_hits"])
    per = _PERSIST_IDLE
    reg.gauge("daft_tpu_persist_artifact_entries",
              "plan/FDO artifact files on disk").set(
        per["artifact_entries"])
    reg.gauge("daft_tpu_persist_artifact_bytes",
              "bytes held by plan/FDO artifact files").set(
        per["artifact_bytes"])
    reg.gauge("daft_tpu_persist_artifact_loads_total",
              "artifact files loaded into the warm-start caches").set(
        per["artifact_loads"])
    reg.gauge("daft_tpu_persist_artifact_saves_total",
              "artifact files written at query end/shutdown").set(
        per["artifact_saves"])
    reg.gauge("daft_tpu_persist_load_failures_total",
              "persist loads degraded to a cold miss (corrupt/version "
              "skew/fault; never a query failure)").set(
        per["load_failures"])
    reg.gauge("daft_tpu_persist_store_failures_total",
              "persist stores dropped (query result unaffected)").set(
        per["store_failures"])
    reg.gauge("daft_tpu_persist_evictions_total",
              "persisted entries pruned (keep-last-K / byte cap)").set(
        per["evictions"])
    reg.gauge("daft_tpu_persist_result_entries",
              "result-tier entries on disk").set(per["disk_entries"])
    reg.gauge("daft_tpu_persist_result_bytes",
              "bytes held by the durable result tier").set(
        per["disk_bytes"])
    reg.gauge("daft_tpu_persist_hits_total",
              "durable result-tier hits (prefixes replayed from disk)"
              ).set(per["hits"])
    reg.gauge("daft_tpu_persist_misses_total",
              "durable result-tier misses").set(per["misses"])
    reg.gauge("daft_tpu_persist_inserts_total",
              "entries written to the durable result tier").set(
        per["inserts"])
    reg.gauge("daft_tpu_persist_refreshes_total",
              "incremental refreshes (entries partially recomputed)"
              ).set(per["refreshes"])
    reg.gauge("daft_tpu_persist_partitions_refreshed_total",
              "partitions recomputed by incremental refresh").set(
        per["partitions_refreshed"])
    reg.gauge("daft_tpu_persist_peer_serves_total",
              "result-tier entries served to peer workers").set(
        per["peer_serves"])
    reg.gauge("daft_tpu_persist_peer_fetches_total",
              "result-tier entries pulled from peer workers").set(
        per["peer_fetches"])
    adm = _ADMISSION_IDLE
    reg.gauge("daft_tpu_admission_active_queries",
              "queries holding an execution slot").set(
        adm["active_queries"])
    reg.gauge("daft_tpu_admission_queue_depth",
              "queries waiting for an execution slot").set(
        adm["queued_queries"])
    reg.gauge("daft_tpu_admission_slots",
              "max concurrently executing queries").set(adm["slots"])
    reg.gauge("daft_tpu_queries_shed_total",
              "queries shed by admission control (overflow/timeout/"
              "drain)").set(adm["shed_total"])
    from .querylog import QUERY_LOG

    reg.gauge("daft_tpu_query_log_depth",
              "QueryRecords currently held").set(len(QUERY_LOG))


_TOP_KEYS = {
    "schema_version": int,
    "unix_time": (int, float),
    "breakers": dict,
    "ledger": dict,
    "scheduler": dict,
    "pools": dict,
    "admission": dict,
    "cluster": dict,
    "streaming": dict,
    "batching": dict,
    "device": dict,
    "queries": list,
    "plan_cache": dict,
    "persist": dict,
    "query_log": dict,
    "log": dict,
    "queries_total": int,
}

_BREAKER_STATES = ("closed", "half_open", "open", "idle")


def validate_health(d: dict) -> List[str]:
    """Schema check for a health snapshot — empty list means valid."""
    errs: List[str] = []
    if not isinstance(d, dict):
        return ["health is not an object"]
    for key, typ in _TOP_KEYS.items():
        if key not in d:
            errs.append(f"missing key {key!r}")
        elif not isinstance(d[key], typ):
            errs.append(f"{key!r} has type {type(d[key]).__name__}")
    if errs:
        return errs
    if d["schema_version"] != HEALTH_SCHEMA_VERSION:
        errs.append(f"schema_version {d['schema_version']} != "
                    f"{HEALTH_SCHEMA_VERSION}")
    for kind, st in d["breakers"].items():
        if st not in _BREAKER_STATES:
            errs.append(f"breakers[{kind!r}] has unknown state {st!r}")
    for k in ("depth", "capacity", "total"):
        if not isinstance(d["query_log"].get(k), int):
            errs.append(f"query_log.{k} missing or non-int")
    if not isinstance(d["scheduler"].get("inflight_tasks"), int):
        errs.append("scheduler.inflight_tasks missing or non-int")
    for k in ("actor_pools", "leaked_threads"):
        if not isinstance(d["pools"].get(k), int):
            errs.append(f"pools.{k} missing or non-int")
    for k in ("slots", "active_queries", "queued_queries", "shed_total"):
        if not isinstance(d["admission"].get(k), int):
            errs.append(f"admission.{k} missing or non-int")
    for k in ("active_channels", "queued_morsels", "queued_bytes"):
        if not isinstance(d["streaming"].get(k), int):
            errs.append(f"streaming.{k} missing or non-int")
    for k in _BATCHING_IDLE:
        if not isinstance(d["batching"].get(k), int):
            errs.append(f"batching.{k} missing or non-int")
    for k in _DEVICE_IDLE:
        if not isinstance(d["device"].get(k), int):
            errs.append(f"device.{k} missing or non-int")
    for k in _PLAN_CACHE_IDLE:
        if not isinstance(d["plan_cache"].get(k), int):
            errs.append(f"plan_cache.{k} missing or non-int")
    for k in _PERSIST_IDLE:
        if not isinstance(d["persist"].get(k), int):
            errs.append(f"persist.{k} missing or non-int")
    for k in ("workers", "workers_alive", "workers_restarting",
              "workers_tripped", "tasks_inflight",
              "task_redispatches_total", "worker_losses_total",
              "tasks_speculated_total", "speculation_wins_total",
              "telemetry_dropped_total",
              "restarts_used", "restart_budget",
              "restart_budget_remaining", "driver_payload_bytes_total",
              "workers_drained_total"):
        if not isinstance(d["cluster"].get(k), int):
            errs.append(f"cluster.{k} missing or non-int")
    if not isinstance(d["cluster"].get("degraded"), bool):
        errs.append("cluster.degraded missing or non-bool")
    peer = d["cluster"].get("peer_plane")
    if not isinstance(peer, dict):
        errs.append("cluster.peer_plane missing or non-object")
    else:
        for k in _PEER_IDLE:
            if not isinstance(peer.get(k), int):
                errs.append(f"cluster.peer_plane.{k} missing or non-int")
    ela = d["cluster"].get("elastic")
    if not isinstance(ela, dict):
        errs.append("cluster.elastic missing or non-object")
    else:
        for k in _ELASTIC_IDLE:
            want = str if k == "last_scale_decision" else int
            if not isinstance(ela.get(k), want):
                errs.append(f"cluster.elastic.{k} missing or "
                            f"non-{want.__name__}")
    for i, q in enumerate(d["queries"]):
        if not isinstance(q, dict):
            errs.append(f"queries[{i}] is not an object")
            continue
        if not isinstance(q.get("query_id"), str):
            errs.append(f"queries[{i}].query_id missing or non-str")
        for k in ("ops_total", "ops_completed", "rows_flowed",
                  "bytes_flowed", "rows_emitted", "tasks_inflight"):
            if not isinstance(q.get(k), int):
                errs.append(f"queries[{i}].{k} missing or non-int")
    return errs
