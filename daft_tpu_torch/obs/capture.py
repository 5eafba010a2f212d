"""Slow and failed query capture: diagnostics bundles and the profiler's
re-arm (the port's copy of daft_tpu/obs/capture.py).

With ``cfg.diagnostics_dir`` set, a query that errors, hits its deadline
or takes at least ``cfg.slow_query_threshold_s`` writes a bundle:

    <diagnostics_dir>/<stamp>_<query_id>_<outcome>/
        record.json     the QueryRecord
        stats.txt       the explain_analyze runtime-stats text
        profile.json    the QueryProfile (only when the profiler was armed)
        log_tail.jsonl  the structured-log ring's tail (this query's first)
        trace_tail.json the chrome-trace ring's tail (only when a trace is armed)

Only the newest ``cfg.diagnostics_keep_last`` bundles stay (the oldest are
pruned at each write, and only directories named as bundles are ever
touched), so a flapping workload never fills the disk.

A slow query also arms the profiler for the NEXT run of the same plan
fingerprint (``note_slow``/``take_arm``): the first slow run captures
counters, the second a whole span tree.

``execution.execute_plan``'s completion hook calls ``maybe_capture`` inside
a catch: a capture failure degrades to an error log line, never a query
failure.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import List, Optional, Set

from .log import get_logger

__all__ = ["maybe_capture", "note_slow", "take_arm", "armed_fingerprints",
           "render_runtime_stats"]

logger = get_logger("obs")

_arm_lock = threading.Lock()
_arm_next: Set[str] = set()


def note_slow(fingerprint: str) -> None:
    """Remember a slow plan shape: its next execution auto-arms the
    profiler (consumed by ``take_arm``)."""
    with _arm_lock:
        _arm_next.add(fingerprint)


def take_arm(fingerprint: str) -> bool:
    """True exactly once per ``note_slow`` of this fingerprint — the
    execute_plan entry hook that decides whether to arm the profiler."""
    with _arm_lock:
        if fingerprint in _arm_next:
            _arm_next.discard(fingerprint)
            return True
        return False


def armed_fingerprints() -> Set[str]:
    with _arm_lock:
        return set(_arm_next)


def render_runtime_stats(stats) -> str:
    """The explain_analyze 'Runtime Stats' text (per-op rows, wall and
    throughput, the IO breakdown, the fusion, planning, batching, exchange
    and residency lines, the counters), shared by DataFrame.explain_analyze
    and the diagnostics bundles."""
    snap = stats.snapshot()
    rows, wall = snap["op_rows"], snap["op_wall_ns"]
    tput = stats.op_throughput()
    names = sorted(set(rows) | set(wall), key=lambda k: -wall.get(k, 0))
    w = max([len(n) for n in names] + [8])
    lines = ["== Runtime Stats ==",
             f"{'operator':<{w}}  {'rows out':>12}  {'wall ms':>10}"
             f"  {'rows/s':>12}  {'MB/s':>8}"]
    for n in names:
        t = tput.get(n, {})
        lines.append(
            f"{n:<{w}}  {rows.get(n, 0):>12,}  {wall.get(n, 0) / 1e6:>10.2f}"
            f"  {t.get('rows_per_sec', 0.0):>12,.0f}"
            f"  {t.get('bytes_per_sec', 0.0) / 1e6:>8.1f}")
    counters = snap["counters"]
    io = stats.io_breakdown()
    if io["io_wait_ms"] or io["prefetch_hits"] or io["prefetch_misses"] \
            or io["spill_write_mbps"] or io["spill_read_mbps"]:
        lines.append("")
        lines.append(
            f"io: wait {io['io_wait_share'] * 100:.1f}% of op wall "
            f"({io['io_wait_ms']:.1f} ms) · prefetch "
            f"{io['prefetch_hits']} hit / {io['prefetch_misses']} miss"
            + (f" / {io['prefetch_throttled']} throttled"
               if io["prefetch_throttled"] else "")
            + f" · spill write {io['spill_write_mbps']:.1f} MB/s"
            f" · read {io['spill_read_mbps']:.1f} MB/s")
    if counters.get("fused_chains"):
        lines.append("")
        lines.append(
            f"fusion: {counters['fused_chains']} FusedMap chain(s), "
            f"{counters.get('fused_ops_eliminated', 0)} op(s) eliminated"
            f", {counters.get('cse_hits', 0)} cse hit(s)")
    plan_line = _render_planning_line(counters)
    if plan_line:
        lines.append("")
        lines.append(plan_line)
    strm = _render_streaming_line(counters)
    if strm:
        lines.append("")
        lines.append(strm)
    bat = _render_batching_line(counters)
    if bat:
        lines.append("")
        lines.append(bat)
    exch = _render_exchange_line(counters)
    if exch:
        lines.append("")
        lines.append(exch)
    res = _render_residency_line(counters)
    if res:
        lines.append("")
        lines.append(res)
    if counters:
        lines.append("")
        lines.append("counters: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counters.items())))
    return "\n".join(lines)


def _render_planning_line(counters: dict) -> str:
    """The explain_analyze 'planning:' line: the optimize, translate and
    fuse wall (the cost a plan-cache hit removes), the fuse-compile share,
    the query's plan-cache hits and misses and any FDO decisions. Empty
    when nothing was recorded (a direct execute_plan without a runner)."""
    ns = counters.get("planning_wall_ns", 0)
    if not ns:
        return ""
    parts = [f"{ns / 1e6:.1f} ms"]
    comp = counters.get("compile_wall_ns", 0)
    if comp:
        parts.append(f"compile {comp / 1e6:.1f} ms")
    hits = counters.get("plan_cache_hits", 0)
    misses = counters.get("plan_cache_misses", 0)
    if hits or misses:
        parts.append(f"plan cache {hits} hit / {misses} miss")
    if counters.get("subplan_cache_hits"):
        parts.append(
            f"{counters['subplan_cache_hits']} prefix replay(s)")
    fdo_bits = []
    for key, label in (("fdo_join_flips", "join flip"),
                       ("fdo_shuffle_resizes", "fan-out resize"),
                       ("fdo_stream_hints", "stream hint"),
                       ("fdo_mispredicts", "MISPREDICT")):
        n = counters.get(key, 0)
        if n:
            fdo_bits.append(f"{n} {label}(s)")
    if fdo_bits:
        parts.append("fdo: " + ", ".join(fdo_bits))
    return "planning: " + " · ".join(parts)


def _render_streaming_line(counters: dict) -> str:
    """The explain_analyze 'streaming:' line: morsels produced, the
    channels' high water, backpressure stalls, limit short-circuits and
    time to the first row. Empty when no morsel streamed."""
    n = counters.get("stream_morsels", 0)
    if not n:
        return ""
    parts = [f"{n:,} morsel(s)",
             f"channel high-water {counters.get('stream_channel_high_water', 0)}"]
    stalls = counters.get("stream_backpressure_stalls", 0)
    if stalls:
        parts.append(
            f"{stalls} backpressure stall(s) "
            f"({counters.get('stream_backpressure_ns', 0) / 1e6:.1f} ms)")
    short = counters.get("morsels_short_circuited", 0)
    if short:
        parts.append(f"{short} short-circuited")
    ttfr = counters.get("time_to_first_row_ns", 0)
    if ttfr:
        parts.append(f"first row {ttfr / 1e6:.1f} ms")
    return "streaming: " + " · ".join(parts)


def _render_batching_line(counters: dict) -> str:
    """The explain_analyze 'batching:' line: batches formed, the mean fill
    against the row budget, the padding overhead and the flush reasons.
    Empty when no batch formed."""
    n = counters.get("batches_formed", 0)
    if not n:
        return ""
    rows = counters.get("batch_rows", 0)
    cap = counters.get("batch_capacity_rows", 0)
    parts = [f"{n:,} batch(es)", f"{rows:,} rows"]
    if cap:
        parts.append(f"mean fill {rows / cap * 100:.1f}%")
    padded = counters.get("batch_rows_padded", 0)
    if padded and rows:
        parts.append(f"pad overhead {padded / rows * 100:.1f}%")
    flushes = []
    for reason in ("budget", "timer", "end"):
        c = counters.get(f"batch_flushes_{reason}", 0)
        if c:
            flushes.append(f"{c} {reason}")
    if flushes:
        parts.append("flushes " + " / ".join(flushes))
    if counters.get("batch_coalesce_faults"):
        parts.append(
            f"{counters['batch_coalesce_faults']} coalesce fault(s) "
            "degraded")
    return "batching: " + " · ".join(parts)


def _render_exchange_line(counters: dict) -> str:
    """The explain_analyze 'exchange:' line: the join filters' pruning
    ('pruned N of M probe rows'), the encoded against the raw payload bytes
    and the rows folded before the exchange. Empty when nothing fired."""
    parts = []
    if counters.get("join_filter_built"):
        pruned = counters.get("join_filter_rows_pruned", 0)
        probed = counters.get("join_filter_probe_rows", 0)
        parts.append(
            f"join filters: pruned {pruned:,} of {probed:,} probe rows "
            f"({counters['join_filter_built']} filter(s))")
    enc = counters.get("exchange_bytes_encoded", 0)
    # denominator = raw bytes of the pieces the encoder actually saw (NOT
    # exchange_bytes, which also counts gathers and encode-disabled paths)
    raw = counters.get("exchange_bytes_encodable", 0)
    if counters.get("exchange_pieces_encoded") and raw:
        parts.append(
            f"encode: {raw:,} -> {enc:,} B ({enc / raw:.0%}, "
            f"{counters['exchange_pieces_encoded']} piece(s))")
    if counters.get("exchange_precombined_rows"):
        parts.append(
            f"combine: {counters['exchange_precombined_rows']:,} row(s) "
            "folded pre-exchange")
    return ("exchange: " + " · ".join(parts)) if parts else ""


def _render_residency_line(counters: dict) -> str:
    """The explain_analyze 'residency:' line: resident segments executed,
    operator-boundary handoffs elided, the card's high water of the
    resident intermediates (printed as HBM, the reference's word) and
    degradations to the staged path. Empty when no segment ran resident."""
    n = counters.get("device_resident_segments", 0)
    if not n:
        return ""
    parts = [f"{n} resident segment(s)",
             f"{counters.get('device_handoffs_elided', 0)} handoff(s) elided"]
    hw = counters.get("hbm_resident_bytes_high_water", 0)
    if hw:
        parts.append(f"HBM high-water {hw / 1e6:.1f} MB")
    fb = counters.get("segment_fallbacks", 0)
    if fb:
        parts.append(f"{fb} fallback(s) to staged")
    return "residency: " + " · ".join(parts)


# a bundle directory name: <stamp>_<query id>_<outcome>. Retention ONLY
# ever touches names matching this — diagnostics_dir may be an existing
# directory with unrelated content, which pruning must never delete
_BUNDLE_RE = re.compile(
    r"^\d{8}T\d{6}_[A-Za-z0-9_-]+_(ok|error|timeout|cancelled|abandoned)$")


def _bundle_name(rec: dict) -> str:
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(rec["unix_time"]))
    qid = "".join(c if c.isalnum() or c in "-_" else "_"
                  for c in rec["query_id"])
    return f"{stamp}_{qid}_{rec['outcome']}"


def _prune(root: str, keep: int) -> None:
    try:
        entries = sorted(
            e for e in os.listdir(root)
            if _BUNDLE_RE.match(e) and os.path.isdir(os.path.join(root, e)))
    except OSError:
        return
    for e in entries[:max(0, len(entries) - max(1, keep))]:
        shutil.rmtree(os.path.join(root, e), ignore_errors=True)


def maybe_capture(rec: dict, cfg, stats, profiler) -> Optional[str]:
    """The completion hook: decide slow or failed, write the bundle, arm the
    next run. Returns the bundle's path (None when nothing was captured)."""
    outcome = rec["outcome"]
    failed = outcome in ("error", "timeout")
    thr = getattr(cfg, "slow_query_threshold_s", None)
    slow = thr is not None and rec["wall_s"] >= thr
    if not (failed or slow):
        return None
    if slow and not rec["profiled"]:
        # the NEXT run of this plan shape records a full span tree
        note_slow(rec["plan_fingerprint"])
    root = getattr(cfg, "diagnostics_dir", None)
    if not root:
        return None
    path = os.path.join(root, _bundle_name(rec))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "record.json"), "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1, sort_keys=True, default=str)
    try:
        text = render_runtime_stats(stats)
    except Exception as e:
        text = f"(runtime-stats rendering failed: {e!r})"
    with open(os.path.join(path, "stats.txt"), "w", encoding="utf-8") as f:
        f.write(text + "\n")
    if profiler is not None and profiler.armed:
        try:
            from ..profile.export import build_profile

            build_profile(profiler, stats).to_json(
                os.path.join(path, "profile.json"))
        except Exception as e:
            logger.error("bundle_profile_failed", path=path, error=repr(e))
    _write_log_tail(path, rec["query_id"])
    _write_trace_tail(path)
    _prune(root, getattr(cfg, "diagnostics_keep_last", 20))
    logger.info("diagnostics_bundle", path=path, outcome=outcome,
                slow=slow, wall_s=rec["wall_s"])
    return path


def _write_log_tail(path: str, query_id: str) -> None:
    from . import log as obs_log

    recs = obs_log.tail(200, query_id=query_id)
    if not recs:
        recs = obs_log.tail(100)
    with open(os.path.join(path, "log_tail.jsonl"), "w",
              encoding="utf-8") as f:
        for r in recs:
            f.write(json.dumps(r, default=str) + "\n")


def _write_trace_tail(path: str) -> None:
    from .. import tracing

    if not tracing.active():
        return
    with open(os.path.join(path, "trace_tail.json"), "w",
              encoding="utf-8") as f:
        json.dump({"traceEvents": tracing.tail(2000)}, f, default=str)


def list_bundles(root: str) -> List[str]:
    """The bundle directories under ``root``, oldest first (by the name
    filter retention uses, so unrelated content never counts)."""
    try:
        return sorted(e for e in os.listdir(root)
                      if _BUNDLE_RE.match(e)
                      and os.path.isdir(os.path.join(root, e)))
    except OSError:
        return []
