"""Feedback-directed planning: planner decisions from recorded sizes (the
port's copy of daft_tpu/adapt/fdo.py).

Adaptive execution (adaptive.py) learns a side's true size by running the
stage under it first. This module learns it from history: the executor
recorded what this plan shape did last time (history.py), so the decision
lands on the first run of a repeated shape, before anything materializes.
Both decisions are behind ``cfg.history_fdo`` and give the same rows:

- join strategy (``join_strategy_hint``, read by
  ``physical._translate_join``): a join side whose static size estimate is
  above the broadcast threshold but whose observed bytes sit at half of it
  or less flips to a broadcast join, when the side's subtree can shrink
  (a Filter, Aggregate, Limit, ...), so that a bare source, whose estimate
  is already true, never flips;
- shuffle fan-out (``agg_shuffle_fanout``, read by
  ``physical._translate_aggregate``): the exchange of a two-stage grouped
  aggregate emits ``ceil(observed bytes / shuffle_target_partition_bytes)``
  partitions; shrink-only, at least ``_FANOUT_MIN_PARTS`` partitions before
  and at most half of them after.

A third decision is per query (``apply_query_hints``, called when
``plancache.plan_query`` hands the plan over): a shape whose recorded runs
(at least two) spent more than half their wall time with producers
stalled on full stream channels runs with ``streaming_execution`` off
(``fdo_stream_hints``).

Each decision records its expectation with the cached plan, where
``still_valid`` derives it again as history moves, and the runtime guard
(``note_broadcast_mispredict``, called by ``BroadcastJoinOp`` when a side
history called small arrives big) demotes the shape's cached plans; the
query itself completes either way.

Decisions run only inside a ``collecting`` scope, which the cold path of
``plancache.plan_query`` opens: adaptive stages and a bare ``translate``
plan statically.

A failure in a decision plans statically, as the reference's catch does,
and logs its line (``fdo_join_hint_failed``, ``fdo_fanout_hint_failed``,
``fdo_demote_failed``); a failure of the port itself
(``errors.PORT_FAILURES``) reaches the caller. Each decision is counted,
logged (``fdo_join_flips``, ``fdo_shuffle_resizes``, ``fdo_mispredict``)
and, in a profiled query, recorded as an ``fdo`` event.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

from ..errors import PORT_FAILURES
from ..obs.log import get_logger

logger = get_logger("fdo")

__all__ = ["collecting", "active", "join_strategy_hint", "broadcast_guard",
           "agg_shuffle_fanout", "agg_observation_key", "observation_key", "still_valid",
           "note_broadcast_mispredict", "apply_query_hints"]

# flip to broadcast only when the observed bytes sit at half the threshold or
# less: hysteresis against shapes oscillating around the boundary
_BROADCAST_SLACK = 0.5
# the runtime guard: the materialized side may exceed the threshold by this
# factor before the plan is demoted (the EWMA drifts; a 10% overshoot is not
# a wrong decision)
_MISPREDICT_SLACK = 1.5
# resize an aggregate's exchange only when it is worth a change of layout
_FANOUT_MIN_PARTS = 4

_tl = threading.local()


class _Collector:
    __slots__ = ("cfg", "stats", "enabled", "expects", "fanout_ok")

    def __init__(self, cfg, stats, enabled: bool, fanout_ok: bool = True):
        self.cfg = cfg
        self.stats = stats
        self.enabled = enabled
        # False declines fan-out resizes: the mesh exchange yields its
        # collective's partition count and cannot honour a reduce-side fan-in
        self.fanout_ok = fanout_ok
        self.expects: List[dict] = []


@contextlib.contextmanager
def collecting(cfg, stats, enabled: bool = True, fanout_ok: bool = True):
    """The scope in which translate's hooks are live; yields the collector
    whose ``expects`` the plan cache stores with the plan."""
    coll = _Collector(cfg, stats, enabled, fanout_ok)
    prev = getattr(_tl, "coll", None)
    _tl.coll = coll
    try:
        yield coll
    finally:
        _tl.coll = prev


def active() -> Optional[_Collector]:
    coll = getattr(_tl, "coll", None)
    if coll is None or not coll.enabled or not coll.cfg.history_fdo:
        return None
    return coll


def observation_key(subplan) -> Optional[str]:
    """The site fingerprint an exchange or a join observes its payload
    under; None outside a collecting scope."""
    if active() is None:
        return None
    try:
        from .fingerprint import canonical_site_fp

        return canonical_site_fp(subplan)
    except PORT_FAILURES:
        raise
    except Exception:
        return None


def _bump(coll, counter: str, **log_fields) -> None:
    if coll.stats is not None:
        coll.stats.bump(counter)
        p = coll.stats.profiler
        if p.armed:
            p.event("fdo", kind=counter, **log_fields)
    logger.info(counter, **log_fields)


# ------------------------------------------------------------------- decisions

def _shrinkable(side) -> bool:
    """Whether the side's static size estimate can overestimate: an op in
    its subtree that can drop rows, or a filter or limit pushed into a scan
    (the optimizer removes the Filter node, but the scan's estimate still
    charges the whole file)."""
    from ..adaptive import _subtree_can_shrink
    from ..logical import ScanSource

    if _subtree_can_shrink(side):
        return True

    def scan_pushed(p) -> bool:
        if isinstance(p, ScanSource):
            pd = p.pushdowns()
            return pd.filters is not None or pd.limit is not None
        return any(scan_pushed(c) for c in p.children())

    return scan_pushed(side)


def join_strategy_hint(plan) -> Optional[str]:
    """``"left"`` or ``"right"`` (broadcast that side), or None. Read by
    ``physical._translate_join`` for a join with no explicit strategy.

    Every side the join type allows to broadcast is consulted (both for an
    inner join: a small left side flips as well as a right one), and each
    consult records an expectation that fresh history derives again."""
    coll = active()
    if coll is None:
        return None
    from ..physical import _broadcast_side
    from .history import HISTORY

    if plan.how == "outer":
        return None
    try:
        threshold = int(coll.cfg.broadcast_join_size_bytes_threshold)
        # which sides may be broadcast: an inner join either, left, semi and
        # anti only the right, right only the left
        preferred = _broadcast_side(plan, None, None)
        candidates = [preferred]
        if plan.how == "inner":
            candidates.append("left" if preferred == "right" else "right")
        from .fingerprint import canonical_site_fp

        for side_name in candidates:
            side = plan.left if side_name == "left" else plan.right
            static = side.approx_size_bytes()
            if static is not None and static <= threshold:
                return None  # the static planner already broadcasts it
            if not _shrinkable(side):
                continue  # the static estimate is already true
            site = canonical_site_fp(side)
            hist = HISTORY.size(site)
            flip = hist is not None and hist[1] <= threshold * _BROADCAST_SLACK
            coll.expects.append({"kind": "join", "site": site, "threshold": threshold,
                                 "decided": "broadcast" if flip else "none"})
            if flip:
                _bump(coll, "fdo_join_flips", site=site, side=side_name,
                      observed_bytes=hist[1], threshold=threshold)
                return side_name
        return None
    except PORT_FAILURES:
        raise
    except Exception as e:
        logger.warning("fdo_join_hint_failed", error=repr(e))
        return None


def broadcast_guard(plan, side_name: str):
    """(site fingerprint, most bytes) that BroadcastJoinOp holds the
    materialized small side to: the runtime detector of a mispredicted
    flip."""
    coll = active()
    if coll is None:
        return None
    try:
        from .fingerprint import canonical_site_fp

        side = plan.left if side_name == "left" else plan.right
        threshold = int(coll.cfg.broadcast_join_size_bytes_threshold)
        return canonical_site_fp(side), int(threshold * _MISPREDICT_SLACK)
    except PORT_FAILURES:
        raise
    except Exception:
        return None


def note_broadcast_mispredict(guard, actual_bytes: int, ctx, canonical_fp: str) -> None:
    """History said broadcast; the side arrived big. Count it
    (``fdo_mispredicts``) and demote the shape's cached plans: the query
    completes on the broadcast plan (correct, only slower), and the next
    plan of the shape derives the hash join from the true size the caller
    observed."""
    site_fp, _max = guard
    ctx.stats.bump("fdo_mispredicts")
    p = ctx.stats.profiler
    if p.armed:
        p.event("fdo", kind="fdo_mispredict", site=site_fp, actual_bytes=actual_bytes)
    logger.warning("fdo_mispredict", site=site_fp, actual_bytes=actual_bytes)
    try:
        from .history import HISTORY
        from .plancache import PLAN_CACHE

        HISTORY.note_mispredict(site_fp)
        if canonical_fp:
            PLAN_CACHE.demote(canonical_fp)
    except PORT_FAILURES:
        raise
    except Exception as e:
        logger.warning("fdo_demote_failed", error=repr(e))


def agg_shuffle_fanout(plan, nparts: int) -> Optional[int]:
    """A smaller fan-out for the exchange of a two-stage grouped aggregate,
    from its observed map-side payload, or None. Shrink-only, and only when
    the change is material: at least ``_FANOUT_MIN_PARTS`` partitions,
    shrinking at least by half."""
    coll = active()
    if coll is None or not coll.fanout_ok or nparts < _FANOUT_MIN_PARTS:
        return None
    try:
        from .fingerprint import canonical_site_fp
        from .history import HISTORY

        site = "aggx:" + canonical_site_fp(plan)
        hist = HISTORY.size(site)
        target = max(int(coll.cfg.shuffle_target_partition_bytes), 1)
        ideal = None
        if hist is not None:
            ideal = max(1, -(-hist[1] // target))
        decided = ideal if ideal is not None and ideal <= nparts // 2 else None
        coll.expects.append({"kind": "fanout", "site": site, "target": target,
                             "nparts": nparts, "decided": decided or 0})
        if decided is None:
            return None
        _bump(coll, "fdo_shuffle_resizes", site=site, from_parts=nparts, to_parts=decided,
              observed_bytes=hist[1])
        return decided
    except PORT_FAILURES:
        raise
    except Exception as e:
        logger.warning("fdo_fanout_hint_failed", error=repr(e))
        return None


def agg_observation_key(plan) -> Optional[str]:
    """The site key an aggregate's exchange observes its input payload
    under (``agg_shuffle_fanout``'s lookup key)."""
    if active() is None:
        return None
    try:
        from .fingerprint import canonical_site_fp

        return "aggx:" + canonical_site_fp(plan)
    except PORT_FAILURES:
        raise
    except Exception:
        return None


def still_valid(exp: dict) -> bool:
    """Derive one recorded expectation again against the current history;
    False drops the cached plan (``plancache.PlanCache.revalidate``)."""
    from .history import HISTORY

    hist = HISTORY.size(exp["site"])
    if exp["kind"] == "join":
        flip = hist is not None and hist[1] <= exp["threshold"] * _BROADCAST_SLACK
        return ("broadcast" if flip else "none") == exp["decided"]
    if exp["kind"] == "fanout":
        ideal = None
        if hist is not None:
            ideal = max(1, -(-hist[1] // exp["target"]))
        decided = ideal if ideal is not None and ideal <= exp["nparts"] // 2 else 0
        return decided == exp["decided"]
    return True  # an unknown kind never invalidates


# ------------------------------------------------------------ query hints

# streaming stands down only where stalls dominated: more than half the wall
# time over at least two recorded runs
_STREAM_STALL_SHARE = 0.5
_STREAM_MIN_RUNS = 2


def apply_query_hints(canonical_fp: str, cfg, stats):
    """The query's config adjusted from its shape's recorded profile: the
    morsel pipeline off where its producers mostly stalled. Returns ``cfg``
    or a replaced copy."""
    if not canonical_fp or not cfg.history_fdo or not cfg.streaming_execution:
        return cfg
    from .history import HISTORY

    prof = HISTORY.query_profile(canonical_fp)
    if prof is None or prof["runs"] < _STREAM_MIN_RUNS or not prof["stream_morsels"]:
        return cfg
    if prof["backpressure_ms"] <= _STREAM_STALL_SHARE * prof["wall_s"] * 1000.0:
        return cfg
    import dataclasses

    if stats is not None:
        stats.bump("fdo_stream_hints")
        p = stats.profiler
        if p.armed:
            p.event("fdo", kind="fdo_stream_hint", fingerprint=canonical_fp)
    logger.info("fdo_stream_hint", fingerprint=canonical_fp,
                backpressure_ms=round(prof["backpressure_ms"], 1),
                wall_s=round(prof["wall_s"], 3))
    return dataclasses.replace(cfg, streaming_execution=False)
