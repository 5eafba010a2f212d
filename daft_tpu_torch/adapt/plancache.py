"""Process-level plan cache: fingerprint -> planned artifacts (the port's
copy of daft_tpu/adapt/plancache.py, without the artifact export and
import).

One entry per (canonical fingerprint, config key) holds the optimized
logical plan, the translated physical plan (its compiled fused programs and
plan segments included) and the feedback decisions baked into it. An entry
holds a small LRU of bindings, the exact literal-bearing structural keys
(``runners.plan_cache_key``), so ``WHERE x > 5`` and ``WHERE x > 9`` share
one entry (the shape, its bytes, its demotion) while each binding serves
its own compiled plan.

Guarantees:

- warm path: a hit makes no ``optimize``, ``translate``, fuse compile or
  segment compile call. The cached physical tree is cloned with every
  per-query latch reset (``clone_plan``), so concurrent queries never share
  an op's mutable state, and the rows equal a cold plan's;
- invalidation: the binding key holds the literals and the in-memory
  sources' tokens; the config key holds the full ExecutionConfig (the card
  or the CPU, the 32- or 64-bit mode among its fields), ``CACHE_VERSION``,
  the runtime generation and the runner; ``revalidate`` drops a binding
  whose recorded decisions fresh history no longer derives; ``demote``
  drops a shape after a runtime mispredict;
- bounded: the estimated bytes (a structural term plus the arrow bytes of
  the in-memory partitions a plan pins) are shed LRU under
  ``cfg.plan_cache_bytes``, charged to the MemoryLedger's
  ``plan_cache_bytes`` account. The columns those partitions staged on the
  card stay pinned with them and are not counted, as in the reference;
- failing open: a defect of the cache layer (the armed ``plancache.lookup``
  fault site among them) plans uncached and counts ``plan_cache_errors``;
  a failure of the port itself (``errors.PORT_FAILURES``) reaches the
  caller. Concurrent misses of one binding build once (single flight);
  a waiter that times out plans uncached. Each fail-open logs its line
  (``canonical_fingerprint_failed``, ``plan_cache_lookup_failed``,
  ``plan_cache_rehydrate_failed``, ``plan_cache_store_failed``).

A profiled query records a ``plancache`` event (``hit`` or ``miss``); a
demotion logs ``plan_cache_demoted`` and a revalidation that drops bindings
``plan_cache_revalidated``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..errors import PORT_FAILURES
from ..obs.log import get_logger

logger = get_logger("plancache")

__all__ = ["PlanCache", "PLAN_CACHE", "CACHE_VERSION", "plan_query", "clone_plan"]

# bump when planner or executor internals change what a plan means (part of
# every lookup key, so a plan from before the bump never serves)
CACHE_VERSION = 1

_BINDINGS_PER_ENTRY = 8
_SINGLE_FLIGHT_WAIT_S = 30.0


class CompiledPlan:
    """One binding's planned artifacts. ``fdo_expect`` lists the feedback
    decisions baked into this plan: per binding, since two literal bindings
    of one shape can be planned under different history and each must be
    revalidated against what it decided."""

    __slots__ = ("optimized", "physical", "nbytes", "fdo_expect")

    def __init__(self, optimized, physical, nbytes: int, fdo_expect=None):
        self.optimized = optimized
        self.physical = physical
        self.nbytes = nbytes
        self.fdo_expect = fdo_expect or []


class _Entry:
    __slots__ = ("canonical_fp", "cfg_key", "bindings", "nbytes")

    def __init__(self, canonical_fp: str, cfg_key: str):
        self.canonical_fp = canonical_fp
        self.cfg_key = cfg_key
        # exact binding key -> CompiledPlan (a small LRU of literal variants)
        self.bindings: "OrderedDict[str, CompiledPlan]" = OrderedDict()
        self.nbytes = 0


def _estimate_plan_bytes(optimized, physical) -> int:
    """The byte cap's estimate: a cheap structural term plus the in-memory
    partitions a cached plan pins (a plan over a large frame keeps its data
    alive past the DataFrame, so the data counts, and a frame beyond the cap
    keeps its plan out of the cache)."""
    from ..physical import InMemoryOp

    def pinned(op) -> int:
        n = 0
        if isinstance(op, InMemoryOp):
            for p in op.parts:
                if p.is_loaded():
                    n += p.size_bytes() or 0
        for c in op.children:
            n += pinned(c)
        return n

    try:
        return (8192 + 24 * (len(optimized.display_tree()) + len(physical.display_tree()))
                + pinned(physical))
    except PORT_FAILURES:
        raise
    except Exception:
        return 65536


def _fresh_slot(slot, memo: dict):
    """A fresh copy of a JoinFilterSlot for one query. The feed exchange and
    the probe exchange share one slot object, so they share the copy too."""
    import copy

    ns = memo.get(id(slot))
    if ns is None:
        ns = copy.copy(slot)
        ns._builder = None
        ns._filter = None
        ns._sealed = False
        memo[id(slot)] = ns
    return ns


def clone_plan(op, _memo: Optional[dict] = None):
    """A cached physical tree made ready for one execution: a structural
    clone (new op objects and children lists; expressions, schemas, fused
    programs and segment programs are immutable and shared) with every
    per-query latch reset: the fusion and residency latches of FusedMapOp
    and DeviceSegmentOp, and the join-filter slots. A cached tree is never
    executed itself."""
    import copy

    from ..fuse.compile import FusedMapOp
    from ..fuse.segment import DeviceSegmentOp

    if _memo is None:
        _memo = {}
    new = copy.copy(op)
    new.children = [clone_plan(c, _memo) for c in op.children]
    if isinstance(new, (FusedMapOp, DeviceSegmentOp)):
        new._recorded_for = None
        new._record_lock = threading.Lock()
    if isinstance(new, DeviceSegmentOp):
        new._resident_for = None
    ff = getattr(new, "filter_feed", None)
    if ff is not None:
        new.filter_feed = _fresh_slot(ff, _memo)
    pf = getattr(new, "probe_filter", None)
    if pf is not None:
        new.probe_filter = _fresh_slot(pf, _memo)
    return new


def _cfg_key(cfg) -> str:
    """The full ExecutionConfig as a deterministic string: any knob change
    invalidates (a missed planning field could serve a stale plan; an extra
    one only costs a plan)."""
    import dataclasses

    return ";".join(f"{f.name}={getattr(cfg, f.name)!r}" for f in dataclasses.fields(cfg))


class PlanCache:
    """Bounded, thread-safe plan cache (see the module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str], _Entry]" = OrderedDict()
        self._inflight: Dict[tuple, threading.Event] = {}
        self._bytes = 0
        self._generation = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.demotions = 0
        self.errors = 0

    # ---------------------------------------------------------------- ledger
    def _charge(self, delta: int) -> None:
        if not delta:
            return
        from ..spill import MEMORY_LEDGER

        MEMORY_LEDGER.cache_account("plan_cache_bytes", delta)

    # ---------------------------------------------------------------- lookup
    def lookup(self, canonical_fp: str, cfg_key: str, binding: str) -> Optional[CompiledPlan]:
        with self._lock:
            entry = self._entries.get((canonical_fp, cfg_key))
            if entry is None:
                self.misses += 1
                return None
            cp = entry.bindings.get(binding)
            if cp is None:
                self.misses += 1
                return None
            entry.bindings.move_to_end(binding)
            self._entries.move_to_end((canonical_fp, cfg_key))
            self.hits += 1
            return cp

    def store(self, canonical_fp: str, cfg_key: str, binding: str, cp: CompiledPlan,
              cap_bytes: int) -> None:
        if cp.nbytes > max(cap_bytes, 0):
            return  # one oversized plan must not evict the whole cache
        with self._lock:
            key = (canonical_fp, cfg_key)
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _Entry(canonical_fp, cfg_key)
            old = entry.bindings.pop(binding, None)
            if old is not None:
                entry.nbytes -= old.nbytes
                self._bytes -= old.nbytes
            entry.bindings[binding] = cp
            entry.nbytes += cp.nbytes
            self._bytes += cp.nbytes
            self.inserts += 1
            delta = cp.nbytes - (old.nbytes if old is not None else 0)
            while len(entry.bindings) > _BINDINGS_PER_ENTRY:
                _, shed = entry.bindings.popitem(last=False)
                entry.nbytes -= shed.nbytes
                self._bytes -= shed.nbytes
                delta -= shed.nbytes
                self.evictions += 1
            self._entries.move_to_end(key)
            while self._bytes > cap_bytes and len(self._entries) > 1:
                k, shed_e = self._entries.popitem(last=False)
                if k == key:  # never shed the entry just stored
                    self._entries[k] = shed_e
                    self._entries.move_to_end(k, last=False)
                    break
                self._bytes -= shed_e.nbytes
                delta -= shed_e.nbytes
                self.evictions += 1
            # the cap binds within one entry too: the literal variants of one
            # hot shape must not hold unbounded bytes
            while self._bytes > cap_bytes and len(entry.bindings) > 1:
                bk = next(iter(entry.bindings))
                if bk == binding:
                    break  # never shed the binding just stored
                shed = entry.bindings.pop(bk)
                entry.nbytes -= shed.nbytes
                self._bytes -= shed.nbytes
                delta -= shed.nbytes
                self.evictions += 1
        self._charge(delta)

    # ---------------------------------------------------------- invalidation
    def demote(self, canonical_fp: str) -> None:
        """Drop every entry of this shape (a runtime mispredict: the cached
        plan's decision was wrong; the next run plans afresh from the
        corrected history)."""
        freed = 0
        with self._lock:
            for key in [k for k in self._entries if k[0] == canonical_fp]:
                e = self._entries.pop(key)
                freed += e.nbytes
                self._bytes -= e.nbytes
                self.demotions += 1
        if freed:
            self._charge(-freed)
            logger.info("plan_cache_demoted", fingerprint=canonical_fp, freed_bytes=freed)

    def revalidate(self, site_fps) -> None:
        """Drop the bindings whose recorded decisions consulted one of the
        sites just updated and no longer derive (fresh history would plan
        differently, say a build side now under the broadcast threshold).
        Per binding: an older literal binding planned under other history
        must not hide behind a newer sibling's valid decisions."""
        from . import fdo

        stale: List[Tuple[Tuple[str, str], str]] = []
        with self._lock:
            items = [(key, list(e.bindings.items())) for key, e in self._entries.items()]
        for key, bindings in items:
            for bk, cp in bindings:
                for exp in cp.fdo_expect:
                    if exp.get("site") not in site_fps:
                        continue
                    try:
                        ok = fdo.still_valid(exp)
                    except PORT_FAILURES:
                        raise
                    except Exception:
                        ok = False
                    if not ok:
                        stale.append((key, bk))
                        break
        if not stale:
            return
        freed = 0
        with self._lock:
            for key, bk in stale:
                e = self._entries.get(key)
                if e is None:
                    continue
                cp = e.bindings.pop(bk, None)
                if cp is None:
                    continue
                e.nbytes -= cp.nbytes
                self._bytes -= cp.nbytes
                freed += cp.nbytes
                self.demotions += 1
                if not e.bindings:
                    self._entries.pop(key, None)
        if freed:
            self._charge(-freed)
            logger.info("plan_cache_revalidated", dropped=len(stale))

    def bump_generation(self) -> None:
        """Invalidate everything (the runtime counterpart of a
        CACHE_VERSION bump)."""
        self.clear()
        with self._lock:
            self._generation += 1

    def clear(self) -> None:
        """Drop every entry and reset the counters (a cleared cache reads as
        a fresh one). In-flight single-flight events are set before they go:
        a waiter plans uncached now instead of sitting out its wait."""
        with self._lock:
            freed = self._bytes
            inflight = list(self._inflight.values())
            self._entries.clear()
            self._inflight.clear()
            self._bytes = 0
            self.hits = self.misses = self.inserts = 0
            self.evictions = self.demotions = self.errors = 0
        for ev in inflight:
            ev.set()
        self._charge(-freed)

    # --------------------------------------------------------- single flight
    def begin_build(self, full_key) -> Optional[threading.Event]:
        """None when this caller owns the build; else the event to wait on
        (another thread is planning this key)."""
        with self._lock:
            ev = self._inflight.get(full_key)
            if ev is not None:
                return ev
            self._inflight[full_key] = threading.Event()
            return None

    def end_build(self, full_key) -> None:
        with self._lock:
            ev = self._inflight.pop(full_key, None)
        if ev is not None:
            ev.set()

    # ----------------------------------------------------------------- admin
    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "bindings": sum(len(e.bindings) for e in self._entries.values()),
                    "bytes": self._bytes, "hits": self.hits, "misses": self.misses,
                    "inserts": self.inserts, "evictions": self.evictions,
                    "demotions": self.demotions, "errors": self.errors}


PLAN_CACHE = PlanCache()


def _error(stats, event: str, e: BaseException) -> None:
    """A fail-open of the cache layer: counted and logged."""
    PLAN_CACHE.errors += 1
    if stats is not None:
        stats.bump("plan_cache_errors")
    logger.warning(event, error=repr(e))


def _event(stats, kind: str, **fields) -> None:
    p = stats.profiler
    if p.armed:
        p.event("plancache", kind=kind, **fields)


def _has_write(plan) -> bool:
    from ..logical import Write

    return isinstance(plan, Write) or any(_has_write(c) for c in plan.children())


def plan_query(plan, cfg, stats=None, optimized: bool = False, runner: str = "native"):
    """The runner's one planning entry point: feedback-informed optimize and
    translate, served from the plan cache where it can be.

    Returns ``(optimized plan, physical plan, run config)``; the run config
    is ``cfg`` (the reference's per-query streaming hint comes with the
    port's streaming). ``planning_wall_ns`` in ``stats`` covers this whole
    call (cold planning, or a warm lookup and clone) and
    ``compile_wall_ns`` the compile share inside ``translate``, so that what
    the cache saves stays measurable either way."""
    from . import fdo
    from .fingerprint import canonical_fingerprint

    t0 = time.perf_counter_ns()
    canonical = ""
    try:
        canonical = canonical_fingerprint(plan)
    except PORT_FAILURES:
        raise
    except Exception as e:
        # a plan without a fingerprint only loses the cache and feedback
        logger.warning("canonical_fingerprint_failed", error=repr(e))

    def _finish(opt, phys):
        if canonical:
            phys._canonical_fp = canonical
        if stats is not None:
            stats.bump("planning_wall_ns", time.perf_counter_ns() - t0)
        return opt, phys, fdo.apply_query_hints(canonical, cfg, stats)

    def _cold(record_fdo: bool):
        from ..optimizer import optimize
        from ..physical import translate

        # fan-out resizes decline for mesh plans (the collective yields its
        # own partition count, which a reduce-side fan-in would
        # desynchronize) and for plans that write (one file per partition:
        # a repeated write must not change its file count with history)
        fanout_ok = runner != "mesh" and not _has_write(plan)
        with fdo.collecting(cfg, stats, enabled=record_fdo,
                            fanout_ok=fanout_ok) as coll:
            opt = plan if optimized else optimize(plan)
            phys = translate(opt, cfg, stats)
        return opt, phys, coll

    use_cache = cfg.plan_cache and not optimized and canonical
    binding = cfg_key = None
    if use_cache:
        try:
            from .. import faults
            from ..runners import plan_cache_key

            faults.check("plancache.lookup", stats)
            # an armed fault registry stands the cache down: a cached plan
            # would let an armed site (fuse.compile, ...) never fire
            binding = None if faults.any_armed() else plan_cache_key(plan)
            # the runner is part of the key: a mesh plan declines fan-out
            # resizes, so a native plan must never serve it
            cfg_key = (_cfg_key(cfg) + f"|v{CACHE_VERSION}|g{PLAN_CACHE.generation}"
                       f"|r{runner}")
        except PORT_FAILURES:
            raise
        except Exception as e:
            _error(stats, "plan_cache_lookup_failed", e)
            binding = None
    if not use_cache or binding is None:
        opt, phys, _ = _cold(record_fdo=not optimized)
        return _finish(opt, phys)

    full_key = (canonical, cfg_key, binding)
    waited = False
    while True:
        try:
            cp = PLAN_CACHE.lookup(canonical, cfg_key, binding)
        except PORT_FAILURES:
            raise
        except Exception:
            PLAN_CACHE.errors += 1
            cp = None
        if cp is not None:
            if stats is not None:
                stats.bump("plan_cache_hits")
                _event(stats, "hit", fingerprint=canonical)
            try:
                phys = clone_plan(cp.physical)
            except PORT_FAILURES:
                raise
            except Exception as e:
                # a defect of the clone: plan afresh
                _error(stats, "plan_cache_rehydrate_failed", e)
                break
            return _finish(cp.optimized, phys)
        if waited:
            break  # the builder failed or its plan was shed: plan uncached
        ev = PLAN_CACHE.begin_build(full_key)
        if ev is not None:
            # another thread plans this binding: wait, then look again
            waited = True
            if not ev.wait(_SINGLE_FLIGHT_WAIT_S):
                break
            continue
        try:  # this thread owns the build
            opt, phys, coll = _cold(record_fdo=True)
            if stats is not None:
                stats.bump("plan_cache_misses")
                _event(stats, "miss", fingerprint=canonical)
            try:
                cp = CompiledPlan(opt, phys, _estimate_plan_bytes(opt, phys),
                                  fdo_expect=coll.expects)
                PLAN_CACHE.store(canonical, cfg_key, binding, cp, cfg.plan_cache_bytes)
            except PORT_FAILURES:
                raise
            except Exception as e:
                _error(stats, "plan_cache_store_failed", e)
            return _finish(opt, phys)
        finally:
            PLAN_CACHE.end_build(full_key)
    # the fail-open tail: plan uncached (still feedback-informed)
    opt, phys, _ = _cold(record_fdo=True)
    if stats is not None:
        stats.bump("plan_cache_misses")
    return _finish(opt, phys)
