"""Sub-plan result cache: the partitions of a Project/Filter/FusedMap chain
over a scan, kept across queries (the port's copy of
daft_tpu/adapt/resultcache.py).

Two queries often share a prefix: ``scan.filter(x)`` under a groupby in one
and under a sort in the other. The whole-plan result cache of ``collect``
(runners.PartitionSetCache) helps only when the whole plan repeats; this
cache keeps the prefix instead. It hooks into ``execution.execute_plan``'s
builder: when a maximal chain of map ops (ProjectOp, FilterOp, FusedMapOp)
ends at a ScanOp, the chain's output partitions are kept on its first
execution (on clean exhaustion only) and replayed by the next query that
plans the same prefix (``subplan_cache_hits``; ``subplan_cache_misses``).

The key is each scan task's exact key (``runners._scan_task_key``: path,
mtime and size, format, pushdowns, schema and options), so an overwritten
file never serves stale rows, plus each chain op's expressions with their
literals (a chain that calls a UDF declines: a UDF may not be
deterministic), plus the config fields results depend on: ``use_device_kernels``,
the device, the 32- or 64-bit mode and the kernel knobs (the reference keys
on its float-affecting knobs; the port's config holds the device and the
mode, whose results differ, as the whole-plan key does).

Entries hold detached Tables, never the query's own MicroPartitions (which
a later spill may unload), and each hit serves fresh MicroPartition
wrappers, so a hit stages its columns again and never shares a spilled
copy. Bytes are LRU-shed under ``subplan_cache_bytes`` and charged to the
memory ledger's ``subplan_cache_bytes`` account. The cache stands aside
under a memory budget, while any fault plan is armed (a replay would hide
an armed ``scan.read``), and fails open: a failure of the key or the store
(the ``resultcache.lookup`` fault site among them) counts
``subplan_cache_errors``, logs ``subplan_cache_key_failed`` or
``subplan_cache_store_failed`` and runs the prefix plainly. A profiled
query records a ``resultcache`` event for a hit and for an insert. Left
out: the persistent tier (persist/resultstore).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterator, List, Optional, Tuple

from ..errors import PORT_FAILURES
from ..obs.log import get_logger

logger = get_logger("resultcache")

__all__ = ["SubplanResultCache", "RESULT_CACHE", "try_result_cache"]


class _Entry:
    __slots__ = ("tables", "nbytes")

    def __init__(self, tables, nbytes: int):
        self.tables = tables
        self.nbytes = nbytes


class SubplanResultCache:
    """Bounded, thread-safe table cache keyed by exact prefix keys."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.errors = 0

    @staticmethod
    def _charge(delta: int) -> None:
        if delta:
            from ..spill import MEMORY_LEDGER

            MEMORY_LEDGER.cache_account("subplan_cache_bytes", delta)

    def get(self, key: str):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return list(e.tables)

    def put(self, key: str, tables, nbytes: int, cap_bytes: int) -> None:
        if nbytes > max(cap_bytes, 0):
            return  # one oversized prefix must not evict everything else
        delta = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                delta -= old.nbytes
            self._entries[key] = _Entry(tables, nbytes)
            self._bytes += nbytes
            delta += nbytes
            self.inserts += 1
            while self._bytes > cap_bytes and len(self._entries) > 1:
                k, shed = self._entries.popitem(last=False)
                if k == key:
                    self._entries[k] = shed
                    self._entries.move_to_end(k, last=False)
                    break
                self._bytes -= shed.nbytes
                delta -= shed.nbytes
                self.evictions += 1
        self._charge(delta)

    def clear(self) -> None:
        """Drop every entry and reset the counters (a cleared cache reads as
        a fresh one)."""
        with self._lock:
            freed = self._bytes
            self._entries.clear()
            self._bytes = 0
            self.hits = self.misses = 0
            self.inserts = self.evictions = self.errors = 0
        self._charge(-freed)

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses, "inserts": self.inserts,
                    "evictions": self.evictions, "errors": self.errors}


RESULT_CACHE = SubplanResultCache()

# the config fields the prefix's results depend on
_CFG_KEY_FIELDS = ("use_device_kernels", "device", "device_x64",
                   "use_segment_sums_kernel", "use_deep_fusion_kernel")


def _chain_over_scan(op) -> Optional[Tuple[list, object]]:
    """(the map-op chain top-down, the scan op) when ``op`` roots a pure
    Project/Filter/FusedMap chain over a ScanOp; None otherwise."""
    from ..fuse.compile import FusedMapOp
    from ..physical import FilterOp, ProjectOp, ScanOp

    chain = []
    cur = op
    while isinstance(cur, (ProjectOp, FilterOp, FusedMapOp)):
        chain.append(cur)
        cur = cur.children[0]
    if not chain or not isinstance(cur, ScanOp):
        return None
    return chain, cur


def _op_key(op) -> str:
    from ..expressions import expr_has_udf
    from ..fuse.compile import FusedMapOp
    from ..physical import FilterOp

    # a FusedMapOp's are the chain's own expressions, as the unfused ops
    # declared them
    exprs = list(op._map_exprs())
    if any(expr_has_udf(e) for e in exprs):
        raise _Decline  # a UDF may not be deterministic: never replayed
    kind = ("fused" if isinstance(op, FusedMapOp)
            else "filter" if isinstance(op, FilterOp) else "project")
    return f"{kind}[{';'.join(repr(e._node._key()) for e in exprs)}]"


class _Decline(Exception):
    pass


def _prefix_key(chain, scan, cfg) -> str:
    from ..runners import _scan_task_key, _Uncacheable

    try:
        scan_part = ";".join(_scan_task_key(t) for t in scan.tasks)
    except _Uncacheable:
        raise _Decline from None
    ops_part = "|".join(_op_key(o) for o in chain)
    cfg_part = ",".join(f"{k}={getattr(cfg, k)!r}" for k in _CFG_KEY_FIELDS)
    return f"{scan_part}||{ops_part}||{cfg_part}"


def try_result_cache(op, ctx, build) -> Optional[Iterator]:
    """The execute_plan builder hook: replay a cached prefix, or tee this
    prefix's output into the cache. None means not applicable (the caller
    builds normally)."""
    from .. import faults

    cfg = ctx.cfg
    if not cfg.subplan_result_cache or ctx.memory_budget is not None:
        # under a budget the ledger and the spill govern the working set: a
        # process-pinned prefix would change what the budget asked for
        return None
    if ctx.partitions_pinned:
        return None  # a mesh or a multi-process run: partitions may be foreign-owned
    if getattr(ctx, "dist_backend", None) is not None:
        # the distributed runner: the workers read their scan tasks
        # themselves, and replaying a driver-pinned prefix would pull the
        # whole scan back into the driver
        return None
    skip = getattr(ctx, "_rc_inner_ops", None)
    if skip is not None and id(op) in skip:
        return None  # an op inside a prefix already being teed above
    found = _chain_over_scan(op)
    if found is None:
        return None
    chain, scan = found
    try:
        faults.check("resultcache.lookup", ctx.stats)
        if faults.any_armed():
            # a replayed prefix would let an armed site (scan.read, ...)
            # never fire: fault-injection runs execute for real
            return None
        key = _prefix_key(chain, scan, cfg)
    except _Decline:
        return None
    except PORT_FAILURES:
        raise
    except Exception as e:
        RESULT_CACHE.errors += 1
        ctx.stats.bump("subplan_cache_errors")
        logger.warning("subplan_cache_key_failed", error=repr(e))
        return None
    tables = RESULT_CACHE.get(key)
    if tables is not None:
        ctx.stats.bump("subplan_cache_hits")
        p = ctx.stats.profiler
        if p.armed:
            p.event("resultcache", kind="hit", parts=len(tables))
        return _replay(tables)
    ctx.stats.bump("subplan_cache_misses")
    # the real stream: the whole chain (op itself included, since build()
    # below enters this hook again) is marked, so that neither the re-entry
    # nor a shorter prefix inside it tees a second entry
    if skip is None:
        skip = ctx._rc_inner_ops = set()
    for inner in chain:
        skip.add(id(inner))
    return _teeing(build(op), key, cfg.subplan_cache_bytes, ctx)


def _replay(tables) -> Iterator:
    from ..micropartition import MicroPartition

    for t in tables:
        yield MicroPartition.from_table(t)


def _teeing(inner, key: str, cap_bytes: int, ctx) -> Iterator:
    """Pass-through that stores the prefix's output on CLEAN exhaustion (a
    limit's early close or an error never stores a partial prefix). Once
    the running total passes the cap the tee lets go of what it held."""
    acc: List = []
    acc_bytes = 0
    abandon = False
    try:
        for p in inner:
            if not abandon:
                if p.is_loaded():
                    acc.append(p)
                    acc_bytes += p.size_bytes() or 0
                    if acc_bytes > cap_bytes:
                        abandon = True
                        acc.clear()
                else:
                    abandon = True  # an unloaded output is not kept
                    acc.clear()
            yield p
    finally:
        close = getattr(inner, "close", None)
        if close is not None:
            close()
    if abandon:
        return
    try:
        tables = [p.table() for p in acc]
        nbytes = sum(p.size_bytes() or 0 for p in acc)
        RESULT_CACHE.put(key, tables, nbytes, cap_bytes)
        p = ctx.stats.profiler
        if p.armed:
            p.event("resultcache", kind="insert", parts=len(tables), nbytes=nbytes)
    except PORT_FAILURES:
        raise
    except Exception as e:
        RESULT_CACHE.errors += 1
        ctx.stats.bump("subplan_cache_errors")
        logger.warning("subplan_cache_store_failed", error=repr(e))
