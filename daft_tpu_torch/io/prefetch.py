"""Pipelined scan IO: bounded readahead of scan tasks that follows
consumption (the port's copy of daft_tpu/io/prefetch.py).

When scan partition i is read, the reads of partitions i+1..i+depth
(``ExecutionConfig.scan_prefetch_depth``) are submitted to the query's pool
(``ExecutionContext.pool()``), so the decode of the next files runs on the
host while the current partition is staged and reduced on the card.

- Equal results. A prefetched read goes through the same ``read_chunks`` /
  ``read`` path a synchronous one takes; the wrapper moves only where it
  runs. The scan op emits the partitions in task order, whatever order the
  fetches finish in, and a wrapped partition's metadata (rows, bytes,
  statistics, schema) answers from the task, so routing does not change.
- Driven by consumption. Fetches start when a partition is read, never at
  planning or emission: a query that reads metadata only, a narrowed
  (``head``, ``select_columns``) partition or a pruned task starts no
  background read.
- Charged to the budget. Each fetch in flight charges its size estimate to
  the ledger's ``prefetch_inflight``; past the first fetch in flight,
  submission stops (``prefetch_throttled``) while the charge would pass
  ``memory_budget_bytes``. Every charge is settled when its partition is
  consumed, abandoned (narrowed, or garbage-collected unread), or its
  fetch is cancelled or fails.
- Deadline- and cancel-aware. No fetch is submitted after the query's
  deadline or once its stats handle is cancelled.
- Stands down on the pool. A partition read on a pool worker (a map task
  or a stream producer, ``scheduler.on_pool_worker()``) submits no
  readahead, since the dispatch window already overlaps the workers'
  reads, and its wait stays out of ``io_wait_ns``.
- Free of deadlock on the pool. A consumer never waits for a fetch that is
  still queued: it cancels it and reads itself (``prefetch_misses``); only
  a running fetch is awaited.
- Errors reach the consumer. A failed background fetch re-raises from the
  partition's read on the consumer's thread; the ``prefetch.fetch`` fault
  site fails it on demand. A fetch is not retried: the scan's retry policy
  runs inside the read.

Counters: ``prefetch_submitted``, ``prefetch_hits``, ``prefetch_misses``,
``prefetch_throttled``, ``prefetch_read_ns`` (the background read time) and
``io_wait_ns`` (the time the consumer's thread waited on a read).

Observability: a fetch runs as a ``prefetch.fetch`` bg span parented to
the scan read that submitted it (the profiler's ``capture()``/``activate()``)
and under that thread's query id; a throttle records a ``throttle`` event;
a pool shut down under the prefetcher logs ``prefetch_degraded_sync``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, List, Optional

from ..obs.log import current_query_id, get_logger, query_context

logger = get_logger("prefetch")

_IDLE, _SUBMITTED, _TAKEN, _ABANDONED = "idle", "submitted", "taken", "abandoned"


class _Slot:
    """One task's readahead state, guarded by its prefetcher's lock."""

    __slots__ = ("task", "est_bytes", "state", "future", "charged")

    def __init__(self, task, est_bytes: int):
        self.task = task
        self.est_bytes = est_bytes
        self.state = _IDLE
        self.future = None
        self.charged = False


class ScanPrefetcher:
    """Bounded readahead over one scan's task list."""

    def __init__(self, tasks, ctx, depth: int):
        # reentrant: a future's cancel() runs its settling callback at once,
        # on the thread that cancels, which may hold the lock
        self._lock = threading.RLock()
        self._slots: List[_Slot] = [_Slot(t, t.size_bytes() or 0) for t in tasks]
        self._ctx = ctx
        self._stats = ctx.stats
        self._deadline = ctx.deadline
        self._budget = ctx.memory_budget
        self._depth = max(0, int(depth))
        self._ledger = ctx.ledger
        self._ninflight = 0  # submitted fetches not yet consumed or settled
        self._closed = False

    def wrap(self, idx: int) -> "PrefetchedScanTask":
        return PrefetchedScanTask(self, idx)

    # ------------------------------------------------------------- submission
    def _may_submit(self) -> bool:
        if self._closed or self._stats.is_cancelled():
            return False
        return self._deadline is None or time.monotonic() <= self._deadline

    def ensure_ahead(self, from_idx: int) -> None:
        """Submit the fetches of tasks [from_idx, from_idx + depth) that are
        still idle. A partition's read calls it, so readahead follows
        consumption."""
        if self._depth <= 0 or not self._may_submit():
            return
        with self._lock:
            hi = min(from_idx + self._depth, len(self._slots))
            for j in range(max(from_idx, 0), hi):
                s = self._slots[j]
                if s.state != _IDLE:
                    continue
                # one fetch in flight is always allowed: the one working
                # partition of slack the spill budget grants the consumer's
                # own read. Past it, readahead must fit the headroom
                if (self._ninflight > 0 and self._budget is not None
                        and self._ledger.current + self._ledger.prefetch_inflight
                        + s.est_bytes > self._budget):
                    self._stats.bump("prefetch_throttled")
                    if self._stats.profiler.armed:
                        self._stats.profiler.event("throttle", what="scan_prefetch",
                                                   bytes=s.est_bytes)
                    return  # retried at the next read
                prof = self._stats.profiler
                token = prof.capture() if prof.armed else None
                qid = current_query_id()
                try:
                    fut = self._ctx.pool().submit(self._fetch, j, token, qid)
                except RuntimeError:
                    # the pool was shut down under us: read synchronously
                    logger.debug("prefetch_degraded_sync", task=j)
                    self._closed = True
                    return
                s.state = _SUBMITTED
                s.future = fut
                s.charged = True
                self._ninflight += 1
                self._ledger.prefetch_started(s.est_bytes)
                self._stats.bump("prefetch_submitted")
                # a fetch that the pool's shutdown cancelled, or that failed,
                # holds nothing: its charge settles at once
                fut.add_done_callback(
                    lambda f, s=s: (f.cancelled() or f.exception() is not None)
                    and self._settle(s))

    def _fetch(self, idx: int, span_token=None, qid=None) -> List[Any]:
        """The background fetch (runs on a pool thread). ``span_token`` is
        the submitting thread's captured span and ``qid`` its query id, so
        the fetch and any line it logs are attributed to the scan read that
        triggered it."""
        from .. import faults

        prof = self._stats.profiler
        with query_context(qid):
            sp = None
            if span_token is not None and prof.armed:
                act = prof.activate(span_token)
                act.__enter__()
                sp = prof.begin("prefetch.fetch", part=idx, kind="bg")
            try:
                faults.check("prefetch.fetch", self._stats)
                t0 = time.perf_counter_ns()
                chunks = _read_task_chunks(self._slots[idx].task)
                self._stats.bump("prefetch_read_ns", time.perf_counter_ns() - t0)
                return chunks
            finally:
                if sp is not None:
                    prof.end(sp)
                    act.__exit__(None, None, None)

    # ------------------------------------------------------------ consumption
    def _release_locked(self, s: _Slot) -> None:
        if s.charged:
            s.charged = False
            self._ninflight -= 1
            self._ledger.prefetch_done(s.est_bytes)

    def _settle(self, s: _Slot) -> None:
        with self._lock:
            self._release_locked(s)

    def _read_here(self, s: _Slot, worker: bool) -> List[Any]:
        """Read the task on this thread, the wait counted as io_wait."""
        t0 = time.perf_counter_ns()
        try:
            return _read_task_chunks(s.task)
        finally:
            self._stats.bump("prefetch_misses")
            if not worker:
                self._stats.io_wait(time.perf_counter_ns() - t0)

    def fetch_now(self, idx: int) -> List[Any]:
        """Materialize task ``idx`` (from its fetch when one was submitted,
        on this thread otherwise) and submit the readahead past it. On a
        pool worker the prefetcher stands down: it submits nothing, and the
        worker's reads stay out of io_wait_ns, which means the consumer's
        waits."""
        from ..scheduler import on_pool_worker

        worker = on_pool_worker()
        if not worker:
            self.ensure_ahead(idx + 1)
        with self._lock:
            s = self._slots[idx]
            fut, s.future = s.future, None
            s.state = _TAKEN
        try:
            if fut is None or fut.cancelled():
                # never submitted, or cancelled by the pool's shutdown
                return self._read_here(s, worker)
            if fut.done():
                self._stats.bump("prefetch_hits")
                return fut.result()
            if fut.cancel():
                # still queued behind other work: never wait on a fetch that
                # has not started (that could starve the pool); read here
                return self._read_here(s, worker)
            # running on a pool thread: it will finish, so wait for it
            t0 = time.perf_counter_ns()
            try:
                return fut.result()
            finally:
                self._stats.bump("prefetch_hits")
                if not worker:
                    self._stats.io_wait(time.perf_counter_ns() - t0)
        finally:
            self._settle(s)

    def abandon(self, idx: int) -> None:
        """The wrapper of ``idx`` was narrowed or died unread: stop its fetch
        where it can and return its charge."""
        with self._lock:
            s = self._slots[idx]
            if s.state in (_TAKEN, _ABANDONED):
                return
            s.state = _ABANDONED
            fut, s.future = s.future, None
            if fut is None or fut.cancel():
                self._release_locked(s)
                return

        def settle_when_done(f):
            f.exception()  # retrieved, so that a failed abandoned fetch is quiet
            self._settle(s)

        fut.add_done_callback(settle_when_done)


def _read_task_chunks(task) -> List[Any]:
    """One scan task's reader chunks, through the path a direct read takes
    (a task with ``read_chunks`` keeps its chunks; another reads as one)."""
    read_chunks = getattr(task, "read_chunks", None)
    if read_chunks is not None:
        return list(read_chunks())
    return [task.read()]


class PrefetchedScanTask:
    """A scan task whose read may be served by a finished background fetch.

    Everything but the read surface answers from the wrapped task, so
    metadata and planning do not change. Narrowing (``with_pushdowns``)
    returns the wrapped task narrowed and abandons the full fetch: a narrowed
    read is another read."""

    def __init__(self, queue: ScanPrefetcher, idx: int):
        self._queue = queue
        self._idx = idx
        self._task = queue._slots[idx].task
        # a wrapper that dies unread (a limit, an abandoned stream) returns
        # its charge and frees its fetch's result
        weakref.finalize(self, queue.abandon, idx)

    # --- read surface ----------------------------------------------------
    def read(self):
        from ..table import Table

        chunks = self._queue.fetch_now(self._idx)
        return chunks[0] if len(chunks) == 1 else Table.concat(chunks)

    def read_chunks(self):
        return self._queue.fetch_now(self._idx)

    def with_pushdowns(self, pushdowns):
        self._queue.abandon(self._idx)
        return self._task.with_pushdowns(pushdowns)

    # --- metadata --------------------------------------------------------
    @property
    def materialized_schema(self):
        return self._task.materialized_schema

    @property
    def pushdowns(self):
        return self._task.pushdowns

    def num_rows(self) -> Optional[int]:
        return self._task.num_rows()

    def size_bytes(self) -> Optional[int]:
        return self._task.size_bytes()

    def can_prune(self) -> bool:
        return self._task.can_prune()

    def __getattr__(self, name):
        # anything else (path, format, schema, stats, row groups, ...)
        return getattr(self._task, name)

    def __repr__(self) -> str:
        return f"PrefetchedScanTask#{self._idx}({self._task!r})"


def pipeline_scan_parts(parts, ctx):
    """The scan's emitted partitions, wrapped for readahead through one
    ScanPrefetcher at ``cfg.scan_prefetch_depth``; a partition another
    process owns (``ctx.foreign_owned``) passes through as it is. Depth 0
    leaves the list as built."""
    from ..micropartition import MicroPartition

    depth = ctx.cfg.scan_prefetch_depth
    if depth <= 0 or not parts:
        return parts
    local = [p for p in parts if not ctx.foreign_owned(p)]
    if not local:
        return parts
    queue = ScanPrefetcher([p.scan_task() for p in local], ctx, depth)
    by_id = {id(p): i for i, p in enumerate(local)}
    return [p if id(p) not in by_id
            else MicroPartition.from_scan_task(queue.wrap(by_id[id(p)])).derived_from(p)
            for p in parts]
