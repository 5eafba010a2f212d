"""Bounded-memory execution: spillable partition buffers (the port's copy of
daft_tpu/spill.py).

Every pipeline breaker that holds many partitions (the shuffle's buckets and
its range input, the hash join's two sides, the sort-merge join's inputs and
buckets) appends them to a ``PartitionBuffer``. Once the query's ledger would
pass ``ExecutionConfig.memory_budget_bytes``, a further partition is written
as an arrow IPC file in the query's spill directory and handed back as an
UNLOADED MicroPartition; the consumer reads it back when it needs it, so the
engine holds about the budget plus one working partition.

- async spill writes (``async_spill_writes``): the IPC write runs on a
  bounded writer thread per query; the partition's tables stay resident
  (``async_spill_inflight``) until the write lands. A write that fails
  holds the partition in memory, as the synchronous path does.
- unspill readahead (``unspill_readahead``): while the consumer works on
  partition i of a drain, partition i+1's read runs on a background
  thread; the shuffle preloads bucket i+1 while bucket i merges. A failure
  of a background read re-raises on the consumer thread.
- integrity (``partition_integrity``): each landed file's crc32 is recorded
  and verified at read-back; every damage mode (a mismatch, a garbled IPC
  stream, a missing file) raises ``DaftCorruptionError``, or recomputes the
  partition through its lineage recipe where one was recorded
  (``lineage_recomputation``).

The writer thread and the readahead read and write host arrow only: no
CUDA call runs on them. A spilled partition loads on the thread that asks
for its table, and its columns stage on the card there.

The ledger also carries the plan cache's, the sub-plan result cache's and
the pinned model actors' resident bytes (``cache_account`` of
``plan_cache_bytes``, ``subplan_cache_bytes`` and ``model_cache_bytes``),
the scan readahead's in-flight fetches (``prefetch_inflight``,
io/prefetch.py), the batching executor's buffered partitions
(``batch_inflight``, batch/coalesce.py), the morsels queued in the stream
channels (``stream_inflight``, stream/channel.py) and the finished task
outputs parked in the scheduler's dispatch window (``exec_inflight``,
scheduler.py), all outside ``current``. A buffer's spill decision charges
``current`` and all four against the budget, as the reference does.

Observability: a spill records a ``spill`` event (``mode`` sync or async)
and a throttled unspill preload a ``throttle`` event; the async write runs
as a ``spill.write`` bg span and a readahead load as a ``spill.read`` bg
span, each parented to the op that caused it through the profiler's
``capture()``/``activate()`` and run under the query id of the thread that
submitted it. A failed write logs ``spill_write_failed`` (or
``spill_disk_full``), a double release ``ledger_negative_release``, and a
recompute ``partition_recomputed`` (or ``spill_lineage_truncated``,
``lineage_recompute_failed``), with a ``partition_recomputed`` event.

Left out: the ledger's accounts for producers the port does not have yet
(streaming channels, the scheduler's parked outputs, distributed workers)
and the child ledgers of the serving runtime.
"""

from __future__ import annotations

import errno
import os
import shutil
import tempfile
import threading
import time
import weakref
from typing import Callable, List, Optional

import pyarrow as pa

from . import faults
from .errors import DaftCorruptionError, DaftInternalError, DaftTransientError
from .micropartition import MicroPartition
from .obs.log import current_query_id, get_logger, query_context

logger = get_logger("spill")
from .table import Table

# marks threads running background IO (unspill readahead): a spill read on
# one of them overlaps the consumer, so it does not count into io_wait_ns
_BG_IO = threading.local()

# the spill directory's prefix in the temp directory
SPILL_DIR_PREFIX = "daft_tpu_torch_spill_"


def _in_background_io() -> bool:
    return getattr(_BG_IO, "active", False)


class MemoryLedger:
    """Account of the bytes held by partition buffers, with its high-water
    mark, the spilled totals and the spill write and read throughput."""

    def __init__(self):
        self._lock = threading.Lock()
        self.current = 0
        self.high_water = 0
        self.spilled_bytes = 0
        self.spilled_partitions = 0
        # releases that would have driven `current` negative (double-release
        # bugs): clamped at 0 and counted so leak tests can assert
        self.negative_releases = 0
        # partitions handed to the async writer whose bytes stay resident
        # until the write lands (not in `current`: transient write-side
        # state, bounded by the writer's queue depth)
        self.async_spill_inflight = 0
        # spill write/read throughput totals (file bytes + wall ns)
        self.spill_write_bytes = 0
        self.spill_write_ns = 0
        self.unspill_bytes = 0
        self.unspill_ns = 0
        # spill writes that failed with ENOSPC: a full spill device turns a
        # bounded-memory engine back into an in-memory one
        self.disk_full_events = 0
        # the plan cache's resident bytes (adapt/plancache.py): not in
        # `current`, since they are process-lifetime state shed by the cache's
        # own cap, not a query's working set the spill reacts to
        self.plan_cache_bytes = 0
        # the sub-plan result cache's resident bytes (adapt/resultcache.py),
        # outside `current` for the same reason
        self.subplan_cache_bytes = 0
        # the scan readahead's fetches in flight (io/prefetch.py). Not in
        # `current`: the prefetcher caps itself against current + this, but
        # a charge in `current` would make every pipeline breaker's append
        # see a full ledger and spill its whole input
        self.prefetch_inflight = 0
        # the bytes of partitions the dynamic-batching executor buffers
        # between feed and flush (batch/coalesce.py). Not in `current`, for
        # the prefetch_inflight reason; settled at every flush, so a nonzero
        # balance after a query is a leak
        self.batch_inflight = 0
        self.batch_inflight_high_water = 0
        # the pinned model actors' resident weight bytes (batch/actors.py),
        # a process cache account like plan_cache_bytes
        self.model_cache_bytes = 0
        # the morsel bytes queued in the stream channels between producers and
        # the consumer (stream/channel.py), outside `current` for the
        # prefetch_inflight reason; bounded by the channel capacity times the
        # producer window
        self.stream_inflight = 0
        self.stream_inflight_high_water = 0
        # the payload bytes of tasks shipped to distributed workers and not
        # answered yet (dist/supervisor.py): the driver still holds them.
        # Outside `current` for the prefetch_inflight reason
        self.dist_inflight = 0
        self.dist_inflight_high_water = 0
        # the finished map-task outputs parked in the scheduler's dispatch
        # window behind the head-of-line task (scheduler.dispatch): charged
        # when a task finishes, released when the consumer pulls it; outside
        # `current` for the prefetch_inflight reason
        self.exec_inflight = 0
        self.exec_inflight_high_water = 0
        # peak of current + stream_inflight + prefetch_inflight +
        # exec_inflight + batch_inflight: the working set the ledger sees,
        # which the spill decision holds to the budget
        self.working_set_high_water = 0

    def cache_account(self, account: str, delta: int) -> None:
        """Charge or release a process cache account (``plan_cache_bytes``,
        ``subplan_cache_bytes``, ``model_cache_bytes``); clamped at 0."""
        if account not in ("plan_cache_bytes", "subplan_cache_bytes", "model_cache_bytes"):
            from .errors import DaftValueError

            raise DaftValueError(f"unknown cache account {account!r}")
        with self._lock:
            setattr(self, account, max(0, getattr(self, account) + delta))

    def disk_full(self) -> None:
        with self._lock:
            self.disk_full_events += 1

    def _note_working_set_locked(self) -> None:
        self.working_set_high_water = max(
            self.working_set_high_water,
            self.current + self.stream_inflight + self.prefetch_inflight
            + self.exec_inflight + self.batch_inflight)

    def add(self, n: int) -> None:
        with self._lock:
            self.current += n
            self.high_water = max(self.high_water, self.current)
            self._note_working_set_locked()

    def sub(self, n: int) -> None:
        with self._lock:
            if n > self.current:
                # double release: clamp rather than poison every later
                # budget decision with a negative balance, and count it
                self.negative_releases += 1
                logger.warning("ledger_negative_release", released=n, current=self.current)
                self.current = 0
            else:
                self.current -= n

    def spilled(self, n: int) -> None:
        with self._lock:
            self.spilled_bytes += n
            self.spilled_partitions += 1

    def prefetch_started(self, n: int) -> None:
        with self._lock:
            self.prefetch_inflight += n
            self._note_working_set_locked()

    def prefetch_done(self, n: int) -> None:
        with self._lock:
            self.prefetch_inflight -= min(n, self.prefetch_inflight)

    def stream_started(self, n: int) -> None:
        with self._lock:
            self.stream_inflight += n
            self.stream_inflight_high_water = max(self.stream_inflight_high_water,
                                                  self.stream_inflight)
            self._note_working_set_locked()

    def stream_done(self, n: int) -> None:
        with self._lock:
            self.stream_inflight -= min(n, self.stream_inflight)

    def exec_started(self, n: int) -> None:
        with self._lock:
            self.exec_inflight += n
            self.exec_inflight_high_water = max(self.exec_inflight_high_water,
                                                self.exec_inflight)
            self._note_working_set_locked()

    def exec_done(self, n: int) -> None:
        with self._lock:
            self.exec_inflight -= min(n, self.exec_inflight)

    def dist_started(self, n: int) -> None:
        with self._lock:
            self.dist_inflight += n
            self.dist_inflight_high_water = max(self.dist_inflight_high_water,
                                                self.dist_inflight)

    def dist_done(self, n: int) -> None:
        with self._lock:
            self.dist_inflight -= min(n, self.dist_inflight)

    def batch_started(self, n: int) -> None:
        with self._lock:
            self.batch_inflight += n
            self.batch_inflight_high_water = max(self.batch_inflight_high_water,
                                                 self.batch_inflight)
            self._note_working_set_locked()

    def batch_done(self, n: int) -> None:
        with self._lock:
            self.batch_inflight -= min(n, self.batch_inflight)

    def async_spill_started(self, n: int) -> None:
        with self._lock:
            self.async_spill_inflight += n

    def async_spill_done(self, n: int) -> None:
        with self._lock:
            self.async_spill_inflight = max(0, self.async_spill_inflight - n)
            self.spilled_bytes += n
            self.spilled_partitions += 1

    def async_spill_abandoned(self, n: int) -> None:
        """The write was never submitted (writer closed): nothing in flight."""
        with self._lock:
            self.async_spill_inflight = max(0, self.async_spill_inflight - n)

    def async_spill_failed(self, n: int) -> None:
        """The write failed, so the partition is held in memory after all:
        its bytes move from the in-flight balance into `current` (the
        holding task's finalizer returns them)."""
        with self._lock:
            self.async_spill_inflight = max(0, self.async_spill_inflight - n)
            self.current += n
            self.high_water = max(self.high_water, self.current)
            self._note_working_set_locked()

    def record_spill_write(self, nbytes: int, ns: int) -> None:
        with self._lock:
            self.spill_write_bytes += nbytes
            self.spill_write_ns += ns

    def record_unspill(self, nbytes: int, ns: int) -> None:
        with self._lock:
            self.unspill_bytes += nbytes
            self.unspill_ns += ns

    _ACCOUNTS = ("current", "high_water", "spilled_bytes", "spilled_partitions",
                 "negative_releases", "async_spill_inflight", "spill_write_bytes",
                 "spill_write_ns", "unspill_bytes", "unspill_ns", "disk_full_events",
                 "plan_cache_bytes", "subplan_cache_bytes", "prefetch_inflight",
                 "batch_inflight", "batch_inflight_high_water", "model_cache_bytes",
                 "stream_inflight", "stream_inflight_high_water", "exec_inflight",
                 "exec_inflight_high_water", "dist_inflight", "dist_inflight_high_water",
                 "working_set_high_water")

    def reset(self) -> None:
        with self._lock:
            for k in self._ACCOUNTS:
                setattr(self, k, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: getattr(self, k) for k in self._ACCOUNTS}


MEMORY_LEDGER = MemoryLedger()

_SPILL_LOCK = threading.Lock()
_SPILL_SEQ = [0]
# IPC body codec for spill files: None writes uncompressed, so a write is a
# copy into the page cache and the read-back a plain file read
_SPILL_CODEC: Optional[str] = None
# writes queued or in flight on the async writer before append() waits:
# bounds the resident not-yet-written bytes to about this many partitions
_SPILL_WRITER_DEPTH = 4


class AsyncSpillWriter:
    """Bounded single-thread writer for async spill writes.

    ``submit`` blocks while _SPILL_WRITER_DEPTH jobs are queued or in flight
    (the caller counts that wait into io_wait_ns). An exception a job did not
    handle itself (a defect: write failures are handled by the job's
    hold-in-memory fallback) is recorded and re-raised at the next
    ``check_deadline`` or drain via ``raise_errors``."""

    def __init__(self, depth: int = _SPILL_WRITER_DEPTH):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="daft-torch-spill-writer")
        self._slots = threading.Semaphore(max(1, depth))
        self._lock = threading.Lock()
        self._errors: List[BaseException] = []
        self._closed = False

    def submit(self, job: Callable[[], None]) -> bool:
        """Queue a write job; blocks while the queue is full. False when the
        writer is already closed (the caller writes synchronously)."""
        with self._lock:
            if self._closed:
                return False
        self._slots.acquire()

        def run():
            try:
                job()
            except BaseException as e:  # surfaced at the next barrier
                with self._lock:
                    self._errors.append(e)
            finally:
                self._slots.release()

        try:
            self._pool.submit(run)
        except RuntimeError:  # closed between the check and the submit
            self._slots.release()
            return False
        return True

    def raise_errors(self) -> None:
        with self._lock:
            if not self._errors:
                return
            err = self._errors.pop(0)
        raise DaftInternalError(f"async spill writer failed: {err!r}") from err

    def close(self) -> None:
        """Wait for every queued write, then stop the thread (called before
        the spill directory is removed)."""
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=True)


class SpillScope:
    """One query's spill directory (created on first use, prefixed
    ``daft_tpu_torch_spill_``), its recycled file slots and its async writer.

    A consumed spill file's path returns to a free list when its task is
    garbage-collected, and the next spill overwrites it: a live reference
    always means the slot was not reused. ``cleanup`` drains the writer
    before removing the directory, so no write races the removal."""

    def __init__(self):
        self._dir: Optional[str] = None
        self._free_slots: List[str] = []
        self._slot_gen: dict = {}
        self._writer: Optional[AsyncSpillWriter] = None
        self._lock = threading.Lock()

    def take_slot(self) -> Optional[str]:
        with self._lock:
            if not self._free_slots:
                return None
            path = self._free_slots.pop()
            # a new generation of bytes owns this path: a reader holding the
            # previous one must not re-read it
            self._slot_gen[path] = self._slot_gen.get(path, 0) + 1
            return path

    def recycle(self, path: str) -> None:
        with self._lock:
            # a late task GC after cleanup() must not feed dead paths to the
            # next query
            if self._dir is not None and path.startswith(self._dir + os.sep):
                self._free_slots.append(path)

    def generation(self, path: str) -> int:
        with self._lock:
            return self._slot_gen.get(path, 0)

    def dir(self) -> str:
        with self._lock:
            if self._dir is None or not os.path.isdir(self._dir):
                self._dir = tempfile.mkdtemp(prefix=SPILL_DIR_PREFIX)
            return self._dir

    def writer(self) -> AsyncSpillWriter:
        with self._lock:
            if self._writer is None:
                self._writer = AsyncSpillWriter()
            return self._writer

    def raise_async_errors(self) -> None:
        """Surface the writer's recorded errors at a barrier (check_deadline,
        drain)."""
        with self._lock:
            w = self._writer
        if w is not None:
            w.raise_errors()

    def cleanup(self) -> None:
        # drain the writer outside the scope lock: write jobs touch the
        # scope's bookkeeping, and close() waits for them
        with self._lock:
            w, self._writer = self._writer, None
        if w is not None:
            w.close()
        with self._lock:
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
                self._dir = None
            self._free_slots.clear()
            self._slot_gen.clear()


class _SpillSlotTask:
    """The scan task of a spilled partition: one read of its file, by copy
    (plain file reads, so no live buffer aliases the slot). The slot returns
    to the scope's free list when the task is garbage-collected
    (weakref.finalize in ``_try_spill``); the read result is held by weakref,
    so forked references (``head``, ``select_columns``) share one read
    without a hidden strong cache pinning memory past its consumers."""

    def __init__(self, path: str, schema, num_rows: int, size_bytes: int,
                 scope: SpillScope, rt_stats=None, ledger=None,
                 expected_crc: Optional[int] = None, lineage=None, lineage_key=None):
        self.path = path
        self.schema = schema
        self.num_rows_exact = num_rows
        # captured at spill time: the file stops describing this partition
        # once the slot recycles
        self.size_bytes_exact = size_bytes
        self._rt_stats = rt_stats
        self._ledger = ledger if ledger is not None else MEMORY_LEDGER
        self._scope = scope
        self._cached_ref = None
        # the slot's generation when it was taken for this partition
        self._slot_gen: int = scope.generation(path)
        # serializes the one read per task
        self._read_lock = threading.Lock()
        # crc32 of the file as written (None: checksums off)
        self.expected_crc = expected_crc
        # (LineageLog, recipe key): a corrupt or missing file recomputes
        self._lineage = lineage
        self._lineage_key = lineage_key

    @property
    def materialized_schema(self):
        return self.schema

    def num_rows(self) -> Optional[int]:
        return self.num_rows_exact

    def size_bytes(self) -> Optional[int]:
        return self.size_bytes_exact

    def read(self) -> Table:
        with self._read_lock:
            if self._cached_ref is not None:
                tbl = self._cached_ref()
                if tbl is not None:
                    return tbl
            # each read-back is a fault site, on the consumer thread or the
            # readahead thread alike
            faults.check("spill.readback", self._rt_stats)
            tbl = self._materialize_locked()
            self._cached_ref = weakref.ref(tbl)
            return tbl

    def _materialize_locked(self) -> Table:
        """The file read (verified), called under the read lock. A corrupt,
        garbled or missing file raises DaftCorruptionError, unless the
        lineage log still holds this partition's recipe: then the partition
        is recomputed from its source (``partitions_recomputed``)."""
        if self._scope.generation(self.path) != self._slot_gen:
            # the free list handed out a slot a live task could still read
            raise DaftInternalError(
                f"spill slot {self.path} was re-taken while a live reference could "
                "still read it; this is an engine bug")
        try:
            return self._read_file_locked()
        except DaftCorruptionError as e:
            tbl = self._recompute_locked(e)
            if tbl is not None:
                return tbl
            raise

    def _read_file_locked(self) -> Table:
        """Verify and parse the spill file: a checksum mismatch, a garbled
        IPC stream and a missing file each raise DaftCorruptionError."""
        t0 = time.perf_counter_ns()
        try:
            if self.expected_crc is not None:
                from .integrity.checksum import crc32_file

                got = crc32_file(self.path)
                if got != self.expected_crc:
                    if self._rt_stats is not None:
                        self._rt_stats.bump("corruption_detected")
                    raise DaftCorruptionError(
                        f"spill file {self.path} failed its integrity check "
                        f"(crc {got:#010x} != {self.expected_crc:#010x})")
            with pa.OSFile(self.path) as f:
                arrow_tbl = pa.ipc.open_file(f).read_all()
        except FileNotFoundError as e:
            raise DaftCorruptionError(f"spill file {self.path} missing at unspill: {e!r}") from e
        except DaftCorruptionError:
            raise
        except (pa.ArrowException, OSError) as e:
            if self._rt_stats is not None:
                self._rt_stats.bump("corruption_detected")
            raise DaftCorruptionError(f"spill file {self.path} unreadable: {e!r}") from e
        dt = time.perf_counter_ns() - t0
        self._ledger.record_unspill(self.size_bytes_exact, dt)
        if self._rt_stats is not None:
            self._rt_stats.bump("spill_read_bytes", self.size_bytes_exact)
            self._rt_stats.bump("spill_read_ns", dt)
            if not _in_background_io():
                # the consumer thread itself waited on this read
                self._rt_stats.io_wait(dt)
        return _from_spilled_arrow(arrow_tbl, self.schema)

    def _recompute_locked(self, cause) -> Optional[Table]:
        """Re-derive the partition through its recorded recipe: the Table,
        or None when lineage is truncated (no recipe, or an evicted one) or
        the source could not be read again; the caller then raises
        ``cause``."""
        log = self._lineage
        recipe = log.get(self._lineage_key) if log is not None else None
        if recipe is None:
            if self._rt_stats is not None:
                self._rt_stats.bump("lineage_truncated")
            logger.warning("spill_lineage_truncated", path=self.path, cause=repr(cause))
            return None
        try:
            tbl = _concat_chunk_tables(recipe())
        except (OSError, pa.ArrowException) as e:
            # the source's own read failed: the original corruption stands
            logger.warning("lineage_recompute_failed", path=self.path, error=repr(e),
                           cause=repr(cause))
            return None
        if self._rt_stats is not None:
            self._rt_stats.bump("partitions_recomputed")
            if self._rt_stats.profiler.armed:
                self._rt_stats.profiler.event("partition_recomputed", path=self.path,
                                              rows=len(tbl))
        logger.warning("partition_recomputed", path=self.path, rows=len(tbl),
                       cause=repr(cause))
        return tbl

    # head() and select_columns() on an unloaded partition narrow its task:
    # a spill task applies the pushdowns to its one read
    @property
    def pushdowns(self):
        from .io.scan import Pushdowns

        return Pushdowns()

    def with_pushdowns(self, pd):
        return _SpillSlotView(self, pd)

    def __repr__(self) -> str:
        return f"_SpillSlotTask({self.path}, rows={self.num_rows_exact})"


class _AsyncSpillSlotTask(_SpillSlotTask):
    """A spill slot whose IPC write is still in flight on the writer thread.
    Until the write lands, the partition's tables stay on the task (counted
    in ``async_spill_inflight``) and a read serves them; a failed write
    keeps them, the synchronous path's hold-in-memory fallback found late."""

    def __init__(self, path: str, schema, num_rows: int, size_bytes: int,
                 scope: SpillScope, tables, rt_stats=None, ledger=None,
                 reader=None, lineage=None, lineage_key=None):
        super().__init__(path, schema, num_rows, size_bytes, scope,
                         rt_stats=rt_stats, ledger=ledger,
                         lineage=lineage, lineage_key=lineage_key)
        # reader: reads before the write lands go through it (an encoded
        # exchange payload: `tables` then holds arrow tables, which the
        # reader decodes)
        self._reader = reader
        self._tables = list(tables) if reader is None else None
        # keeps the encoded payload alive until the write lands
        self._enc_tables = list(tables) if reader is not None else None
        # bytes this task holds in the ledger's `current` after a failed
        # write; shared with the finalizer so the charge settles once
        self._held_cell = {"bytes": 0}

    def _write_done(self, file_bytes: int, crc: Optional[int] = None) -> None:
        with self._read_lock:
            self._tables = None
            self._reader = None
            self._enc_tables = None
            self.size_bytes_exact = file_bytes
            self.expected_crc = crc

    def _write_failed(self, size: int) -> None:
        with self._read_lock:
            self._held_cell["bytes"] = size

    def _materialize_locked(self) -> Table:
        if self._reader is not None:
            if self._rt_stats is not None:
                self._rt_stats.bump("spill_mem_reads")
            return self._reader()
        if self._tables is not None:
            if self._rt_stats is not None:
                self._rt_stats.bump("spill_mem_reads")
            return _concat_chunk_tables(self._tables)
        return super()._materialize_locked()

    def __repr__(self) -> str:
        return f"_AsyncSpillSlotTask({self.path}, rows={self.num_rows_exact})"


def _settle_sync_slot(scope: SpillScope, path: str, lineage, lineage_key) -> None:
    """Finalizer of a synchronous spill task: recycle the slot and drop the
    lineage recipe (an unreachable slot never needs recomputing)."""
    scope.recycle(path)
    if lineage is not None:
        lineage.forget(lineage_key)


def _settle_async_slot(scope: SpillScope, path: str, held_cell: dict,
                       ledger=None, lineage=None, lineage_key=None) -> None:
    """Finalizer of an async spill task: as above, and return the bytes a
    failed write left held in the ledger."""
    scope.recycle(path)
    if lineage is not None:
        lineage.forget(lineage_key)
    held = held_cell.get("bytes", 0)
    if held:
        held_cell["bytes"] = 0
        (ledger if ledger is not None else MEMORY_LEDGER).sub(held)


class _SpillSlotView:
    """A column or limit pushdown applied over a spill task's single read
    (``head`` and ``select_columns`` set no filters)."""

    def __init__(self, task, pd):
        self._task = task
        self.pushdowns = pd
        self.schema = task.schema

    @property
    def materialized_schema(self):
        if self.pushdowns.columns is None:
            return self._task.materialized_schema
        return self.schema.select([c for c in self.pushdowns.columns if c in self.schema])

    def num_rows(self) -> Optional[int]:
        n = self._task.num_rows()
        if n is None:
            return None
        if self.pushdowns.limit is not None:
            return min(n, self.pushdowns.limit)
        return n

    def size_bytes(self) -> Optional[int]:
        return self._task.size_bytes()

    def with_pushdowns(self, pd):
        return _SpillSlotView(self._task, pd)

    def read(self) -> Table:
        tbl = self._task.read()
        pd = self.pushdowns
        if pd.columns is not None:
            # the pushdown's column order wins
            tbl = tbl.select_columns([c for c in pd.columns if c in tbl.schema.field_names()])
        if pd.limit is not None and len(tbl) > pd.limit:
            tbl = tbl.slice(0, pd.limit)
        return tbl


def _concat_chunk_tables(tbls) -> Table:
    """A chunk list as ONE Table, every chunk cast to the first one's schema,
    as the IPC writer casts its batches, so that memory-served and
    recomputed reads equal the file round trip."""
    if len(tbls) == 1:
        return tbls[0]
    s0 = tbls[0].schema
    return Table.concat([t if t.schema == s0 else t.cast_to_schema(s0) for t in tbls])


def _from_spilled_arrow(arrow_tbl, schema) -> Table:
    """A read-back file as a Table of the partition's engine schema
    (dictionary columns of an encoded piece decode here)."""
    from .series import Series

    arrow_tbl = arrow_tbl.combine_chunks()
    return Table(schema, [Series.from_arrow(arrow_tbl.column(i), f.name, f.dtype)
                          for i, f in enumerate(schema)])


def _is_disk_full(e: BaseException) -> bool:
    return isinstance(e, OSError) and e.errno == errno.ENOSPC


def _classify_spill_failure(e: BaseException, path: str, mode: str, ledger: "MemoryLedger",
                            stats) -> None:
    """Count a failed spill write (synchronous or async). A full disk
    (ENOSPC) is counted apart (``spill_disk_full``, the ledger's
    ``disk_full_events``) and its partial file removed, so a later unspill
    can never read a torn IPC stream off a recycled slot."""
    if _is_disk_full(e):
        ledger.disk_full()
        if stats is not None:
            stats.bump("spill_disk_full")
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        logger.warning("spill_disk_full", mode=mode, path=path, error=repr(e))
    else:
        logger.warning("spill_write_failed", mode=mode, path=path, error=repr(e))
    if stats is not None:
        stats.bump("spill_write_failures")


# what a spill write may fail with and still hold the partition in memory:
# the disk (OSError, ENOSPC among them), arrow, and the injected fault (a
# DaftTransientError, itself an OSError); anything else reaches the caller
SPILL_WRITE_FAILURES = (OSError, pa.ArrowException, faults.InjectedFault)


def _write_spill_ipc(path: str, tbls) -> int:
    """Arrow IPC spill write, one record batch per chunk (a multi-piece
    bucket is never concatenated just to be spilled). Entries are engine
    Tables or arrow tables (an encoded exchange payload: dictionary columns
    write natively, so spilled exchange bytes stay encoded). Returns the
    bytes written."""
    atbls = [t if isinstance(t, pa.Table) else t.to_arrow() for t in tbls]
    schema = atbls[0].schema
    opts = pa.ipc.IpcWriteOptions(compression=_SPILL_CODEC)
    with pa.OSFile(path, "wb") as f, pa.ipc.new_file(f, schema, options=opts) as w:
        for at in atbls:
            if at.schema != schema:
                at = at.cast(schema)
            w.write_table(at)
    return os.path.getsize(path)


class _bg_span:
    """``with _bg_span(prof, token, name) as sp``: a ``bg`` span on a
    background thread, parented to the captured ``token`` (None, and no
    span, when the query is not profiled)."""

    __slots__ = ("_prof", "_token", "_name", "_act", "_sp")

    def __init__(self, prof, token, name: str):
        self._prof, self._token, self._name = prof, token, name
        self._act = self._sp = None

    def __enter__(self):
        if self._token is not None:
            self._act = self._prof.activate(self._token)
            self._act.__enter__()
            self._sp = self._prof.begin(self._name, kind="bg")
        return self._sp

    def __exit__(self, *exc):
        if self._sp is not None:
            self._prof.end(self._sp)
            self._act.__exit__(None, None, None)
        return False


def _corrupt_if_armed(path: str, stats) -> None:
    """The ``spill.corrupt`` site: an armed plan flips a real bit of the
    landed file after its checksum was recorded."""
    try:
        faults.check("spill.corrupt", stats)
    except DaftTransientError:
        from .integrity.checksum import flip_file_bits

        flip_file_bits(path)


class PartitionBuffer:
    """Append MicroPartitions; past the budget they spill to arrow IPC files
    and come back lazy. Iterating yields partitions in append order.

    ``async_spill`` routes the writes through the scope's writer thread;
    ``readahead`` (a submit callable, the query's background pool) reads
    drain()'s spilled partitions one ahead of the consumer. Both are off
    for a buffer built directly; the ExecutionContext wires them from the
    config."""

    def __init__(self, budget_bytes: Optional[int], stats=None,
                 scope: Optional[SpillScope] = None, async_spill: bool = False,
                 readahead: Optional[Callable] = None,
                 ledger: Optional[MemoryLedger] = None,
                 integrity: bool = False, lineage=None):
        self.budget = budget_bytes
        self.stats = stats
        self.scope = scope or SpillScope()
        self.async_spill = async_spill
        self.ledger = ledger if ledger is not None else MEMORY_LEDGER
        # spill writes record a crc32 of the landed file, read-backs verify
        # it; `lineage` (a LineageLog) records the recipes of spilled
        # partitions that have one
        self.integrity = integrity
        self.lineage = lineage
        self._readahead = readahead
        self._items: List[Optional[MicroPartition]] = []
        self._held: List[int] = []

    def append(self, part: MicroPartition) -> None:
        size = part.size_bytes() or 0
        # the query's working set: buffered bytes, the stream channels'
        # morsels, the scan readahead's fetches in flight, the task outputs
        # parked in the dispatch window and the batching executor's buffered
        # partitions eat the same budget
        if (self.budget is not None and len(part)
                and (self.ledger.current + self.ledger.stream_inflight
                     + self.ledger.prefetch_inflight + self.ledger.exec_inflight
                     + self.ledger.batch_inflight + size > self.budget)):
            spilled = self._try_spill(part, size)
            if spilled is not None:
                self._items.append(spilled)
                self._held.append(0)
                return
        self.ledger.add(size)
        self._items.append(part)
        self._held.append(size)

    def _take_path(self) -> str:
        path = self.scope.take_slot()
        if path is None:
            with _SPILL_LOCK:
                _SPILL_SEQ[0] += 1
                seq = _SPILL_SEQ[0]
            path = os.path.join(self.scope.dir(), f"spill_{seq}.arrow")
        return path

    def _lineage_key_for(self, part: MicroPartition):
        """Record this partition's recompute recipe, if it has one, in the
        query's LineageLog; the recipe key, or None (truncated lineage)."""
        if self.lineage is None:
            return None
        recipe = part.lineage_recipe
        if recipe is None:
            # a partition that IS a re-readable scan task's output
            from .integrity.lineage import task_recipe, unwrap_source_task

            src = unwrap_source_task(part)
            if src is None:
                return None
            recipe = task_recipe(src)
        return self.lineage.record(recipe)

    def _try_spill(self, part: MicroPartition, size: int) -> Optional[MicroPartition]:
        # lineage first: the recipe check reads the partition's lazy state
        lineage_key = self._lineage_key_for(part)
        task0 = part.scan_task()
        enc = getattr(task0, "encoded_payload", None) if task0 is not None else None
        if enc is not None:
            # an encoded exchange piece spills its encoded arrow payload as
            # it is; the read-back decodes it
            tbls = enc()
            schema = part.schema
            nrows = len(part)
            reader = task0.read
        else:
            tbls = part.chunk_tables()
            if any(f.dtype.is_python() for f in tbls[0].schema):
                # python-object columns have no arrow representation: hold
                # the partition in memory, as a failed write does
                if self.stats is not None:
                    self.stats.bump("spill_write_failures")
                return None
            schema = tbls[0].schema
            nrows = sum(len(t) for t in tbls)
            reader = None
        path = self._take_path()
        if self.async_spill:
            out = self._spill_async(path, tbls, size, schema, nrows, reader, lineage_key)
            if out is not None:
                return out
            # the writer is closed: write synchronously
        try:
            faults.check("spill.write", self.stats)
            t0 = time.perf_counter_ns()
            file_bytes = _write_spill_ipc(path, tbls)
            dt = time.perf_counter_ns() - t0
        except SPILL_WRITE_FAILURES as e:
            # hold the partition in memory; the slot goes back on the list
            _classify_spill_failure(e, path, "sync", self.ledger, self.stats)
            self.scope.recycle(path)
            if lineage_key is not None:
                self.lineage.forget(lineage_key)
            return None
        crc = None
        if self.integrity:
            from .integrity.checksum import crc32_file

            crc = crc32_file(path)
        _corrupt_if_armed(path, self.stats)
        self.ledger.spilled(size)
        self.ledger.record_spill_write(file_bytes, dt)
        if self.stats is not None:
            self.stats.bump("spilled_partitions")
            self.stats.bump("spill_write_bytes", file_bytes)
            self.stats.bump("spill_write_ns", dt)
            # a synchronous spill stalls the breaker for the whole write
            self.stats.io_wait(dt)
            if self.stats.profiler.armed:
                self.stats.profiler.event("spill", mode="sync", rows=nrows, bytes=file_bytes)
        task = _SpillSlotTask(path, schema, nrows, file_bytes, self.scope,
                              rt_stats=self.stats, ledger=self.ledger, expected_crc=crc,
                              lineage=self.lineage, lineage_key=lineage_key)
        # the slot recycles when nothing can read it any more: task GC
        weakref.finalize(task, _settle_sync_slot, self.scope, path, self.lineage, lineage_key)
        return MicroPartition.from_scan_task(task)

    def _spill_async(self, path: str, tbls, size: int, schema, nrows: int,
                     reader=None, lineage_key=None) -> Optional[MicroPartition]:
        """Hand the write to the scope's writer thread; the partition
        returned is consumable at once (reads serve the resident tables,
        or decode an encoded payload, until the write lands)."""
        writer = self.scope.writer()
        mem_bytes = sum((t.nbytes if isinstance(t, pa.Table) else t.size_bytes())
                        for t in tbls)
        task = _AsyncSpillSlotTask(path, schema, nrows, mem_bytes, self.scope, tbls,
                                   rt_stats=self.stats, ledger=self.ledger, reader=reader,
                                   lineage=self.lineage, lineage_key=lineage_key)
        stats, ledger, integrity = self.stats, self.ledger, self.integrity
        # the submitting thread's span and query id: the write, on the
        # writer thread, is attributed to the op and query that spilled
        prof = stats.profiler if stats is not None else None
        token = prof.capture() if prof is not None and prof.armed else None
        qid = current_query_id()

        def job():
            # host arrow only: no CUDA call runs on the writer thread
            with query_context(qid), _bg_span(prof, token, "spill.write") as sp:
                try:
                    faults.check("spill.write", stats)
                    t0 = time.perf_counter_ns()
                    file_bytes = _write_spill_ipc(path, tbls)
                    dt = time.perf_counter_ns() - t0
                except SPILL_WRITE_FAILURES as e:
                    # as the synchronous path, found late: hold in memory
                    _classify_spill_failure(e, path, "async", ledger, stats)
                    ledger.async_spill_failed(size)
                    task._write_failed(size)
                    return
                crc = None
                if integrity:
                    from .integrity.checksum import crc32_file

                    crc = crc32_file(path)
                _corrupt_if_armed(path, stats)
                ledger.async_spill_done(size)
                ledger.record_spill_write(file_bytes, dt)
                task._write_done(file_bytes, crc)
                if stats is not None:
                    stats.bump("spilled_partitions")
                    stats.bump("spill_write_bytes", file_bytes)
                    stats.bump("spill_write_ns", dt)
                if sp is not None:
                    sp.set_attr("bytes", file_bytes)
                    prof.event("spill", mode="async", rows=nrows, bytes=file_bytes)

        ledger.async_spill_started(size)
        t0 = time.perf_counter_ns()
        submitted = writer.submit(job)
        backpressure = time.perf_counter_ns() - t0
        if not submitted:
            ledger.async_spill_abandoned(size)
            return None
        if stats is not None and backpressure > 1_000_000:
            # a full writer queue: the only disk stall left on append
            stats.io_wait(backpressure)
            stats.bump("spill_backpressure_ns", backpressure)
        weakref.finalize(task, _settle_async_slot, self.scope, path, task._held_cell,
                         self.ledger, self.lineage, lineage_key)
        return MicroPartition.from_scan_task(task)

    def __len__(self) -> int:
        return len(self._items)

    def parts(self) -> List[MicroPartition]:
        return list(self._items)

    def preload(self) -> None:
        """Read spilled items back in the background (the shuffle calls this
        on bucket i+1 while bucket i merges). At least one load is issued,
        further ones while their bytes fit in the budget
        (``preload_throttled`` counts a stop). A failed background load
        leaves the partition unloaded, and the consumer's own read raises."""
        if self._readahead is None:
            return
        submitted_bytes = 0
        for p in self._items:
            if p is None or p.is_loaded():
                continue
            est = p.size_bytes() or 0
            if (submitted_bytes and self.budget is not None
                    and submitted_bytes + est > self.budget):
                if self.stats is not None:
                    self.stats.bump("preload_throttled")
                    if self.stats.profiler.armed:
                        self.stats.profiler.event("throttle", what="unspill_preload", bytes=est)
                return
            self._submit_load(p)
            submitted_bytes += est

    def _submit_load(self, part: MicroPartition):
        prof = self.stats.profiler if self.stats is not None else None
        token = prof.capture() if prof is not None and prof.armed else None
        qid = current_query_id()

        def job():
            # host arrow only: the columns stage on the consumer thread
            _BG_IO.active = True
            try:
                with query_context(qid), _bg_span(prof, token, "spill.read"):
                    return part.table()
            finally:
                _BG_IO.active = False

        try:
            fut = self._readahead(job)
        except RuntimeError:  # the pool is shut down: the consumer reads
            return None
        if fut is not None:
            # retrieve a background exception even when nobody waits: the
            # partition stays unloaded, and the consumer's read raises it
            fut.add_done_callback(lambda f: None if f.cancelled() else f.exception())
            if self.stats is not None:
                self.stats.bump("unspill_readahead_submitted")
        return fut

    def drain(self):
        """Yield the partitions in append order, dropping each reference as
        it is handed out, so that a spilled partition's table lives only for
        the consumer's one iteration. With readahead, the next spilled
        partition's read runs in the background while the consumer works; a
        background failure re-raises here, at that partition's hand-off."""
        self.scope.raise_async_errors()
        pending_idx = -1
        pending_fut = None
        for i in range(len(self._items)):
            part, self._items[i] = self._items[i], None
            self.ledger.sub(self._held[i])
            self._held[i] = 0
            if pending_idx == i and pending_fut is not None:
                self._await_load(pending_fut)
                pending_fut = None
            if self._readahead is not None and pending_fut is None:
                j = i + 1
                while (j < len(self._items) and self._items[j] is not None
                       and self._items[j].is_loaded()):
                    j += 1
                if j < len(self._items) and self._items[j] is not None:
                    pending_fut = self._submit_load(self._items[j])
                    pending_idx = j
            yield part
        self._items = []
        self._held = []

    def _await_load(self, fut) -> None:
        """Resolve a readahead future before handing its partition out. A
        load that has not started is cancelled, and the consumer reads it
        itself."""
        if fut.cancelled():
            if self.stats is not None:
                self.stats.bump("unspill_readahead_misses")
            return
        if fut.done():
            if self.stats is not None:
                self.stats.bump("unspill_readahead_hits")
            fut.result()  # a background failure re-raises to the consumer
            return
        if fut.cancel():
            if self.stats is not None:
                self.stats.bump("unspill_readahead_misses")
            return
        t0 = time.perf_counter_ns()
        try:
            fut.result()
        finally:
            if self.stats is not None:
                self.stats.bump("unspill_readahead_hits")
                self.stats.io_wait(time.perf_counter_ns() - t0)

    def release(self) -> None:
        """Return the held bytes to the ledger and drop the partitions (once
        the buffer's contents were consumed downstream)."""
        self.ledger.sub(sum(self._held))
        self._items = []
        self._held = []
