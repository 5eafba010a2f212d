"""Partition-task scheduling: explicit tasks and a bounded dispatch loop
(the port's copy of daft_tpu/scheduler.py, in-process only).

A ``PartitionTask`` is one partition, the function to run on it and the
resource request the query's accountant admits first. ``dispatch`` runs
tasks on the query's worker pool (``ExecutionContext.pool()``, threads
named ``daft-torch-exec``) while its in-flight window has room (by default
``num_workers + max_task_backlog``) and yields their results in task order.
A request is admitted on the dispatching thread and released by the worker
when its task ends, or by the dispatcher when a queued task is cancelled
before it ran. Cancellation (``RuntimeStats.cancel``) and the deadline are
checked between dispatches. On a budgeted query the finished outputs parked
behind the head-of-line task are charged to the ledger's ``exec_inflight``;
while they exceed a quarter of the budget no task is submitted and the head
is drained instead (``dispatch_backpressure_stalls``). An output that is
never pulled (an early close) settles its charge when its task ends.

A task that raises ``DaftTransientError`` re-runs up to
``task_retry_attempts`` extra times (``run_retrying``: ``task_retries``
and a ``task_retry`` log line). Any other exception, a ``DaftKernelError``
or ``torch.AcceleratorError`` from a kernel launched on a worker among
them, reaches the consumer when it pulls that task's result.

Workers run kernels on the card with the default stream of their device
(``torch.cuda.current_stream``), so the card sees launches in the order the
host threads issue them.

``on_pool_worker()`` marks the threads that run a dispatched task or a
stream producer: the scan readahead (io/prefetch.py) stands down there,
since the dispatch window already overlaps the workers' reads, and
``io_wait_ns`` keeps meaning the time the consumer's thread waited.

Left out: the dispatch backend of worker processes (``DispatchBackend``,
the ``dist.remote`` span), which comes with the distributed runner
(ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

from .micropartition import MicroPartition
from .obs.log import current_query_id, query_context

# marks threads executing a dispatched partition task
_WORKER_TL = threading.local()


def on_pool_worker() -> bool:
    return getattr(_WORKER_TL, "active", False)


# process-wide count of dispatched, unfinished partition tasks: health()'s
# view of the scheduler's in-flight window
_inflight_lock = threading.Lock()
_inflight = 0


def inflight_tasks() -> int:
    with _inflight_lock:
        return _inflight


def _inflight_add(n: int) -> None:
    global _inflight
    with _inflight_lock:
        _inflight += n


def _result_bytes(out) -> int:
    """The ledger charge of a parked task output: loaded partitions only, so
    that the accounting never reads a file. A shuffle's fan-out task returns
    a list of pieces."""
    if isinstance(out, MicroPartition):
        parts = (out,)
    elif isinstance(out, (list, tuple)):
        parts = tuple(p for p in out if isinstance(p, MicroPartition))
    else:
        return 0
    return sum(p.size_bytes() or 0 for p in parts if p.is_loaded())


def run_map_task(op, part, ctx):
    """One map partition on this thread (in-process; the reference's dispatch
    backend of worker processes comes with item 10): the output and the
    map's wall time in ns."""
    t0 = time.perf_counter_ns()
    out = op.map_partition(part, ctx)
    return out, time.perf_counter_ns() - t0


def run_retrying(fn, ctx, op_name: str, seq: int):
    """``fn()``, re-run after a ``DaftTransientError`` up to
    ``task_retry_attempts`` extra times with the scan reads' retry policy.
    Cancellation and the deadline are checked before each re-run, which
    counts ``task_retries`` and logs ``task_retry``."""
    extra = max(0, ctx.cfg.task_retry_attempts)
    if extra == 0:
        return fn()
    from .errors import DaftTransientError
    from .execution import QueryCancelledError
    from .io.object_store import RetryPolicy
    from .obs.log import get_logger

    tries = [0]

    def attempt():
        if tries[0]:
            if ctx.stats.is_cancelled():
                raise QueryCancelledError(f"query cancelled (retrying {op_name})")
            ctx.check_deadline()
            ctx.stats.bump("task_retries")
            get_logger("scheduler").warning("task_retry", op=op_name, seq=seq,
                                            attempt=tries[0])
        tries[0] += 1
        return fn()

    return RetryPolicy(attempts=extra + 1, backoff_s=ctx.cfg.task_retry_backoff_s,
                       retryable=(DaftTransientError,)).run(attempt)


def _await_result(task: "PartitionTask", fut, ctx) -> MicroPartition:
    """The head-of-line task's result. Blocked time is ``dispatch_wait_ns``
    and the pulling op's ``queue_wait`` phase; a task cancelled before it
    ran returns its reservation and surfaces as query cancellation."""
    from concurrent.futures import CancelledError

    from .execution import QueryCancelledError

    try:
        if fut.done():
            out = fut.result()
        else:
            t0 = time.perf_counter_ns()
            try:
                out = fut.result()
            finally:
                ctx.stats.dispatch_wait(time.perf_counter_ns() - t0)
        if task.held_bytes:
            # the output leaves the window: it is the consumer's working unit
            ctx.ledger.exec_done(task.held_bytes)
            task.held_bytes = 0
        return out
    except CancelledError:
        _inflight_add(-1)
        if task.resource_request:
            ctx.accountant.release(task.resource_request)
        if ctx.progress is not None:
            ctx.progress.task_finished()
        raise QueryCancelledError("query cancelled (queued task cancelled)") from None


class PartitionTask:
    """One unit of per-partition work. ``span_token``/``submit_ns`` carry the
    dispatching thread's profiler context across the pool hop and
    ``query_id`` its log context; ``held_bytes`` is the output's
    ``exec_inflight`` charge while it waits in the window."""

    __slots__ = ("partition", "fn", "resource_request", "op_name", "seq",
                 "span_token", "submit_ns", "query_id", "held_bytes")

    def __init__(self, partition: MicroPartition, fn: Callable, resource_request=None,
                 op_name: str = "task", seq: int = 0):
        self.partition = partition
        self.fn = fn
        self.resource_request = resource_request
        self.op_name = op_name
        self.seq = seq
        self.span_token = None
        self.submit_ns = 0
        self.query_id = None
        self.held_bytes = 0

    def run(self) -> MicroPartition:
        return self.fn(self.partition)

    def __repr__(self) -> str:
        return f"PartitionTask({self.op_name}#{self.seq})"


def dispatch(tasks: Iterator[PartitionTask], ctx,
             window: Optional[int] = None) -> Iterator[MicroPartition]:
    """Run ``tasks`` on the query's pool with a bounded in-flight window and
    yield their results in task order (see the module docstring)."""
    from .execution import QueryCancelledError

    if window is None:
        backlog = ctx.cfg.max_task_backlog
        if backlog < 0:  # one backlog slot per worker
            backlog = ctx.num_workers
        window = ctx.num_workers + backlog
    window = max(1, window)
    budget = ctx.memory_budget
    exec_cap = None if budget is None else max(1, budget // 4)
    pool = ctx.pool()
    pending: deque = deque()
    progress = ctx.progress

    def run_task(task: PartitionTask) -> MicroPartition:
        _WORKER_TL.active = True
        prof = ctx.stats.profiler
        sp = None
        qctx = query_context(task.query_id)
        qctx.__enter__()
        if prof.armed:
            # the task's op span, parented to the dispatching thread's span;
            # the wait from submit to start is its queue_wait phase
            act = prof.activate(task.span_token)
            act.__enter__()
            sp = prof.begin(task.op_name, op=task.op_name, part=task.seq)
            if task.submit_ns:
                sp.add_phase("queue_wait", time.perf_counter_ns() - task.submit_ns)
        else:
            act = None
        try:
            out = run_retrying(task.run, ctx, task.op_name, task.seq)
            held = _result_bytes(out)
            if held:
                # the output now waits behind the head-of-line task
                task.held_bytes = held
                ctx.ledger.exec_started(held)
            return out
        finally:
            _WORKER_TL.active = False
            if sp is not None:
                prof.end(sp)
            if act is not None:
                act.__exit__(None, None, None)
            qctx.__exit__(None, None, None)
            # drop the input now: the output may wait behind a slow head
            task.partition = None
            if task.resource_request:
                ctx.accountant.release(task.resource_request)
            _inflight_add(-1)
            if progress is not None:
                progress.task_finished()

    prof = ctx.stats.profiler
    try:
        for task in tasks:
            if ctx.stats.is_cancelled():
                raise QueryCancelledError(f"query cancelled (at {task.op_name})")
            ctx.check_deadline()
            if task.resource_request:
                ctx.accountant.admit(task.resource_request)
            if prof.armed:
                task.span_token = prof.capture()
                task.submit_ns = time.perf_counter_ns()
            task.query_id = current_query_id()
            _inflight_add(1)
            if progress is not None:
                progress.task_started()
            pending.append((task, pool.submit(run_task, task)))
            while len(pending) >= window or (
                    exec_cap is not None and pending and ctx.ledger.exec_inflight > exec_cap):
                if exec_cap is not None and len(pending) < window \
                        and ctx.ledger.exec_inflight > exec_cap:
                    ctx.stats.bump("dispatch_backpressure_stalls")
                yield _await_result(*pending.popleft(), ctx)
        while pending:
            # the deadline stays cooperative through the drain
            ctx.check_deadline()
            yield _await_result(*pending.popleft(), ctx)
    finally:
        for task, fut in pending:
            if fut.cancel():
                # queued, never ran: return its admission
                _inflight_add(-1)
                if task.resource_request:
                    ctx.accountant.release(task.resource_request)
                if progress is not None:
                    progress.task_finished()
            else:
                # running, or done and never pulled: settle its parked
                # output's charge when it ends (at once when already done)
                def _settle(f, t=task):
                    if t.held_bytes:
                        ctx.ledger.exec_done(t.held_bytes)
                        t.held_bytes = 0

                fut.add_done_callback(_settle)
