"""Partition-task scheduling: explicit tasks, a bounded dispatch loop and
the dispatch backend of worker processes (the port's copy of
daft_tpu/scheduler.py).

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

``run_map_task`` runs one map partition. Under the distributed runner the
context carries a dispatch backend (``DispatchBackend``: dist/supervisor.py's
WorkerPool), and the task ships to a worker process from inside the pool
thread that runs it, so the dispatch window, the retries, the deadline and
cancellation hold as in-process; the round trip is a ``dist.remote`` phase
span. A task the backend declines runs here.
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


class DispatchBackend:
    """Where a map-class partition task's work runs. The default is the
    in-process pool; an object of this shape on
    ``ExecutionContext.dist_backend`` (dist/supervisor.WorkerPool) routes
    eligible tasks to worker processes instead, through the same dispatch
    window, retries, deadline and cancellation, since the backend call
    happens inside the task function the in-process pool runs."""

    def capacity(self) -> int:
        """Concurrent tasks the backend can absorb."""
        raise NotImplementedError

    def try_execute(self, op, part, ctx, op_name: str, seq: int):
        """Run one map task remotely: ``(out, rows, wall_ns)``, or None when
        the task is ineligible or the backend degraded (the caller runs it
        in-process). Raises the task's terminal error. A backend may read a
        placement hint from the partition (a peer-backed shuffle partition
        prefers the workers hosting its pieces); any ready worker stays a
        legal target."""
        raise NotImplementedError

    # The peer-shuffle extension (dist/peerplane.py), optional: ShuffleOp
    # probes for these and keeps the star path without them.
    #   execute_fanout(part, spec, ctx, op_name, seq)
    #       -> (wid, (host, port), metas) | None
    #   peer_ready() -> bool      any ready worker serving pieces?
    #   new_shuffle_id() -> int   scopes the piece keys of one shuffle
    #   peer_token() -> str       the transport token of peer fetches
    #   drop_shuffles(sids)       the fleet-wide piece drop at query end


def run_map_task(op, part, ctx, op_name: str, seq: int):
    """One map partition: through the context's dispatch backend where there
    is one and it takes the task, else on this thread. Returns ``(out, rows,
    wall_ns)``: ``rows`` is the worker's row count on the remote path (None
    in-process) and ``wall_ns`` the work's own time (the worker's measure
    remotely).

    The remote path runs under a ``dist.remote`` phase span of the driver:
    the backend stamps its submit -> sent -> reply split on it and splices
    the worker's telemetry under it, so the remote queue and transport time
    shows even when a worker's fragment is lost."""
    backend = getattr(ctx, "dist_backend", None)
    if backend is not None:
        prof = ctx.stats.profiler
        sp = prof.begin("dist.remote", op=op_name, part=seq, kind="phase") if prof.armed else None
        try:
            res = backend.try_execute(op, part, ctx, op_name, seq)
        except BaseException:
            if sp is not None:
                prof.end(sp)  # a remote error is still a remote execution
            raise
        if sp is not None:
            # a decline was no remote execution: the span closes unrecorded
            (prof.end if res is not None else prof.cancel)(sp)
        if res is not None:
            return res
    t0 = time.perf_counter_ns()
    out = op.map_partition(part, ctx)
    return out, None, time.perf_counter_ns() - t0


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
