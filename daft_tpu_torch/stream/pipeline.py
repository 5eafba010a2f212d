"""The morsel-driven pipeline driver.

``try_stream`` inspects a physical op while the executor builds its tree
and, when the op roots a streamable segment (``[Limit?] -> {Project |
Filter | FusedMap | BatchedUdf}* -> source``), replaces the whole segment
with one pipelined stream:

- producers (one pool task per source partition, a window of one per
  worker in flight by default, the fan-out ``_parallel_map`` gives the
  partition path) cut the partition into morsels (``iter_morsels``) and
  run every map op of the segment on each, pushing the results into that
  partition's :class:`BoundedChannel`;
- the consumer (the pulling thread) drains the channels in source order and
  re-chunks the morsels into partitions at the segment's top, so the ops
  above keep whole partitions and the rows equal those with
  ``cfg.streaming_execution`` off;
- a Limit sink consumes morsels directly: the first partition leaves once
  enough morsels exist, and reaching the limit closes every channel, so
  producers stop reading what nobody will use (``morsels_short_circuited``
  counts what was abandoned).

The morsel contract: an op streams when it declares ``morsel_streamable``
and implements ``map_partition``, calls no UDF unless batch-declared (a
UDF might depend on its batch) and requests no resources. On the device
path the chain streams only in device-morsel mode (``device_residency``
on, every map device-pipelinable, an in-memory partition above the morsel
size): each morsel stages and runs on the card by itself, and the
aggregate above still sees whole partitions.

Errors: a producer's failure (an injected ``scan.read`` fault, a
``DaftKernelError`` from a kernel it launched) parks on its channel and
re-raises on the consumer's thread at the next pull, never a hung channel;
the consumer's teardown (a limit, cancellation, the deadline, a closed
generator) closes every channel, so blocked producers stop at once.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterator, List, Optional

from ..micropartition import MicroPartition
from .channel import WAIT, BoundedChannel, ChannelClosed
from .morsel import iter_morsels

__all__ = ["try_stream", "extract_segment", "StreamSegment"]

# how long the consumer waits on an empty channel before checking the
# deadline, cancellation and its producer again (a cancelled producer must
# surface as query cancellation, never a hang)
_POLL_S = 0.05


class _StopSignal(threading.Event):
    """Cooperative stop for producers. ``short_circuit`` tells an unwinding
    producer whether the stop was a deliberate early end (a limit reached,
    a close from above: the avoided work counts as
    ``morsels_short_circuited``) or a teardown after an error, a
    cancellation or the deadline (not counted: a failed query's record must
    not read as if a limit fired)."""

    short_circuit = False


def _map_streamable(op, ctx) -> bool:
    """The morsel contract: declared streamable (``morsel_streamable``), a
    map op, row-local (no UDF unless batch-declared: a UDF sees whole
    partitions on the partition path and may depend on its batch) and no
    resource request (admission is per partition task, not per morsel)."""
    from ..execution import op_resource_request
    from ..expressions import expr_has_udf

    if not getattr(op, "morsel_streamable", False) \
            or op.map_partition is None:
        return False
    if len(op.children) != 1:
        return False
    if any(expr_has_udf(e) for e in op._map_exprs()) \
            and not getattr(op, "batch_declared", False):
        # a batch-declared UDF (physical.BatchedUdfOp) streams: its
        # declaration is a row-locality contract, and each producer gives it
        # a BatchingExecutor of its own (_produce_once)
        return False
    if op_resource_request(op):
        return False
    return True


class StreamSegment:
    """One streamable chain: ``maps`` bottom-up over ``source``, with an
    optional row ``limit`` on top. ``count_source`` marks a Scan or
    InMemory source the producers read themselves and record time for (a
    generic source is pulled through its own traced stream instead)."""

    __slots__ = ("maps", "limit", "source", "count_source")

    def __init__(self, maps: List, limit: Optional[int], source,
                 count_source: bool):
        self.maps = maps
        self.limit = limit
        self.source = source
        self.count_source = count_source


def extract_segment(op, ctx) -> Optional[StreamSegment]:
    """The maximal streamable segment rooted at ``op``, or None when
    streaming would change nothing (no map, and no limit over a direct
    source: the plain pull is as good there)."""
    from ..physical import InMemoryOp, LimitOp, ScanOp

    limit = None
    cur = op
    if isinstance(cur, LimitOp) and type(cur) is LimitOp:
        limit = cur.limit
        cur = cur.children[0]
    maps: List = []
    while _map_streamable(cur, ctx):
        maps.append(cur)
        cur = cur.children[0]
    maps.reverse()  # bottom-up application order
    source = cur
    direct = isinstance(source, (ScanOp, InMemoryOp))
    if not maps and not (limit is not None and direct):
        return None
    return StreamSegment(maps, limit, source, count_source=direct)


def try_stream(op, ctx, build, trace: bool = True):
    """A pipelined partition stream replacing the segment rooted at ``op``,
    or None when the op or the config does not stream. ``build`` is the
    executor's recursive stream builder, used for a generic segment base."""
    cfg = ctx.cfg
    if not cfg.streaming_execution:
        return None
    if cfg.use_device_kernels:
        # the device path wants whole partitions: one launch over one staged
        # partition beats many small ones. Except in device-morsel mode
        # (device_residency): a chain whose every map is device-pipelinable
        # stages each morsel and runs its program on it. A chain with a host
        # map declines: every morsel would make an arrow round trip the
        # partition path avoids
        if not cfg.device_residency:
            return None
        probe = extract_segment(op, ctx)
        if probe is None or not probe.maps or not all(
                m.device_pipelinable(ctx) for m in probe.maps):
            return None
        # only where slicing subdivides: a partition at or under the morsel
        # size is one launch already, and the partition path's
        # double-buffered dispatch pipelines it better
        from ..physical import InMemoryOp as _InMem
        msz = max(1, int(cfg.morsel_size_rows))
        src = probe.source
        if not (isinstance(src, _InMem)
                and any((p.num_rows_or_none() or 0) > msz for p in src.parts)):
            return None
    if ctx.partitions_pinned:
        # a mesh or a multi-process run: partitions are pinned to slots and
        # processes, and morsels would read foreign partitions
        return None
    if getattr(ctx, "dist_backend", None) is not None:
        # the distributed runner ships map work to worker processes a
        # partition at a time: morsel channels here would keep it in the
        # driver
        return None
    seg = extract_segment(op, ctx)
    if seg is None:
        return None
    from ..physical import InMemoryOp, ScanOp

    src = seg.source
    if isinstance(src, ScanOp):
        def parts_fn():
            prof = ctx.stats.profiler
            with prof.span("scan.plan", kind="phase"):
                parts = src.plan_parts(ctx)
            return iter(parts), True
    elif isinstance(src, InMemoryOp):
        def parts_fn():
            return iter(src.parts), True
    else:
        def parts_fn():
            # a generic base: partitions pulled through the upstream stream,
            # built (and traced) as usual, on the consumer's thread
            return build(src), False
    top = seg.maps[-1] if seg.maps else op
    return _run_segment(seg, parts_fn, ctx, top, trace)


def _run_segment(seg: StreamSegment, parts_fn, ctx, top_op,
                 trace: bool) -> Iterator[MicroPartition]:
    """The consumer: the producer window, the in-order drain of the
    channels, the morsel-to-partition re-chunk (or the limit sink) and the
    teardown."""
    from .. import tracing
    from ..execution import QueryCancelledError, _tl

    cfg = ctx.cfg
    stats = ctx.stats
    prof = stats.profiler
    morsel_rows = max(1, int(cfg.morsel_size_rows))
    capacity = max(1, int(cfg.stream_channel_capacity))
    window = int(cfg.stream_producer_window)
    if window <= 0:
        # one producer per worker: streaming replaces _parallel_map's fan-out
        # and must not run fewer maps at once (the per-channel byte cap below
        # divides the budget's share by the window)
        window = max(1, ctx.num_workers)
    budget = ctx.memory_budget
    # per-channel byte cap: a quarter of the budget split across the window
    # (one morsel is always admitted)
    max_bytes = None if budget is None else max(1, budget // (4 * window))
    out_schema = seg.maps[-1].schema if seg.maps else seg.source.schema
    top_name = top_op.name()
    stop = _StopSignal()
    pool = ctx.pool()
    pending: deque = deque()  # (channel, future)
    src_iter, skippable = parts_fn()
    state = {"exhausted": False, "closed": False}

    from ..obs.log import current_query_id

    qid = current_query_id()

    def submit_next() -> bool:
        if state["exhausted"]:
            return False
        part = next(src_iter, None)
        if part is None:
            state["exhausted"] = True
            return False
        chan = BoundedChannel(capacity, max_bytes=max_bytes,
                              ledger=ctx.ledger, stats=stats)
        token = prof.capture() if prof.armed else None
        fut = pool.submit(_produce_partition, seg, part, chan, ctx, stop,
                          morsel_rows, token, qid)
        pending.append((chan, fut))
        return True

    def shutdown(short_circuit: bool) -> None:
        # the first close wins and fixes the short-circuit attribution: the
        # teardown may shut an orphaned segment down through close_streams()
        # before the suspended generator closes with short_circuit=True
        if state["closed"]:
            return
        state["closed"] = True
        if short_circuit:
            stop.short_circuit = True
        stop.set()
        while pending:
            chan, fut = pending.popleft()
            if fut.cancel() and short_circuit:
                # the producer never ran: its whole partition was skipped
                stats.bump("morsels_short_circuited")
            chan.close()
        if short_circuit and skippable and not state["exhausted"]:
            # count the source partitions the early stop never read (the
            # rest of the parts list, read for its length only)
            n = sum(1 for _ in src_iter)
            if n:
                stats.bump("morsels_short_circuited", n)
            state["exhausted"] = True
        elif not skippable:
            close = getattr(src_iter, "close", None)
            if close is not None:
                close()

    def drain_head(remaining):
        """Drain the head channel into a morsel list: (morsels, rows, new
        remaining, limit reached). The time blocked on the channel counts as
        dispatch wait (the queue_wait phase), so a starved pipeline shows as
        one. Every ``get`` is timed, also one that ends with a morsel: a
        producer-bound pipeline blocks on each get without reaching the
        timeout."""
        chan, fut = pending[0]
        morsels: List[MicroPartition] = []
        rows = 0
        hit = False
        waited_ns = 0
        while True:
            t0g = time.perf_counter_ns()
            got = chan.get(timeout=_POLL_S)
            waited_ns += time.perf_counter_ns() - t0g
            if got is WAIT:
                if stats.is_cancelled():
                    raise QueryCancelledError(
                        f"query cancelled (at {top_name})")
                ctx.check_deadline()
                if fut.cancelled():
                    raise QueryCancelledError(
                        "query cancelled (stream producer cancelled)")
                if fut.done():
                    # a producer that died without fail() must surface,
                    # never hang the channel
                    exc = fut.exception()
                    if exc is not None:
                        raise exc
                continue
            if got is None:
                break
            m = got
            n = len(m)
            if remaining is not None and rows + n >= remaining:
                if rows + n > remaining:
                    m = m.head(remaining - rows)
                    n = len(m)
                hit = True
            morsels.append(m)
            rows += n
            if hit:
                break
        pending.popleft()
        if hit:
            # the head producer may still run (or wait in put()): close its
            # channel too, since shutdown() sees only the channels still
            # pending and a parked producer would hold a worker for good.
            # The stop is flagged as the limit's first, so the unwinding
            # producer counts its abandoned work as short-circuited
            stop.short_circuit = True
            chan.close()
        stats.bump_max("stream_channel_high_water", chan.high_water)
        if waited_ns:
            stats.dispatch_wait(waited_ns)
        if remaining is not None:
            remaining -= rows
        return morsels, rows, remaining, hit

    remaining = seg.limit
    seq = 0
    short_circuit = False
    # while this generator is suspended at a yield, only the registry can
    # shut it down when the chain above dies (a `for` loop never closes its
    # input, and an exception's traceback keeps the frame alive)
    token = ctx.register_stream(shutdown)
    try:
        if remaining is not None and remaining <= 0:
            return
        while True:
            if stats.is_cancelled():
                raise QueryCancelledError(f"query cancelled (at {top_name})")
            ctx.check_deadline()
            # the consumer's op span covers the submits and the head drain,
            # so the producers' morsel spans captured at submit parent to it
            sp = (prof.begin(top_name, op=top_name, part=seq)
                  if trace and prof.armed else None)
            t0 = time.perf_counter_ns()
            stack = None
            if trace:
                # _traced's self-time stack, so the parent op's self time
                # excludes this pull
                stack = getattr(_tl, "stack", None)
                if stack is None:
                    stack = _tl.stack = []
                stack.append(0)
            pulled = False
            try:
                while len(pending) < window and submit_next():
                    pass
                if not pending:
                    return
                morsels, rows, remaining, hit = drain_head(remaining)
                pulled = True
            finally:
                if stack is not None:
                    dt = time.perf_counter_ns() - t0
                    stack.pop()
                    if stack:
                        stack[-1] += dt
                if sp is not None:
                    if pulled:
                        sp.set_attr("rows", rows)
                        prof.end(sp)
                    else:
                        prof.cancel(sp)
            out = _rechunk(morsels, out_schema)
            seq += 1
            if trace:
                tracing.report_progress(top_name, rows)
            yield out
            if hit:
                # the limit is reached: stop every producer
                short_circuit = True
                shutdown(short_circuit=True)
                return
    except GeneratorExit:
        # a deliberate close from above (a LimitOp, an abandoned iterator):
        # the avoided work is a short-circuit. An error, a cancellation or
        # the deadline reach the finally uncounted
        short_circuit = True
        raise
    finally:
        shutdown(short_circuit=short_circuit)
        ctx.unregister_stream(token)


def _part_bytes(part: MicroPartition) -> int:
    b = part.size_bytes()
    return b if b is not None else 0


def _rechunk(morsels: List[MicroPartition], out_schema) -> MicroPartition:
    """The morsel-to-partition re-chunk: ONE table, what the partition path's
    map would have produced (a partition of several tables could change how
    an op above sums its floats)."""
    from ..table import Table

    tables = [t for m in morsels for t in m._tables if len(t)]
    if not tables:
        return MicroPartition.empty(out_schema)
    if len(tables) == 1:
        return MicroPartition.from_table(tables[0])
    return MicroPartition.from_table(Table.concat(tables))


def _produce_partition(seg: StreamSegment, part: MicroPartition, chan,
                       ctx, stop: threading.Event, morsel_rows: int,
                       token, qid) -> None:
    """One producer (one source partition, on the query's pool): cut it into
    morsels, run the segment's maps on each and push the results into the
    channel. Each morsel's work is a ``morsel`` span parented (through
    ``token``) to the consumer's op span, and each op's rows and wall time
    go to the stats. A failure parks on the channel for the consumer; a
    close (a limit) unwinds quietly as a short-circuit."""
    from .. import scheduler
    from ..obs.log import query_context

    stats = ctx.stats
    prof = stats.profiler
    scheduler._WORKER_TL.active = True
    act = prof.activate(token) if prof.armed else None
    if act is not None:
        act.__enter__()
    try:
        with query_context(qid):
            try:
                _produce_with_retry(seg, part, chan, ctx, stop, morsel_rows)
                chan.finish()
            except ChannelClosed:
                if stop.short_circuit:
                    stats.bump("morsels_short_circuited")
            except BaseException as e:
                chan.fail(e)
    finally:
        if act is not None:
            act.__exit__(None, None, None)
        scheduler._WORKER_TL.active = False


def _produce_with_retry(seg: StreamSegment, part: MicroPartition, chan,
                        ctx, stop: threading.Event,
                        morsel_rows: int) -> None:
    """The producer's loop under the scheduler's retry contract
    (``task_retry_attempts``): a ``DaftTransientError`` (a ``scan.read``
    fault past the scan's own retries leaves the partition unloaded and
    readable again) re-runs the partition, but only while nothing has been
    pushed (a retry after a push would repeat rows the consumer has; that
    case fails the query as any other error does)."""
    from ..errors import DaftTransientError
    from ..execution import QueryCancelledError
    from ..obs.log import get_logger

    stats = ctx.stats
    retries_left = max(0, ctx.cfg.task_retry_attempts)
    while True:
        try:
            _produce_once(seg, part, chan, ctx, stop, morsel_rows)
            return
        except DaftTransientError:
            if chan.pushed or retries_left <= 0:
                raise
            if stats.is_cancelled():
                raise QueryCancelledError(
                    f"query cancelled (retrying {seg.source.name()})")
            ctx.check_deadline()
            retries_left -= 1
            stats.bump("task_retries")
            get_logger("stream").warning(
                "stream_task_retry", op=seg.source.name(),
                attempts_left=retries_left)
            time.sleep(max(0.0, ctx.cfg.task_retry_backoff_s))


def _batch_executors(seg: StreamSegment, ctx) -> dict:
    """One BatchingExecutor per batch-declared map of the segment, owned by
    this producer (one partition): morsels coalesce across their boundaries
    within the partition, and the outputs re-split to the morsel boundaries
    the unbatched path gives."""
    execs: dict = {}
    if not ctx.cfg.dynamic_batching:
        return execs
    for i, mop in enumerate(seg.maps):
        if getattr(mop, "batch_declared", False):
            from ..batch.executor import BatchingExecutor

            execs[i] = BatchingExecutor(mop.name(), mop.exprs, ctx,
                                        settings=mop._settings(ctx))
    return execs


def _produce_once(seg: StreamSegment, part: MicroPartition, chan, ctx,
                  stop: threading.Event, morsel_rows: int) -> None:
    stats = ctx.stats
    prof = stats.profiler
    src_name = seg.source.name()
    execs = _batch_executors(seg, ctx)

    def apply_maps(ms, i0):
        """Run morsels through maps[i0:]. A batch stage may hold morsels back
        (still coalescing) or release several at once, each with its source
        boundaries."""
        for i in range(i0, len(seg.maps)):
            mop = seg.maps[i]
            bx = execs.get(i)
            nxt = []
            for m in ms:
                t0 = time.perf_counter_ns()
                outs = bx.feed(m) if bx is not None \
                    else [mop.map_partition(m, ctx)]
                stats.record_op(mop.name(), sum(len(o) for o in outs),
                                time.perf_counter_ns() - t0,
                                sum(_part_bytes(o) for o in outs))
                nxt.extend(outs)
            ms = nxt
        return ms

    try:
        t_read = time.perf_counter_ns()
        for m in iter_morsels(part, morsel_rows):
            read_ns = time.perf_counter_ns() - t_read
            if stop.is_set():
                if getattr(stop, "short_circuit", False):
                    stats.bump("morsels_short_circuited")
                return
            sp = (prof.begin("morsel", kind="bg")
                  if prof.armed else None)
            outs = []
            try:
                if seg.count_source:
                    # the chunk's decode ran in iter_morsels' pull: it is
                    # the bypassed source's time
                    stats.record_op(src_name, len(m), read_ns,
                                    _part_bytes(m))
                outs = apply_maps([m], 0)
            finally:
                if sp is not None:
                    sp.set_attr("rows", sum(len(o) for o in outs))
                    prof.end(sp)
            stats.bump("stream_morsels")
            for o in outs:
                chan.put(o, _part_bytes(o))
            t_read = time.perf_counter_ns()
        # the partition's end: drain each batch stage bottom-up (a lower
        # stage's tail flows through every stage above it)
        for i in sorted(execs):
            if stop.is_set():
                return
            t0 = time.perf_counter_ns()
            tail = execs[i].finish()
            stats.record_op(seg.maps[i].name(),
                            sum(len(o) for o in tail),
                            time.perf_counter_ns() - t0,
                            sum(_part_bytes(o) for o in tail))
            for o in apply_maps(tail, i + 1):
                chan.put(o, _part_bytes(o))
    finally:
        # a stop or an error with morsels still buffered: settle their
        # batch_inflight charge without running the apply
        for bx in execs.values():
            bx.abort()
