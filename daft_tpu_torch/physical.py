"""Physical plan: operators that execute partition streams (the port's copy
of the part of daft_tpu/physical.py this slice runs).

An aggregation directly over a filter fuses into FusedFilterAggregateOp
(``fuse_for_device``): on the device path the predicate stays a mask that
feeds the masked segment reductions, with no host compaction between them.
TPC-H Q1 plans as Sort <- FusedFilterAggregate <- InMemory and Q6 as
FusedFilterAggregate <- InMemory.

``translate`` then collapses Project/Filter chains into FusedMapOps
(fuse/compile.py) and Aggregate-over-map-chain segments into device-resident
DeviceSegmentOps (fuse/segment.py), in the reference's order. A join plans
as a BroadcastJoinOp when the side to replicate is estimated at most
``broadcast_join_size_bytes_threshold`` bytes, a HashJoinOp otherwise; both
run each partition pair through the device probe
(``ExecutionContext.eval_join_dispatch``) or the host join. ``translate``
takes the optimized plan (optimizer.py), whose column pruning puts a
Project over each join side: TPC-H Q3 plans as Limit <- Sort <- Project <-
DeviceSegment <- BroadcastJoin(BroadcastJoin(FusedMap(orders),
FusedMap(customer)), FusedMap(lineitem)) at SF0.01, each FusedMap a
filter between pruning Projects that runs as one device program.

A lone FilterOp or ProjectOp runs on the card through
``ExecutionContext.eval_filter_dispatch`` / ``eval_projection_dispatch``
(the filter's mask computed on the card, the compaction on the host), and
a DistinctOp through ``eval_distinct`` (the first row of each key tuple
from the group-codes kernel). A Distinct over several partitions plans as
DistinctOp per partition, a hash ShuffleOp on the keys, and DistinctOp
again; a hash, range or random Repartition is a ShuffleOp of that scheme.

The exchange between partitions is the ShuffleOp (the reference's star
path). A Sort over several partitions range-shuffles its input and sorts
each range partition (SortOp, through the device argsort). A HashJoin over
several partitions hash-shuffles both sides to the larger partition count
and joins each co-partitioned pair; the left exchange builds the runtime
join filter (exchange/joinfilter.py) that prunes the right one, and a
BroadcastJoinOp prunes its streamed side with a filter over its
replicated side.

An aggregate over more than one partition plans in two stages, as the
reference's ``_translate_aggregate`` does: stage 1 aggregates each partition
into partials (``populate_aggregation_stages``), a hash ShuffleOp on the
group keys (a GatherOp when there are none) moves the partials, stage 2
merges them, and a final Project derives each result (mean = sum / count,
stddev from the sums of x and x * x and the count) and casts to the plan's
schema. count_distinct and skew do not split: their raw rows shuffle by
key, or gather for a global aggregate. The stage-2 shuffle folds the stage-1
pieces bound for one bucket (exchange/combine.py) when every merge is
exact. Stage 1 over a filter fuses into a FusedFilterAggregateOp, and over
a map chain into a DeviceSegmentOp, as a one-partition aggregate does.

The pipeline breakers that hold many partitions buffer them in the query's
spillable ``ctx.partition_buffer()``s (spill.py): the shuffle's buckets and
its range input, the hash join's two sides and the sort-merge join's inputs
and buckets. Under ``memory_budget_bytes`` they spill past the budget and
read back lazily, and the shuffle dictionary-encodes its pieces
(exchange/encode.py).

In a profiled query the blocking parts of the ops are phase spans under
their op's span, named as the reference names them: ``scan.plan``,
``write.sink``, ``coalesce.gather``, ``shuffle.fanout`` and
``shuffle.merge``, ``sort.partition``, ``gather.merge``,
``distinct.partition``, ``pivot.gather`` and ``join.build`` (the hash,
broadcast and sort-merge joins).

Feedback-directed planning (adapt/fdo.py) hooks into translation inside
``plan_query``'s collecting scope: a hash join's exchanges and a grouped
two-stage aggregate's exchange carry ``fdo_obs_key`` and record what
crossed them; ``_translate_join`` flips a join whose side history calls
small to a BroadcastJoinOp (with a mispredict guard), and
``_translate_aggregate`` shrinks an aggregate's exchange to ``reduce_to``
partitions, merging adjacent hash buckets at the reduce side.

A ScanSource translates to a ScanOp: one unloaded partition per scan task
its statistics do not prune, each read by the operator above it, with the
reads of the next ``scan_prefetch_depth`` partitions running ahead on the
query's pool (io/prefetch.py). The shuffle gives each piece of such a
partition a lineage recipe (integrity/lineage.py) that re-reads the file
and splits it again. A Write translates to a WriteOp, which writes each
partition of its input through io/writer.py and yields the manifest of
the files it wrote.

Scheduling. A map op (one that implements ``map_partition``) may run its
partitions on the query's pool (execution.py ``_parallel_map``) when
``parallel_safe``; ``device_pipelinable`` says whether its device program
compiles against its input's schema, where the executor prefers the
double-buffered sequential driver. ``morsel_streamable`` declares
``map_partition`` row-local (Project, Filter, FusedMap, BatchedUdf), so
the morsel pipeline (stream/) may run it per morsel. The hash and random
shuffles split their input partitions on the pool (``_fanout_stream``,
behind ``parallel_shuffle_fanout``), the pieces in input order. On the
host path an in-memory source under an aggregate splits at plan time into
morsels of ``default_morsel_size`` rows (``_split_morsels``). A Limit
closes its child stream once satisfied, so a pipeline below stops.

Mesh runs (parallel/mesh_exec.py): under a context whose partitions are
pinned (``ctx.partitions_pinned``) a hash, random or range shuffle first
offers its whole input to the slot exchange (a range shuffle samples its
boundaries before, and the host fallback reuses them); a sort-merge join
range-splits both sides through one aligned exchange each, the smaller side
first (``device_aligned_smj_exchanges``); and a scan marks each partition's
``owner_process`` (``scan_owner``). A broadcast join hands its collected
build side to ``ctx.prepare_broadcast``. Left out of this slice: the
shuffle's peer-to-peer leg.

UDFs. A map op whose expressions call UDFs with a resource request has it
checked by the query's accountant and each partition admitted while it
runs, and never defers a device resolver (``_map_execute``);
``parallel_safe`` says whether its partitions may run concurrently. A
projection holding a batch-declared UDF becomes a ``BatchedUdfOp``
(``_route_batched_udfs``, before the fuse passes): a fusion barrier whose
execute coalesces partitions through batch/executor.py and re-splits the
output to the source boundaries.

A sort-merge join (``SortMergeJoinOp``) samples both sides' keys as they
stream in, range-splits both by the same boundaries and sorts and joins
bucket i of the left with bucket i of the right on the host; a cross join
(``CrossJoinOp``) joins each left partition with the whole right side on
a literal key, on the host. Explode, unpivot, sample, monotonic ids and
concat are per-partition host ops; a pivot gathers its input into one
partition and pivots it on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import faults
from .errors import PORT_FAILURES
from .expressions import AggExpr, Alias, Expression, Function, col, lit
from .integrity.lineage import (fanout_piece_recipe, range_piece_recipe, task_recipe,
                                unwrap_source_task)
from .logical import (Aggregate, Concat, Distinct, Explode, Filter, InMemorySource, Join, Limit,
                      LogicalPlan, MonotonicallyIncreasingId, Pivot, Project, Repartition,
                      Sample, ScanSource, Sort, Unpivot, Write)
from .micropartition import MicroPartition
from .schema import Schema

PartStream = Iterator[MicroPartition]


def summarize_exprs(exprs, limit: int = 120) -> str:
    """Compact expression-list rendering for plan dumps: full displays up to
    ``limit`` chars, then a count of what was elided."""
    parts = []
    used = 0
    for i, e in enumerate(exprs):
        d = e._node.display()
        if parts and used + len(d) + 2 > limit:
            return ", ".join(parts) + f", ... (+{len(exprs) - i} more)"
        if not parts and len(d) > limit:
            d = d[:limit] + "…"
        parts.append(d)
        used += len(d) + 2
    return ", ".join(parts)


class PhysicalOp:
    """Base: children + a generator-producing execute().

    Ops that are pure per-partition maps implement ``map_partition``
    ((part, ctx) -> part), optionally ``map_partition_dispatch`` (the
    device launch) and ``map_partition_declined`` (what runs when the
    dispatch declined), and run through ``_map_execute`` or the executor's
    worker pool."""

    map_partition = None  # a map op's per-partition function

    # True declares map_partition row-local: applying it per morsel and
    # re-chunking gives the rows of applying it per partition, so the
    # morsel pipeline (stream/) may run it. Ops that aggregate, reorder or
    # depend on a partition's position leave it False
    morsel_streamable = False

    def __init__(self, children: List["PhysicalOp"], schema: Schema, num_partitions: int):
        self.children = children
        self.schema = schema
        self.num_partitions = num_partitions

    def map_empty(self, ctx):
        """Partitions to emit when the mapped input is empty."""
        return iter(())

    def parallel_safe(self) -> bool:
        """Whether map_partition may run concurrently across partitions.
        Function UDFs (and bare class UDFs sharing one instance) carry user
        state with no thread-safety contract; class UDFs on an actor pool
        (concurrency > 1) serialize per instance and stay safe."""
        from .expressions import expr_udfs_parallel_safe

        return all(expr_udfs_parallel_safe(e) for e in self._map_exprs())

    def _map_exprs(self):
        """The expressions a map op evaluates (UDF parallel-safety, resource
        requests and the result cache read them)."""
        return ()

    def device_pipelinable(self, ctx) -> bool:
        """True when this op's device program compiles against its input's
        schema: the executor then prefers the double-buffered sequential
        driver to the worker pool (the card runs one partition after
        another)."""
        return False

    def _map_execute(self, inputs, ctx, _primed=None):
        """Sequential loop over map_partition with device double-buffering:
        ops that implement map_partition_dispatch launch partition i+1 on the
        card BEFORE partition i's result is fetched back. Output order is
        preserved; a host-path partition first drains the pending one. An op
        whose UDFs request resources has the request checked by the query's
        accountant (an impossible one raises before any partition runs), each
        partition admitted while it runs, and never defers a resolver.
        ``_primed`` is the launched resolver of a first partition the caller
        dispatched while choosing the driver."""
        from .execution import op_resource_request

        req = op_resource_request(self)
        if req:
            ctx.accountant.check(req)
        saw = _primed is not None
        pending = _primed  # deferred resolver of the previous device partition
        for part in inputs[0]:
            saw = True
            if req:
                ctx.accountant.admit(req)
            try:
                dispatch = None if req else self.map_partition_dispatch(part, ctx)
                if pending is not None:
                    yield pending()
                    pending = None
                if dispatch is not None:
                    pending = dispatch
                    continue
                out = self.map_partition_declined(part, ctx)
            finally:
                if req:
                    ctx.accountant.release(req)
            yield out
        if pending is not None:
            yield pending()
        if not saw:
            yield from self.map_empty(ctx)

    def map_partition_dispatch(self, part, ctx):
        """Optional non-blocking device launch: return a zero-arg resolver,
        or None to take map_partition_declined."""
        return None

    def map_partition_declined(self, part, ctx):
        """Synchronous evaluation after map_partition_dispatch returned None."""
        return self.map_partition(part, ctx)

    def name(self) -> str:
        return type(self).__name__

    def execute(self, inputs: List[PartStream], ctx) -> PartStream:
        raise NotImplementedError

    def display_tree(self, indent: str = "") -> str:
        out = [indent + ("* " if indent else "") + self.describe()]
        for c in self.children:
            out.append(c.display_tree(indent + "  "))
        return "\n".join(out)

    def describe(self) -> str:
        return f"{self.name()} [{self.num_partitions} parts]"

    def __repr__(self) -> str:
        return self.display_tree()


class ScanOp(PhysicalOp):
    """The source over files: one unloaded partition per scan task whose
    statistics do not prove its pushed filter matches nothing. Each reads
    its file when the first operator above asks for its table."""

    def __init__(self, tasks: List, schema: Schema):
        super().__init__([], schema, max(len(tasks), 1))
        self.tasks = tasks

    def plan_parts(self, ctx) -> List[MicroPartition]:
        """The scan's unloaded partitions, the pruned tasks counted
        (``scan_tasks_pruned``) and the rest emitted (``scan_tasks_emitted``).
        In a multi-process run, task i's partition is read by process
        ``ctx.scan_owner(i)`` alone (its index in the task list every
        process holds alike)."""
        parts = []
        for i, task in enumerate(self.tasks):
            if task.can_prune():
                ctx.stats.bump("scan_tasks_pruned")
                continue
            ctx.stats.bump("scan_tasks_emitted")
            part = MicroPartition.from_scan_task(task)
            if ctx.partitions_pinned:
                part.owner_process = ctx.scan_owner(i)
            parts.append(part)
        return parts

    def execute(self, inputs, ctx) -> PartStream:
        from .io.prefetch import pipeline_scan_parts

        with ctx.stats.profiler.span("scan.plan", kind="phase"):
            parts = self.plan_parts(ctx)
        # bounded readahead: reading partition i submits the fetches of
        # i+1..i+depth; in task order, and the same rows at every depth
        yield from pipeline_scan_parts(parts, ctx)

    def describe(self):
        return f"Scan [{len(self.tasks)} tasks]"


class InMemoryOp(PhysicalOp):
    def __init__(self, parts: List[MicroPartition], schema: Schema):
        super().__init__([], schema, max(len(parts), 1))
        self.parts = parts

    def execute(self, inputs, ctx) -> PartStream:
        yield from self.parts


def _device_compiles(exprs, schema, ctx) -> bool:
    """Whether ``exprs`` compile for the device layer against ``schema``."""
    if not ctx.cfg.use_device_kernels:
        return False
    from .kernels.device import normalize_and_check

    try:
        return normalize_and_check(list(exprs), schema) is not None
    except PORT_FAILURES:
        raise
    except Exception:
        return False


class ProjectOp(PhysicalOp):
    # row-local: per-morsel evaluation and re-chunk equal the partition's
    # (the pipeline still declines a UDF that is not batch-declared)
    morsel_streamable = True

    def __init__(self, child: PhysicalOp, exprs: List[Expression], schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.exprs = exprs

    def map_partition(self, part, ctx):
        return ctx.eval_projection(part, self.exprs)

    def map_partition_dispatch(self, part, ctx):
        return ctx.eval_projection_dispatch(part, self.exprs)

    def map_partition_declined(self, part, ctx):
        # the dispatch already found this partition device-ineligible: go
        # straight to the host instead of staging it again
        ctx.stats.bump("host_projections")
        return part.eval_expression_list(self.exprs)

    def device_pipelinable(self, ctx) -> bool:
        return _device_compiles(self.exprs, self.children[0].schema, ctx)

    def _map_exprs(self):
        return self.exprs

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)

    def describe(self):
        return "Project: " + ", ".join(e._node.display() for e in self.exprs)


class BatchedUdfOp(PhysicalOp):
    """A projection holding batch-declared UDFs (batch/), run through the
    dynamic-batching executor instead of the per-partition UDF path.

    Not a ProjectOp subclass: both fuse passes match ``isinstance(op,
    (ProjectOp, FilterOp))``, so this op is a fusion barrier by construction
    (the batching executor owns the evaluation of its UDFs), while the chains
    above and below still fuse.

    ``execute`` coalesces whole partitions under the budget and re-splits to
    the source partition boundaries; ``map_partition`` is the one-partition
    apply; the morsel pipeline gives each producer a BatchingExecutor of its
    own and re-splits to the morsel boundaries. All give the rows of the
    unbatched path."""

    # the batch declaration is a row-locality contract: the morsel contract
    morsel_streamable = True
    # the executor runs this op's own execute (no fan-out); the morsel
    # pipeline lifts its UDF decline for it
    batch_declared = True

    def __init__(self, child: PhysicalOp, exprs: List[Expression], schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.exprs = exprs

    def _map_exprs(self):
        return self.exprs

    def _settings(self, ctx):
        from .batch.executor import BatchSettings
        from .expressions import expr_batch_udfs

        decl = None
        for e in self.exprs:
            udfs = expr_batch_udfs(e)
            if udfs:
                decl = udfs[0].batching  # the first declaration wins
                break
        return BatchSettings.resolve(decl, ctx.cfg)

    def map_partition(self, part, ctx):
        from .batch.device import exec_ctx_scope

        ctx.stats.bump("host_projections")
        with exec_ctx_scope(ctx):
            return part.eval_expression_list(self.exprs)

    def execute(self, inputs, ctx) -> PartStream:
        from .execution import op_resource_request

        if op_resource_request(self):
            # admission is per partition: such UDFs skip the cross-partition
            # coalescing rather than hold an admission across a batch
            yield from self._map_execute(inputs, ctx)
            return
        from .batch.executor import BatchingExecutor

        bx = BatchingExecutor(self.name(), self.exprs, ctx, settings=self._settings(ctx))
        try:
            for part in inputs[0]:
                yield from bx.feed(part)
            yield from bx.finish()
        finally:
            # an abandoned stream (a limit or an error above): settle the
            # buffered charges
            bx.abort()

    def describe(self):
        return "BatchedUdf: " + summarize_exprs(self.exprs)


def _route_batched_udfs(op: PhysicalOp) -> PhysicalOp:
    """Pre-fusion pass: ProjectOps whose expressions carry a batching
    declaration become BatchedUdfOps. Runs BEFORE the fuse passes, which
    would otherwise fold the projection into a fused map."""
    from .expressions import expr_has_batch_udf

    op.children = [_route_batched_udfs(c) for c in op.children]
    if type(op) is ProjectOp and any(expr_has_batch_udf(e) for e in op.exprs):
        return BatchedUdfOp(op.children[0], op.exprs, op.schema)
    return op


class FilterOp(PhysicalOp):
    # row-local: a row's fate depends on its own values only
    morsel_streamable = True

    def __init__(self, child: PhysicalOp, predicate: Expression):
        super().__init__([child], child.schema, child.num_partitions)
        self.predicate = predicate

    def map_partition(self, part, ctx):
        return ctx.eval_filter(part, self.predicate)

    def map_partition_dispatch(self, part, ctx):
        return ctx.eval_filter_dispatch(part, self.predicate)

    def map_partition_declined(self, part, ctx):
        # the dispatch already found this partition device-ineligible
        ctx.stats.bump("host_filters")
        return part.filter([self.predicate])

    def device_pipelinable(self, ctx) -> bool:
        return _device_compiles([self.predicate], self.children[0].schema, ctx)

    def _map_exprs(self):
        return (self.predicate,)

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)

    def describe(self):
        return f"Filter: {self.predicate._node.display()}"


class LimitOp(PhysicalOp):
    """Streaming global limit: takes partitions until ``limit`` rows are out,
    then closes its input, so a morsel pipeline below stops its producers
    at once (``morsels_short_circuited``). Directly over a streamable chain
    the pipeline takes the limit as its sink and this op never runs."""

    def __init__(self, child: PhysicalOp, limit: int):
        super().__init__([child], child.schema, child.num_partitions)
        self.limit = limit

    def execute(self, inputs, ctx) -> PartStream:
        remaining = self.limit
        src = inputs[0]
        if remaining > 0:
            for part in src:
                if len(part) > remaining:
                    part = part.head(remaining)
                remaining -= len(part)
                yield part
                if remaining <= 0:
                    break
        close = getattr(src, "close", None)
        if close is not None:
            close()

    def describe(self):
        return f"Limit: {self.limit}"


class ExplodeOp(PhysicalOp):
    """Per-partition explode of the list columns ``exprs`` (host)."""

    def __init__(self, child: PhysicalOp, exprs: List[Expression], schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.exprs = exprs

    def map_partition(self, part, ctx):
        return part.explode(self.exprs)

    def _map_exprs(self):
        return list(self.exprs)

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)


class UnpivotOp(PhysicalOp):
    """Per-partition unpivot (host)."""

    def __init__(self, child: PhysicalOp, ids, values, variable_name, value_name,
                 schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.ids = ids
        self.values = values
        self.variable_name = variable_name
        self.value_name = value_name

    def map_partition(self, part, ctx):
        return part.unpivot(self.ids, self.values, self.variable_name, self.value_name)

    def _map_exprs(self):
        return list(self.ids) + list(self.values)

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)


class SampleOp(PhysicalOp):
    """Per-partition sample: partition i draws with seed ``seed + i``."""

    def __init__(self, child: PhysicalOp, fraction: float, with_replacement: bool, seed):
        super().__init__([child], child.schema, child.num_partitions)
        self.fraction = fraction
        self.with_replacement = with_replacement
        self.seed = seed

    def execute(self, inputs, ctx) -> PartStream:
        for i, part in enumerate(inputs[0]):
            seed = None if self.seed is None else self.seed + i
            yield part.sample(fraction=self.fraction, with_replacement=self.with_replacement,
                              seed=seed)


class MonotonicIdOp(PhysicalOp):
    """Per-partition ids: partition i numbers its rows from ``i << 36``."""

    def __init__(self, child: PhysicalOp, column_name: str, schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.column_name = column_name

    def execute(self, inputs, ctx) -> PartStream:
        for i, part in enumerate(inputs[0]):
            yield part.add_monotonic_id(i << 36, self.column_name)


class WriteOp(PhysicalOp):
    """Writes each partition of its input as files under ``root_dir``
    (io/writer.py) and yields each one's manifest; an input with no
    partitions yields an empty manifest."""

    def __init__(self, child: PhysicalOp, root_dir: str, format: str, compression,
                 partition_cols, schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.root_dir = root_dir
        self.format = format
        self.compression = compression
        self.partition_cols = partition_cols

    def execute(self, inputs, ctx) -> PartStream:
        wrote = False
        for part in inputs[0]:
            wrote = True
            with ctx.stats.profiler.span("write.sink", kind="phase"):
                out = part.write_tabular(self.root_dir, self.format, self.compression,
                                         self.partition_cols)
            yield out
        if not wrote:
            yield MicroPartition.empty(self.schema)

    def describe(self):
        return f"Write: {self.format} -> {self.root_dir}"


class SortOp(PhysicalOp):
    """Per-partition sort; an upstream range ShuffleOp makes it a global
    sort (each range partition sorts on its own, through the device
    argsort when it clears ``device_min_rows``)."""

    def __init__(self, child: PhysicalOp, sort_by, descending, nulls_first):
        super().__init__([child], child.schema, child.num_partitions)
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first

    def execute(self, inputs, ctx) -> PartStream:
        ctx.check_deadline()  # a pipeline breaker: the deadline first
        prof = ctx.stats.profiler
        for part in inputs[0]:
            # the per-partition sort (the device argsort when eligible) is a
            # phase span: a profile splits sort time from pull time
            with prof.span("sort.partition", kind="phase"):
                out = ctx.eval_sort(part, self.sort_by, self.descending, self.nulls_first)
            yield out

    def describe(self):
        return "Sort: " + ", ".join(e._node.display() for e in self.sort_by)


class AggregateOp(PhysicalOp):
    """Full aggregation per partition."""

    def __init__(self, child: PhysicalOp, aggregations: List[Expression],
                 groupby: List[Expression], schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.aggregations = aggregations
        self.groupby = groupby

    def map_partition(self, part, ctx):
        return ctx.eval_agg(part, self.aggregations, self.groupby or None)

    def map_partition_dispatch(self, part, ctx):
        return ctx.eval_agg_dispatch(part, self.aggregations, self.groupby or None)

    def map_partition_declined(self, part, ctx):
        # the dispatch already found this partition device-ineligible
        return ctx._eval_agg_host(part, self.aggregations, self.groupby or None)

    def device_pipelinable(self, ctx) -> bool:
        return self._agg_compiles(ctx, None)

    def _agg_compiles(self, ctx, predicate) -> bool:
        if not ctx.cfg.use_device_kernels:
            return False
        from .kernels.device_agg import agg_plan_device_compilable

        return agg_plan_device_compilable(self.aggregations, self.children[0].schema,
                                          predicate=predicate)

    def map_empty(self, ctx):
        # a global agg over zero partitions still yields one row (count=0 etc.)
        if not self.groupby:
            yield MicroPartition.empty(self.children[0].schema).agg(self.aggregations, None)

    def _map_exprs(self):
        return list(self.aggregations) + list(self.groupby)

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)

    def describe(self):
        a = ", ".join(e._node.display() for e in self.aggregations)
        g = ", ".join(e._node.display() for e in self.groupby)
        return f"Aggregate: {a}" + (f" by [{g}]" if g else "")


class FusedFilterAggregateOp(AggregateOp):
    """Filter fused into a grouped aggregation: on the device path the
    predicate stays a mask feeding masked segment reductions. The host path
    applies filter-then-agg per partition."""

    def __init__(self, child: PhysicalOp, predicate: Expression,
                 aggregations: List[Expression], groupby: List[Expression],
                 schema: Schema):
        super().__init__(child, aggregations, groupby, schema)
        self.predicate = predicate

    def map_partition(self, part, ctx):
        return ctx.eval_agg(part, self.aggregations, self.groupby or None,
                            predicate=self.predicate)

    def map_partition_dispatch(self, part, ctx):
        return ctx.eval_agg_dispatch(part, self.aggregations, self.groupby or None,
                                     predicate=self.predicate)

    def map_partition_declined(self, part, ctx):
        return ctx._eval_agg_host(part, self.aggregations, self.groupby or None,
                                  predicate=self.predicate)

    def device_pipelinable(self, ctx) -> bool:
        return self._agg_compiles(ctx, self.predicate)

    def _map_exprs(self):
        return [self.predicate] + list(self.aggregations) + list(self.groupby)

    def describe(self):
        a = ", ".join(e._node.display() for e in self.aggregations)
        g = ", ".join(e._node.display() for e in self.groupby)
        return (f"FusedFilterAggregate: where {self.predicate._node.display()} agg {a}"
                + (f" by [{g}]" if g else ""))


class DistinctOp(PhysicalOp):
    """Per-partition distinct over ``subset`` (every column when None)."""

    def __init__(self, child: PhysicalOp, subset: Optional[List[Expression]]):
        super().__init__([child], child.schema, child.num_partitions)
        self.subset = subset

    def execute(self, inputs, ctx) -> PartStream:
        prof = ctx.stats.profiler
        for part in inputs[0]:
            with prof.span("distinct.partition", kind="phase"):
                out = ctx.eval_distinct(part, self.subset)
            yield out


def _one_partition(parts: List[MicroPartition], schema: Schema) -> MicroPartition:
    """``parts`` as one partition (an empty one of ``schema`` when none)."""
    return (MicroPartition.concat(parts) if len(parts) > 1 else parts[0] if parts
            else MicroPartition.empty(schema))


class PivotOp(PhysicalOp):
    """Gathers its input into one partition and pivots it (host)."""

    def __init__(self, child: PhysicalOp, groupby, pivot_col, value_col, agg_fn, names,
                 schema: Schema):
        super().__init__([child], schema, 1)
        self.groupby = groupby
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_fn = agg_fn
        self.names = names

    def execute(self, inputs, ctx) -> PartStream:
        # the gather that buffers the whole input is this op's blocking phase
        with ctx.stats.profiler.span("pivot.gather", kind="phase"):
            part = _one_partition(list(inputs[0]), self.children[0].schema)
        out = part.pivot(self.groupby, self.pivot_col, self.value_col, self.names, self.agg_fn)
        yield out.cast_to_schema(self.schema)


class ConcatOp(PhysicalOp):
    """The left input's partitions, then the right's, each cast to the
    unified schema."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, schema: Schema):
        super().__init__([left, right], schema, left.num_partitions + right.num_partitions)

    def execute(self, inputs, ctx) -> PartStream:
        for stream in inputs:
            for part in stream:
                yield part.cast_to_schema(self.schema)


class GatherOp(PhysicalOp):
    """All partitions -> one (a global aggregate's stage 2). The rows and
    bytes gathered count as ``exchange_rows`` and ``exchange_bytes``."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.schema, 1)

    def execute(self, inputs, ctx) -> PartStream:
        ctx.check_deadline()  # a pipeline breaker: the deadline first
        with ctx.stats.profiler.span("gather.merge", kind="phase"):
            out = _one_partition(list(_counted(inputs[0], ctx)), self.schema)
        yield out


def _count_exchanged(part: MicroPartition, ctx) -> None:
    """Count ``part``'s rows and bytes as ``exchange_rows`` and
    ``exchange_bytes``: what enters an exchange."""
    if len(part):
        ctx.stats.bump("exchange_rows", len(part))
    nbytes = part.size_bytes()
    if nbytes:
        ctx.stats.bump("exchange_bytes", nbytes)


def _counted(stream: PartStream, ctx) -> PartStream:
    """Pass-through that counts the rows and bytes entering an exchange."""
    for p in stream:
        _count_exchanged(p, ctx)
        yield p


class CoalesceOp(PhysicalOp):
    """N partitions -> M partitions without a shuffle (``into_partitions``):
    fewer partitions than inputs merge adjacent ones; more split the rows
    evenly, in order."""

    def __init__(self, child: PhysicalOp, num: int):
        super().__init__([child], child.schema, num)
        self.num = num

    def execute(self, inputs, ctx) -> PartStream:
        with ctx.stats.profiler.span("coalesce.gather", kind="phase"):
            parts = list(inputs[0])
        if not parts:
            return
        total = sum(len(p) for p in parts)
        if self.num >= len(parts):
            big = MicroPartition.concat(parts) if len(parts) > 1 else parts[0]
            per = (total + self.num - 1) // self.num if self.num else total
            for i in range(self.num):
                yield big.slice(min(i * per, total), min((i + 1) * per, total))
        else:
            per = (len(parts) + self.num - 1) // self.num
            for i in range(0, len(parts), per):
                group = parts[i:i + per]
                yield MicroPartition.concat(group) if len(group) > 1 else group[0]


class ShuffleOp(PhysicalOp):
    """The exchange between partitions on the host (the star path of the
    reference's ShuffleOp). ``scheme``: ``hash`` (each partition splits by
    row hash mod ``num_partitions``, ``MicroPartition.partition_by_hash``),
    ``random`` (a draw seeded by the source partition's index) or ``range``
    (the partitions are buffered while their sort keys are sampled, the
    samples give ``num_partitions - 1`` boundary rows, and each partition
    splits by them). Output partition i chains the i-th pieces in source
    order, so rows keep their order within a bucket; an empty bucket is an
    empty partition and an empty input yields nothing.

    Translate may attach a join-filter slot that this exchange feeds
    (``filter_feed``, the build side) or prunes with (``probe_filter``, the
    probe side), and a stage-2 merge (``combine``, ``(stage2_aggs,
    key_cols)``) that folds the pieces bound for one bucket as they arrive
    (exchange/combine.py). Each leg is behind its knob, and the results
    equal those with the knob off. ``exchange_rows`` and ``exchange_bytes``
    count what crosses the exchange, after the prune and the fold and before
    the encode; ``shuffles`` counts the exchanges that ran.

    The buckets and the range input are ``ctx.partition_buffer()``s. Under a
    memory budget each piece is dictionary-encoded before it enters its
    bucket (``exchange_payload_encoding``; ``exchange_pieces_encoded``,
    ``exchange_bytes_encodable``, ``exchange_bytes_encoded``), bucket i+1
    preloads its spilled pieces while bucket i merges, and each bucket is
    released once yielded.

    Under the distributed runner a hash or random exchange without a join
    filter or a fold runs peer to peer (``_peer_execute``, behind
    ``peer_shuffle``): the workers split the sources and host the pieces,
    and each output is a map of piece locations (dist/peerplane.py)."""

    filter_feed = None    # JoinFilterSlot this build-side exchange populates
    probe_filter = None   # JoinFilterSlot whose sealed filter prunes here
    combine = None        # (stage2_aggs, key_cols) of the pre-exchange fold
    # the site key (adapt/fdo.py) the rows and bytes that crossed this
    # exchange are recorded under once its input has drained: the history
    # the next plan of the shape reads
    fdo_obs_key = None
    # the fan-out resize (adapt/fdo.py): emit this many partitions by merging
    # adjacent buckets at the reduce side. Hashing stays modulo ``num``, so
    # the groups' placement, the combine's folds and the rows' order equal
    # the unresized exchange's; only the partition count shrinks
    reduce_to = None

    def __init__(self, child: PhysicalOp, scheme: str, num: int,
                 by: Optional[List[Expression]] = None,
                 descending: Optional[List[bool]] = None,
                 nulls_first: Optional[List[Optional[bool]]] = None):
        super().__init__([child], child.schema, num)
        self.scheme = scheme
        self.num = num
        self.by = by or []
        self.descending = descending or [False] * len(self.by)
        self.nulls_first = nulls_first if nulls_first is not None else [None] * len(self.by)

    def _feed_filter(self, stream, ctx) -> PartStream:
        """Build-side pass-through: every streamed partition's join keys go
        into the slot's builder, sealed when the stream ends (the join op
        drains this side before the probe side's exchange runs). A failure
        of the feed or the seal (the ``join.filter`` fault site among them)
        abandons the filter and counts ``join_filter_errors``; the exchange
        itself goes on unfiltered."""
        slot = self.filter_feed
        if not ctx.cfg.runtime_join_filters or not slot.eligible:
            slot.abandon()
            yield from stream
            return
        slot.begin()
        for p in stream:
            try:
                faults.check("join.filter", ctx.stats)
                for t in p.chunk_tables():
                    slot.feed(t)
            except PORT_FAILURES:
                raise
            except Exception:
                slot.abandon()
                ctx.stats.bump("join_filter_errors")
            yield p
        try:
            slot.seal()
        except PORT_FAILURES:
            raise
        except Exception:
            slot.abandon()
            ctx.stats.bump("join_filter_errors")
        if slot.filter() is not None:
            ctx.stats.bump("join_filter_built")

    def _prune_stream(self, stream, ctx, obs=None) -> PartStream:
        """Probe-side pass-through: each partition pruned by the sealed
        build-side filter before it is bucketed (no filter: untouched).

        ``obs`` is the exchange's feedback accumulator: the rows and bytes
        the prune removed are added back there, so that the side is recorded
        at its true size (a broadcast flip seeded from the pruned bytes
        would materialize the side unpruned and mispredict)."""
        from .exchange.joinfilter import prune_partition

        slot = self.probe_filter
        for p in stream:
            jf = slot.filter()
            if jf is None:
                yield p
                continue
            out = prune_partition(p, jf, self.by, ctx)
            if obs is not None and p.is_loaded():
                obs[0] += max(0, (p.num_rows_or_none() or 0) - (out.num_rows_or_none() or 0))
                obs[1] += max(0, (p.size_bytes() or 0) - (out.size_bytes() or 0))
            yield out

    def _peer_execute(self, stream, ctx, n, fdo_obs, backend) -> PartStream:
        """The peer-to-peer exchange: each source partition ships to a worker
        as a fan-out task (the split runs there and the pieces stay on that
        worker's piece server) and each reduce output is a PeerPieceTask, an
        unloaded task whose payload is a map of piece locations, pulled from
        the peers by whichever process materializes it. The driver moves
        plan metadata and location maps only.

        A source without a lineage recipe (a loaded or derived partition, or
        ``lineage_recomputation`` off) splits here: a peer hosting pieces
        that cannot be recomputed would turn its death into a failed query,
        and the driver holds these bytes already. A worker declining a
        fan-out splits that source here too; its pieces ride inline in the
        map, and the reader concatenates entries in source order either
        way. A peer dying after its fan-out is the reader's problem:
        PeerPieceTask recomputes the lost piece from its source."""
        from .dist.peerplane import PeerPieceTask, PieceRef

        lineage_on = ctx.cfg.lineage_recomputation
        integrity = ctx.cfg.partition_integrity
        sid = backend.new_shuffle_id()
        ctx.register_peer_shuffle(sid)
        token = backend.peer_token()
        sources: Dict[int, Any] = {}
        entries: List[List[Any]] = [[] for _ in range(n)]
        saw = False

        def account(rows, nbytes):
            if rows:
                ctx.stats.bump("exchange_rows", rows)
            if nbytes:
                ctx.stats.bump("exchange_bytes", nbytes)
            if fdo_obs is not None:
                fdo_obs[0] += rows or 0
                fdo_obs[1] += nbytes or 0

        with ctx.stats.profiler.span("shuffle.fanout", kind="phase"):
            pool = ctx.pool()
            pending = []
            for pi, p in enumerate(stream):
                saw = True
                # captured before shipping: the recipe recomputes every piece
                # this source produces
                src_task = unwrap_source_task(p) if lineage_on else None
                if src_task is not None:
                    sources[pi] = src_task
                    spec = {"sid": sid, "src": pi, "scheme": self.scheme, "num": n,
                            "seed": pi, "by": self.by, "crc": integrity}
                    pending.append((pi, p, pool.submit(
                        backend.execute_fanout, p, spec, ctx, f"shuffle.{self.scheme}", pi)))
                else:
                    pending.append((pi, p, None))
            for pi, p, fut in pending:
                res = fut.result() if fut is not None else None
                if res is None:
                    pieces = (p.partition_by_hash(self.by, n) if self.scheme == "hash"
                              else p.partition_by_random(n, seed=pi))
                    src_task = sources.get(pi)
                    for i, piece in enumerate(pieces):
                        nrows = piece.num_rows_or_none() or 0
                        if not nrows:
                            continue
                        if src_task is not None:
                            piece.lineage_recipe = fanout_piece_recipe(
                                src_task, self.by, self.scheme, n, pi, i)
                        account(nrows, piece.size_bytes() or 0)
                        entries[i].append(piece)
                else:
                    wid, (host, port), metas = res
                    for (i, rows, nbytes, crc) in metas:
                        account(rows, nbytes)
                        entries[i].append(PieceRef(wid, host, port, sid, i, pi, rows,
                                                   nbytes, crc))
        if fdo_obs is not None and saw:
            ctx.stats.fdo_observe(self.fdo_obs_key, fdo_obs[0], fdo_obs[1])
        if not saw:
            return
        ctx.stats.bump("shuffles")
        split = (self.by, self.scheme, n)

        def emit(refs):
            if not refs:
                return MicroPartition.empty(self.schema)
            # only the sources this bucket's remote pieces need ride along
            # (inline pieces carry their own recipe)
            need = {e.src for e in refs if isinstance(e, PieceRef)}
            task = PeerPieceTask(self.schema, refs, token, split,
                                 {s: sources[s] for s in need if s in sources},
                                 checksum=integrity, stats=ctx.stats)
            return MicroPartition.from_scan_task(task)

        k = self.reduce_to if self.reduce_to is not None and 0 < self.reduce_to < n else None
        if k is None:
            for i in range(n):
                yield emit(entries[i])
            return
        groups: List[List[int]] = [[] for _ in range(k)]
        for i in range(n):
            groups[i * k // n].append(i)
        ctx.stats.bump("fdo_reduced_partitions", n - k)
        for idxs in groups:
            yield emit([e for i in idxs for e in entries[i]])

    def _mesh_leg(self, src, ctx, combine):
        """The mesh leg: the whole input offered to the slot exchange.
        Returns (the exchanged partitions or None, the drained input, the
        range boundaries sampled for it or None)."""
        n = self.num
        parts = list(src)
        if not parts:
            return None, parts, None
        boundaries = None
        if self.scheme == "range":
            # a cheap dtype gate before the sampling; the host fallback reuses
            # the boundaries
            from .kernels.device import stageable_dtype

            if all(stageable_dtype(f.dtype) for f in parts[0].schema):
                samples = [sample_partition_keys(p, self.by, n, ctx.cfg.sample_size_for_sort)
                           for p in parts]
                boundaries = boundaries_from_samples(samples, self.by, n, self.descending,
                                                     self.nulls_first)
        # the exchange counts exchange_rows/exchange_bytes itself (what it
        # staged, after the fold)
        out = ctx.try_device_shuffle(parts, self.by, n, self.scheme, self.descending,
                                     self.nulls_first, boundaries, combine=combine)
        return out, parts, boundaries

    def execute(self, inputs, ctx) -> PartStream:
        n = self.num
        src = inputs[0]
        fdo_obs = [0, 0] if self.fdo_obs_key is not None else None
        if self.filter_feed is not None:
            src = self._feed_filter(src, ctx)
        if self.probe_filter is not None and ctx.cfg.runtime_join_filters:
            src = self._prune_stream(src, ctx, obs=fdo_obs)
        pre_boundaries = None
        if ctx.partitions_pinned and self.scheme in ("hash", "random", "range"):
            combine = (self.combine if self.combine is not None
                       and ctx.cfg.hierarchical_exchange_combine else None)
            out, parts, pre_boundaries = self._mesh_leg(src, ctx, combine)
            if not parts:
                return
            if out is not None:
                yield from out
                return
            src = iter(parts)
        # the peer-to-peer path (dist/peerplane.py): a hash or random exchange
        # on a worker pool that serves pieces fans out on the workers, and
        # each reduce bucket is a map of piece locations. The join filter's
        # feed and prune and the fold keep the star path: each is defined
        # over pieces the driver holds
        backend = getattr(ctx, "dist_backend", None)
        if (backend is not None and self.scheme in ("hash", "random")
                and self.filter_feed is None and self.probe_filter is None
                and not (self.combine is not None and ctx.cfg.hierarchical_exchange_combine)
                and ctx.cfg.peer_shuffle
                and getattr(backend, "execute_fanout", None) is not None
                and backend.peer_ready()):
            yield from self._peer_execute(src, ctx, n, fdo_obs, backend)
            return
        # partition_buffer() checks the deadline: a pipeline breaker first
        # proves the query still has time
        buckets = [ctx.partition_buffer() for _ in range(n)]
        # payload encoding engages under a budget only: there the exchanged
        # bytes are what the ledger holds and the spill writes
        encode = ctx.cfg.exchange_payload_encoding and ctx.memory_budget is not None
        comb = None
        if self.combine is not None and ctx.cfg.hierarchical_exchange_combine:
            from .exchange.combine import BucketCombiner

            comb = BucketCombiner(self.combine[0], self.combine[1], ctx.stats,
                                  ledger=ctx.ledger, budget=ctx.memory_budget)

        def exchange_append(i: int, piece: MicroPartition) -> None:
            # counted on the raw piece, after the prune and the fold
            _count_exchanged(piece, ctx)
            if fdo_obs is not None:
                fdo_obs[0] += piece.num_rows_or_none() or 0
                fdo_obs[1] += piece.size_bytes() or 0
            if encode:
                piece = self._encoded(piece, ctx)
            buckets[i].append(piece)

        saw = False
        # lineage (integrity/lineage.py): the pieces of an unloaded partition
        # over a file re-derive from the file, so a spilled piece whose file
        # is corrupt or gone recomputes. The task is captured before the
        # split (or the sampling) loads the partition
        lineage_on = ctx.cfg.lineage_recomputation
        # the whole map side (the pull of the input, the split, the bucket
        # appends) runs inside this op's FIRST pull: a named phase, so the
        # exchange's two halves are separable on the timeline
        with ctx.stats.profiler.span("shuffle.fanout", kind="phase"):
            if self.scheme == "range":
                # the boundaries need every input, so the partitions are buffered
                # (spillable) and their keys sampled as they stream in: a spilled
                # partition is never read back for sampling
                in_buf = ctx.partition_buffer()
                samples = []
                src_tasks = []
                for p in src:
                    src_task = unwrap_source_task(p) if lineage_on else None
                    src_tasks.append(src_task)
                    if pre_boundaries is None:
                        samples.append(sample_partition_keys(p, self.by, n,
                                                             ctx.cfg.sample_size_for_sort))
                    if src_task is not None:
                        # the sampling loaded it: buffered, it re-reads its file
                        p.lineage_recipe = task_recipe(src_task)
                    in_buf.append(p)
                saw = len(in_buf) > 0
                if saw and pre_boundaries is not None:
                    boundaries = pre_boundaries  # sampled for the mesh leg
                elif saw:
                    boundaries = boundaries_from_samples(samples, self.by, n, self.descending,
                                                         self.nulls_first)
                for pi, p in enumerate(in_buf.drain()):
                    pieces = p.partition_by_range(self.by, boundaries, self.descending,
                                                  self.nulls_first)
                    for i, piece in enumerate(pieces):
                        if src_tasks[pi] is not None:
                            piece.lineage_recipe = range_piece_recipe(
                                src_tasks[pi], self.by, boundaries, self.descending,
                                self.nulls_first, i)
                        exchange_append(min(i, n - 1), piece)
            else:
                def fanout(p, pi):
                    # the task is captured before the split loads p
                    src_task = unwrap_source_task(p) if lineage_on else None
                    pieces = (p.partition_by_hash(self.by, n) if self.scheme == "hash"
                              else p.partition_by_random(n, seed=pi))
                    if src_task is not None:
                        for i, piece in enumerate(pieces):
                            piece.lineage_recipe = fanout_piece_recipe(
                                src_task, self.by, self.scheme, n, pi, i)
                    return pieces

                for pieces in _fanout_stream(src, fanout, ctx,
                                             _subtree_may_yield_unloaded(self)):
                    saw = True
                    for i, piece in enumerate(pieces):
                        if comb is None or comb.failed:
                            exchange_append(i, piece)
                            continue
                        flushed = comb.add(i, piece)
                        if flushed is not None:
                            # the fold declined: what was staged goes on raw, and
                            # combining stops (stage 2 merges partials of any
                            # granularity)
                            for b, part in flushed:
                                exchange_append(b, part)
                if comb is not None:
                    for b, part in comb.finish():
                        exchange_append(b, part)
        if fdo_obs is not None and saw:
            # recorded only once the input has drained: a teardown half way
            # through the fan-out never reaches here
            ctx.stats.fdo_observe(self.fdo_obs_key, fdo_obs[0], fdo_obs[1])
        if not saw:
            return
        ctx.stats.bump("shuffles")
        k = self.reduce_to if self.reduce_to is not None and 0 < self.reduce_to < n else None
        # bucket i goes to output i * k // n: adjacent buckets merge, in
        # bucket order (the rows and their order equal the unresized
        # exchange's outputs concatenated)
        groups = [[i] for i in range(n)] if k is None else [[] for _ in range(k)]
        if k is not None:
            for i in range(n):
                groups[i * k // n].append(i)
            ctx.stats.bump("fdo_reduced_partitions", n - k)
        for g, idxs in enumerate(groups):
            if g + 1 < len(groups):
                # the next group's spilled pieces read back while this one merges
                for j in groups[g + 1]:
                    buckets[j].preload()
            if any(len(buckets[i]) for i in idxs):
                with ctx.stats.profiler.span("shuffle.merge", kind="phase"):
                    # concat loads every spilled or encoded piece of the group
                    merged = MicroPartition.concat(
                        [q for i in idxs if len(buckets[i]) for q in buckets[i].parts()])
            else:
                merged = MicroPartition.empty(self.schema)
            yield merged
            for i in idxs:
                buckets[i].release()

    @staticmethod
    def _encoded(piece: MicroPartition, ctx) -> MicroPartition:
        """``piece`` with its low-cardinality columns dictionary-encoded
        (exchange/encode.py), or as it is when no column wins. A failure of
        the encode (the ``exchange.encode`` fault site, an arrow error)
        ships the piece raw and counts ``exchange_encode_failures``."""
        from .exchange.encode import ENCODE_FAILURES, encode_exchange_partition

        raw = piece.size_bytes() or 0
        try:
            enc = encode_exchange_partition(piece, ctx.stats,
                                            integrity=ctx.cfg.partition_integrity)
        except ENCODE_FAILURES:
            enc = None
            ctx.stats.bump("exchange_encode_failures")
        if enc is not None:
            piece = enc
            ctx.stats.bump("exchange_pieces_encoded")
        # the encoded-to-raw ratio's denominator covers the same pieces
        enc_bytes = (piece.size_bytes() or raw) if enc is not None else raw
        if raw:
            ctx.stats.bump("exchange_bytes_encodable", raw)
        if enc_bytes:
            ctx.stats.bump("exchange_bytes_encoded", enc_bytes)
        return piece

    def describe(self):
        by = ", ".join(e._node.display() for e in self.by)
        tags = []
        if self.filter_feed is not None:
            tags.append("join-filter-feed")
        if self.probe_filter is not None:
            tags.append("join-filter-probe")
        if self.combine is not None:
            tags.append("combine")
        if self.reduce_to is not None:
            tags.append(f"fdo-reduce {self.reduce_to}")
        tag = f" <{'+'.join(tags)}>" if tags else ""
        return f"Shuffle[{self.scheme}] -> {self.num}" + (f" by [{by}]" if by else "") + tag


def _subtree_may_yield_unloaded(op: PhysicalOp) -> bool:
    """True when ``op``'s stream can hold unloaded partitions: a ScanOp below
    it (the map ops pass scan partitions through unread)."""
    if isinstance(op, ScanOp):
        return True
    return any(_subtree_may_yield_unloaded(c) for c in op.children)


def _fanout_stream(stream: PartStream, fn, ctx, may_be_unloaded: bool):
    """The map side of a hash or random shuffle: ``fn(part, index)``'s piece
    lists in input order. With ``parallel_shuffle_fanout`` and more than one
    worker, the read and split of partition i+1 run on the pool while
    partition i's pieces go to their buckets; a stream that may hold
    unloaded partitions keeps min(4, workers) in flight, so only a few read
    partitions exist beyond the buckets. The buckets hold what the inline
    split gives."""
    if not ctx.cfg.parallel_shuffle_fanout or ctx.num_workers <= 1:
        for pi, p in enumerate(stream):
            yield fn(p, pi)
        return
    from .scheduler import PartitionTask, dispatch

    window = min(4, ctx.num_workers) if may_be_unloaded else None

    def tasks():
        for pi, p in enumerate(stream):
            yield PartitionTask(p, (lambda part, _pi=pi: fn(part, _pi)), None,
                                "shuffle-fanout", pi)

    yield from dispatch(tasks(), ctx, window=window)


def sample_partition_keys(p: MicroPartition, by: List[Expression], num: int,
                          sample_size: int = 20):
    """The sampled sort-key rows of one partition (an empty Table for an
    empty one): ``max(sample_size, sample_size * num)`` rows, or all."""
    keys = p.table().eval_expression_list(by)
    if len(keys) == 0:
        return keys
    k = min(len(keys), max(sample_size, sample_size * num))
    return keys.sample(size=k, seed=0) if k < len(keys) else keys


def boundaries_from_samples(samples, by: List[Expression], num: int,
                            descending: List[bool],
                            nulls_first: Optional[List[Optional[bool]]] = None):
    """``num - 1`` quantile boundary rows of the partitions' key samples."""
    import numpy as np
    import pyarrow as pa

    from .series import Series
    from .table import Table

    key_tables = [s for s in samples if s is not None and len(s) > 0]
    if not key_tables:
        return next(s for s in samples if s is not None).slice(0, 0)
    allk = Table.concat(key_tables)
    allk = allk.sort([col(n) for n in allk.column_names], descending=descending,
                     nulls_first=nulls_first)
    m = len(allk)
    idxs = [min(max(int(np.floor(m * (i + 1) / num)), 0), m - 1) for i in range(num - 1)]
    return allk.take(Series.from_arrow(pa.array(np.asarray(idxs, dtype=np.uint64)), "i"))


def sample_boundaries(parts: List[MicroPartition], by: List[Expression], num: int,
                      descending: List[bool],
                      nulls_first: Optional[List[Optional[bool]]] = None,
                      sample_size: int = 20):
    """Boundary rows of partitions already in memory."""
    samples = [sample_partition_keys(p, by, num, sample_size) for p in parts]
    return boundaries_from_samples(samples, by, num, descending, nulls_first)


def aligned_boundaries_from_samples(sides_samples, num: int):
    """``num - 1`` quantile boundary rows over the combined key samples of
    several inputs (each a list of per-partition samples), so that every
    side range-splits by the same boundaries: bucket i covers the same key
    interval on each side. Samples are cast to the first side's names and
    types, so that they concatenate."""
    import numpy as np
    import pyarrow as pa

    from .series import Series
    from .table import Table

    key_tables = []
    first_empty = None
    for samples in sides_samples:
        for keys in samples:
            if keys is None:
                continue
            if first_empty is None:
                first_empty = keys.slice(0, 0)
            if len(keys) == 0:
                continue
            if keys.schema != first_empty.schema:
                keys = Table(first_empty.schema,
                             [c.cast(f.dtype).rename(f.name)
                              for c, f in zip(keys._columns, first_empty.schema)])
            key_tables.append(keys)
    if not key_tables:
        return first_empty
    allk = Table.concat(key_tables)
    allk = allk.sort([col(n) for n in allk.column_names])
    m = len(allk)
    idxs = [min(max(int(np.floor(m * (i + 1) / num)), 0), m - 1) for i in range(num - 1)]
    return allk.take(Series.from_arrow(pa.array(np.asarray(idxs, dtype=np.uint64)), "i"))


def _pipelined_join(ctx, pairs, how: str, suffix: str):
    """Join loop shared by the join ops: for each (left, right, left_on,
    right_on) pair, pair i+1's keys stage and its probe launches before pair
    i's result is fetched (one pending pair at a time). A pair the dispatch
    declines goes straight to the host join."""
    pending = None
    for l, r, lon, ron in pairs:
        fin = ctx.eval_join_dispatch(l, r, lon, ron, how, suffix)
        if pending is not None:
            yield pending()
            pending = None
        if fin is not None:
            pending = fin
        else:
            yield ctx.eval_join_declined(l, r, lon, ron, how, suffix)
    if pending is not None:
        yield pending()


class HashJoinOp(PhysicalOp):
    """Partition-aligned join: partition i of the left joins partition i of
    the right. When either side has several partitions, ``translate`` puts
    a hash ShuffleOp under each side, which co-partitions them. The left
    side is drained first, so its exchange seals the runtime join filter
    before the right side's exchange prunes with it."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, left_on, right_on,
                 how: str, schema: Schema, suffix: str = "right."):
        super().__init__([left, right], schema, max(left.num_partitions, right.num_partitions))
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.suffix = suffix

    def execute(self, inputs, ctx) -> PartStream:
        # the join build buffers both sides (partition_buffer() checks the
        # deadline first)
        lbuf = ctx.partition_buffer()
        rbuf = ctx.partition_buffer()
        with ctx.stats.profiler.span("join.build", kind="phase"):
            for p in inputs[0]:
                lbuf.append(p)
            for p in inputs[1]:
                rbuf.append(p)
        n = max(len(lbuf), len(rbuf))
        lschema = self.children[0].schema
        rschema = self.children[1].schema
        # drain() is lazy: a partition's bytes leave the ledger when its pair
        # is consumed, and its reference drops right after the join
        liter = lbuf.drain()
        riter = rbuf.drain()

        def pairs():
            for _ in range(n):
                l = next(liter, None)
                r = next(riter, None)
                if l is None:
                    l = MicroPartition.empty(lschema)
                if r is None:
                    r = MicroPartition.empty(rschema)
                yield l, r, self.left_on, self.right_on

        yield from _pipelined_join(ctx, pairs(), self.how, self.suffix)

    def describe(self):
        return f"HashJoin[{self.how}]"


class BroadcastJoinOp(PhysicalOp):
    """Collect the small side whole, stream the big side's partitions
    against it."""

    # set by _translate_join when history (not a static estimate) chose the
    # broadcast: the mispredict guard (site key, most bytes) and the site key
    # that keeps the side's history current
    fdo_guard = None
    fdo_obs_key = None

    def __init__(self, big: PhysicalOp, small: PhysicalOp, big_on, small_on,
                 how: str, schema: Schema, small_is_left: bool, suffix: str = "right."):
        super().__init__([big, small], schema, big.num_partitions)
        self.big_on = big_on
        self.small_on = small_on
        self.how = how
        self.small_is_left = small_is_left
        self.suffix = suffix

    def _filter_prunable(self) -> bool:
        """Whether the streamed (big) side may be pruned by a filter built
        from the replicated side's keys: the big side is the right side
        exactly when the small side is the left."""
        from .exchange.joinfilter import prunable

        return prunable(self.how, probe_is_right=self.small_is_left)

    def _build_small_filter(self, small: MicroPartition, ctx):
        """The Bloom + min-max filter over the collected small side's keys,
        or None (knob off, not prunable, ineligible key dtypes, too many
        build rows, or a failure of the build, the ``join.filter`` fault site
        among them, counted as ``join_filter_errors``)."""
        if not ctx.cfg.runtime_join_filters or not self._filter_prunable():
            return None
        from .exchange.joinfilter import JoinFilterSlot

        slot = JoinFilterSlot(self.small_on, self.big_on, self.children[1].schema,
                              self.children[0].schema, self.how)
        if not slot.eligible:
            return None
        try:
            faults.check("join.filter", ctx.stats)
            slot.begin()
            for t in small.chunk_tables():
                slot.feed(t)
            slot.seal()
        except PORT_FAILURES:
            raise
        except Exception:
            ctx.stats.bump("join_filter_errors")
            return None
        jf = slot.filter()
        if jf is not None:
            ctx.stats.bump("join_filter_built")
        return jf

    def execute(self, inputs, ctx) -> PartStream:
        ctx.check_deadline()  # the join build collects the small side
        with ctx.stats.profiler.span("join.build", kind="phase"):
            small = _one_partition(list(inputs[1]), self.children[1].schema)
            # a mesh context copies the build key onto every device here, so
            # each partition's probe reads the copy on its own device
            small = ctx.prepare_broadcast(small, self.small_on, self.how)
            # the small side is the build side: each streamed big partition
            # is pruned by its filter before the probe
            jf = self._build_small_filter(small, ctx)
        ctx.stats.bump("broadcast_joins")
        small_bytes = small.size_bytes() or 0
        if self.fdo_obs_key is not None:
            # the side's history stays current while the broadcast plan
            # serves: a grown side reverts the decision at the next plan
            ctx.stats.fdo_observe(self.fdo_obs_key, len(small), small_bytes)
        if self.fdo_guard is not None and small_bytes > self.fdo_guard[1]:
            # history said broadcast and the side arrived big: the query
            # completes on this plan (correct, only slower), and the shape's
            # cached plans are demoted
            from .adapt.fdo import note_broadcast_mispredict

            note_broadcast_mispredict(self.fdo_guard, small_bytes, ctx, ctx.canonical_fp)

        def pairs():
            from .exchange.joinfilter import prune_partition

            for part in inputs[0]:
                if jf is not None:
                    part = prune_partition(part, jf, self.big_on, ctx)
                if self.small_is_left:
                    yield small, part, self.small_on, self.big_on
                else:
                    yield part, small, self.big_on, self.small_on

        yield from _pipelined_join(ctx, pairs(), self.how, self.suffix)

    def describe(self):
        return f"BroadcastJoin[{self.how}]"


class SortMergeJoinOp(PhysicalOp):
    """A sort-merge join over aligned range boundaries: both sides' keys are
    sampled as their partitions stream in, the combined samples give one
    set of boundaries (``aligned_boundaries_from_samples``), both sides
    split by them (bucket i of the left covers the keys of bucket i of the
    right), and each bucket pair is sorted and joined on the host. Each
    bucket's output is sorted by the left keys, so the partitions
    concatenate to a key-sorted result. With one partition, or at most one
    partition a side, the sides merge once, unsplit."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, left_on, right_on,
                 how: str, schema: Schema, suffix: str = "right."):
        super().__init__([left, right], schema, max(left.num_partitions, right.num_partitions))
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.suffix = suffix

    def execute(self, inputs, ctx) -> PartStream:
        # the join buffers both sides (partition_buffer() checks the deadline
        # first); keys are sampled as the partitions stream in, so a spilled
        # input is never read back for the boundaries
        n = self.num_partitions
        ssize = ctx.cfg.sample_size_for_sort
        lbuf = ctx.partition_buffer()
        rbuf = ctx.partition_buffer()
        lsamples, rsamples = [], []
        with ctx.stats.profiler.span("join.build", kind="phase"):
            for stream, on, buf, samples in ((inputs[0], self.left_on, lbuf, lsamples),
                                             (inputs[1], self.right_on, rbuf, rsamples)):
                for p in stream:
                    samples.append(sample_partition_keys(p, on, n, ssize))
                    buf.append(p)
        lschema = self.children[0].schema
        rschema = self.children[1].schema
        if n <= 1 or (len(lbuf) <= 1 and len(rbuf) <= 1):
            # one merge of every partition, held in the ledger until then
            l = _one_partition(lbuf.parts(), lschema)
            r = _one_partition(rbuf.parts(), rschema)
            lbuf.release()
            rbuf.release()
            yield l.sort_merge_join(r, self.left_on, self.right_on, self.how, self.suffix)
            return
        k = len(self.left_on)
        bnds = aligned_boundaries_from_samples([lsamples, rsamples], n)
        ctx.stats.bump("aligned_boundary_shuffles")
        if ctx.partitions_pinned:
            outs = self._mesh_exchange(lbuf, rbuf, bnds, ctx, k)
            if outs is not None:
                lbuf.release()
                rbuf.release()
                ctx.stats.bump("device_aligned_smj_exchanges")
                for l, r in zip(*outs):
                    yield l.sort_merge_join(r, self.left_on, self.right_on, self.how,
                                            self.suffix)
                return
        lbuckets = [ctx.partition_buffer() for _ in range(n)]
        rbuckets = [ctx.partition_buffer() for _ in range(n)]
        for buf, on, buckets in ((lbuf, self.left_on, lbuckets),
                                 (rbuf, self.right_on, rbuckets)):
            for p in buf.drain():
                for i, piece in enumerate(p.partition_by_range(on, bnds, [False] * k,
                                                               [None] * k)):
                    if len(piece):
                        _count_exchanged(piece, ctx)
                    buckets[min(i, n - 1)].append(piece)
        for lb, rb in zip(lbuckets, rbuckets):
            yield _one_partition(lb.parts(), lschema).sort_merge_join(
                _one_partition(rb.parts(), rschema), self.left_on, self.right_on, self.how,
                self.suffix)
            lb.release()
            rb.release()

    def _mesh_exchange(self, lbuf, rbuf, bnds, ctx, k: int):
        """Both sides through the mesh's range exchange by the same aligned
        boundaries, the smaller side first (a decline found only at staging,
        an int64 past int32 in the 32-bit mode, then costs the cheaper
        exchange), or None: an empty side, an unloaded input or a column the
        exchange cannot ship leaves the join to the host split."""
        from .kernels.device import stageable_dtype

        n = self.num_partitions
        lparts, rparts = lbuf.parts(), rbuf.parts()
        lrows = sum(len(p) for p in lparts)
        rrows = sum(len(p) for p in rparts)
        if not (lrows > 0 and rrows > 0
                and all(p.is_loaded() for p in lparts + rparts)
                and all(stageable_dtype(f.dtype) for f in self.children[0].schema)
                and all(stageable_dtype(f.dtype) for f in self.children[1].schema)):
            return None
        zeros, nf = [False] * k, [None] * k
        small_left = lrows <= rrows
        first = (lparts, self.left_on) if small_left else (rparts, self.right_on)
        second = (rparts, self.right_on) if small_left else (lparts, self.left_on)
        out1 = ctx.try_device_shuffle(first[0], first[1], n, "range", zeros, nf, bnds)
        if out1 is None:
            return None
        out2 = ctx.try_device_shuffle(second[0], second[1], n, "range", zeros, nf, bnds)
        if out2 is None:
            return None
        return (out1, out2) if small_left else (out2, out1)


class CrossJoinOp(PhysicalOp):
    """Every left row with every right row: the right side is gathered, a
    literal key is added to both sides, and each left partition joins the
    whole right side on it (host)."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, schema: Schema, suffix: str):
        super().__init__([left, right], schema, left.num_partitions)
        self.suffix = suffix

    def execute(self, inputs, ctx) -> PartStream:
        right = _one_partition(list(inputs[1]), self.children[1].schema)
        key = "__cross_key"
        rk = right.eval_expression_list(
            [col(c) for c in right.schema.field_names()] + [lit(1).alias(key)])
        for part in inputs[0]:
            lk = part.eval_expression_list(
                [col(c) for c in part.schema.field_names()] + [lit(1).alias(key)])
            joined = lk.hash_join(rk, [col(key)], [col(key)], "inner", self.suffix)
            keep = [c for c in joined.schema.field_names() if c != key]
            yield joined.select_columns(keep).cast_to_schema(self.schema)


# ---------------------------------------------------------------------------
# logical -> physical translation
# ---------------------------------------------------------------------------

def fuse_for_device(op: PhysicalOp) -> PhysicalOp:
    """Post-translation fusion: an Aggregate directly over a Filter becomes a
    FusedFilterAggregateOp. Column-pruning Projects (pure selection) above or
    below the filter are spliced out: device staging only copies the columns
    the aggregate references, and a materialized prune would mint a fresh
    partition each query and orphan its staged columns."""
    for i, c in enumerate(op.children):
        op.children[i] = fuse_for_device(c)
    if type(op) is AggregateOp:
        child = op.children[0]
        if isinstance(child, ProjectOp) and _is_pure_column_selection(child.exprs):
            child = child.children[0]
        if isinstance(child, FilterOp):
            fchild = child.children[0]
            if isinstance(fchild, ProjectOp) and _is_pure_column_selection(fchild.exprs):
                fchild = fchild.children[0]
            return FusedFilterAggregateOp(fchild, child.predicate,
                                          op.aggregations, op.groupby, op.schema)
        op.children[0] = child
    return op


def _is_pure_column_selection(exprs) -> bool:
    from .expressions import Column

    return all(isinstance(e._node, Column) and e._node.cname == e.name()
               for e in exprs)


def translate(plan: LogicalPlan, cfg=None, stats=None) -> PhysicalOp:
    """Public entry: recursive translation, then the routing of
    batch-declared UDF projections to BatchedUdfOp (behind
    ``cfg.dynamic_batching``), then device-path fusion
    (``fuse_for_device``), then map-chain fusion (``fuse_map_chains``,
    behind ``cfg.expr_fusion``), then the plan-segment compiler
    (``compile_plan_segments``, behind ``cfg.use_device_kernels`` and
    ``cfg.device_residency``). ``stats`` receives ``segment_compiles`` and
    ``compile_wall_ns``, the compile share of planning that the plan
    cache's warm path skips."""
    import time

    if cfg is None:
        from .context import get_context

        cfg = get_context().execution_config
    out = _translate(plan, cfg, morsels=False)
    if cfg.dynamic_batching:
        # before the fuse passes: a batch-declared projection becomes its own
        # op (and a fusion barrier), not a piece of a fused map
        out = _route_batched_udfs(out)
    out = fuse_for_device(out)
    if cfg.expr_fusion:
        from .fuse import fuse_map_chains

        t0 = time.perf_counter_ns()
        out = fuse_map_chains(out, cfg)
        if stats is not None:
            stats.bump("compile_wall_ns", time.perf_counter_ns() - t0)
    if cfg.use_device_kernels and cfg.device_residency:
        # last: the segment compiler consumes the Aggregate-over-FusedMap
        # trees the fuse passes built
        from .fuse import compile_plan_segments

        t0 = time.perf_counter_ns()
        out = compile_plan_segments(out, cfg, stats)
        if stats is not None:
            stats.bump("compile_wall_ns", time.perf_counter_ns() - t0)
    return out


def _split_morsels(parts: List[MicroPartition], cfg) -> List[MicroPartition]:
    """On the host path with more than one worker, split each in-memory
    partition of more than twice ``default_morsel_size`` rows into at most
    4 * workers zero-copy slices, so that the pool has parallel work even
    over a one-partition source. The device path keeps whole partitions
    (one launch over one staged partition, and the stage caches stay)."""
    from .context import resolve_executor_threads

    if cfg.use_device_kernels:
        return parts
    threads = resolve_executor_threads(cfg)
    if threads <= 1:
        return parts
    morsel = max(int(cfg.default_morsel_size), 1)
    out: List[MicroPartition] = []
    for p in parts:
        n = p.num_rows_or_none()
        if n is None or n <= 2 * morsel:
            out.append(p)
            continue
        k = min(-(-n // morsel), threads * 4)
        step = -(-n // k)
        for s in range(0, n, step):
            out.append(p.slice(s, min(s + step, n)))
    return out


def _translate(plan: LogicalPlan, cfg, morsels: bool = False) -> PhysicalOp:
    """The recursive translation. ``morsels`` (set under an aggregate, kept
    through Project and Filter) splits large in-memory sources into morsels
    (``_split_morsels``): the two-stage aggregate turns them into parallel
    stage-1 work."""
    if isinstance(plan, InMemorySource):
        parts = _split_morsels(plan.partitions, cfg) if morsels else plan.partitions
        return InMemoryOp(parts, plan.schema)
    if isinstance(plan, ScanSource):
        return ScanOp(plan.tasks, plan.schema)
    if isinstance(plan, Project):
        return ProjectOp(_translate(plan.input, cfg, morsels), plan.exprs, plan.schema)
    if isinstance(plan, Filter):
        return FilterOp(_translate(plan.input, cfg, morsels), plan.predicate)
    if isinstance(plan, Limit):
        return LimitOp(_translate(plan.input, cfg), plan.limit)
    if isinstance(plan, Explode):
        return ExplodeOp(_translate(plan.input, cfg), plan.to_explode, plan.schema)
    if isinstance(plan, Unpivot):
        return UnpivotOp(_translate(plan.input, cfg), plan.ids, plan.values,
                         plan.variable_name, plan.value_name, plan.schema)
    if isinstance(plan, Sample):
        return SampleOp(_translate(plan.input, cfg), plan.fraction, plan.with_replacement,
                        plan.seed)
    if isinstance(plan, MonotonicallyIncreasingId):
        return MonotonicIdOp(_translate(plan.input, cfg), plan.column_name, plan.schema)
    if isinstance(plan, Write):
        return WriteOp(_translate(plan.input, cfg), plan.root_dir, plan.format,
                       plan.compression, plan.partition_cols, plan.schema)
    if isinstance(plan, Sort):
        child = _translate(plan.input, cfg)
        if child.num_partitions > 1:
            child = ShuffleOp(child, "range", child.num_partitions, plan.sort_by,
                              plan.descending, plan.nulls_first)
        return SortOp(child, plan.sort_by, plan.descending, plan.nulls_first)
    if isinstance(plan, Repartition):
        child = _translate(plan.input, cfg)
        num = plan.num if plan.num is not None else child.num_partitions
        if plan.scheme == "into":
            return child if num == child.num_partitions else CoalesceOp(child, num)
        if plan.scheme == "hash":
            return ShuffleOp(child, "hash", num, plan.by)
        if plan.scheme == "range":
            return ShuffleOp(child, "range", num, plan.by, plan.descending)
        return ShuffleOp(child, "random", num)
    if isinstance(plan, Distinct):
        child = _translate(plan.input, cfg)
        out = DistinctOp(child, plan.subset)
        if child.num_partitions > 1:
            keys = plan.subset or [col(c) for c in plan.schema.field_names()]
            out = DistinctOp(ShuffleOp(out, "hash", child.num_partitions, keys), plan.subset)
        return out
    if isinstance(plan, Aggregate):
        return _translate_aggregate(plan, cfg)
    if isinstance(plan, Pivot):
        return PivotOp(_translate(plan.input, cfg), plan.groupby, plan.pivot_col,
                       plan.value_col, plan.agg_fn, plan.names, plan.schema)
    if isinstance(plan, Concat):
        return ConcatOp(_translate(plan.input, cfg), _translate(plan.other, cfg), plan.schema)
    if isinstance(plan, Join):
        return _translate_join(plan, cfg)
    raise ValueError(f"cannot translate logical node {plan.name()}")


# ---------------------------------------------------------------------------
# two-stage aggregation (the reference's populate_aggregation_stages and
# _translate_aggregate, for the aggregation kinds the port has)
# ---------------------------------------------------------------------------

# stage-1 kind -> the stage-2 kind that merges its partials
_MERGE_KIND = {"sum": "sum", "count": "sum", "min": "min", "max": "max", "list": "concat",
               "concat": "concat", "any_value": "any_value",
               "sketch_hll": "merge_sketch_hll", "sketch_quantile": "merge_sketch_quantile"}
# kinds that split into partials (count_distinct and skew do not: their
# per-partition results cannot be merged)
DECOMPOSABLE = {"sum", "count", "mean", "min", "max", "list", "concat", "any_value", "stddev"}


def _strip_alias(e: Expression) -> AggExpr:
    n = e._node
    while isinstance(n, Alias):
        n = n.child
    if not isinstance(n, AggExpr):
        raise ValueError(f"expected aggregation expression, got {e!r}")
    return n


def populate_aggregation_stages(
    aggs: List[Expression],
) -> Tuple[List[Expression], List[Expression], List[Expression]]:
    """Split aggregations into (first_stage, second_stage, final_projection).

    first_stage runs per input partition and names its partials
    ``__s1_{i}_{kind}``; second_stage merges the partials after the
    exchange; final_projection derives each result (mean = sum / count,
    stddev from the sums of the child and of its square and the count). A
    partial is shared by every aggregation that needs it (mean's and
    stddev's sum and count with a sum() and a count() of the same child). A
    kind that does not decompose raises ValueError."""
    stage1: List[Expression] = []
    stage2: List[Expression] = []
    final: List[Expression] = []
    seen_ids: Dict[Tuple, str] = {}

    def s1(kind: str, child_expr: Expression, tag: str, extra=None) -> str:
        key = (kind, child_expr._node._key(), tag)
        if key in seen_ids:
            return seen_ids[key]
        ident = f"__s1_{len(seen_ids)}_{kind}"
        seen_ids[key] = ident
        stage1.append(Expression(AggExpr(kind, child_expr._node, extra)).alias(ident))
        stage2.append(Expression(AggExpr(_MERGE_KIND[kind], col(ident)._node,
                                         extra if kind == "any_value" else None)).alias(ident))
        return ident

    for e in aggs:
        node = _strip_alias(e)
        alias = e.name()
        child = Expression(node.child)
        k = node.kind
        if k in ("sum", "min", "max"):
            final.append(col(s1(k, child, "")).alias(alias))
        elif k == "count":
            ident = s1("count", child, node.extra.get("mode", "valid"), dict(node.extra))
            final.append(col(ident).alias(alias))
        elif k == "mean":
            sid = s1("sum", child, "")
            cid = s1("count", child, "valid", {"mode": "valid"})
            final.append((col(sid) / col(cid)).alias(alias))
        elif k == "stddev":
            # population stddev from E[x^2] - E[x]^2, the variance clamped at 0
            # against rounding before the square root
            sid = s1("sum", child, "")
            qid = s1("sum", child * child, "")
            cid = s1("count", child, "valid", {"mode": "valid"})
            mean = col(sid) / col(cid)
            var = (col(qid) / col(cid)) - (mean * mean)
            final.append((((var + abs(var)) / lit(2.0)) ** lit(0.5)).alias(alias))
        elif k in ("list", "concat"):
            final.append(col(s1(k, child, k)).alias(alias))
        elif k == "any_value":
            final.append(col(s1("any_value", child, "any", dict(node.extra))).alias(alias))
        elif k == "approx_count_distinct":
            # the exchange carries HLL registers, never the counted rows
            ident = s1("sketch_hll", child, "hll")
            final.append(Expression(Function("sketch.hll_estimate", [col(ident)._node]))
                         .alias(alias))
        elif k == "approx_percentiles":
            ident = s1("sketch_quantile", child, "qsketch")
            final.append(Expression(Function(
                "sketch.quantile_estimate", [col(ident)._node],
                {"percentiles": node.extra.get("percentiles", 0.5)})).alias(alias))
        else:
            raise ValueError(f"aggregation {k!r} is not decomposable")
    return stage1, stage2, final


def aggs_decomposable(aggs: List[Expression], include_sketch: bool = False) -> bool:
    """Every aggregation splits into partials. With ``include_sketch`` the
    approximate ones do too, through the sketch subsystem
    (daft_tpu_torch/sketch/): a mergeable sketch a group in stage 1, the
    serialized sketches over the exchange, a merge in stage 2 and an
    estimate in the final projection."""
    from .sketch import SKETCH_DECOMPOSABLE

    allowed = DECOMPOSABLE | (SKETCH_DECOMPOSABLE if include_sketch else set())
    try:
        return all(_strip_alias(e).kind in allowed for e in aggs)
    except ValueError:
        return False


def _stage_schema(input_schema: Schema, aggs: List[Expression],
                  groupby: List[Expression]) -> Schema:
    from .schema import Field

    return Schema([Field(e.name(), e._node.to_field(input_schema).dtype)
                   for e in list(groupby) + list(aggs)])


def _translate_aggregate(plan: Aggregate, cfg) -> PhysicalOp:
    """One partition: one AggregateOp. More: stage 1 per partition, the
    partials exchanged (hash ShuffleOp on the group keys, GatherOp for a
    global aggregate), stage 2, the final Project with the plan's schema."""
    child = _translate(plan.input, cfg, morsels=True)
    nparts = child.num_partitions
    if nparts == 1:
        return AggregateOp(child, plan.aggregations, plan.groupby, plan.schema)
    if not aggs_decomposable(plan.aggregations, cfg.sketch_aggregations):
        # count_distinct, skew (and approx_* with sketch_aggregations off):
        # shuffle the raw rows by key (gather them for a global aggregate),
        # then aggregate each partition in full
        if plan.groupby:
            shuffled = ShuffleOp(child, "hash", nparts, plan.groupby)
            return AggregateOp(shuffled, plan.aggregations, plan.groupby, plan.schema)
        cd = _global_count_distinct_plan(plan, child, nparts)
        if cd is not None:
            return cd
        return AggregateOp(GatherOp(child), plan.aggregations, [], plan.schema)
    stage1, stage2, final = populate_aggregation_stages(plan.aggregations)
    key_cols = [col(e.name()) for e in plan.groupby]
    p1 = AggregateOp(child, stage1, plan.groupby,
                     _stage_schema(plan.input.schema, stage1, plan.groupby))
    if plan.groupby:
        from .adapt import fdo

        exchanged = ShuffleOp(p1, "hash", nparts, key_cols)
        # the fan-out resize: a repeated shape's exchange emits only the
        # partitions its recorded payload needs (hashing stays modulo nparts)
        resized = fdo.agg_shuffle_fanout(plan, nparts)
        if resized:
            exchanged.reduce_to = resized
            exchanged.num_partitions = resized
        okey = fdo.agg_observation_key(plan)
        if okey:
            exchanged.fdo_obs_key = okey
        if cfg.hierarchical_exchange_combine:
            # fold the stage-1 pieces bound for one bucket through stage 2
            # before they are held (only schema-closed exact merges)
            from .exchange.combine import combine_spec_applicable

            if combine_spec_applicable(stage2, key_cols, p1.schema):
                exchanged.combine = (stage2, key_cols)
    else:
        exchanged = GatherOp(p1)
    p2 = AggregateOp(exchanged, stage2, key_cols, _stage_schema(p1.schema, stage2, key_cols))
    return ProjectOp(p2, key_cols + final, plan.schema)


def _global_count_distinct_plan(plan: Aggregate, child: PhysicalOp,
                                nparts: int) -> Optional[PhysicalOp]:
    """A global count_distinct without gathering the raw rows: hash-shuffle
    the rows by the counted value (equal values meet in one partition),
    count distinct per partition, and sum the partitions' counts. Applies
    when the list is exactly one count_distinct."""
    if len(plan.aggregations) != 1:
        return None  # different value columns would need different shuffles
    e = plan.aggregations[0]
    node = e._node
    while isinstance(node, Alias):
        node = node.child
    if not (isinstance(node, AggExpr) and node.kind == "count_distinct"):
        return None
    alias = e.name()
    shuffled = ShuffleOp(child, "hash", nparts, [Expression(node.child)])
    p1 = AggregateOp(shuffled, [e], [], _stage_schema(plan.input.schema, [e], []))
    total = [col(alias).sum().alias(alias)]
    return AggregateOp(GatherOp(p1), total, [], _stage_schema(p1.schema, total, []))


def _translate_join(plan: Join, cfg) -> PhysicalOp:
    from .adapt import fdo

    left = _translate(plan.left, cfg)
    right = _translate(plan.right, cfg)
    if plan.how == "cross":
        return CrossJoinOp(left, right, plan.schema, plan.suffix)
    strategy = plan.strategy
    fdo_side = None
    if strategy is None:
        # the feedback flip: a side whose recorded size sits well under the
        # broadcast threshold flips the join on the first run of a repeated
        # shape (live only inside plan_query's collecting scope)
        fdo_side = fdo.join_strategy_hint(plan)
        strategy = "broadcast" if fdo_side is not None else _choose_join_strategy(plan, cfg)
    if strategy == "broadcast" and plan.how == "outer":
        # an outer join preserves both sides: replaying the replicated side
        # per big-side partition would duplicate its unmatched rows
        strategy = "hash"
    if strategy == "broadcast":
        if fdo_side is not None:
            broadcast_left = fdo_side == "left"
        else:
            broadcast_left = _broadcast_side(plan, plan.left.approx_size_bytes(),
                                             plan.right.approx_size_bytes()) == "left"
        if broadcast_left:
            op = BroadcastJoinOp(right, left, plan.right_on, plan.left_on, plan.how,
                                 plan.schema, small_is_left=True, suffix=plan.suffix)
        else:
            op = BroadcastJoinOp(left, right, plan.left_on, plan.right_on, plan.how,
                                 plan.schema, small_is_left=False, suffix=plan.suffix)
        if fdo_side is not None:
            # the runtime mispredict guard, and the observation that keeps
            # the side's history current
            op.fdo_guard = fdo.broadcast_guard(plan, fdo_side)
            op.fdo_obs_key = fdo.observation_key(plan.left if fdo_side == "left"
                                                 else plan.right)
        return op
    if strategy == "sort_merge":
        return SortMergeJoinOp(left, right, plan.left_on, plan.right_on, plan.how,
                               plan.schema, plan.suffix)
    nparts = max(left.num_partitions, right.num_partitions)
    if nparts > 1:
        # co-partition both sides; the left exchange (drained first) builds
        # the runtime join filter from its keys and the right one prunes
        # with it, where the join type allows pruning the right side
        from .exchange.joinfilter import JoinFilterSlot, prunable

        lshuf = ShuffleOp(left, "hash", nparts, plan.left_on)
        rshuf = ShuffleOp(right, "hash", nparts, plan.right_on)
        # each side's exchange records the rows and bytes that crossed it,
        # the history a later plan's broadcast flip reads
        lshuf.fdo_obs_key = fdo.observation_key(plan.left)
        rshuf.fdo_obs_key = fdo.observation_key(plan.right)
        if cfg.runtime_join_filters and prunable(plan.how, probe_is_right=True):
            slot = JoinFilterSlot(plan.left_on, plan.right_on, left.schema, right.schema,
                                  plan.how)
            if slot.eligible:
                lshuf.filter_feed = slot
                rshuf.probe_filter = slot
        left, right = lshuf, rshuf
    return HashJoinOp(left, right, plan.left_on, plan.right_on, plan.how, plan.schema,
                      plan.suffix)


def _broadcast_side(plan: Join, lsize, rsize) -> str:
    """Which side to replicate. The preserved side of an outer join cannot
    be broadcast (its unmatched rows must appear exactly once)."""
    if plan.how in ("left", "semi", "anti"):
        return "right"
    if plan.how == "right":
        return "left"
    # inner: the smaller side
    if lsize is not None and (rsize is None or lsize <= rsize):
        return "left"
    return "right"


def _choose_join_strategy(plan: Join, cfg) -> str:
    if plan.how == "outer":
        return "hash"
    lsize = plan.left.approx_size_bytes()
    rsize = plan.right.approx_size_bytes()
    side = _broadcast_side(plan, lsize, rsize)
    size = lsize if side == "left" else rsize
    if size is not None and size <= cfg.broadcast_join_size_bytes_threshold:
        return "broadcast"
    return "hash"
