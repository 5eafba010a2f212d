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
(``ExecutionContext.eval_join_dispatch``) or the host join. TPC-H Q3 at SF1
plans as Limit <- Sort <- Project <- DeviceSegment <- HashJoin(
BroadcastJoin(Filter(orders), Filter(customer)), Filter(lineitem)); with no
optimizer to prune columns, no Project sits over the filters, so they stay
single ops (no FusedMap) and run on the host.

Left out of this slice: scans, shuffles (a multi-partition aggregate or sort
gathers its input into one partition instead of the reference's two-stage
hash exchange, so a plan segment forms over one partition; a hash join whose
inputs have more than one partition gathers each side into one partition
instead of the hash exchange that co-partitions them), the sort-merge and
cross joins, the runtime join filter, feedback-directed join planning,
distinct/explode/pivot/sample/write ops, the optimizer, the worker pool,
streaming and batched UDFs.
"""

from __future__ import annotations

from typing import Iterator, List

from .expressions import Expression
from .logical import (Aggregate, Filter, InMemorySource, Join, Limit, LogicalPlan, Project,
                      Sort)
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

    Ops that are pure per-partition maps implement ``map_partition`` (the
    host path, (part, ctx) -> part), optionally ``map_partition_dispatch``
    (the device path) and ``map_partition_declined`` (what runs when the
    dispatch declined), and run through ``_map_execute``."""

    def __init__(self, children: List["PhysicalOp"], schema: Schema, num_partitions: int):
        self.children = children
        self.schema = schema
        self.num_partitions = num_partitions

    def map_empty(self, ctx):
        """Partitions to emit when the mapped input is empty."""
        return iter(())

    def _map_execute(self, inputs, ctx):
        """Sequential loop over map_partition with device double-buffering:
        ops that implement map_partition_dispatch launch partition i+1 on the
        card BEFORE partition i's result is fetched back. Output order is
        preserved; a host-path partition first drains the pending one."""
        saw = False
        pending = None  # deferred resolver of the previous device partition
        for part in inputs[0]:
            saw = True
            dispatch = self.map_partition_dispatch(part, ctx)
            if pending is not None:
                yield pending()
                pending = None
            if dispatch is not None:
                pending = dispatch
                continue
            yield self.map_partition_declined(part, ctx)
        if pending is not None:
            yield pending()
        if not saw:
            yield from self.map_empty(ctx)

    def map_partition(self, part, ctx):
        raise NotImplementedError

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


class InMemoryOp(PhysicalOp):
    def __init__(self, parts: List[MicroPartition], schema: Schema):
        super().__init__([], schema, max(len(parts), 1))
        self.parts = parts

    def execute(self, inputs, ctx) -> PartStream:
        yield from self.parts


class ProjectOp(PhysicalOp):
    def __init__(self, child: PhysicalOp, exprs: List[Expression], schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.exprs = exprs

    def map_partition(self, part, ctx):
        ctx.stats.bump("host_projections")
        return part.eval_expression_list(self.exprs)

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)

    def describe(self):
        return "Project: " + ", ".join(e._node.display() for e in self.exprs)


class FilterOp(PhysicalOp):
    def __init__(self, child: PhysicalOp, predicate: Expression):
        super().__init__([child], child.schema, child.num_partitions)
        self.predicate = predicate

    def map_partition(self, part, ctx):
        ctx.stats.bump("host_filters")
        return part.filter([self.predicate])

    def execute(self, inputs, ctx) -> PartStream:
        return self._map_execute(inputs, ctx)

    def describe(self):
        return f"Filter: {self.predicate._node.display()}"


class LimitOp(PhysicalOp):
    """Streaming global limit: takes partitions until ``limit`` rows are out,
    then stops reading its input."""

    def __init__(self, child: PhysicalOp, limit: int):
        super().__init__([child], child.schema, child.num_partitions)
        self.limit = limit

    def execute(self, inputs, ctx) -> PartStream:
        remaining = self.limit
        if remaining <= 0:
            return
        for part in inputs[0]:
            if len(part) > remaining:
                part = part.head(remaining)
            remaining -= len(part)
            yield part
            if remaining <= 0:
                break

    def describe(self):
        return f"Limit: {self.limit}"


class SortOp(PhysicalOp):
    """Per-partition sort; translate gathers a multi-partition input first."""

    def __init__(self, child: PhysicalOp, sort_by, descending, nulls_first):
        super().__init__([child], child.schema, child.num_partitions)
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first

    def execute(self, inputs, ctx) -> PartStream:
        for part in inputs[0]:
            yield ctx.eval_sort(part, self.sort_by, self.descending, self.nulls_first)

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
        return ctx._eval_agg_host(part, self.aggregations, self.groupby or None)

    def map_partition_dispatch(self, part, ctx):
        return ctx.eval_agg_dispatch(part, self.aggregations, self.groupby or None)

    def map_empty(self, ctx):
        # a global agg over zero partitions still yields one row (count=0 etc.)
        if not self.groupby:
            yield MicroPartition.empty(self.children[0].schema).agg(self.aggregations, None)

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
        return ctx._eval_agg_host(part, self.aggregations, self.groupby or None,
                                  predicate=self.predicate)

    def map_partition_dispatch(self, part, ctx):
        return ctx.eval_agg_dispatch(part, self.aggregations, self.groupby or None,
                                     predicate=self.predicate)

    def describe(self):
        a = ", ".join(e._node.display() for e in self.aggregations)
        g = ", ".join(e._node.display() for e in self.groupby)
        return (f"FusedFilterAggregate: where {self.predicate._node.display()} agg {a}"
                + (f" by [{g}]" if g else ""))


class GatherOp(PhysicalOp):
    """All partitions -> one."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.schema, 1)

    def execute(self, inputs, ctx) -> PartStream:
        parts = list(inputs[0])
        yield (MicroPartition.empty(self.schema) if not parts
               else parts[0] if len(parts) == 1
               else MicroPartition.concat(parts))


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
    the right. ``translate`` gathers each side into one partition first when
    either has several (the port has no shuffle yet)."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, left_on, right_on,
                 how: str, schema: Schema, suffix: str = "right."):
        super().__init__([left, right], schema, max(left.num_partitions, right.num_partitions))
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.suffix = suffix

    def execute(self, inputs, ctx) -> PartStream:
        lparts = list(inputs[0])
        rparts = list(inputs[1])
        lschema = self.children[0].schema
        rschema = self.children[1].schema

        def pairs():
            for i in range(max(len(lparts), len(rparts))):
                l = lparts[i] if i < len(lparts) else MicroPartition.empty(lschema)
                r = rparts[i] if i < len(rparts) else MicroPartition.empty(rschema)
                yield l, r, self.left_on, self.right_on

        yield from _pipelined_join(ctx, pairs(), self.how, self.suffix)

    def describe(self):
        return f"HashJoin[{self.how}]"


class BroadcastJoinOp(PhysicalOp):
    """Collect the small side whole, stream the big side's partitions
    against it."""

    def __init__(self, big: PhysicalOp, small: PhysicalOp, big_on, small_on,
                 how: str, schema: Schema, small_is_left: bool, suffix: str = "right."):
        super().__init__([big, small], schema, big.num_partitions)
        self.big_on = big_on
        self.small_on = small_on
        self.how = how
        self.small_is_left = small_is_left
        self.suffix = suffix

    def execute(self, inputs, ctx) -> PartStream:
        small_parts = list(inputs[1])
        small = (MicroPartition.concat(small_parts) if len(small_parts) > 1
                 else small_parts[0] if small_parts
                 else MicroPartition.empty(self.children[1].schema))
        ctx.stats.bump("broadcast_joins")

        def pairs():
            for part in inputs[0]:
                if self.small_is_left:
                    yield small, part, self.small_on, self.big_on
                else:
                    yield part, small, self.big_on, self.small_on

        yield from _pipelined_join(ctx, pairs(), self.how, self.suffix)

    def describe(self):
        return f"BroadcastJoin[{self.how}]"


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
    """Public entry: recursive translation, then device-path fusion
    (``fuse_for_device``), then map-chain fusion (``fuse_map_chains``,
    behind ``cfg.expr_fusion``), then the plan-segment compiler
    (``compile_plan_segments``, behind ``cfg.use_device_kernels`` and
    ``cfg.device_residency``). ``stats`` receives ``segment_compiles``."""
    if cfg is None:
        from .context import get_context

        cfg = get_context().execution_config
    out = fuse_for_device(_translate(plan, cfg))
    if cfg.expr_fusion:
        from .fuse import fuse_map_chains

        out = fuse_map_chains(out, cfg)
    if cfg.use_device_kernels and cfg.device_residency:
        # last: the segment compiler consumes the Aggregate-over-FusedMap
        # trees the fuse passes built
        from .fuse import compile_plan_segments

        out = compile_plan_segments(out, cfg, stats)
    return out


def _translate(plan: LogicalPlan, cfg) -> PhysicalOp:
    if isinstance(plan, InMemorySource):
        return InMemoryOp(plan.partitions, plan.schema)
    if isinstance(plan, Project):
        return ProjectOp(_translate(plan.input, cfg), plan.exprs, plan.schema)
    if isinstance(plan, Filter):
        return FilterOp(_translate(plan.input, cfg), plan.predicate)
    if isinstance(plan, Limit):
        return LimitOp(_translate(plan.input, cfg), plan.limit)
    if isinstance(plan, Sort):
        return SortOp(_gathered(_translate(plan.input, cfg)), plan.sort_by,
                      plan.descending, plan.nulls_first)
    if isinstance(plan, Aggregate):
        return AggregateOp(_gathered(_translate(plan.input, cfg)), plan.aggregations,
                           plan.groupby, plan.schema)
    if isinstance(plan, Join):
        return _translate_join(plan, cfg)
    raise ValueError(f"cannot translate logical node {plan.name()}")


def _translate_join(plan: Join, cfg) -> PhysicalOp:
    left = _translate(plan.left, cfg)
    right = _translate(plan.right, cfg)
    strategy = plan.strategy or _choose_join_strategy(plan, cfg)
    if strategy == "broadcast" and plan.how == "outer":
        # an outer join preserves both sides: replaying the replicated side
        # per big-side partition would duplicate its unmatched rows
        strategy = "hash"
    if strategy == "broadcast":
        lsize = plan.left.approx_size_bytes()
        rsize = plan.right.approx_size_bytes()
        if _broadcast_side(plan, lsize, rsize) == "left":
            return BroadcastJoinOp(right, left, plan.right_on, plan.left_on, plan.how,
                                   plan.schema, small_is_left=True, suffix=plan.suffix)
        return BroadcastJoinOp(left, right, plan.left_on, plan.right_on, plan.how,
                               plan.schema, small_is_left=False, suffix=plan.suffix)
    if max(left.num_partitions, right.num_partitions) > 1:
        left, right = GatherOp(left), GatherOp(right)
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


def _gathered(child: PhysicalOp) -> PhysicalOp:
    return GatherOp(child) if child.num_partitions > 1 else child
