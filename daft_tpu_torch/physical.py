"""Physical plan: operators that execute partition streams (the port's copy
of the part of daft_tpu/physical.py this slice runs).

An aggregation directly over a filter fuses into FusedFilterAggregateOp
(``fuse_for_device``): on the device path the predicate stays a mask that
feeds the masked segment reductions, with no host compaction between them.
TPC-H Q1 plans as Sort <- FusedFilterAggregate <- InMemory and Q6 as
FusedFilterAggregate <- InMemory.

Left out of this slice: scans, limit, shuffles (a multi-partition aggregate
or sort gathers its input into one partition instead of the reference's
two-stage hash exchange), joins, distinct/explode/pivot/sample/write ops,
the map-chain fusion (fuse/) and device-resident plan segments
(fuse/segment.py), the worker pool, streaming and batched UDFs.
"""

from __future__ import annotations

from typing import Iterator, List

from .expressions import Expression
from .logical import Aggregate, Filter, InMemorySource, LogicalPlan, Project, Sort
from .micropartition import MicroPartition
from .schema import Schema

PartStream = Iterator[MicroPartition]


class PhysicalOp:
    """Base: children + a generator-producing execute().

    Ops that are pure per-partition maps implement ``map_partition`` (the
    host path, (part, ctx) -> part), optionally ``map_partition_dispatch``
    (the device path), and run through ``_map_execute``."""

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
            yield self.map_partition(part, ctx)
        if pending is not None:
            yield pending()
        if not saw:
            yield from self.map_empty(ctx)

    def map_partition(self, part, ctx):
        raise NotImplementedError

    def map_partition_dispatch(self, part, ctx):
        """Optional non-blocking device launch: return a zero-arg resolver,
        or None to take the host path (map_partition)."""
        return None

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


def translate(plan: LogicalPlan) -> PhysicalOp:
    """Public entry: recursive translation, then device-path fusion."""
    return fuse_for_device(_translate(plan))


def _translate(plan: LogicalPlan) -> PhysicalOp:
    if isinstance(plan, InMemorySource):
        return InMemoryOp(plan.partitions, plan.schema)
    if isinstance(plan, Project):
        return ProjectOp(_translate(plan.input), plan.exprs, plan.schema)
    if isinstance(plan, Filter):
        return FilterOp(_translate(plan.input), plan.predicate)
    if isinstance(plan, Sort):
        return SortOp(_gathered(_translate(plan.input)), plan.sort_by,
                      plan.descending, plan.nulls_first)
    if isinstance(plan, Aggregate):
        return AggregateOp(_gathered(_translate(plan.input)), plan.aggregations,
                           plan.groupby, plan.schema)
    raise ValueError(f"cannot translate logical node {plan.name()}")


def _gathered(child: PhysicalOp) -> PhysicalOp:
    return GatherOp(child) if child.num_partitions > 1 else child
