"""Logical plan: the lazy operator tree behind a DataFrame (the port's copy
of daft_tpu/logical.py). Every node resolves and validates its output schema
at construction time, so API misuse fails at build time, not at collect time.

This slice carries InMemorySource, Project, Filter, Limit, Sort, Aggregate
and Join (with the size estimate the join planner reads). Left out until a
later slice: scans, repartition, distinct, sample, concat,
explode/unpivot/pivot, monotonic ids and writes, the row-count estimates and
the expression-analysis helpers the optimizer uses.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .datatypes import try_unify
from .expressions import Expression
from .schema import Field, Schema


class LogicalPlan:
    """Base class. Subclasses set .schema at construction."""

    schema: Schema

    def children(self) -> List["LogicalPlan"]:
        return []

    def with_children(self, children: List["LogicalPlan"]) -> "LogicalPlan":
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__

    def multiline_display(self) -> List[str]:
        return [self.name()]

    def approx_size_bytes(self) -> Optional[int]:
        """Estimated output bytes (what the join planner compares against
        the broadcast threshold), or None when unknown."""
        ch = self.children()
        if len(ch) == 1:
            return ch[0].approx_size_bytes()
        return None

    def display_tree(self, indent: str = "") -> str:
        lines = self.multiline_display()
        out = [indent + ("* " if indent else "") + lines[0]]
        for l in lines[1:]:
            out.append(indent + "|   " + l)
        for c in self.children():
            out.append(c.display_tree(indent + "  "))
        return "\n".join(out)

    def __repr__(self) -> str:
        return self.display_tree()


class InMemorySource(LogicalPlan):
    """Scan over already-materialized partitions (from_pydict / from_arrow).
    Reference: logical_ops/source.rs InMemoryInfo."""

    def __init__(self, schema: Schema, partitions: List[Any]):
        self.schema = schema
        self.partitions = partitions

    def with_children(self, children):
        assert not children
        return self

    def approx_size_bytes(self):
        return sum(p.size_bytes() for p in self.partitions)

    def multiline_display(self):
        return [f"InMemorySource: {len(self.partitions)} partitions",
                f"Schema = {self.schema.short_repr()}"]


class UnaryNode(LogicalPlan):
    def __init__(self, input: LogicalPlan):
        self.input = input

    def children(self):
        return [self.input]


class Project(UnaryNode):
    def __init__(self, input: LogicalPlan, exprs: List[Expression]):
        super().__init__(input)
        self.exprs = exprs
        fields = []
        seen = set()
        for e in exprs:
            f = e._node.to_field(input.schema)
            f = Field(e.name(), f.dtype)
            if f.name in seen:
                raise ValueError(f"duplicate column name {f.name!r} in projection")
            seen.add(f.name)
            fields.append(f)
        self.schema = Schema(fields)

    def with_children(self, c):
        return Project(c[0], self.exprs)

    def multiline_display(self):
        return ["Project: " + ", ".join(e._node.display() for e in self.exprs)]


class Filter(UnaryNode):
    def __init__(self, input: LogicalPlan, predicate: Expression):
        super().__init__(input)
        f = predicate._node.to_field(input.schema)
        if not (f.dtype.is_boolean() or f.dtype.is_null()):
            raise ValueError(f"filter predicate must be boolean, got {f.dtype}")
        self.predicate = predicate
        self.schema = input.schema

    def with_children(self, c):
        return Filter(c[0], self.predicate)

    def multiline_display(self):
        return [f"Filter: {self.predicate._node.display()}"]


class Limit(UnaryNode):
    def __init__(self, input: LogicalPlan, limit: int):
        super().__init__(input)
        self.limit = int(limit)
        self.schema = input.schema

    def with_children(self, c):
        return Limit(c[0], self.limit)

    def multiline_display(self):
        return [f"Limit: {self.limit}"]


class Sort(UnaryNode):
    def __init__(self, input: LogicalPlan, sort_by: List[Expression],
                 descending: List[bool], nulls_first: List[Optional[bool]]):
        super().__init__(input)
        for e in sort_by:
            f = e._node.to_field(input.schema)
            if not f.dtype.is_comparable():
                raise ValueError(f"cannot sort by {f.dtype}")
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.schema = input.schema

    def with_children(self, c):
        return Sort(c[0], self.sort_by, self.descending, self.nulls_first)

    def multiline_display(self):
        keys = ", ".join(
            f"{e._node.display()}{' desc' if d else ''}" for e, d in zip(self.sort_by, self.descending)
        )
        return [f"Sort: {keys}"]


class Aggregate(UnaryNode):
    def __init__(self, input: LogicalPlan, aggregations: List[Expression],
                 groupby: List[Expression]):
        super().__init__(input)
        self.aggregations = aggregations
        self.groupby = groupby
        fields = []
        seen = set()
        for e in groupby + aggregations:
            f = e._node.to_field(input.schema)
            f = Field(e.name(), f.dtype)
            if f.name in seen:
                raise ValueError(f"duplicate column {f.name!r} in aggregation output")
            seen.add(f.name)
            fields.append(f)
        self.schema = Schema(fields)

    def with_children(self, c):
        return Aggregate(c[0], self.aggregations, self.groupby)

    def multiline_display(self):
        lines = ["Aggregate: " + ", ".join(e._node.display() for e in self.aggregations)]
        if self.groupby:
            lines.append("Group by = " + ", ".join(e._node.display() for e in self.groupby))
        return lines



def join_output_schema(left: Schema, right: Schema, left_on: List[Expression],
                       right_on: List[Expression], how: str, suffix: str = "right.") -> Schema:
    """Schema of a join output; must stay in lockstep with Table.hash_join."""
    if how in ("semi", "anti"):
        return left
    lk_names = [e.name() for e in left_on]
    rk_names = [e.name() for e in right_on]
    fields: List[Field] = []
    left_names = set(left.field_names())
    for i, ln in enumerate(lk_names):
        lf = left_on[i]._node.to_field(left)
        rf = right_on[i]._node.to_field(right)
        u = try_unify(lf.dtype, rf.dtype)
        if u is None:
            raise ValueError(f"cannot join on {lf.dtype} vs {rf.dtype}")
        fields.append(Field(ln, u))
    for f in left:
        if f.name not in lk_names:
            fields.append(f)
    for f in right:
        if f.name in rk_names:
            continue
        name = f.name if f.name not in left_names else f"{suffix}{f.name}"
        fields.append(Field(name, f.dtype))
    return Schema(fields)


class Join(LogicalPlan):
    """An equi-join of two plans. Hows inner, left, right, outer, semi and
    anti; strategies None (the planner chooses), "hash" and "broadcast".
    Cross joins and the "sort_merge" strategy are not ported yet."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_on: List[Expression], right_on: List[Expression],
                 how: str = "inner", strategy: Optional[str] = None,
                 suffix: str = "right."):
        if how not in ("inner", "left", "right", "outer", "semi", "anti", "cross"):
            raise ValueError(f"unknown join type {how!r}")
        if strategy not in (None, "hash", "sort_merge", "broadcast"):
            raise ValueError(f"unknown join strategy {strategy!r}")
        if how == "cross" or strategy == "sort_merge":
            raise NotImplementedError(
                "cross joins and the sort_merge strategy come with a later slice of the "
                "port (CrossJoinOp, SortMergeJoinOp)")
        if not left_on or len(left_on) != len(right_on):
            raise ValueError("join requires equal-length left_on/right_on")
        self.left = left
        self.right = right
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.strategy = strategy
        self.suffix = suffix
        self.schema = join_output_schema(left.schema, right.schema, left_on, right_on, how,
                                         suffix)

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return Join(c[0], c[1], self.left_on, self.right_on, self.how, self.strategy,
                    self.suffix)

    def multiline_display(self):
        on = ", ".join(f"{l._node.display()}={r._node.display()}"
                       for l, r in zip(self.left_on, self.right_on))
        return [f"Join: {self.how} on {on}" + (f" [{self.strategy}]" if self.strategy else "")]
