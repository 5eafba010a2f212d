"""Logical plan: the lazy operator tree behind a DataFrame (the port's copy
of daft_tpu/logical.py). Every node resolves and validates its output schema
at construction time, so API misuse fails at build time, not at collect time.

This slice carries InMemorySource, Project, Filter, Sort and Aggregate.
Left out until a later slice: scans, limit, repartition, distinct, sample,
joins, concat, explode/unpivot/pivot, monotonic ids and writes, and the
expression-analysis helpers the optimizer uses.
"""

from __future__ import annotations

from typing import Any, List, Optional

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

