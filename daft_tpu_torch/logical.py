"""Logical plan: the lazy operator tree behind a DataFrame (the port's copy
of daft_tpu/logical.py). Every node resolves and validates its output schema
at construction time, so API misuse fails at build time, not at collect time.

This slice carries InMemorySource, Project, Filter, Limit, Sort,
Repartition (the hash scheme), Distinct, Aggregate and Join (with the size
estimate the join planner reads), and the expression-analysis helpers the
optimizer (optimizer.py) uses. Left out until a later slice: scans, the
random, range and into repartition schemes, sample, concat,
explode/unpivot/pivot, monotonic ids and writes, and the row-count estimates.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .datatypes import try_unify
from .expressions import AggExpr, Alias, Column, Expression
from .schema import Field, Schema


# ---------------------------------------------------------------------------
# expression analysis
# ---------------------------------------------------------------------------

def expr_input_columns(e: Expression) -> List[str]:
    """Column names an expression reads (order of first reference)."""
    out: List[str] = []

    def walk(n):
        if isinstance(n, Column):
            if n.cname not in out:
                out.append(n.cname)
        for c in n.children():
            walk(c)

    walk(e._node)
    return out


def substitute_columns(e: Expression, mapping: Dict[str, Expression]) -> Expression:
    """Replace col(name) references with the mapped defining expressions."""

    def walk(n):
        if isinstance(n, Column) and n.cname in mapping:
            return mapping[n.cname]._node
        kids = n.children()
        if not kids:
            return n
        return n.with_children([walk(c) for c in kids])

    return Expression(walk(e._node))


def expr_has_special(e: Expression) -> bool:
    """True if the expression contains an aggregation (not freely movable).
    The reference also counts UDFs, which the port does not have yet."""
    found = [False]

    def walk(n):
        if isinstance(n, AggExpr):
            found[0] = True
        for c in n.children():
            walk(c)

    walk(e._node)
    return found[0]


def is_trivial_passthrough(e: Expression) -> Optional[str]:
    """If the expression is just col(x) (possibly aliased to the same name),
    return x; else None."""
    n = e._node
    alias = None
    while isinstance(n, Alias):
        alias = n.alias
        n = n.child
    if isinstance(n, Column) and (alias is None or alias == n.cname):
        return n.cname
    return None


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


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

    def num_partitions(self) -> int:
        ch = self.children()
        return max((c.num_partitions() for c in ch), default=1)

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

    def num_partitions(self) -> int:
        return max(len(self.partitions), 1)

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


class Repartition(UnaryNode):
    """A hash repartition on ``by`` into ``num`` partitions (None keeps the
    input's count). The reference's random, range and into schemes come
    with the shuffles between partitions (ROADMAP Queue 1, item 9)."""

    def __init__(self, input: LogicalPlan, scheme: str, num: Optional[int],
                 by: Optional[List[Expression]] = None):
        super().__init__(input)
        if scheme not in ("hash", "random", "range", "into"):
            raise ValueError(f"unknown repartition scheme {scheme!r}")
        if scheme != "hash":
            raise NotImplementedError(
                f"the {scheme!r} repartition scheme comes with a later slice of the port "
                "(ROADMAP Queue 1, item 9: shuffles between partitions)")
        if not by:
            raise ValueError("hash repartition requires partition-by expressions")
        self.scheme = scheme
        self.num = num
        self.by = by
        self.schema = input.schema

    def with_children(self, c):
        return Repartition(c[0], self.scheme, self.num, self.by)

    def num_partitions(self) -> int:
        return self.num if self.num is not None else self.input.num_partitions()

    def multiline_display(self):
        by = ", ".join(e._node.display() for e in self.by)
        return [f"Repartition: {self.scheme} num={self.num}" + (f" by=[{by}]" if by else "")]


class Distinct(UnaryNode):
    """The first row of each distinct tuple of ``subset`` (every column when
    None), in input order."""

    def __init__(self, input: LogicalPlan, subset: Optional[List[Expression]] = None):
        super().__init__(input)
        self.subset = subset
        self.schema = input.schema

    def with_children(self, c):
        return Distinct(c[0], self.subset)


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

    def num_partitions(self) -> int:
        return max(self.left.num_partitions(), self.right.num_partitions())

    def with_children(self, c):
        return Join(c[0], c[1], self.left_on, self.right_on, self.how, self.strategy,
                    self.suffix)

    def multiline_display(self):
        on = ", ".join(f"{l._node.display()}={r._node.display()}"
                       for l, r in zip(self.left_on, self.right_on))
        return [f"Join: {self.how} on {on}" + (f" [{self.strategy}]" if self.strategy else "")]
