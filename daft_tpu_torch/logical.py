"""Logical plan: the lazy operator tree behind a DataFrame (the port's copy
of daft_tpu/logical.py). Every node resolves and validates its output schema
at construction time, so API misuse fails at build time, not at collect time.

This slice carries InMemorySource, ScanSource (files through scan tasks),
Project, Filter, Limit, Sort,
Repartition (hash, range, random and into), Distinct, Sample, Aggregate,
Pivot, Join (every join type, the cross join among them, with the size
estimate the join planner reads), Concat, Explode, Unpivot and
MonotonicallyIncreasingId, Write (parquet, CSV or JSON files, optionally
hive-partitioned; its schema is the manifest's), and the
expression-analysis helpers the optimizer (optimizer.py) uses. Left out
until a later slice: the lake writers' nodes, and the row-count estimates
of the nodes above a source.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .datatypes import DataType, try_unify
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
    """True if the expression contains an aggregation or a UDF (not freely
    movable: the optimizer never pushes a filter through such a projection,
    nor merges or reorders it)."""
    from .expressions import PyUdf

    found = [False]

    def walk(n):
        if isinstance(n, (AggExpr, PyUdf)):
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
        import uuid

        self.schema = schema
        self.partitions = partitions
        # the data's identity for the plan and result caches and the site
        # keys of feedback-directed planning: a uuid is never reused, where
        # an id() is after garbage collection
        self._cache_token = uuid.uuid4().hex

    def with_children(self, children):
        assert not children
        return self

    def num_partitions(self) -> int:
        return max(len(self.partitions), 1)

    def approx_size_bytes(self):
        # an unloaded partition whose size is unknown counts as 0, as in
        # the reference
        return sum(p.size_bytes() or 0 for p in self.partitions)

    def multiline_display(self):
        return [f"InMemorySource: {len(self.partitions)} partitions",
                f"Schema = {self.schema.short_repr()}"]


class ScanSource(LogicalPlan):
    """Scan over files through ScanTasks (io/scan.py). The optimizer installs
    the pushdowns (columns, a filter, a limit) on the tasks; the visible
    schema follows the column pushdown, which every task shares."""

    def __init__(self, schema: Schema, tasks: List[Any]):
        self.file_schema = schema
        self.tasks = tasks
        self.schema = tasks[0].materialized_schema if tasks else schema

    def with_children(self, children):
        assert not children
        return self

    def with_pushdowns(self, pushdowns) -> "ScanSource":
        return ScanSource(self.file_schema, [t.with_pushdowns(pushdowns) for t in self.tasks])

    def pushdowns(self):
        from .io.scan import Pushdowns

        return self.tasks[0].pushdowns if self.tasks else Pushdowns()

    def num_partitions(self) -> int:
        return max(len(self.tasks), 1)

    def approx_num_rows(self) -> Optional[int]:
        """The rows after pushdowns, from file metadata (None under a
        pushed filter, or where a task does not know)."""
        total = 0
        for t in self.tasks:
            n = t.num_rows()
            if n is None:
                return None
            total += n
        return total

    def approx_size_bytes(self) -> Optional[int]:
        """The tasks' bytes: the file's size, or its row groups' from the
        footer, whatever the pushdowns read of it."""
        total = 0
        for t in self.tasks:
            n = t.size_bytes()
            if n is None:
                return None
            total += n
        return total

    def multiline_display(self):
        lines = [f"ScanSource: {len(self.tasks)} tasks"]
        if self.tasks:
            lines.append(f"Format = {self.tasks[0].format}")
            pd = self.pushdowns()
            if not pd.is_empty():
                lines.append(f"Pushdowns = {pd!r}")
        lines.append(f"Schema = {self.schema.short_repr()}")
        return lines


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
    """A repartition into ``num`` partitions (None keeps the input's
    count): ``hash`` on ``by``, ``range`` on ``by`` (each key ascending
    unless ``descending`` says otherwise), ``random``, or ``into`` without
    a shuffle (coalesce or split)."""

    def __init__(self, input: LogicalPlan, scheme: str, num: Optional[int],
                 by: Optional[List[Expression]] = None,
                 descending: Optional[List[bool]] = None):
        super().__init__(input)
        if scheme not in ("hash", "random", "range", "into"):
            raise ValueError(f"unknown repartition scheme {scheme!r}")
        if scheme == "hash" and not by:
            raise ValueError("hash repartition requires partition-by expressions")
        self.scheme = scheme
        self.num = num
        self.by = by or []
        self.descending = descending or [False] * len(self.by)
        self.schema = input.schema

    def with_children(self, c):
        return Repartition(c[0], self.scheme, self.num, self.by, self.descending)

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


class Sample(UnaryNode):
    """A draw of ``fraction`` of each partition's rows, with or without
    replacement, seeded by ``seed`` plus the partition's index."""

    def __init__(self, input: LogicalPlan, fraction: float, with_replacement: bool,
                 seed: Optional[int]):
        super().__init__(input)
        self.fraction = fraction
        self.with_replacement = with_replacement
        self.seed = seed
        self.schema = input.schema

    def with_children(self, c):
        return Sample(c[0], self.fraction, self.with_replacement, self.seed)


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


class Pivot(UnaryNode):
    """One row per ``groupby`` tuple and one column per name in ``names``:
    ``agg_fn`` of ``value_col`` over the rows whose ``pivot_col`` is that
    name (null where there are none)."""

    def __init__(self, input: LogicalPlan, groupby: List[Expression], pivot_col: Expression,
                 value_col: Expression, agg_fn: str, names: List[str]):
        super().__init__(input)
        self.groupby = groupby
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_fn = agg_fn
        self.names = names
        vf = AggExpr(agg_fn, value_col._node).to_field(input.schema)
        fields = [Field(e.name(), e._node.to_field(input.schema).dtype) for e in groupby]
        fields += [Field(str(n), vf.dtype) for n in names]
        self.schema = Schema(fields)

    def with_children(self, c):
        return Pivot(c[0], self.groupby, self.pivot_col, self.value_col, self.agg_fn,
                     self.names)


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
    """An equi-join of two plans (hows inner, left, right, outer, semi and
    anti) or a cross join (``how="cross"``, no keys; the left fields, then
    the right ones, ``suffix`` on a clash). Strategies None (the planner
    chooses), "hash", "sort_merge" and "broadcast"."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_on: List[Expression], right_on: List[Expression],
                 how: str = "inner", strategy: Optional[str] = None,
                 suffix: str = "right."):
        if how not in ("inner", "left", "right", "outer", "semi", "anti", "cross"):
            raise ValueError(f"unknown join type {how!r}")
        if strategy not in (None, "hash", "sort_merge", "broadcast"):
            raise ValueError(f"unknown join strategy {strategy!r}")
        if how == "cross":
            if left_on or right_on:
                raise ValueError("cross join takes no keys")
        elif not left_on or len(left_on) != len(right_on):
            raise ValueError("join requires equal-length left_on/right_on")
        self.left = left
        self.right = right
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.strategy = strategy
        self.suffix = suffix
        if how == "cross":
            lnames = set(left.schema.field_names())
            self.schema = Schema(list(left.schema) + [
                Field(f.name if f.name not in lnames else f"{suffix}{f.name}", f.dtype)
                for f in right.schema])
        else:
            self.schema = join_output_schema(left.schema, right.schema, left_on, right_on,
                                             how, suffix)

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
        return [f"Join: {self.how}" + (f" on {on}" if on else "")
                + (f" [{self.strategy}]" if self.strategy else "")]


class Concat(LogicalPlan):
    """The rows of ``input``, then those of ``other``: equal column names,
    each column's type the unification of the two sides'."""

    def __init__(self, input: LogicalPlan, other: LogicalPlan):
        if input.schema.field_names() != other.schema.field_names():
            raise ValueError(f"concat schema mismatch: {input.schema.field_names()} vs "
                             f"{other.schema.field_names()}")
        fields = []
        for a, b in zip(input.schema, other.schema):
            u = try_unify(a.dtype, b.dtype)
            if u is None:
                raise ValueError(f"concat column {a.name!r}: {a.dtype} vs {b.dtype}")
            fields.append(Field(a.name, u))
        self.input = input
        self.other = other
        self.schema = Schema(fields)

    def children(self):
        return [self.input, self.other]

    def with_children(self, c):
        return Concat(c[0], c[1])

    def num_partitions(self) -> int:
        return self.input.num_partitions() + self.other.num_partitions()


class Explode(UnaryNode):
    """One row per element of the list columns ``to_explode`` (equal list
    lengths per row; an empty or null list gives one null row)."""

    def __init__(self, input: LogicalPlan, to_explode: List[Expression]):
        super().__init__(input)
        self.to_explode = to_explode
        names = {e.name() for e in to_explode}
        fields = []
        for f in input.schema:
            if f.name in names:
                if not f.dtype.is_list():
                    raise ValueError(f"cannot explode non-list column {f.name!r} ({f.dtype})")
                fields.append(Field(f.name, f.dtype.inner))
            else:
                fields.append(f)
        self.schema = Schema(fields)

    def with_children(self, c):
        return Explode(c[0], self.to_explode)


class Unpivot(UnaryNode):
    """Wide to long: the ``ids`` columns, then ``variable_name`` (the name
    of a value column) and ``value_name`` (its value, the value columns'
    unified type), one row per input row and value column."""

    def __init__(self, input: LogicalPlan, ids: List[Expression], values: List[Expression],
                 variable_name: str, value_name: str):
        super().__init__(input)
        if not values:
            raise ValueError("unpivot requires at least one value column")
        self.ids = ids
        self.values = values
        self.variable_name = variable_name
        self.value_name = value_name
        vdt = None
        for e in values:
            dt = e._node.to_field(input.schema).dtype
            vdt = dt if vdt is None else try_unify(vdt, dt)
            if vdt is None:
                raise ValueError("unpivot value columns have incompatible types")
        fields = [Field(e.name(), e._node.to_field(input.schema).dtype) for e in ids]
        fields.append(Field(variable_name, DataType.string()))
        fields.append(Field(value_name, vdt))
        self.schema = Schema(fields)

    def with_children(self, c):
        return Unpivot(c[0], self.ids, self.values, self.variable_name, self.value_name)


class MonotonicallyIncreasingId(UnaryNode):
    """A uint64 id column first: partition i numbers its rows from
    ``i << 36``."""

    def __init__(self, input: LogicalPlan, column_name: str = "id"):
        super().__init__(input)
        self.column_name = column_name
        self.schema = Schema([Field(column_name, DataType.uint64())] + list(input.schema))

    def with_children(self, c):
        return MonotonicallyIncreasingId(c[0], self.column_name)


class Write(UnaryNode):
    """Writes its input under ``root_dir``; its rows are the manifest: a
    ``path`` per written file, plus the key columns of a hive-partitioned
    write."""

    def __init__(self, input: LogicalPlan, root_dir: str, format: str = "parquet",
                 compression: Optional[str] = None,
                 partition_cols: Optional[List[Expression]] = None):
        super().__init__(input)
        self.root_dir = root_dir
        self.format = format
        self.compression = compression
        self.partition_cols = partition_cols
        fields = [Field("path", DataType.string())]
        for e in partition_cols or []:
            fields.append(Field(e.name(), e._node.to_field(input.schema).dtype))
        self.schema = Schema(fields)

    def with_children(self, c):
        return Write(c[0], self.root_dir, self.format, self.compression, self.partition_cols)

    def multiline_display(self):
        return [f"Write: {self.format} -> {self.root_dir}"]
