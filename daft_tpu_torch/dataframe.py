"""DataFrame: the lazy user-facing frame over a logical plan (the port's copy
of the part of daft_tpu/dataframe.py this slice runs).

Covers where/filter, select, with_column(s), groupby(...).agg, agg, sort,
join, limit/head, distinct/unique, repartition (by hash), collect,
to_pydict, to_arrow, explain and the per-query ``stats``. Left out of this
slice: cross joins, sample, the random, range and into repartitions
(``repartition`` without keys, ``into_partitions``), concat,
explode/unpivot/pivot, writers, profiling, the result cache and the
integrations.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from .context import get_context
from .execution import RuntimeStats
from .expressions import Expression, col
from .logical import (Aggregate, Distinct, Filter, InMemorySource, Join, Limit, LogicalPlan,
                      Project, Repartition, Sort)
from .micropartition import MicroPartition
from .runners import PartitionSet
from .schema import Schema

ColumnInput = Union[str, Expression]


def _to_expr(c: ColumnInput) -> Expression:
    return col(c) if isinstance(c, str) else c


def _to_exprs(cols) -> List[Expression]:
    if isinstance(cols, (str, Expression)):
        return [_to_expr(cols)]
    return [_to_expr(c) for c in cols]


def _norm_bools(v, k: int, default=False):
    if v is None:
        return [default] * k
    if isinstance(v, bool):
        return [v] * k
    out = list(v)
    if len(out) != k:
        raise ValueError(f"expected {k} flags, got {len(out)}")
    return out


class DataFrame:
    def __init__(self, plan: LogicalPlan, result: Optional[PartitionSet] = None):
        self._plan = plan
        self._result = result
        self.stats = RuntimeStats()

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def column_names(self) -> List[str]:
        return self._plan.schema.field_names()

    def explain(self, show_all: bool = False) -> str:
        """Logical plan (and optimized + physical when show_all)."""
        out = ["== Unoptimized Logical Plan ==", self._plan.display_tree()]
        if show_all:
            from .optimizer import optimize
            from .physical import translate

            opt = optimize(self._plan)
            out += ["", "== Optimized Logical Plan ==", opt.display_tree()]
            out += ["", "== Physical Plan ==",
                    translate(opt, get_context().execution_config).display_tree()]
        text = "\n".join(out)
        print(text)
        return text

    def select(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(Project(self._plan, [_to_expr(c) for c in columns]))

    def with_column(self, name: str, expr: Expression) -> "DataFrame":
        return self.with_columns({name: expr})

    def with_columns(self, columns: Dict[str, Expression]) -> "DataFrame":
        """A Project of every column, each named one replaced by (or, when
        new, appended as) its expression."""
        exprs: List[Expression] = []
        for n in self.column_names:
            exprs.append(_to_expr(columns[n]).alias(n) if n in columns else col(n))
        for n, e in columns.items():
            if n not in self.schema:
                exprs.append(_to_expr(e).alias(n))
        return DataFrame(Project(self._plan, exprs))

    def where(self, predicate: Expression) -> "DataFrame":
        return DataFrame(Filter(self._plan, predicate))

    filter = where

    def sort(self, by, desc: Union[bool, List[bool]] = False,
             nulls_first=None) -> "DataFrame":
        by = _to_exprs(by)
        desc = _norm_bools(desc, len(by))
        nf = _norm_bools(nulls_first, len(by), None)
        return DataFrame(Sort(self._plan, by, desc, nf))

    def distinct(self, *subset: ColumnInput) -> "DataFrame":
        return DataFrame(Distinct(self._plan, _to_exprs(subset) if subset else None))

    unique = distinct

    def limit(self, num: int) -> "DataFrame":
        if num < 0:
            raise ValueError(f"limit must be non-negative, got {num}")
        return DataFrame(Limit(self._plan, num))

    head = limit

    def repartition(self, num: Optional[int], *partition_by: ColumnInput) -> "DataFrame":
        """Hash-repartition by ``partition_by`` into ``num`` partitions.
        Without keys the reference repartitions at random, a scheme the port
        does not have yet (the Repartition node raises)."""
        if partition_by:
            return DataFrame(Repartition(self._plan, "hash", num, _to_exprs(partition_by)))
        return DataFrame(Repartition(self._plan, "random", num))

    def join(self, other: "DataFrame", on=None, left_on=None, right_on=None,
             how: str = "inner", strategy: Optional[str] = None,
             suffix: str = "right.") -> "DataFrame":
        """Equi-join with ``other`` on ``on`` (both sides) or on
        ``left_on``/``right_on``. Output row order is unspecified, as in the
        reference: sort after the join where order matters."""
        if on is not None:
            left_on = right_on = on
        if how != "cross" and (left_on is None or right_on is None):
            raise ValueError("join requires on= or left_on=/right_on=")
        lo = _to_exprs(left_on) if left_on is not None else []
        ro = _to_exprs(right_on) if right_on is not None else []
        return DataFrame(Join(self._plan, other._plan, lo, ro, how, strategy, suffix))

    def agg(self, *to_agg) -> "DataFrame":
        return DataFrame(Aggregate(self._plan, _normalize_aggs(to_agg), []))

    def groupby(self, *group_by: ColumnInput) -> "GroupedDataFrame":
        exprs: List[Expression] = []
        for g in group_by:
            exprs.extend(_to_exprs(g) if isinstance(g, (list, tuple)) else [_to_expr(g)])
        if not exprs:
            raise ValueError("groupby requires at least one column")
        return GroupedDataFrame(self, exprs)

    def collect(self) -> "DataFrame":
        """Materialize the plan; ``stats`` then holds the query's counters."""
        if self._result is not None:
            return self
        self._result = get_context().runner().run(self._plan, stats=self.stats)
        self._plan = InMemorySource(self._result.schema, self._result.partitions)
        return self

    def to_pydict(self) -> Dict[str, list]:
        return self.collect()._result.to_table().to_pydict()

    def to_arrow(self):
        return self.collect()._result.to_table().to_arrow()

    def __repr__(self) -> str:
        return f"DataFrame({self.schema!r})"


class GroupedDataFrame:
    """Result of df.groupby(...)."""

    def __init__(self, df: DataFrame, group_by: List[Expression]):
        self.df = df
        self.group_by = group_by

    def agg(self, *to_agg) -> DataFrame:
        return DataFrame(Aggregate(self.df._plan, _normalize_aggs(to_agg), self.group_by))


def _normalize_aggs(to_agg) -> List[Expression]:
    flat: List[Any] = []
    for a in to_agg:
        flat.extend(a) if isinstance(a, (list, tuple)) else flat.append(a)
    for e in flat:
        if not e._node.is_aggregation():
            raise ValueError(f"agg() expects aggregation expressions, got {e!r}")
    return flat


def from_partitions(parts: List[MicroPartition], schema: Schema) -> DataFrame:
    return DataFrame(InMemorySource(schema, parts), result=PartitionSet(schema, parts))
