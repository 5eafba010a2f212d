"""DataFrame: the lazy user-facing frame over a logical plan (the port's copy
of the part of daft_tpu/dataframe.py this slice runs).

Covers where/filter, select, groupby(...).agg, agg, sort, collect, to_pydict,
to_arrow, explain and the per-query ``stats``. Left out of this slice:
joins, limit, distinct, sample, repartition, explode/unpivot/pivot, writers,
profiling, the result cache and the integrations.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from .context import get_context
from .execution import RuntimeStats
from .expressions import Expression, col
from .logical import Aggregate, Filter, InMemorySource, LogicalPlan, Project, Sort
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
        """Logical plan (and the physical plan when show_all)."""
        out = ["== Logical Plan ==", self._plan.display_tree()]
        if show_all:
            from .physical import translate

            out += ["", "== Physical Plan ==", translate(self._plan).display_tree()]
        text = "\n".join(out)
        print(text)
        return text

    def select(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(Project(self._plan, [_to_expr(c) for c in columns]))

    def where(self, predicate: Expression) -> "DataFrame":
        return DataFrame(Filter(self._plan, predicate))

    filter = where

    def sort(self, by, desc: Union[bool, List[bool]] = False,
             nulls_first=None) -> "DataFrame":
        by = _to_exprs(by)
        desc = _norm_bools(desc, len(by))
        nf = _norm_bools(nulls_first, len(by), None)
        return DataFrame(Sort(self._plan, by, desc, nf))

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
