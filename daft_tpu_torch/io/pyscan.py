"""User-extensible Python scan sources (the port's copy of
daft_tpu/io/pyscan.py).

A ``ScanOperator`` exposes a third-party catalog's or storage client's
fragments as ``FactoryScanTask``s whose bytes a plain Python callable
produces; those tasks flow through the same lazy MicroPartition and
pushdown machinery as file scans. ``read_lance`` (io/catalogs.py) is built
on this layer. A factory task is never cached: a callable's identity
cannot be fingerprinted (``runners._scan_task_key``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Iterator, List, Optional

from ..schema import Schema
from ..stats import TableStats
from .scan import Pushdowns, ScanTask


class ScanOperator(ABC):
    """A pluggable source of scan tasks.

    Implementations enumerate their fragments as `FactoryScanTask`s. The
    `can_absorb_*` flags declare which pushdowns the operator's factories
    honor themselves — `from_scan_operator` copies them onto tasks that don't
    set `absorbs` explicitly; anything not absorbed is re-applied by the
    engine after materialization, so a conservative `False` is always correct.
    """

    def display_name(self) -> str:
        return type(self).__name__

    @abstractmethod
    def schema(self) -> Schema: ...

    def partitioning_keys(self) -> List[str]:
        return []

    def can_absorb_filter(self) -> bool:
        return False

    def can_absorb_limit(self) -> bool:
        return False

    def can_absorb_select(self) -> bool:
        return False

    @abstractmethod
    def to_scan_tasks(self, pushdowns: Pushdowns) -> Iterator["FactoryScanTask"]: ...

    def multiline_display(self) -> List[str]:
        return [self.display_name(), f"Schema = {self.schema().field_names()}"]


class FactoryScanTask(ScanTask):
    """A scan task whose bytes come from a Python callable, not a file.

    The factory is invoked as `factory(pushdowns)` and may return a pyarrow
    Table/RecordBatch, an iterable of RecordBatches, or a Table. All
    pushdowns are re-applied after materialization unless `absorbs` names them
    (("columns", "filters", "limit") subset) — double-applying a projection,
    filter, or limit is idempotent, so a factory that partially honors its
    pushdowns stays correct.
    """

    __slots__ = ("factory", "absorbs")

    def __init__(self, factory: Callable[[Pushdowns], Any], schema: Schema,
                 pushdowns: Optional[Pushdowns] = None,
                 num_rows: Optional[int] = None,
                 size_bytes: Optional[int] = None,
                 stats: Optional[TableStats] = None,
                 label: str = "python-factory",
                 absorbs: tuple = ()):
        super().__init__(label, "python", schema, pushdowns, None,
                         num_rows, size_bytes, stats)
        self.factory = factory
        self.absorbs = tuple(absorbs)

    def __repr__(self) -> str:
        return f"FactoryScanTask({self.path}, {self.pushdowns!r})"

    def with_pushdowns(self, pushdowns: Pushdowns) -> "FactoryScanTask":
        return FactoryScanTask(self.factory, self.schema, pushdowns,
                               self._num_rows, self._size_bytes, self.stats,
                               self.path, self.absorbs)

    def read(self):
        import pyarrow as pa

        from ..expressions import Expression
        from ..table import Table

        pd = self.pushdowns
        factory_pd = pd
        if pd.filters is not None and pd.columns is not None:
            # a factory honoring the column pushdown must still produce the
            # filter's input columns, or the engine-side re-filter would lose
            # them (the union the file readers take in readers._project_columns)
            from ..logical import expr_input_columns

            need = expr_input_columns(Expression(pd.filters))
            extra = [c for c in need if c not in pd.columns and c in self.schema]
            if extra:
                factory_pd = pd.with_columns(list(pd.columns) + extra)
        raw = self.factory(factory_pd)
        if isinstance(raw, Table):
            tbl = raw
        elif isinstance(raw, (pa.Table, pa.RecordBatch)):
            tbl = Table.from_arrow(raw)
        else:  # an iterator of record batches
            batches = list(raw)
            if not batches:
                return Table.empty(self.materialized_schema)
            tbl = Table.from_arrow(pa.Table.from_batches(batches))
        if pd.filters is not None and "filters" not in self.absorbs:
            tbl = tbl.filter(Expression(pd.filters))
        if pd.limit is not None and "limit" not in self.absorbs:
            tbl = tbl.head(pd.limit)
        want = self.materialized_schema
        if tbl.schema.field_names() != want.field_names():
            tbl = tbl.select_columns([c for c in want.field_names()
                                      if c in tbl.schema])
        return tbl.cast_to_schema(want)


def from_scan_operator(op: ScanOperator):
    """Build a DataFrame over a custom ScanOperator.

    The operator's `can_absorb_*` flags become the default `absorbs` of its
    tasks: a task that did not set `absorbs` itself inherits them, so the
    engine skips re-applying the pushdowns the operator declared it honors.
    """
    from ..dataframe import DataFrame
    from ..logical import ScanSource

    flags = (("columns",) if op.can_absorb_select() else ()) \
        + (("filters",) if op.can_absorb_filter() else ()) \
        + (("limit",) if op.can_absorb_limit() else ())
    schema = op.schema()
    tasks = []
    for t in op.to_scan_tasks(Pushdowns()):
        if isinstance(t, FactoryScanTask) and not t.absorbs and flags:
            t = FactoryScanTask(t.factory, t.schema, t.pushdowns, t._num_rows,
                                t._size_bytes, t.stats, t.path, flags)
        tasks.append(t)
    return DataFrame(ScanSource(schema, tasks))
