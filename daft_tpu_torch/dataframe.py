"""DataFrame: the lazy user-facing frame over a logical plan (the port's copy
of the part of daft_tpu/dataframe.py this slice runs).

Covers where/filter, drop_null, drop_nan, select, exclude, with_column(s),
with_column(s)_renamed, groupby(...).agg, agg, count_rows/len, sort, join
(every join type, cross joins among them, and the hash, broadcast and
sort-merge strategies), concat, limit/head, distinct/unique, sample,
repartition, into_partitions, explode, unpivot/melt, pivot,
with_monotonically_increasing_id, the aggregation shorthands of DataFrame
and GroupedDataFrame (sum, mean, min, max, stddev, any_value, count,
agg_list, agg_concat), collect, explain and the per-query
``stats``, over in-memory frames and over the file scans of api.py
(read_parquet, read_csv, read_json, local or remote) and the lake readers,
and the output surface: the writers (write_parquet, write_csv, write_json
to local paths or object-store urls, each returning the manifest of the
written files; write_iceberg, write_deltalake and write_lance, each
returning the added files), the Ray and Dask conversions (each raising an
ImportError where its package is missing), num_partitions, iter_partitions, iter_rows, to_arrow_iter,
to_pydict, to_pylist, to_arrow, to_pandas, to_table, show and a ``repr``
that previews a collected frame (``num_preview_rows``) and never runs the
plan. ``collect(profile=...)`` records a QueryProfile (``profile()``, and
to a JSON file given a path), ``explain_analyze`` renders the runtime
stats and the profile's timeline, and ``last_query_record`` is the query
log's record of the latest execution. ``cancel()`` stops a running
execution from another thread (``QueryCancelledError``, a ``cancelled``
record); ``collect`` re-arms the handle. Left out of this slice: the
torch datasets and the HTML preview with its viz hooks (ROADMAP, Queue 1,
item 10) and the integrations.
GroupedDataFrame.map_groups runs a python UDF once per group, and a
python UDF (udf.py) may appear in any expression; SQL texts plan through
sql.py onto this API, and ``where`` takes a SQL predicate too.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

from .context import get_context
from .execution import RuntimeStats
from .expressions import AggExpr, Expression, col
from .logical import (Aggregate, Concat, Distinct, Explode, Filter, InMemorySource, Join, Limit,
                      LogicalPlan, MonotonicallyIncreasingId, Pivot, Project, Repartition,
                      Sample, Sort, Unpivot, Write)
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
        self._profile = None  # the QueryProfile of a profiled collect()

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def column_names(self) -> List[str]:
        return self._plan.schema.field_names()

    def num_partitions(self) -> int:
        return self._plan.num_partitions()

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

    def explain_analyze(self) -> str:
        """Execute (if not collected yet, with the profiler armed) and render
        each operator's rows, wall time and throughput, the IO, fusion,
        planning, batching, exchange and residency lines and the counters,
        then the profile's per-op timeline and critical path."""
        from .obs.capture import render_runtime_stats

        self.collect(profile=True)
        lines = [render_runtime_stats(self.stats)]
        if self._profile is not None and self._profile.ops:
            lines.append("")
            lines.append(self._profile.render_timeline())
        text = "\n".join(lines)
        print(text)
        return text

    def select(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(Project(self._plan, [_to_expr(c) for c in columns]))

    def exclude(self, *names: str) -> "DataFrame":
        drop = set(names)
        return DataFrame(Project(self._plan, [col(n) for n in self.column_names
                                              if n not in drop]))

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

    def with_column_renamed(self, existing: str, new: str) -> "DataFrame":
        return self.with_columns_renamed({existing: new})

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "DataFrame":
        return DataFrame(Project(self._plan, [col(n).alias(mapping.get(n, n))
                                              for n in self.column_names]))

    def where(self, predicate: Union[Expression, str]) -> "DataFrame":
        """The rows where ``predicate`` holds (an Expression or a SQL text)."""
        if isinstance(predicate, str):
            from .sql import sql_expr

            predicate = sql_expr(predicate)
        return DataFrame(Filter(self._plan, predicate))

    filter = where

    def drop_null(self, *columns: ColumnInput) -> "DataFrame":
        """The rows with no null in ``columns`` (every column when none)."""
        exprs = _to_exprs(columns) if columns else [col(n) for n in self.column_names]
        pred = exprs[0].not_null()
        for e in exprs[1:]:
            pred = pred & e.not_null()
        return self.where(pred)

    def drop_nan(self, *columns: ColumnInput) -> "DataFrame":
        """The rows with no NaN in ``columns`` (every float column when
        none); nulls stay."""
        exprs = (_to_exprs(columns) if columns
                 else [col(f.name) for f in self.schema if f.dtype.is_floating()])
        if not exprs:
            return self
        pred = None
        for e in exprs:
            p = e.is_null() | e.float.not_nan()
            pred = p if pred is None else (pred & p)
        return self.where(pred)

    def sort(self, by, desc: Union[bool, List[bool]] = False,
             nulls_first=None) -> "DataFrame":
        by = _to_exprs(by)
        desc = _norm_bools(desc, len(by))
        nf = _norm_bools(nulls_first, len(by), None)
        return DataFrame(Sort(self._plan, by, desc, nf))

    def distinct(self, *subset: ColumnInput) -> "DataFrame":
        return DataFrame(Distinct(self._plan, _to_exprs(subset) if subset else None))

    unique = distinct

    def sample(self, fraction: float, with_replacement: bool = False,
               seed: Optional[int] = None) -> "DataFrame":
        """``round(fraction * n)`` rows of each partition of n rows, drawn
        with seed ``seed`` plus the partition's index."""
        if fraction < 0.0 or fraction > 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        return DataFrame(Sample(self._plan, fraction, with_replacement, seed))

    def limit(self, num: int) -> "DataFrame":
        if num < 0:
            raise ValueError(f"limit must be non-negative, got {num}")
        return DataFrame(Limit(self._plan, num))

    head = limit

    def repartition(self, num: Optional[int], *partition_by: ColumnInput) -> "DataFrame":
        """Hash-repartition by ``partition_by`` into ``num`` partitions, or,
        without keys, repartition at random."""
        if partition_by:
            return DataFrame(Repartition(self._plan, "hash", num, _to_exprs(partition_by)))
        return DataFrame(Repartition(self._plan, "random", num))

    def into_partitions(self, num: int) -> "DataFrame":
        """Coalesce or split into ``num`` partitions without a shuffle."""
        return DataFrame(Repartition(self._plan, "into", num))

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

    def concat(self, other: "DataFrame") -> "DataFrame":
        """This frame's rows, then ``other``'s (equal column names)."""
        return DataFrame(Concat(self._plan, other._plan))

    def explode(self, *columns: ColumnInput) -> "DataFrame":
        return DataFrame(Explode(self._plan, _to_exprs(columns)))

    def unpivot(self, ids, values=None, variable_name: str = "variable",
                value_name: str = "value") -> "DataFrame":
        """Wide to long; ``values`` defaults to every column not in ``ids``."""
        ids = _to_exprs(ids)
        if values is None:
            id_names = {e.name() for e in ids}
            values = [col(n) for n in self.column_names if n not in id_names]
        else:
            values = _to_exprs(values)
        return DataFrame(Unpivot(self._plan, ids, values, variable_name, value_name))

    melt = unpivot

    def pivot(self, group_by, pivot_col: ColumnInput, value_col: ColumnInput,
              agg_fn: str, names: Optional[List[str]] = None) -> "DataFrame":
        """One column per value of ``pivot_col`` (``names``; when None, the
        column's distinct values but null, found by running a query now)."""
        group_by = _to_exprs(group_by)
        pivot_e = _to_expr(pivot_col)
        value_e = _to_expr(value_col)
        if names is None:
            names_df = DataFrame(self._plan).select(pivot_e).distinct().collect()
            names = [v for v in names_df.to_pydict()[pivot_e.name()] if v is not None]
        return DataFrame(Pivot(self._plan, group_by, pivot_e, value_e, agg_fn, names))

    def _add_monotonic_id(self, column_name: str = "id") -> "DataFrame":
        return DataFrame(MonotonicallyIncreasingId(self._plan, column_name))

    with_monotonically_increasing_id = _add_monotonic_id

    # ------------------------------------------------------------------ aggregation
    def _agg_all(self, kind: str, cols, **extra) -> "DataFrame":
        """``kind`` over ``cols``, or over every numeric column."""
        exprs = _to_exprs(cols) if cols else [
            col(f.name) for f in self.schema if f.dtype.is_numeric()]
        aggs = [Expression(AggExpr(kind, e._node, extra or None)).alias(e.name()) for e in exprs]
        return DataFrame(Aggregate(self._plan, aggs, []))

    def sum(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_all("sum", cols)

    def mean(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_all("mean", cols)

    def min(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_all("min", cols)

    def max(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_all("max", cols)

    def stddev(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_all("stddev", cols)

    def any_value(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_all("any_value", cols)

    def _agg_each(self, kind: str, cols) -> "DataFrame":
        """``kind`` over ``cols``, or over every column."""
        exprs = _to_exprs(cols) if cols else [col(n) for n in self.column_names]
        aggs = [Expression(AggExpr(kind, e._node)).alias(e.name()) for e in exprs]
        return DataFrame(Aggregate(self._plan, aggs, []))

    def count(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_each("count", cols)

    def agg_list(self, *cols: ColumnInput) -> "DataFrame":
        return self._agg_each("list", cols)

    def agg_concat(self, *cols: ColumnInput) -> "DataFrame":
        aggs = [Expression(AggExpr("concat", e._node)).alias(e.name()) for e in _to_exprs(cols)]
        return DataFrame(Aggregate(self._plan, aggs, []))

    def agg(self, *to_agg) -> "DataFrame":
        return DataFrame(Aggregate(self._plan, _normalize_aggs(to_agg), []))

    def groupby(self, *group_by: ColumnInput) -> "GroupedDataFrame":
        exprs: List[Expression] = []
        for g in group_by:
            exprs.extend(_to_exprs(g) if isinstance(g, (list, tuple)) else [_to_expr(g)])
        if not exprs:
            raise ValueError("groupby requires at least one column")
        return GroupedDataFrame(self, exprs)

    def count_rows(self) -> int:
        """The number of rows (a count of every row, nulls included)."""
        if not self.column_names:
            return 0
        cnt = DataFrame(Aggregate(
            self._plan, [Expression(AggExpr("count", col(self.column_names[0])._node,
                                            {"mode": "all"})).alias("count")], []))
        return cnt.to_pydict()["count"][0]

    def __len__(self) -> int:
        return self.count_rows()

    # ------------------------------------------------------------------ writes
    def _write(self, root_dir: str, format: str, compression, partition_cols) -> "DataFrame":
        pc = _to_exprs(partition_cols) if partition_cols else None
        return DataFrame(Write(self._plan, root_dir, format, compression, pc)).collect()

    def write_parquet(self, root_dir: str, compression: str = "snappy",
                      partition_cols=None) -> "DataFrame":
        """Write the frame as parquet files under ``root_dir`` (hive
        directories by ``partition_cols``); returns the manifest."""
        return self._write(root_dir, "parquet", compression, partition_cols)

    def write_csv(self, root_dir: str, partition_cols=None) -> "DataFrame":
        return self._write(root_dir, "csv", None, partition_cols)

    def write_json(self, root_dir: str, partition_cols=None) -> "DataFrame":
        return self._write(root_dir, "json", None, partition_cols)

    def _lake_write(self, writer, table_uri: str, mode: str) -> "DataFrame":
        self.collect()
        added = writer(table_uri, [p.to_arrow() for p in self._result.partitions], mode=mode)
        from .api import from_pydict

        return from_pydict({"path": added})

    def write_iceberg(self, table_uri: str, mode: str = "append") -> "DataFrame":
        """Write the frame as an Iceberg v2 snapshot commit (mode: append,
        overwrite or error); returns a DataFrame of the added file paths."""
        from .io.catalogs import write_iceberg_table

        return self._lake_write(write_iceberg_table, table_uri, mode)

    def write_deltalake(self, table_uri: str, mode: str = "append") -> "DataFrame":
        """Write the frame as a Delta Lake commit (mode: append, overwrite or
        error): the parquet data files land first, then one put-if-absent
        JSON transaction publishes them. Returns a DataFrame of the added
        file paths."""
        from .io.catalogs import write_deltalake_table

        return self._lake_write(write_deltalake_table, table_uri, mode)

    def write_lance(self, table_uri: str, mode: str = "append") -> "DataFrame":
        """Write the frame as a lance dataset; needs the optional ``lance``
        package. Returns a DataFrame of the data-file paths."""
        from .io.catalogs import write_lance_table

        return self._lake_write(write_lance_table, table_uri, mode)

    def to_ray_dataset(self):
        """A Ray Dataset of the rows; needs ``ray``, which the port does not
        depend on (its distributed backends are the mesh runner and the
        runner of worker processes, dist/)."""
        try:
            import ray.data  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "to_ray_dataset requires ray, which is not installed; "
                "distributed execution here runs on the mesh runner (MeshRunner) or on "
                "worker processes (distributed_workers)") from e
        import ray.data as rd

        return rd.from_arrow(self.to_arrow())

    def to_dask_dataframe(self):
        """A Dask DataFrame of the rows; needs ``dask``."""
        try:
            import dask.dataframe as dd
        except ImportError as e:
            raise ImportError("to_dask_dataframe requires dask, which is not installed") from e
        return dd.from_pandas(self.to_pandas(), npartitions=max(self.num_partitions(), 1))

    def cancel(self) -> None:
        """Stop this DataFrame's running execution at its next partition
        boundary (safe from any thread): the execution raises
        ``QueryCancelledError`` and its record says ``cancelled``."""
        self.stats.cancel()

    def collect(self, profile: Union[bool, str, None] = None) -> "DataFrame":
        """Materialize the plan; ``stats`` then holds the query's counters.

        ``profile`` arms the query profiler for this execution: ``True``
        records a QueryProfile (``profile()``, ``last_profile()``), a path
        also writes its JSON there, ``None`` follows ``enable_profiling``.
        A collected DataFrame does not run again: its profile, if any, is
        served (and written to a path given).

        Under ``enable_result_cache`` a plan whose structural key
        (``runners.plan_cache_key``) another live DataFrame has collected
        under the same config is served from that result
        (``result_cache_hits``, and a ``result_cache_hit`` event when
        profiled); the entry goes when the last DataFrame that owns it goes.
        The reference keys on the plan alone; the port's config holds the
        device and the 32- or 64-bit mode, whose results differ, so its key
        holds the config too."""
        if self._result is not None:
            if isinstance(profile, str) and self._profile is not None:
                self._profile.to_json(profile)
            return self
        self.stats.reset_cancel()  # a cancelled DataFrame may run again
        from .runners import partition_set_cache, plan_cache_key

        cache = partition_set_cache()
        cfg = get_context().execution_config
        want = profile if profile is not None else cfg.enable_profiling
        if want:
            from .profile import Profiler

            self.stats.profiler = Profiler(query_id=f"q-{id(self._plan):x}")
        key = plan_cache_key(self._plan) if cfg.enable_result_cache else None
        if key is not None:
            from .adapt.plancache import _cfg_key

            key += "|" + _cfg_key(cfg)
        hit = cache.get(key) if key is not None else None
        if hit is not None:
            self.stats.bump("result_cache_hits")
            if self.stats.profiler.armed:
                self.stats.profiler.event("result_cache_hit")
            self._result = hit
        else:
            self._result = get_context().runner().run(self._plan, stats=self.stats)
            if key is not None:
                import weakref

                cache.put(key, self._result)
                # the entry lives exactly as long as some DataFrame owns it
                weakref.finalize(self, cache.release, key)
        if want:
            from .profile import build_profile

            qp = build_profile(self.stats.profiler, self.stats)
            self._profile = qp
            get_context()._last_profile = qp
            if isinstance(want, str):
                qp.to_json(want)
        self._plan = InMemorySource(self._result.schema, self._result.partitions)
        return self

    def profile(self):
        """The QueryProfile recorded by a profiled collect(), or None."""
        return self._profile

    def last_query_record(self):
        """The query log's QueryRecord of this DataFrame's latest plan
        execution (None before any execution, or when the result was served
        from the result cache). The same record is in ``query_log()``."""
        return self.stats.last_record

    def iter_partitions(self) -> Iterator[MicroPartition]:
        """The result's partitions: a collected frame's, else streamed from a
        run of the plan."""
        if self._result is not None:
            yield from self._result.partitions
            return
        self.stats.reset_cancel()
        yield from get_context().runner().run_iter(self._plan, stats=self.stats)

    def to_arrow_iter(self):
        for part in self.iter_partitions():
            if len(part):
                yield from part.to_arrow().to_batches()

    def iter_rows(self) -> Iterator[dict]:
        for part in self.iter_partitions():
            yield from part.to_pylist()

    def to_table(self):
        return self.collect()._result.to_table()

    def to_pydict(self) -> Dict[str, list]:
        return self.to_table().to_pydict()

    def to_pylist(self) -> List[dict]:
        return self.to_table().to_pylist()

    def to_arrow(self):
        return self.to_table().to_arrow()

    def to_pandas(self):
        return self.to_table().to_pandas()

    # ------------------------------------------------------------------ display
    def show(self, n: int = 8) -> None:
        print(self.limit(n)._preview_str(n))

    def _preview_str(self, n: int) -> str:
        tbl = self.limit(n).to_table()
        d = tbl.to_pydict()
        names = list(d)
        widths = {}
        dtypes = {f.name: repr(f.dtype) for f in tbl.schema}
        for nm in names:
            vals = [_cell(v) for v in d[nm]]
            widths[nm] = min(30, max([len(nm), len(dtypes[nm])] + [len(v) for v in vals] + [4]))
            d[nm] = vals

        def row(cells):
            return "| " + " | ".join(c[:widths[nm]].ljust(widths[nm])
                                     for nm, c in zip(names, cells)) + " |"

        sep = "+" + "+".join("-" * (widths[nm] + 2) for nm in names) + "+"
        lines = [sep, row(names), row([dtypes[nm] for nm in names]), sep]
        for i in range(len(d[names[0]]) if names else 0):
            lines.append(row([d[nm][i] for nm in names]))
        lines.append(sep)
        return "\n".join(lines)

    def __repr__(self) -> str:
        # a preview of a collected frame only: a repr never runs the plan
        if self._result is not None:
            from .errors import PORT_FAILURES

            try:
                return self._preview_str(get_context().execution_config.num_preview_rows)
            except PORT_FAILURES:
                raise
            except Exception:
                pass  # a frame that cannot preview (a python column) shows its schema
        return f"DataFrame({self.schema!r})"


def _cell(v) -> str:
    if v is None:
        return "None"
    s = str(v)
    return s if len(s) <= 30 else s[:27] + "..."


class GroupedDataFrame:
    """Result of df.groupby(...)."""

    def __init__(self, df: DataFrame, group_by: List[Expression]):
        self.df = df
        self.group_by = group_by

    def _agg_all(self, kind: str, cols, **extra) -> DataFrame:
        """``kind`` over ``cols``, or over every column that is not a key
        (the numeric ones only, except for count and any_value)."""
        keys = {e.name() for e in self.group_by}
        if cols:
            exprs = _to_exprs(cols)
        else:
            exprs = [col(f.name) for f in self.df.schema
                     if f.name not in keys and (f.dtype.is_numeric() or kind in ("count", "any_value"))]
        aggs = [Expression(AggExpr(kind, e._node, extra or None)).alias(e.name()) for e in exprs]
        return DataFrame(Aggregate(self.df._plan, aggs, self.group_by))

    def sum(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("sum", cols)

    def mean(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("mean", cols)

    def min(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("min", cols)

    def max(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("max", cols)

    def stddev(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("stddev", cols)

    def any_value(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("any_value", cols)

    def count(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("count", cols)

    def agg_list(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("list", cols)

    def agg_concat(self, *cols: ColumnInput) -> DataFrame:
        return self._agg_all("concat", cols)

    def agg(self, *to_agg) -> DataFrame:
        return DataFrame(Aggregate(self.df._plan, _normalize_aggs(to_agg), self.group_by))

    def map_groups(self, udf_expr: Expression) -> DataFrame:
        """Run a UDF once per group: the input is collected and split by the
        group keys, and the UDF sees each group's rows as whole columns. The
        result holds the group keys (repeated) and the UDF's column."""
        from .table import Table

        mp = self.df.collect()._result.to_micropartition()
        parts, uniq = mp.partition_by_value(self.group_by)
        outs = []
        key_names = uniq.column_names
        for i, part in enumerate(parts):
            res = part.table().eval_expression_list([udf_expr])
            key_row = uniq.slice(i, i + 1)
            n = len(res)
            key_cols = {kn: [key_row.get_column(kn).to_pylist()[0]] * n for kn in key_names}
            outs.append(Table.from_pydict({**key_cols, **res.to_pydict()}))
        out_tbl = Table.concat(outs) if outs else Table.empty(Schema(list(uniq.schema)))
        return from_partitions([MicroPartition.from_table(out_tbl)], out_tbl.schema)


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
