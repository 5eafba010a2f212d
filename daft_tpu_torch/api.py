"""Public constructors and entry points (the port's copy of the part of
daft_tpu/api.py this slice runs): ``from_pydict``, ``from_pylist``,
``from_arrow`` and ``from_pandas`` over memory, the file readers
``read_parquet``, ``read_csv``, ``read_json`` and ``from_glob_path`` over
local paths and object-store urls (io/object_store.py), the lake readers
``read_deltalake`` (a path or a ``UnityCatalogTable``), ``read_iceberg``,
``read_hudi`` and ``read_lance`` (io/catalogs.py), ``read_sql`` over a
DB-API connection, ``from_scan_operator`` over a user's ScanOperator
(io/pyscan.py), ``from_ray_dataset`` and ``from_dask_dataframe`` (each
raising an ImportError where its package is missing), the SQL front end (``sql``, ``sql_expr``) and the python UDF
decorators (``udf``, ``batch_udf``, and the ``UDF`` class they make). A
reader builds a ScanSource of scan tasks (io/scan.py) and reads nothing but
the first file's schema (and parquet footers) until a query runs.

The observability surface: ``last_profile`` (the latest profiled query's
QueryProfile), ``metrics_text`` (the Prometheus text of the process
metrics, the health gauges refreshed first), ``query_log`` (the QueryRecords
of completed executions), ``health`` (the engine-health snapshot),
``query_progress`` (running queries) and ``engine_log_tail`` (the structured
log's newest records).

Left out of this slice: the serving runtime with its ``shutdown``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .context import get_context
from .dataframe import DataFrame, from_partitions
from .datatypes import DataType
from .io.scan import FileFormat, Pushdowns, ScanTask, glob_paths, merge_scan_tasks_by_size
from .logical import ScanSource
from .micropartition import MicroPartition
from .schema import Field, Schema
from .table import Table
from .udf import UDF, batch_udf, udf  # noqa: F401  (re-exported)


def from_pydict(data: Dict[str, Any]) -> DataFrame:
    mp = MicroPartition.from_pydict(data)
    return from_partitions([mp], mp.schema)


def from_pylist(rows: List[dict]) -> DataFrame:
    """A DataFrame of one partition, one row per dict."""
    mp = MicroPartition.from_table(Table.from_pylist(rows))
    return from_partitions([mp], mp.schema)


def from_arrow(data) -> DataFrame:
    """A DataFrame over one pyarrow Table/RecordBatch (one partition) or a
    list of them (one partition each)."""
    import pyarrow as pa

    if isinstance(data, (pa.Table, pa.RecordBatch)):
        mp = MicroPartition.from_arrow(data)
        return from_partitions([mp], mp.schema)
    if isinstance(data, (list, tuple)):
        parts = [MicroPartition.from_arrow(t) for t in data]
        if not parts:
            raise ValueError("from_arrow of empty list")
        return from_partitions(parts, parts[0].schema)
    raise TypeError(f"from_arrow expects pyarrow Table/RecordBatch, got {type(data)}")


def from_pandas(df) -> DataFrame:
    import pyarrow as pa

    return from_arrow(pa.Table.from_pandas(df))


def from_ray_dataset(ds) -> DataFrame:
    """A DataFrame from a Ray Dataset; needs the optional ``ray`` package."""
    try:
        import ray  # noqa: F401
    except ImportError as e:
        raise ImportError("from_ray_dataset requires the optional `ray` "
                          "package, which is not installed") from e
    import pyarrow as pa

    tables = [ray.get(r) for r in ds.to_arrow_refs()]
    if not tables:
        return from_arrow(pa.table({}))
    return from_arrow(pa.concat_tables(tables) if len(tables) != 1 else tables[0])


def from_dask_dataframe(ddf) -> DataFrame:
    """A DataFrame from a Dask DataFrame; needs the optional ``dask``
    package."""
    try:
        import dask  # noqa: F401
    except ImportError as e:
        raise ImportError("from_dask_dataframe requires the optional `dask` "
                          "package, which is not installed") from e
    return from_pandas(ddf.compute())


def from_glob_path(path: str) -> DataFrame:
    """A DataFrame of the file metadata (path, size, num_rows) of a glob."""
    from .io.readers import file_size

    paths = glob_paths(path)
    return from_pydict({"path": paths, "size": [file_size(p) for p in paths],
                        "num_rows": [None] * len(paths)})


def _hinted(schema: Schema, schema_hints: Optional[Dict[str, DataType]]) -> Schema:
    if not schema_hints:
        return schema
    return schema.apply_hints(Schema([Field(k, v) for k, v in schema_hints.items()]))


def _scan_frame(schema: Schema, tasks: List[ScanTask]) -> DataFrame:
    cfg = get_context().execution_config
    tasks = merge_scan_tasks_by_size(tasks, cfg.scan_tasks_min_size_bytes,
                                     cfg.scan_tasks_max_size_bytes)
    return DataFrame(ScanSource(schema, tasks))


def read_parquet(path, schema_hints: Optional[Dict[str, DataType]] = None,
                 _split_row_groups: Optional[bool] = None) -> DataFrame:
    """A lazy scan of parquet files. A file larger than
    ``scan_tasks_max_size_bytes`` with several row groups (or any file, with
    ``_split_row_groups=True``) splits into one task per run of row groups
    of about ``scan_tasks_min_size_bytes``; each task carries its row
    groups' statistics, for pruning."""
    from .io.readers import file_size, open_parquet_file, row_group_stats

    paths = glob_paths(path)
    if not paths:
        raise FileNotFoundError(f"no files for {path!r}")
    pf0 = open_parquet_file(paths[0])
    schema = _hinted(Schema.from_arrow(pf0.schema_arrow), schema_hints)
    cfg = get_context().execution_config
    tasks: List[ScanTask] = []
    for p in paths:
        md = pf0.metadata if p == paths[0] else open_parquet_file(p).metadata
        fsize = file_size(p)
        split = _split_row_groups
        if split is None:
            split = fsize > cfg.scan_tasks_max_size_bytes and md.num_row_groups > 1
        if split:
            runs: List[List[int]] = []
            cur: List[int] = []
            cur_bytes = 0
            for rg in range(md.num_row_groups):
                cur.append(rg)
                cur_bytes += md.row_group(rg).total_byte_size
                if cur_bytes >= cfg.scan_tasks_min_size_bytes:
                    runs.append(cur)
                    cur, cur_bytes = [], 0
            if cur:
                runs.append(cur)
            for run in runs:
                st = row_group_stats(md, run[0], schema)
                for rg in run[1:]:
                    st = st.merge(row_group_stats(md, rg, schema))
                tasks.append(ScanTask(
                    p, FileFormat.PARQUET, schema, Pushdowns(),
                    num_rows=sum(md.row_group(rg).num_rows for rg in run),
                    size_bytes=sum(md.row_group(rg).total_byte_size for rg in run),
                    stats=st, row_group_ids=run))
        else:
            st = None
            if md.num_row_groups:
                st = row_group_stats(md, 0, schema)
                for rg in range(1, md.num_row_groups):
                    st = st.merge(row_group_stats(md, rg, schema))
            tasks.append(ScanTask(p, FileFormat.PARQUET, schema, Pushdowns(),
                                  num_rows=md.num_rows, size_bytes=fsize, stats=st))
    return _scan_frame(schema, tasks)


def read_csv(path, delimiter: str = ",", has_headers: bool = True,
             column_names: Optional[List[str]] = None,
             schema_hints: Optional[Dict[str, DataType]] = None, **kw) -> DataFrame:
    """A lazy scan of CSV files, one task per file (small files merged); the
    schema is inferred from the first block of the first file."""
    from .io.readers import file_size, infer_csv_schema

    paths = glob_paths(path)
    schema = _hinted(infer_csv_schema(paths[0], delimiter=delimiter, has_headers=has_headers,
                                      column_names=column_names), schema_hints)
    opts = {"delimiter": delimiter, "has_headers": has_headers,
            "column_names": column_names, **kw}
    return _scan_frame(schema, [ScanTask(p, FileFormat.CSV, schema, Pushdowns(),
                                         storage_options=opts, size_bytes=file_size(p))
                                for p in paths])


def read_json(path, schema_hints: Optional[Dict[str, DataType]] = None) -> DataFrame:
    """A lazy scan of newline-delimited JSON files, one task per file (small
    files merged); the schema is inferred from the first block."""
    from .io.readers import file_size, infer_json_schema

    paths = glob_paths(path)
    schema = _hinted(infer_json_schema(paths[0]), schema_hints)
    return _scan_frame(schema, [ScanTask(p, FileFormat.JSON, schema, Pushdowns(),
                                         size_bytes=file_size(p)) for p in paths])


def read_deltalake(table_uri) -> DataFrame:
    """A Delta Lake table, by replaying its transaction log; ``table_uri``
    is a path, an object-store uri or a ``UnityCatalogTable``
    (``io.unity.UnityCatalog.load_table``)."""
    from .io.catalogs import read_deltalake_scan
    from .io.unity import UnityCatalogTable

    if isinstance(table_uri, UnityCatalogTable):
        table_uri = table_uri.table_uri
    schema, tasks = read_deltalake_scan(table_uri)
    return DataFrame(ScanSource(schema, tasks))


def read_sql(sql: str, conn, params=None) -> DataFrame:
    """The rows of a SQL query through a DB-API connection, a connection
    factory, or a sqlite path or ``sqlite://`` url, read in one shot."""
    from .io.catalogs import read_sql_arrow

    return from_arrow(read_sql_arrow(sql, conn, params))


def read_iceberg(table_uri: str, snapshot_id=None) -> DataFrame:
    """An Iceberg v1/v2 table (its current snapshot, or ``snapshot_id``),
    by replaying manifest list, manifests and live data files. Copy-on-write
    tables only."""
    from .io.catalogs import read_iceberg_scan

    schema, tasks = read_iceberg_scan(table_uri, snapshot_id)
    return DataFrame(ScanSource(schema, tasks))


def read_hudi(table_uri: str) -> DataFrame:
    """A local Hudi copy-on-write table, by replaying its ``.hoodie``
    commit timeline."""
    from .io.catalogs import read_hudi_scan

    schema, tasks = read_hudi_scan(table_uri)
    return DataFrame(ScanSource(schema, tasks))


def read_lance(url: str, storage_options=None) -> DataFrame:
    """A LanceDB dataset, one scan task a fragment; needs the optional
    ``lance`` package."""
    from .io.catalogs import read_lance_scan

    return read_lance_scan(url, storage_options=storage_options)


def from_scan_operator(op) -> DataFrame:
    """A DataFrame over a user-defined ScanOperator (io/pyscan.py)."""
    from .io.pyscan import from_scan_operator as _fso

    return _fso(op)


def sql(query: str, **catalog: DataFrame) -> DataFrame:
    """A DataFrame planned from a SQL text over the named frames."""
    from .sql import sql as _sql

    return _sql(query, **catalog)


def sql_expr(text: str):
    """An Expression parsed from a SQL expression text."""
    from .sql import sql_expr as _sql_expr

    return _sql_expr(text)


def last_profile():
    """The QueryProfile of the latest profiled query
    (``df.collect(profile=True)``, ``enable_profiling``), or None."""
    return get_context().last_profile()


def metrics_text() -> str:
    """The Prometheus text of the process metrics registry
    (profile/metrics.py). The health and ledger gauges are refreshed first,
    so the text carries the current memory pressure and breaker state."""
    from .obs.health import refresh_health_gauges
    from .profile import METRICS

    refresh_health_gauges()
    return METRICS.render_prometheus()


def query_log(limit: Optional[int] = None) -> List[dict]:
    """The query log's QueryRecords, oldest first (the newest ``limit`` when
    given): one per completed plan execution, whatever its outcome
    (``ExecutionConfig.enable_query_log``)."""
    from .obs.querylog import QUERY_LOG

    return QUERY_LOG.records(limit)


def health() -> dict:
    """One engine-health snapshot: breaker states, the memory ledger, actor
    pools and leaked threads, the plan cache, batching and residency counts,
    running queries (``"queries"``) and the query log's depth. Mirrored as
    gauges in ``metrics_text()``."""
    from .obs.health import engine_health

    return engine_health()


def query_progress(query_id: Optional[str] = None):
    """Live progress of running queries (obs/cluster.py): operators done of
    the total, rows and bytes that flowed, rows emitted. With ``query_id``,
    that query's snapshot (None when it is not running); without, the list
    of all running queries, as ``health()["queries"]`` holds it."""
    from .obs.cluster import queries_snapshot
    from .obs.cluster import query_progress as _one

    if query_id is not None:
        return _one(query_id)
    return queries_snapshot()


def engine_log_tail(n: int = 200, query_id: Optional[str] = None) -> List[dict]:
    """The newest structured engine-log records (obs/log.py), optionally of
    one query id."""
    from .obs.log import tail

    return tail(n, query_id=query_id)
