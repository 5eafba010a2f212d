"""Format readers: parquet, CSV, newline-delimited JSON and arrow IPC into a
Table, honoring pushdowns (the port's copy of daft_tpu/io/readers.py).

The decode runs on the host in pyarrow; the decoded tables are what the
device layer stages. A parquet read projects its columns at the IO layer,
prunes row groups by their footer statistics (``row_group_stats``,
``filter_may_match``), stops early for a limit without a filter, and
applies the pushed filter to the decoded rows (``_residual_filter``).
``plan_parquet_chunks`` and ``read_parquet_chunk`` read one row group at a
time and choose the row groups the whole-file read would. The JSON reader
streams blocks and stops once a limit is met. A remote parquet file reads
through ``ObjectFile`` (io/object_store.py), so its footer and the chosen
row groups cost ranged GETs, not a download; a remote CSV or JSON file is
fetched whole through the client (its schema from a record-aligned prefix).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.parquet as papq

from ..schema import Schema
from ..stats import ColumnStats, TableStats, filter_may_match
from ..table import Table
from .scan import IO_STATS, Pushdowns


def _residual_filter(tbl: Table, pushdowns: Pushdowns) -> Table:
    if pushdowns.filters is not None:
        from ..expressions import Expression

        tbl = tbl.filter([Expression(pushdowns.filters)])
    if pushdowns.limit is not None:
        tbl = tbl.head(pushdowns.limit)
    return tbl


def _project_columns(names: List[str], pushdowns: Pushdowns) -> Optional[List[str]]:
    """Columns to read: the pushdown projection plus any filter dependencies."""
    if pushdowns.columns is None:
        return None
    need = [c for c in pushdowns.columns if c in names]
    if pushdowns.filters is not None:
        for c in _filter_columns(pushdowns.filters):
            if c in names and c not in need:
                need.append(c)
    return need


def _filter_columns(node) -> List[str]:
    from ..expressions import Column

    out: List[str] = []

    def walk(n):
        if isinstance(n, Column):
            if n.cname not in out:
                out.append(n.cname)
        for c in n.children():
            walk(c)

    walk(node)
    return out


def _drop_filter_only_columns(tbl: Table, pushdowns: Pushdowns) -> Table:
    if pushdowns.columns is None:
        return tbl
    keep = [c for c in pushdowns.columns if c in tbl.schema]
    return tbl.select_columns(keep)


# ---------------------------------------------------------------------------
# Parquet
# ---------------------------------------------------------------------------

def open_parquet_file(path: str) -> "papq.ParquetFile":
    """A ParquetFile over a local path or a remote object: a remote one
    reads through an ObjectFile of its own (ranged GETs of the footer and
    the selected row groups only, never a full download)."""
    from .object_store import default_io_client, is_remote_path

    if is_remote_path(path):
        return papq.ParquetFile(default_io_client().open(path))
    return papq.ParquetFile(path)


def open_input_bytes(path: str):
    """A whole-object file handle for the record formats (CSV, JSON)."""
    import io as _io

    from .object_store import default_io_client, is_remote_path

    if is_remote_path(path):
        return _io.BytesIO(default_io_client().get(path))
    return path


def open_prefix_bytes(path: str, nbytes: int = 1 << 20):
    """A record-aligned PREFIX of the object for schema inference, so a
    large remote CSV is not downloaded twice (once to infer, once to read).
    The ranged fetch is cut at its last newline, so the parser never sees a
    truncated record; an object under ``nbytes`` comes back whole."""
    import io as _io

    from .object_store import default_io_client, is_remote_path

    if not is_remote_path(path):
        return path
    client = default_io_client()
    size = client.get_size(path)
    if size <= nbytes:
        return _io.BytesIO(client.get(path))
    chunk = client.get(path, (0, nbytes))
    head, nl, _tail = chunk.rpartition(b"\n")
    return _io.BytesIO(head + nl if nl else chunk)


def file_size(path: str) -> int:
    from .object_store import default_io_client, is_remote_path

    if is_remote_path(path):
        return default_io_client().get_size(path)
    return os.path.getsize(path)


def parquet_metadata(path: str) -> "papq.FileMetaData":
    return open_parquet_file(path).metadata


def row_group_stats(md, rg_idx: int, schema: Schema) -> TableStats:
    """The min/max/null_count bounds of one row group, from the parquet
    footer's metadata."""
    rg = md.row_group(rg_idx)
    cols: Dict[str, ColumnStats] = {}
    for ci in range(rg.num_columns):
        cc = rg.column(ci)
        name = cc.path_in_schema.split(".")[0]
        if name in cols:  # nested leaves: only top-level bounds are usable
            cols[name] = ColumnStats()
            continue
        st = cc.statistics
        if st is None or not st.has_min_max:
            cols[name] = ColumnStats(null_count=getattr(st, "null_count", None) if st else None)
        else:
            cols[name] = ColumnStats(st.min, st.max, st.null_count)
    return TableStats(cols, num_rows=rg.num_rows, size_bytes=rg.total_byte_size)


def plan_parquet_chunks(path: str, pushdowns: Optional[Pushdowns] = None,
                        schema: Optional[Schema] = None,
                        row_group_ids: Optional[List[int]] = None):
    """Everything ``read_parquet_table`` does BEFORE decoding: open the
    footer, project columns, prune row groups by stats, apply the
    limit-aware early stop. Returns ``(pf, chosen_row_groups, columns,
    file_schema)``. The chunk-wise streaming read and the whole-file read
    share this, so both choose exactly the same row groups."""
    pushdowns = pushdowns or Pushdowns()
    pf = open_parquet_file(path)
    md = pf.metadata
    IO_STATS.bump(files_opened=1)
    file_schema = Schema.from_arrow(pf.schema_arrow) if schema is None else schema
    columns = _project_columns(file_schema.field_names(), pushdowns)
    if columns is not None:
        IO_STATS.bump(columns_read=len(columns))
    else:
        IO_STATS.bump(columns_read=md.num_columns)

    candidates = list(range(md.num_row_groups)) if row_group_ids is None else list(row_group_ids)
    chosen: List[int] = []
    rows_taken = 0
    pruned = 0
    for rg in candidates:
        if pushdowns.filters is not None:
            st = row_group_stats(md, rg, file_schema)
            if not filter_may_match(pushdowns.filters, st):
                pruned += 1
                continue
        chosen.append(rg)
        rows_taken += md.row_group(rg).num_rows
        if pushdowns.limit is not None and pushdowns.filters is None and rows_taken >= pushdowns.limit:
            break
    IO_STATS.bump(row_groups_read=len(chosen), row_groups_pruned=pruned)
    return pf, chosen, columns, file_schema


def _finish_parquet_decode(arrow_tbl: "pa.Table", columns,
                           pushdowns: Pushdowns,
                           schema: Optional[Schema]) -> Table:
    """The decode tail shared by the whole-file and chunk-wise parquet
    reads (IO accounting, schema cast, residual filter, filter-only-column
    drop). One copy on purpose: chunk-wise reads must concatenate to
    exactly the whole-file content."""
    IO_STATS.bump(bytes_read=arrow_tbl.nbytes, rows_read=arrow_tbl.num_rows)
    tbl = Table.from_arrow(arrow_tbl)
    if schema is not None:
        want = [f for f in (schema.select(columns) if columns is not None else schema)]
        tbl = tbl.cast_to_schema(Schema(want))
    tbl = _residual_filter(tbl, pushdowns)
    return _drop_filter_only_columns(tbl, pushdowns)


def read_parquet_chunk(pf, rg: int, columns, pushdowns: Pushdowns,
                       schema: Optional[Schema]) -> Table:
    """Decode ONE planned row group, applying the same schema cast,
    residual filter, and filter-only-column drop as the whole-file read —
    chunk-wise reads concatenate to byte-identical content."""
    arrow_tbl = pf.read_row_group(rg, columns=columns, use_threads=True)
    return _finish_parquet_decode(arrow_tbl, columns, pushdowns, schema)


def read_parquet_table(path: str, pushdowns: Optional[Pushdowns] = None,
                       schema: Optional[Schema] = None,
                       row_group_ids: Optional[List[int]] = None) -> Table:
    """Read one parquet file with pushdowns: column projection at the IO layer,
    row-group pruning via footer stats, limit-aware early stop, residual filter
    on the decoded batch."""
    pushdowns = pushdowns or Pushdowns()
    pf, chosen, columns, file_schema = plan_parquet_chunks(
        path, pushdowns, schema, row_group_ids)

    if not chosen:
        empty = file_schema if columns is None else file_schema.select(columns)
        out = Table.empty(empty)
        return _drop_filter_only_columns(_residual_filter(out, pushdowns), pushdowns)

    arrow_tbl = pf.read_row_groups(chosen, columns=columns, use_threads=True)
    return _finish_parquet_decode(arrow_tbl, columns, pushdowns, schema)


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

def read_csv_table(path: str, pushdowns: Optional[Pushdowns] = None,
                   schema: Optional[Schema] = None,
                   delimiter: str = ",", has_headers: bool = True,
                   double_quote: bool = True, quote: str = '"',
                   escape_char: Optional[str] = None,
                   comment: Optional[str] = None,
                   allow_variable_columns: bool = False,
                   column_names: Optional[List[str]] = None, **_kw) -> Table:
    pushdowns = pushdowns or Pushdowns()
    read_opts = pacsv.ReadOptions(
        column_names=column_names if not has_headers and column_names else None,
        autogenerate_column_names=(not has_headers and not column_names),
    )
    parse_opts = pacsv.ParseOptions(
        delimiter=delimiter, double_quote=double_quote, quote_char=quote,
        escape_char=escape_char or False,
    )
    convert_opts = pacsv.ConvertOptions()
    if schema is not None:
        convert_opts.column_types = {f.name: f.dtype.to_arrow() for f in schema
                                     if not f.dtype.is_null()}
    columns = None
    if schema is not None and pushdowns.columns is not None:
        columns = _project_columns(schema.field_names(), pushdowns)
        convert_opts.include_columns = columns
    arrow_tbl = pacsv.read_csv(open_input_bytes(path), read_options=read_opts,
                               parse_options=parse_opts, convert_options=convert_opts)
    IO_STATS.bump(files_opened=1, bytes_read=arrow_tbl.nbytes, rows_read=arrow_tbl.num_rows,
                  columns_read=arrow_tbl.num_columns)
    tbl = Table.from_arrow(arrow_tbl)
    if schema is None and pushdowns.columns is not None:
        columns = _project_columns(tbl.column_names, pushdowns)
        tbl = tbl.select_columns([c for c in columns if c in tbl.schema])
    if schema is not None:
        want = schema.select(columns) if columns is not None else schema
        tbl = tbl.cast_to_schema(want)
    tbl = _residual_filter(tbl, pushdowns)
    return _drop_filter_only_columns(tbl, pushdowns)


def infer_csv_schema(path: str, delimiter: str = ",", has_headers: bool = True,
                     column_names: Optional[List[str]] = None, **_kw) -> Schema:
    read_opts = pacsv.ReadOptions(
        column_names=column_names if not has_headers and column_names else None,
        autogenerate_column_names=(not has_headers and not column_names),
        block_size=1 << 20,
    )
    parse_opts = pacsv.ParseOptions(delimiter=delimiter)
    with pacsv.open_csv(open_prefix_bytes(path), read_options=read_opts, parse_options=parse_opts) as rd:
        batch = rd.read_next_batch()
    return Schema.from_arrow(batch.schema)


# ---------------------------------------------------------------------------
# JSON (newline-delimited)
# ---------------------------------------------------------------------------

def read_json_table(path: str, pushdowns: Optional[Pushdowns] = None,
                    schema: Optional[Schema] = None, **_kw) -> Table:
    """Streaming newline-delimited JSON reader: parses fixed-size blocks,
    decodes only the projected and filter columns (an explicit schema, other
    fields ignored), applies the residual filter per block, and stops as
    soon as the limit is met, so a limit over a huge file parses its head
    only."""
    pushdowns = pushdowns or Pushdowns()
    columns = None
    parse_options = None
    if schema is not None:
        # decode exactly the known/projected fields: unexpected fields are
        # ignored (fields appearing only in later blocks would otherwise be
        # a parse error under block streaming)
        if pushdowns.columns is not None:
            columns = _project_columns(schema.field_names(), pushdowns)
            want_names = [c for c in columns if c in schema]
        else:
            want_names = schema.field_names()
        want_fields = [(c, schema[c].dtype.to_arrow()) for c in want_names]
        if want_fields:
            parse_options = pajson.ParseOptions(
                explicit_schema=pa.schema(want_fields),
                unexpected_field_behavior="ignore")
    want = None
    if schema is not None:
        want = (schema.select([c for c in columns if c in schema])
                if columns is not None else schema)
    limit = pushdowns.limit
    chunks = []
    rows = 0
    parsed = 0
    nbytes = 0
    with pajson.open_json(open_input_bytes(path),
                          parse_options=parse_options) as reader:
        for batch in reader:
            t = Table.from_arrow(pa.Table.from_batches([batch]))
            parsed += len(t)
            nbytes += batch.nbytes
            if want is not None:
                t = t.cast_to_schema(want)
            t = _residual_filter(t, pushdowns)
            chunks.append(t)
            rows += len(t)
            if limit is not None and rows >= limit:
                break
    if not chunks:
        tbl = Table.empty(want)
    else:
        tbl = Table.concat(chunks) if len(chunks) != 1 else chunks[0]
    if limit is not None and len(tbl) > limit:
        tbl = tbl.slice(0, limit)
    # rows_read = rows PARSED (pre-filter), matching the CSV/parquet readers
    IO_STATS.bump(files_opened=1, bytes_read=nbytes, rows_read=parsed,
                  columns_read=len(tbl.column_names))
    return _drop_filter_only_columns(tbl, pushdowns)


def read_arrow_ipc_table(path: str, pushdowns: Optional[Pushdowns] = None,
                         schema: Optional[Schema] = None, **_kw) -> Table:
    """Arrow IPC (feather v2) reader, the spill format: a memory-mapped file
    reads back at memcpy speed, with no decode."""
    pushdowns = pushdowns or Pushdowns()
    columns = None
    if schema is not None and pushdowns.columns is not None:
        columns = [c for c in _project_columns(schema.field_names(), pushdowns)
                   if c in schema]
    # NOT a context manager: the table's buffers are zero-copy views onto
    # the map; the file stays open until the buffers drop their references
    source = pa.memory_map(path)
    arrow_tbl = pa.ipc.open_file(source).read_all()
    if columns is not None:
        arrow_tbl = arrow_tbl.select(columns)
    tbl = Table.from_arrow(arrow_tbl)
    tbl = _residual_filter(tbl, pushdowns)
    if pushdowns.limit is not None and len(tbl) > pushdowns.limit:
        tbl = tbl.slice(0, pushdowns.limit)
    IO_STATS.bump(files_opened=1, bytes_read=arrow_tbl.nbytes,
                  rows_read=len(arrow_tbl), columns_read=len(tbl.column_names))
    return _drop_filter_only_columns(tbl, pushdowns)


def infer_json_schema(path: str, **_kw) -> Schema:
    # one block of the file is enough to infer from
    arrow_tbl = pajson.read_json(open_prefix_bytes(path), read_options=pajson.ReadOptions(block_size=1 << 20))
    return Schema.from_arrow(arrow_tbl.schema)
