"""Tabular writers: a Table to parquet, CSV or JSON files (the port's copy
of daft_tpu/io/writer.py).

``write_tabular`` writes one or more files per partition (split at a
target file size), optionally hive-partitioned by key columns (a null key
goes to ``__HIVE_DEFAULT_PARTITION__``), and returns a manifest Table of
the written paths, plus the key columns of a hive-partitioned write. File
names hold a random uuid, so a repeated write never overwrites an earlier
one.

Targets are local paths or object-store urls (``s3://``, ``gs://``, ...):
every byte goes through ``io.object_store.STORAGE``, so the client that
serves the reads serves the writes. A local file streams to disk; a remote
one is encoded into one buffer and put (multipart above the store's
threshold). ``write_parquet_any`` writes one parquet file either way for
the lake writers (io/catalogs.py).
"""

from __future__ import annotations

import io
import json
import uuid
from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq

from ..schema import Field, Schema
from ..series import Series
from ..table import Table
from .object_store import STORAGE

TARGET_FILE_SIZE_BYTES = 512 * 1024 * 1024


def write_parquet_any(path: str, arrow_tbl: pa.Table) -> int:
    """ONE parquet file to a local path (streamed to disk) or an object-store
    url (buffered once, put without a copy); returns the encoded size."""
    import os

    if STORAGE.is_remote(path):
        buf = io.BytesIO()
        papq.write_table(arrow_tbl, buf)
        view = buf.getbuffer()
        STORAGE.put(path, view)
        return len(view)
    lp = STORAGE._local(path)
    os.makedirs(os.path.dirname(lp) or ".", exist_ok=True)
    papq.write_table(arrow_tbl, lp)
    return os.path.getsize(lp)


def _encode_to(sink, arrow_tbl: pa.Table, format: str,
               compression: Optional[str]) -> None:
    """``sink`` is a path (streamed to disk) or a file-like (buffered)."""
    if format == "parquet":
        papq.write_table(arrow_tbl, sink, compression=compression or "snappy")
    elif format == "csv":
        pacsv.write_csv(arrow_tbl, sink)
    elif format == "json":
        cols = arrow_tbl.to_pydict()
        names = list(cols)
        text = "".join(json.dumps(dict(zip(names, row)), default=str) + "\n"
                       for row in (zip(*cols.values()) if names else []))
        data = text.encode()
        if isinstance(sink, str):
            with open(sink, "wb") as f:
                f.write(data)
        else:
            sink.write(data)
    else:
        raise ValueError(f"unknown write format {format!r}")


def _write_one(arrow_tbl: pa.Table, root: str, format: str,
               compression: Optional[str], idx: int) -> str:
    path = STORAGE.join(root, f"{uuid.uuid4().hex[:16]}-{idx}.{format}")
    if STORAGE.is_remote(path):
        buf = io.BytesIO()
        _encode_to(buf, arrow_tbl, format, compression)
        # a view of the buffer, not a copy (a multipart put slices views too)
        STORAGE.put(path, buf.getbuffer())
    else:
        _encode_to(STORAGE._local(path), arrow_tbl, format, compression)
    return path


def write_tabular(tbl: Table, root_dir: str, format: str = "parquet",
                  compression: Optional[str] = None,
                  partition_cols: Optional[Sequence] = None,
                  target_file_size: int = TARGET_FILE_SIZE_BYTES) -> Table:
    """Write a table under ``root_dir``; returns the manifest table (a
    ``path`` column, plus the partition key columns when hive-partitioning)."""
    STORAGE.makedirs(root_dir)
    paths: List[str] = []
    part_vals: List[Dict[str, Any]] = []

    if partition_cols:
        parts, uniq = tbl.partition_by_value(list(partition_cols))
        key_names = uniq.column_names
        for part, keyrow in zip(parts, uniq.to_pylist()):
            subdir = STORAGE.join(root_dir,
                                  *[f"{k}={_hive_value(v)}" for k, v in keyrow.items()])
            STORAGE.makedirs(subdir)
            keep = [c for c in part.column_names if c not in key_names] or part.column_names
            body = part.select_columns(keep)
            for i, chunk in enumerate(_split_by_size(body, target_file_size)):
                paths.append(_write_one(chunk.to_arrow(), subdir, format, compression, i))
                part_vals.append(keyrow)
        cols = [Series.from_pylist(paths, "path")]
        fields = [Field("path", cols[0].dtype)]
        for k in key_names:
            s = Series.from_pylist([pv[k] for pv in part_vals], k)
            cols.append(s)
            fields.append(Field(k, s.dtype))
        return Table(Schema(fields), cols)

    for i, chunk in enumerate(_split_by_size(tbl, target_file_size)):
        paths.append(_write_one(chunk.to_arrow(), root_dir, format, compression, i))
    s = Series.from_pylist(paths, "path")
    return Table(Schema([Field("path", s.dtype)]), [s])


def _split_by_size(tbl: Table, target: int):
    n = len(tbl)
    if n == 0:
        yield tbl
        return
    n_files = max(1, -(-max(tbl.size_bytes(), 1) // target))
    rows_per = -(-n // n_files)
    for start in range(0, n, rows_per):
        yield tbl.slice(start, min(start + rows_per, n))


def _hive_value(v: Any) -> str:
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    return str(v).replace("/", "%2F")
