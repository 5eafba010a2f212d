"""Tabular writers: a Table to parquet, CSV or JSON files (the port's copy
of daft_tpu/io/writer.py).

``write_tabular`` writes one or more files per partition (split at a
target file size), optionally hive-partitioned by key columns (a null key
goes to ``__HIVE_DEFAULT_PARTITION__``), and returns a manifest Table of
the written paths, plus the key columns of a hive-partitioned write. File
names hold a random uuid, so a repeated write never overwrites an earlier
one.

The port writes local paths only, through ``os`` and pyarrow: a remote
target raises a ``ValueError`` until the object-store client is ported
(ROADMAP, Queue 1, item 9). Left out: ``write_parquet_any``, which only the
lake writers (the same item) call.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq

from ..schema import Field, Schema
from ..series import Series
from ..table import Table
from .object_store import check_local_path

TARGET_FILE_SIZE_BYTES = 512 * 1024 * 1024


def _encode_to(path: str, arrow_tbl: pa.Table, format: str,
               compression: Optional[str]) -> None:
    if format == "parquet":
        papq.write_table(arrow_tbl, path, compression=compression or "snappy")
    elif format == "csv":
        pacsv.write_csv(arrow_tbl, path)
    elif format == "json":
        cols = arrow_tbl.to_pydict()
        names = list(cols)
        text = "".join(json.dumps(dict(zip(names, row)), default=str) + "\n"
                       for row in (zip(*cols.values()) if names else []))
        with open(path, "wb") as f:
            f.write(text.encode())
    else:
        raise ValueError(f"unknown write format {format!r}")


def _local(path: str) -> str:
    """A local path, without its ``file://`` scheme (the manifest keeps it)."""
    return path[len("file://"):] if path.startswith("file://") else path


def _write_one(arrow_tbl: pa.Table, root: str, format: str,
               compression: Optional[str], idx: int) -> str:
    path = os.path.join(root, f"{uuid.uuid4().hex[:16]}-{idx}.{format}")
    _encode_to(_local(path), arrow_tbl, format, compression)
    return path


def write_tabular(tbl: Table, root_dir: str, format: str = "parquet",
                  compression: Optional[str] = None,
                  partition_cols: Optional[Sequence] = None,
                  target_file_size: int = TARGET_FILE_SIZE_BYTES) -> Table:
    """Write a table under ``root_dir``; returns the manifest table (a
    ``path`` column, plus the partition key columns when hive-partitioning)."""
    check_local_path(root_dir)
    os.makedirs(_local(root_dir), exist_ok=True)
    paths: List[str] = []
    part_vals: List[Dict[str, Any]] = []

    if partition_cols:
        parts, uniq = tbl.partition_by_value(list(partition_cols))
        key_names = uniq.column_names
        for part, keyrow in zip(parts, uniq.to_pylist()):
            subdir = os.path.join(root_dir,
                                  *[f"{k}={_hive_value(v)}" for k, v in keyrow.items()])
            os.makedirs(_local(subdir), exist_ok=True)
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
