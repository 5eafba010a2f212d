"""Public constructors (the port's copy of the part of daft_tpu/api.py this
slice runs). Left out of this slice: file readers, catalogs, SQL, UDFs, the
serving runtime and the health/metrics endpoints."""

from __future__ import annotations

from typing import Any, Dict

from .dataframe import DataFrame, from_partitions
from .micropartition import MicroPartition


def from_pydict(data: Dict[str, Any]) -> DataFrame:
    mp = MicroPartition.from_pydict(data)
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
