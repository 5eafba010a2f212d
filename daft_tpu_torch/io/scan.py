"""Scan tasks and their pushdowns (the port's copy of the part of
daft_tpu/io/scan.py this slice reads): ``Pushdowns`` alone, which
``MicroPartition.head`` and ``select_columns`` narrow an unloaded
partition's task through. The scan tasks, the file formats and the scan
operator come with the scan slice."""

from __future__ import annotations

from typing import Any, List, Optional


class Pushdowns:
    """Pushed-down operations a reader may honor: column projection, row
    filters, and a row limit (reference: daft-scan Pushdowns, lib.rs:839)."""

    __slots__ = ("columns", "filters", "limit")

    def __init__(self, columns: Optional[List[str]] = None,
                 filters: Optional[Any] = None,  # ExprNode
                 limit: Optional[int] = None):
        self.columns = columns
        self.filters = filters
        self.limit = limit

    def is_empty(self) -> bool:
        return self.columns is None and self.filters is None and self.limit is None

    def __repr__(self) -> str:
        parts = []
        if self.columns is not None:
            parts.append(f"columns={self.columns}")
        if self.filters is not None:
            parts.append(f"filters={self.filters.display()}")
        if self.limit is not None:
            parts.append(f"limit={self.limit}")
        return f"Pushdowns({', '.join(parts)})"

    def with_columns(self, columns: Optional[List[str]]) -> "Pushdowns":
        return Pushdowns(columns, self.filters, self.limit)

    def with_filters(self, filters) -> "Pushdowns":
        return Pushdowns(self.columns, filters, self.limit)

    def with_limit(self, limit: Optional[int]) -> "Pushdowns":
        return Pushdowns(self.columns, self.filters, limit)
