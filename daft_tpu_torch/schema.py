"""Field and Schema (the port's copy of daft_tpu/schema.py; reference:
daft/logical/schema.py, src/daft-core/src/schema)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import pyarrow as pa

from .datatypes import DataType


class Field:
    __slots__ = ("name", "dtype", "metadata")

    def __init__(self, name: str, dtype: DataType, metadata: Optional[dict] = None):
        self.name = name
        self.dtype = dtype
        self.metadata = metadata or {}

    def rename(self, name: str) -> "Field":
        return Field(name, self.dtype, self.metadata)

    def with_dtype(self, dtype: DataType) -> "Field":
        return Field(self.name, dtype, self.metadata)

    def __eq__(self, other) -> bool:
        return isinstance(other, Field) and self.name == other.name and self.dtype == other.dtype

    def __hash__(self) -> int:
        return hash((self.name, self.dtype))

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.dtype!r})"


class Schema:
    """Ordered mapping name → Field. Duplicate names are rejected."""

    __slots__ = ("_fields",)

    def __init__(self, fields: List[Field]):
        names = [f.name for f in fields]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate field names in schema: {dup}")
        self._fields: Dict[str, Field] = {f.name: f for f in fields}

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_pairs(pairs) -> "Schema":
        return Schema([Field(n, dt) for n, dt in (pairs.items() if isinstance(pairs, dict) else pairs)])

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "Schema":
        return Schema([Field(f.name, DataType.from_arrow(f.type)) for f in schema])

    @staticmethod
    def empty() -> "Schema":
        return Schema([])

    # --- accessors --------------------------------------------------------
    def field_names(self) -> List[str]:
        return list(self._fields)

    @property
    def column_names(self) -> List[str]:
        return list(self._fields)

    def fields(self) -> List[Field]:
        return list(self._fields.values())

    def __getitem__(self, name: str) -> Field:
        if name not in self._fields:
            raise KeyError(f"column {name!r} not found in schema; available: {self.field_names()}")
        return self._fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __len__(self) -> int:
        return len(self._fields)

    def __iter__(self) -> Iterator[Field]:
        return iter(self._fields.values())

    def index(self, name: str) -> int:
        for i, n in enumerate(self._fields):
            if n == name:
                return i
        raise KeyError(name)

    # --- ops --------------------------------------------------------------
    def to_arrow(self) -> pa.Schema:
        return pa.schema([pa.field(f.name, f.dtype.to_arrow()) for f in self])

    def union(self, other: "Schema") -> "Schema":
        return Schema(self.fields() + [f for f in other if f.name not in self])

    def non_distinct_union(self, other: "Schema") -> "Schema":
        out = list(self.fields())
        for f in other:
            if f.name not in self:
                out.append(f)
        return Schema(out)

    def apply_hints(self, hints: "Schema") -> "Schema":
        return Schema([hints[f.name] if f.name in hints else f for f in self])

    def select(self, names: List[str]) -> "Schema":
        return Schema([self[n] for n in names])

    def rename(self, mapping: Dict[str, str]) -> "Schema":
        return Schema([f.rename(mapping.get(f.name, f.name)) for f in self])

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields() == other.fields()

    def __hash__(self) -> int:
        return hash(tuple(self.fields()))

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}: {f.dtype!r}" for f in self)
        return f"Schema({inner})"

    def _truncated_table_string(self) -> str:
        parts = [f"{f.name} ({f.dtype!r})" for f in self]
        return " | ".join(parts)

    def short_repr(self, max_fields: int = 6) -> str:
        parts = [f"{f.name}" for f in self]
        if len(parts) > max_fields:
            parts = parts[:max_fields] + [f"... +{len(parts) - max_fields}"]
        return ", ".join(parts)
