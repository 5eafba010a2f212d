"""DataType system (the port's copy of daft_tpu/datatypes.py, unchanged apart
from its docstrings).

Covers the full logical type lattice of the reference engine
(`src/daft-core/src/datatypes/dtype.rs:14-99` in the reference tree), including the
multimodal types (Embedding / Image / FixedShapeImage / Tensor / FixedShapeTensor /
Python). Backed by Apache Arrow on the host; numeric / temporal types additionally have
a device representation (torch tensors in this package, see kernels/device.py).
"""

from __future__ import annotations

import enum
from typing import Any, Optional, Tuple

import pyarrow as pa


class TypeKind(enum.Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL128 = "decimal128"
    STRING = "string"
    BINARY = "binary"
    FIXED_SIZE_BINARY = "fixed_size_binary"
    DATE = "date"
    TIME = "time"
    TIMESTAMP = "timestamp"
    DURATION = "duration"
    INTERVAL = "interval"
    LIST = "list"
    FIXED_SIZE_LIST = "fixed_size_list"
    STRUCT = "struct"
    MAP = "map"
    EXTENSION = "extension"
    EMBEDDING = "embedding"
    IMAGE = "image"
    FIXED_SHAPE_IMAGE = "fixed_shape_image"
    TENSOR = "tensor"
    FIXED_SHAPE_TENSOR = "fixed_shape_tensor"
    SPARSE_TENSOR = "sparse_tensor"
    PYTHON = "python"
    UNKNOWN = "unknown"


_INTEGER_KINDS = {
    TypeKind.INT8,
    TypeKind.INT16,
    TypeKind.INT32,
    TypeKind.INT64,
    TypeKind.UINT8,
    TypeKind.UINT16,
    TypeKind.UINT32,
    TypeKind.UINT64,
}
_FLOAT_KINDS = {TypeKind.FLOAT32, TypeKind.FLOAT64}
_TEMPORAL_KINDS = {TypeKind.DATE, TypeKind.TIME, TypeKind.TIMESTAMP, TypeKind.DURATION}

_SIGNED_INTS = [TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64]
_UNSIGNED_INTS = [TypeKind.UINT8, TypeKind.UINT16, TypeKind.UINT32, TypeKind.UINT64]

_BIT_WIDTH = {
    TypeKind.BOOL: 1,
    TypeKind.INT8: 8,
    TypeKind.INT16: 16,
    TypeKind.INT32: 32,
    TypeKind.INT64: 64,
    TypeKind.UINT8: 8,
    TypeKind.UINT16: 16,
    TypeKind.UINT32: 32,
    TypeKind.UINT64: 64,
    TypeKind.FLOAT32: 32,
    TypeKind.FLOAT64: 64,
}

# Image modes supported by the image type (reference: ImageMode in
# src/daft-core/src/datatypes/image_mode.rs).
IMAGE_MODES = ("L", "LA", "RGB", "RGBA", "L16", "LA16", "RGB16", "RGBA16", "RGB32F", "RGBA32F")
_IMAGE_MODE_CHANNELS = {
    "L": 1, "LA": 2, "RGB": 3, "RGBA": 4,
    "L16": 1, "LA16": 2, "RGB16": 3, "RGBA16": 4,
    "RGB32F": 3, "RGBA32F": 4,
}


class DataType:
    """A logical data type. Immutable and hashable."""

    __slots__ = ("kind", "params")

    def __init__(self, kind: TypeKind, params: Tuple = ()):  # params: hashable tuple
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "params", params)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError("DataType is immutable")

    def __reduce__(self):
        # default unpickling would go through the blocked __setattr__;
        # rebuilding through __init__ keeps the immutability contract while
        # letting types cross process boundaries (dist/ worker transport)
        return (DataType, (self.kind, self.params))

    # --- constructors -----------------------------------------------------
    @staticmethod
    def null() -> "DataType":
        return DataType(TypeKind.NULL)

    @staticmethod
    def bool() -> "DataType":
        return DataType(TypeKind.BOOL)

    @staticmethod
    def int8() -> "DataType":
        return DataType(TypeKind.INT8)

    @staticmethod
    def int16() -> "DataType":
        return DataType(TypeKind.INT16)

    @staticmethod
    def int32() -> "DataType":
        return DataType(TypeKind.INT32)

    @staticmethod
    def int64() -> "DataType":
        return DataType(TypeKind.INT64)

    @staticmethod
    def uint8() -> "DataType":
        return DataType(TypeKind.UINT8)

    @staticmethod
    def uint16() -> "DataType":
        return DataType(TypeKind.UINT16)

    @staticmethod
    def uint32() -> "DataType":
        return DataType(TypeKind.UINT32)

    @staticmethod
    def uint64() -> "DataType":
        return DataType(TypeKind.UINT64)

    @staticmethod
    def float32() -> "DataType":
        return DataType(TypeKind.FLOAT32)

    @staticmethod
    def float64() -> "DataType":
        return DataType(TypeKind.FLOAT64)

    @staticmethod
    def decimal128(precision: int, scale: int) -> "DataType":
        if not 1 <= precision <= 38:
            raise ValueError(f"decimal128 precision must be in [1, 38], got {precision}")
        return DataType(TypeKind.DECIMAL128, (precision, scale))

    @staticmethod
    def string() -> "DataType":
        return DataType(TypeKind.STRING)

    @staticmethod
    def binary() -> "DataType":
        return DataType(TypeKind.BINARY)

    @staticmethod
    def fixed_size_binary(size: int) -> "DataType":
        return DataType(TypeKind.FIXED_SIZE_BINARY, (size,))

    @staticmethod
    def date() -> "DataType":
        return DataType(TypeKind.DATE)

    @staticmethod
    def time(timeunit: str = "us") -> "DataType":
        _check_timeunit(timeunit, allowed=("us", "ns"))
        return DataType(TypeKind.TIME, (timeunit,))

    @staticmethod
    def timestamp(timeunit: str = "us", timezone: Optional[str] = None) -> "DataType":
        _check_timeunit(timeunit)
        return DataType(TypeKind.TIMESTAMP, (timeunit, timezone))

    @staticmethod
    def duration(timeunit: str = "us") -> "DataType":
        _check_timeunit(timeunit)
        return DataType(TypeKind.DURATION, (timeunit,))

    @staticmethod
    def interval() -> "DataType":
        return DataType(TypeKind.INTERVAL)

    @staticmethod
    def list(inner: "DataType") -> "DataType":
        return DataType(TypeKind.LIST, (inner,))

    @staticmethod
    def fixed_size_list(inner: "DataType", size: int) -> "DataType":
        return DataType(TypeKind.FIXED_SIZE_LIST, (inner, size))

    @staticmethod
    def struct(fields: dict) -> "DataType":
        return DataType(TypeKind.STRUCT, tuple(fields.items()))

    @staticmethod
    def map(key: "DataType", value: "DataType") -> "DataType":
        return DataType(TypeKind.MAP, (key, value))

    @staticmethod
    def extension(name: str, storage: "DataType", metadata: Optional[str] = None) -> "DataType":
        return DataType(TypeKind.EXTENSION, (name, storage, metadata))

    @staticmethod
    def embedding(inner: "DataType", size: int) -> "DataType":
        if not (inner.is_numeric()):
            raise ValueError(f"embedding inner type must be numeric, got {inner}")
        return DataType(TypeKind.EMBEDDING, (inner, size))

    @staticmethod
    def image(mode: Optional[str] = None, height: Optional[int] = None, width: Optional[int] = None) -> "DataType":
        if mode is not None and mode not in IMAGE_MODES:
            raise ValueError(f"unknown image mode {mode!r}; expected one of {IMAGE_MODES}")
        if height is not None or width is not None:
            if mode is None or height is None or width is None:
                raise ValueError("fixed-shape image requires mode, height and width")
            return DataType(TypeKind.FIXED_SHAPE_IMAGE, (mode, height, width))
        return DataType(TypeKind.IMAGE, (mode,))

    @staticmethod
    def tensor(inner: "DataType", shape: Optional[Tuple[int, ...]] = None) -> "DataType":
        if shape is not None:
            return DataType(TypeKind.FIXED_SHAPE_TENSOR, (inner, tuple(shape)))
        return DataType(TypeKind.TENSOR, (inner,))

    @staticmethod
    def sparse_tensor(inner: "DataType") -> "DataType":
        return DataType(TypeKind.SPARSE_TENSOR, (inner,))

    @staticmethod
    def python() -> "DataType":
        return DataType(TypeKind.PYTHON)

    # --- predicates -------------------------------------------------------
    def is_null(self) -> bool:
        return self.kind == TypeKind.NULL

    def is_boolean(self) -> bool:
        return self.kind == TypeKind.BOOL

    def is_integer(self) -> bool:
        return self.kind in _INTEGER_KINDS

    def is_signed_integer(self) -> bool:
        return self.kind in _SIGNED_INTS

    def is_unsigned_integer(self) -> bool:
        return self.kind in _UNSIGNED_INTS

    def is_floating(self) -> bool:
        return self.kind in _FLOAT_KINDS

    def is_numeric(self) -> bool:
        return self.is_integer() or self.is_floating() or self.kind == TypeKind.DECIMAL128

    def is_temporal(self) -> bool:
        return self.kind in _TEMPORAL_KINDS

    def is_string(self) -> bool:
        return self.kind == TypeKind.STRING

    def is_binary(self) -> bool:
        return self.kind in (TypeKind.BINARY, TypeKind.FIXED_SIZE_BINARY)

    def is_list(self) -> bool:
        return self.kind in (TypeKind.LIST, TypeKind.FIXED_SIZE_LIST)

    def is_nested(self) -> bool:
        return self.kind in (
            TypeKind.LIST, TypeKind.FIXED_SIZE_LIST, TypeKind.STRUCT, TypeKind.MAP,
            TypeKind.EMBEDDING, TypeKind.IMAGE, TypeKind.FIXED_SHAPE_IMAGE,
            TypeKind.TENSOR, TypeKind.FIXED_SHAPE_TENSOR, TypeKind.SPARSE_TENSOR,
        )

    def is_python(self) -> bool:
        return self.kind == TypeKind.PYTHON

    def is_comparable(self) -> bool:
        return (
            self.is_numeric() or self.is_boolean() or self.is_string()
            or self.is_binary() or self.is_temporal() or self.is_null()
        )

    def is_hashable(self) -> bool:
        return self.is_comparable() or self.is_list()

    def is_device_representable(self) -> bool:
        """True if the physical values can live on the device as a dense array."""
        if self.kind in _BIT_WIDTH or self.is_temporal():
            return True
        if self.kind in (TypeKind.FIXED_SIZE_LIST, TypeKind.EMBEDDING):
            return self.params[0].is_device_representable()
        if self.kind in (TypeKind.FIXED_SHAPE_TENSOR,):
            return self.params[0].is_device_representable()
        if self.kind == TypeKind.FIXED_SHAPE_IMAGE:
            return True
        return False

    def bit_width(self) -> int:
        try:
            return _BIT_WIDTH[self.kind]
        except KeyError:
            raise ValueError(f"{self} has no fixed bit width") from None

    # --- nested accessors -------------------------------------------------
    @property
    def inner(self) -> "DataType":
        if self.kind in (TypeKind.LIST, TypeKind.TENSOR, TypeKind.SPARSE_TENSOR):
            return self.params[0]
        if self.kind in (TypeKind.FIXED_SIZE_LIST, TypeKind.EMBEDDING):
            return self.params[0]
        if self.kind == TypeKind.FIXED_SHAPE_TENSOR:
            return self.params[0]
        if self.kind == TypeKind.MAP:
            return DataType.struct({"key": self.params[0], "value": self.params[1]})
        raise ValueError(f"{self} has no inner type")

    @property
    def size(self) -> int:
        if self.kind in (TypeKind.FIXED_SIZE_LIST, TypeKind.EMBEDDING):
            return self.params[1]
        if self.kind == TypeKind.FIXED_SIZE_BINARY:
            return self.params[0]
        raise ValueError(f"{self} has no fixed size")

    @property
    def fields(self) -> dict:
        if self.kind != TypeKind.STRUCT:
            raise ValueError(f"{self} is not a struct")
        return dict(self.params)

    @property
    def image_mode(self) -> Optional[str]:
        if self.kind == TypeKind.IMAGE:
            return self.params[0]
        if self.kind == TypeKind.FIXED_SHAPE_IMAGE:
            return self.params[0]
        raise ValueError(f"{self} is not an image type")

    @property
    def tensor_shape(self) -> Tuple[int, ...]:
        if self.kind == TypeKind.FIXED_SHAPE_TENSOR:
            return self.params[1]
        if self.kind == TypeKind.FIXED_SHAPE_IMAGE:
            mode, h, w = self.params
            return (h, w, _IMAGE_MODE_CHANNELS[mode])
        raise ValueError(f"{self} has no static shape")

    # --- conversions ------------------------------------------------------
    def to_arrow(self) -> pa.DataType:
        return _to_arrow(self)

    @staticmethod
    def from_arrow(t: pa.DataType) -> "DataType":
        return _from_arrow(t)

    def to_physical(self) -> "DataType":
        """The physical (storage) type of a logical type."""
        k = self.kind
        if k == TypeKind.DATE:
            return DataType.int32()
        if k in (TypeKind.TIME, TypeKind.TIMESTAMP, TypeKind.DURATION):
            return DataType.int64()
        if k == TypeKind.EMBEDDING:
            return DataType.fixed_size_list(self.params[0].to_physical(), self.params[1])
        if k == TypeKind.IMAGE:
            return DataType.struct(
                {
                    "data": DataType.list(DataType.uint8()),
                    "channel": DataType.uint16(),
                    "height": DataType.uint32(),
                    "width": DataType.uint32(),
                    "mode": DataType.uint8(),
                }
            )
        if k == TypeKind.FIXED_SHAPE_IMAGE:
            mode, h, w = self.params
            dt = DataType.uint8() if not mode.endswith(("16", "32F")) else (
                DataType.uint16() if mode.endswith("16") else DataType.float32()
            )
            return DataType.fixed_size_list(dt, h * w * _IMAGE_MODE_CHANNELS[mode])
        if k == TypeKind.TENSOR:
            return DataType.struct({"data": DataType.list(self.params[0]), "shape": DataType.list(DataType.uint64())})
        if k == TypeKind.FIXED_SHAPE_TENSOR:
            inner, shape = self.params
            n = 1
            for s in shape:
                n *= s
            return DataType.fixed_size_list(inner.to_physical(), n)
        return self

    def to_numpy_dtype(self):
        import numpy as np

        m = {
            TypeKind.BOOL: np.bool_, TypeKind.INT8: np.int8, TypeKind.INT16: np.int16,
            TypeKind.INT32: np.int32, TypeKind.INT64: np.int64, TypeKind.UINT8: np.uint8,
            TypeKind.UINT16: np.uint16, TypeKind.UINT32: np.uint32, TypeKind.UINT64: np.uint64,
            TypeKind.FLOAT32: np.float32, TypeKind.FLOAT64: np.float64,
        }
        if self.kind in m:
            return np.dtype(m[self.kind])
        if self.is_temporal():
            return np.dtype(np.int64) if self.kind != TypeKind.DATE else np.dtype(np.int32)
        raise ValueError(f"{self} has no numpy dtype")

    # --- dunder -----------------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        return isinstance(other, DataType) and self.kind == other.kind and self.params == other.params

    def __hash__(self) -> int:
        return hash((self.kind, self.params))

    def __repr__(self) -> str:
        k = self.kind
        if not self.params:
            return k.value
        if k == TypeKind.DECIMAL128:
            return f"decimal128({self.params[0]}, {self.params[1]})"
        if k == TypeKind.TIMESTAMP:
            tu, tz = self.params
            return f"timestamp[{tu}]" if tz is None else f"timestamp[{tu}, {tz}]"
        if k in (TypeKind.TIME, TypeKind.DURATION):
            return f"{k.value}[{self.params[0]}]"
        if k == TypeKind.LIST:
            return f"list[{self.params[0]!r}]"
        if k == TypeKind.FIXED_SIZE_LIST:
            return f"fixed_size_list[{self.params[0]!r}; {self.params[1]}]"
        if k == TypeKind.STRUCT:
            inner = ", ".join(f"{n}: {t!r}" for n, t in self.params)
            return f"struct[{inner}]"
        if k == TypeKind.MAP:
            return f"map[{self.params[0]!r}: {self.params[1]!r}]"
        if k == TypeKind.EMBEDDING:
            return f"embedding[{self.params[0]!r}; {self.params[1]}]"
        if k == TypeKind.IMAGE:
            return "image" if self.params[0] is None else f"image[{self.params[0]}]"
        if k == TypeKind.FIXED_SHAPE_IMAGE:
            return f"image[{self.params[0]}, {self.params[1]}x{self.params[2]}]"
        if k == TypeKind.TENSOR:
            return f"tensor[{self.params[0]!r}]"
        if k == TypeKind.FIXED_SHAPE_TENSOR:
            return f"tensor[{self.params[0]!r}; {self.params[1]}]"
        if k == TypeKind.SPARSE_TENSOR:
            return f"sparse_tensor[{self.params[0]!r}]"
        if k == TypeKind.EXTENSION:
            return f"extension[{self.params[0]}]"
        if k == TypeKind.FIXED_SIZE_BINARY:
            return f"fixed_size_binary[{self.params[0]}]"
        return f"{k.value}{self.params!r}"


def _check_timeunit(tu: str, allowed=("s", "ms", "us", "ns")) -> None:
    if tu not in allowed:
        raise ValueError(f"invalid time unit {tu!r}; expected one of {allowed}")


# ---------------------------------------------------------------------------
# Arrow conversion
# ---------------------------------------------------------------------------

_ARROW_EXT_PREFIX = "daft_tpu."


def _to_arrow(dt: DataType) -> pa.DataType:
    k = dt.kind
    simple = {
        TypeKind.NULL: pa.null(), TypeKind.BOOL: pa.bool_(),
        TypeKind.INT8: pa.int8(), TypeKind.INT16: pa.int16(),
        TypeKind.INT32: pa.int32(), TypeKind.INT64: pa.int64(),
        TypeKind.UINT8: pa.uint8(), TypeKind.UINT16: pa.uint16(),
        TypeKind.UINT32: pa.uint32(), TypeKind.UINT64: pa.uint64(),
        TypeKind.FLOAT32: pa.float32(), TypeKind.FLOAT64: pa.float64(),
        TypeKind.STRING: pa.large_string(), TypeKind.BINARY: pa.large_binary(),
        TypeKind.DATE: pa.date32(), TypeKind.INTERVAL: pa.month_day_nano_interval(),
    }
    if k in simple:
        return simple[k]
    if k == TypeKind.DECIMAL128:
        return pa.decimal128(*dt.params)
    if k == TypeKind.FIXED_SIZE_BINARY:
        return pa.binary(dt.params[0])
    if k == TypeKind.TIME:
        return pa.time64(dt.params[0])
    if k == TypeKind.TIMESTAMP:
        return pa.timestamp(dt.params[0], tz=dt.params[1])
    if k == TypeKind.DURATION:
        return pa.duration(dt.params[0])
    if k == TypeKind.LIST:
        return pa.large_list(_to_arrow(dt.params[0]))
    if k == TypeKind.FIXED_SIZE_LIST:
        return pa.list_(_to_arrow(dt.params[0]), dt.params[1])
    if k == TypeKind.STRUCT:
        return pa.struct([pa.field(n, _to_arrow(t)) for n, t in dt.params])
    if k == TypeKind.MAP:
        return pa.map_(_to_arrow(dt.params[0]), _to_arrow(dt.params[1]))
    # Multimodal/logical types are stored as their physical arrow type; the logical
    # DataType is carried by the Series/Schema, not by arrow metadata.
    if k in (
        TypeKind.EMBEDDING, TypeKind.IMAGE, TypeKind.FIXED_SHAPE_IMAGE,
        TypeKind.TENSOR, TypeKind.FIXED_SHAPE_TENSOR, TypeKind.SPARSE_TENSOR,
    ):
        return _to_arrow(dt.to_physical())
    if k == TypeKind.EXTENSION:
        return _to_arrow(dt.params[1])
    if k == TypeKind.PYTHON:
        raise ValueError("Python type has no arrow representation")
    raise ValueError(f"cannot convert {dt} to arrow")


def _from_arrow(t: pa.DataType) -> DataType:
    if pa.types.is_null(t):
        return DataType.null()
    if pa.types.is_boolean(t):
        return DataType.bool()
    for name in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"):
        if getattr(pa.types, f"is_{name}")(t):
            return DataType(TypeKind(name))
    if pa.types.is_float16(t):
        return DataType.float32()  # promoted: f16 unsupported like reference (dtype.rs:38)
    if pa.types.is_float32(t):
        return DataType.float32()
    if pa.types.is_float64(t):
        return DataType.float64()
    if pa.types.is_decimal(t):
        return DataType.decimal128(t.precision, t.scale)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return DataType.string()
    if pa.types.is_fixed_size_binary(t):
        return DataType.fixed_size_binary(t.byte_width)
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return DataType.binary()
    if pa.types.is_date32(t) or pa.types.is_date64(t):
        return DataType.date()
    if pa.types.is_time32(t) or pa.types.is_time64(t):
        return DataType.time(t.unit if t.unit in ("us", "ns") else "us")
    if pa.types.is_timestamp(t):
        return DataType.timestamp(t.unit, t.tz)
    if pa.types.is_duration(t):
        return DataType.duration(t.unit)
    if pa.types.is_interval(t):
        return DataType.interval()
    if pa.types.is_fixed_size_list(t):
        return DataType.fixed_size_list(_from_arrow(t.value_type), t.list_size)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return DataType.list(_from_arrow(t.value_type))
    if pa.types.is_struct(t):
        return DataType.struct({t.field(i).name: _from_arrow(t.field(i).type) for i in range(t.num_fields)})
    if pa.types.is_map(t):
        return DataType.map(_from_arrow(t.key_type), _from_arrow(t.item_type))
    if pa.types.is_dictionary(t):
        return _from_arrow(t.value_type)
    raise ValueError(f"unsupported arrow type: {t}")


def infer_datatype(value: Any) -> DataType:
    """Infer a DataType from a single Python value (None → null)."""
    import datetime

    import numpy as np

    if value is None:
        return DataType.null()
    if isinstance(value, bool):
        return DataType.bool()
    if isinstance(value, int):
        return DataType.int64()
    if isinstance(value, float):
        return DataType.float64()
    if isinstance(value, str):
        return DataType.string()
    if isinstance(value, (bytes, bytearray)):
        return DataType.binary()
    if isinstance(value, datetime.datetime):
        return DataType.timestamp("us")
    if isinstance(value, datetime.date):
        return DataType.date()
    if isinstance(value, datetime.timedelta):
        return DataType.duration("us")
    if isinstance(value, np.generic):
        # numpy SCALARS (np.int64, np.float32, np.datetime64, np.bool_, ...)
        # are not python int/float/datetime subclasses; map through their
        # dtype so a list of them infers like the equivalent python values
        if isinstance(value, (np.datetime64, np.timedelta64)) \
                and np.isnat(value):
            # NaT is a null, whatever its unit — a unit-less NaT's dtype
            # ('M8') has no arrow mapping and must not poison the column
            return DataType.null()
        try:
            return _from_arrow(pa.from_numpy_dtype(value.dtype))
        except (pa.ArrowNotImplementedError, ValueError, TypeError,
                NotImplementedError):
            return DataType.python()
    if isinstance(value, np.ndarray):
        if value.ndim == 1:
            return DataType.list(_from_arrow(pa.from_numpy_dtype(value.dtype)))
        return DataType.tensor(_from_arrow(pa.from_numpy_dtype(value.dtype)))
    if isinstance(value, (list, tuple)):
        inner = DataType.null()
        for v in value:
            inner = try_unify(inner, infer_datatype(v)) or DataType.python()
        return DataType.list(inner)
    if isinstance(value, dict):
        return DataType.struct({k: infer_datatype(v) for k, v in value.items()})
    return DataType.python()


def try_unify(a: DataType, b: DataType) -> Optional[DataType]:
    """The common supertype of two types, or None if incompatible.

    Mirrors the reference's `try_get_supertype` semantics
    (src/daft-core/src/utils/supertype.rs): null promotes to anything, ints widen,
    int+float → float, anything+python → python.
    """
    if a == b:
        return a
    if a.is_null():
        return b
    if b.is_null():
        return a
    if a.is_python() or b.is_python():
        return DataType.python()
    if a.is_numeric() and b.is_numeric():
        return _numeric_supertype(a, b)
    if a.is_boolean() and b.is_numeric():
        return b
    if b.is_boolean() and a.is_numeric():
        return a
    if a.is_string() and b.is_string():
        return DataType.string()
    if a.kind == TypeKind.LIST and b.kind == TypeKind.LIST:
        inner = try_unify(a.params[0], b.params[0])
        return DataType.list(inner) if inner is not None else None
    if a.kind == TypeKind.TIMESTAMP and b.kind == TypeKind.TIMESTAMP:
        units = ["s", "ms", "us", "ns"]
        tu = units[max(units.index(a.params[0]), units.index(b.params[0]))]
        tz = a.params[1] if a.params[1] == b.params[1] else None
        return DataType.timestamp(tu, tz)
    if a.kind == TypeKind.DURATION and b.kind == TypeKind.DURATION:
        units = ["s", "ms", "us", "ns"]
        return DataType.duration(
            units[max(units.index(a.params[0]), units.index(b.params[0]))])
    if a.kind == TypeKind.DATE and b.kind == TypeKind.TIMESTAMP:
        return b
    if b.kind == TypeKind.DATE and a.kind == TypeKind.TIMESTAMP:
        return a
    return None


def _numeric_supertype(a: DataType, b: DataType) -> DataType:
    if a.kind == TypeKind.DECIMAL128 or b.kind == TypeKind.DECIMAL128:
        return DataType.float64()
    if a.is_floating() or b.is_floating():
        if DataType.float64() in (a, b) or (a.is_integer() and a.bit_width() > 32) or (
            b.is_integer() and b.bit_width() > 32
        ):
            return DataType.float64()
        return DataType.float32()
    aw, bw = a.bit_width(), b.bit_width()
    if a.is_signed_integer() == b.is_signed_integer():
        wide = max(aw, bw)
        kinds = _SIGNED_INTS if a.is_signed_integer() else _UNSIGNED_INTS
        return DataType(kinds[{8: 0, 16: 1, 32: 2, 64: 3}[wide]])
    # mixed signedness: need a signed type wider than the unsigned one; signed+uint64
    # has no such integer, so follow numpy (and the reference's supertype.rs): float64
    uw = aw if a.is_unsigned_integer() else bw
    sw = aw if a.is_signed_integer() else bw
    if uw >= 64:
        return DataType.float64()
    target = max(sw, uw * 2)
    return DataType(_SIGNED_INTS[{8: 0, 16: 1, 32: 2, 64: 3}[target]])
