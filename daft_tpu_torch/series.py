"""Series: a named, typed column (the port's copy of daft_tpu/series.py).

Host storage is a single-chunk Arrow array of the logical type's physical arrow
mapping, or a numpy object array for python-dtype columns. The device path
stages numeric columns as torch tensors (see daft_tpu_torch/kernels/device.py).

Left out of this slice: the hash expression (Series.hash/murmur3_32), the
multimodal image casts, the sketch-backed approximate aggregations and the
per-element math functions. The row hash of the hash shuffle is
Table.hash_rows (kernels/host_hash.py), which hashes a table's Arrow columns
directly and needs none of them.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .datatypes import DataType, TypeKind, infer_datatype, try_unify


class Series:
    __slots__ = ("_name", "_dtype", "_arrow", "_pyobjs")

    def __init__(self, name: str, dtype: DataType, arrow: Optional[pa.Array], pyobjs: Optional[np.ndarray] = None):
        self._name = name
        self._dtype = dtype
        self._arrow = arrow
        self._pyobjs = pyobjs  # numpy object array when dtype is python

    # ------------------------------------------------------------------ ctors
    @staticmethod
    def from_arrow(arr, name: str = "arrow_series", dtype: Optional[DataType] = None) -> "Series":
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.chunk(0) if arr.num_chunks == 1 else arr.combine_chunks()
        if isinstance(arr, pa.Scalar):
            arr = pa.array([arr.as_py()], type=arr.type)
        if pa.types.is_dictionary(arr.type):
            arr = arr.dictionary_decode()
        inferred = DataType.from_arrow(arr.type)
        if dtype is None:
            dtype = inferred
        else:
            # Canonical storage for every logical dtype is dtype.to_arrow() — temporal
            # logical types keep real arrow temporal storage in all construction paths.
            target = dtype.to_arrow() if not dtype.is_python() else None
            if target is not None and arr.type != target:
                arr = arr.cast(target)
        if dtype.is_string() and not pa.types.is_large_string(arr.type):
            arr = arr.cast(pa.large_string())
        if dtype.kind == TypeKind.BINARY and not pa.types.is_large_binary(arr.type):
            arr = arr.cast(pa.large_binary())
        return Series(name, dtype, arr)

    @staticmethod
    def from_pylist(data: Sequence[Any], name: str = "list_series", dtype: Optional[DataType] = None) -> "Series":
        inferred = dtype is None
        if inferred:
            dt = DataType.null()
            for v in data:
                nxt = infer_datatype(v)
                u = try_unify(dt, nxt)
                if u is None:
                    dt = DataType.python()
                    break
                dt = u
            dtype = dt
        if dtype.is_python():
            return _python_object_series(name, data)
        try:
            arr = pa.array(data, type=dtype.to_arrow())
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError,
                TypeError, OverflowError) as e:
            # an EXPLICITLY requested dtype keeps the original contract:
            # arrow conversion errors fall back to python storage, but
            # python-level failures (overflow of the requested type, ...)
            # propagate rather than silently ignoring the request
            if not inferred and isinstance(e, (TypeError, OverflowError)):
                raise
            # numpy scalars can defeat arrow's sequence converter (e.g. a
            # list holding np.datetime64[D] raises TypeError even with an
            # explicit date32 type): normalize them to python values first
            try:
                cleaned = [v.item() if isinstance(v, np.generic) else v
                           for v in data]
                arr = pa.array(cleaned, type=dtype.to_arrow())
            except Exception:
                return _python_object_series(name, data)
        return Series(name, dtype, arr)

    @staticmethod
    def from_numpy(arr: np.ndarray, name: str = "numpy_series", dtype: Optional[DataType] = None) -> "Series":
        if arr.dtype == object:
            return Series.from_pylist(list(arr), name, dtype)
        if arr.ndim == 1:
            pa_arr = pa.array(arr)
            return Series.from_arrow(pa_arr, name, dtype)
        if arr.ndim >= 2:
            inner = DataType.from_arrow(pa.from_numpy_dtype(arr.dtype))
            shape = arr.shape[1:]
            dt = dtype or DataType.tensor(inner, shape)
            n = 1
            for s in shape:
                n *= s
            flat = pa.FixedSizeListArray.from_arrays(pa.array(arr.reshape(-1)), n)
            return Series(name, dt, flat)
        raise ValueError("cannot create Series from 0-d array")

    @staticmethod
    def empty(name: str, dtype: DataType) -> "Series":
        if dtype.is_python():
            return Series(name, dtype, None, np.empty(0, dtype=object))
        return Series(name, dtype, pa.array([], type=dtype.to_arrow()))

    @staticmethod
    def full_null(name: str, dtype: DataType, length: int) -> "Series":
        if dtype.is_python():
            return Series(name, dtype, None, np.full(length, None, dtype=object))
        return Series(name, dtype, pa.nulls(length, type=dtype.to_arrow()))

    # ------------------------------------------------------------------ basics
    @property
    def name(self) -> str:
        return self._name

    @property
    def dtype(self) -> DataType:
        return self._dtype

    def rename(self, name: str) -> "Series":
        return Series(name, self._dtype, self._arrow, self._pyobjs)

    def __len__(self) -> int:
        return len(self._pyobjs) if self._arrow is None else len(self._arrow)

    def size_bytes(self) -> int:
        if self._arrow is None:
            return int(self._pyobjs.nbytes) + 64 * len(self._pyobjs)
        return self._arrow.nbytes

    def is_python(self) -> bool:
        return self._dtype.is_python()

    def to_arrow(self) -> pa.Array:
        if self._arrow is None:
            raise ValueError("Python-object Series has no arrow representation")
        return self._arrow

    def to_pylist(self) -> List[Any]:
        if self._arrow is None:
            return list(self._pyobjs)
        return self._arrow.to_pylist()

    def __repr__(self) -> str:
        vals = self.to_pylist()
        preview = ", ".join(repr(v) for v in vals[:8]) + (", …" if len(vals) > 8 else "")
        return f"Series[{self._name}: {self._dtype!r}; {len(self)} rows]([{preview}])"

    # ------------------------------------------------------------------ casting
    def cast(self, dtype: DataType) -> "Series":
        if dtype == self._dtype:
            return self
        if dtype.is_python():
            objs = np.empty(len(self), dtype=object)
            for i, v in enumerate(self.to_pylist()):
                objs[i] = v
            return Series(self._name, dtype, None, objs)
        if self.is_python():
            return Series.from_pylist(self.to_pylist(), self._name, dtype)
        target = dtype.to_arrow()
        src = self._arrow
        opts = pc.CastOptions(target_type=target, allow_float_truncate=True, allow_time_truncate=True)
        try:
            out = pc.cast(src, options=opts)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            if dtype.is_string():
                out = pa.array([None if v is None else str(v) for v in src.to_pylist()], type=pa.large_string())
            elif dtype.is_temporal() and (self._dtype.is_integer() or self._dtype.is_floating()):
                # numeric -> temporal: interpret as epoch count in the target unit
                phys = src.cast(dtype.to_physical().to_arrow())
                out = phys.view(target) if phys.type.bit_width == target.bit_width else phys.cast(target)
            else:
                raise
        return Series(self._name, dtype, out)

    def _require_arrow(self, op: str) -> pa.Array:
        if self._arrow is None:
            raise ValueError(f"{op} is not supported for python-dtype Series (cast first)")
        return self._arrow

    # ------------------------------------------------------------------ arithmetic
    def _binary_numeric(self, other: "Series", fn, name=None, force_dtype: Optional[DataType] = None,
                        unify: bool = True) -> "Series":
        self._require_arrow("arithmetic")
        other._require_arrow("arithmetic")
        l, r = self, other
        if unify and l._dtype != r._dtype and all(
                d.is_numeric() or d.is_boolean() for d in (l._dtype, r._dtype)):
            # bool operands unify to the numeric side (reference binary_ops.rs:
            # (Boolean, numeric) -> numeric)
            u = try_unify(l._dtype, r._dtype)
            if u is not None and u.is_numeric():
                l, r = l.cast(u), r.cast(u)
        out = fn(*_binary_args(l, r))
        s = Series.from_arrow(out, name or self._name)
        if force_dtype is not None and s._dtype != force_dtype:
            s = s.cast(force_dtype)
        return s

    def __add__(self, other: "Series") -> "Series":
        other = _as_series(other)
        if self._dtype.is_string() or other._dtype.is_string():
            self._require_arrow("arithmetic")
            other._require_arrow("arithmetic")
            l, r = _broadcast(self, other)
            return Series.from_arrow(pc.binary_join_element_wise(
                l._arrow.cast(pa.large_string()), r._arrow.cast(pa.large_string()),
                pa.scalar("", pa.large_string())), self._name)
        self._check_temporal_arith("+", other)
        return self._binary_numeric(other, pc.add_checked)

    def __sub__(self, other):
        other = _as_series(other)
        self._check_temporal_arith("-", other)
        return self._binary_numeric(other, pc.subtract_checked)

    def _check_temporal_arith(self, op: str, other: "Series") -> None:
        """Mirror the planner's temporal-pair rules (reference binary_ops.rs:
        e.g. date - timestamp is illegal) — arrow's kernels are more
        permissive than the type system allows."""
        if self._dtype.is_temporal() or other._dtype.is_temporal():
            from .expressions import _temporal_arith_type

            _temporal_arith_type(op, self._dtype, other._dtype)  # raises if illegal

    def __mul__(self, other):
        return self._binary_numeric(_as_series(other), pc.multiply_checked)

    def __truediv__(self, other):
        other = _as_series(other)
        l, r = _broadcast(self.cast(DataType.float64()), other.cast(DataType.float64()))
        return Series.from_arrow(pc.divide(l._arrow, r._arrow), self._name)

    def __floordiv__(self, other):
        other = _as_series(other)
        l, r = _broadcast(self, other)
        if l._dtype.is_floating() or r._dtype.is_floating():
            return Series.from_arrow(pc.floor(pc.divide(l._arrow, r._arrow)), self._name)
        quot = pc.divide_checked(l._arrow, r._arrow)
        rem = pc.subtract_checked(l._arrow, pc.multiply_checked(quot, r._arrow))
        neg = pc.not_equal(pc.sign(l._arrow), pc.sign(r._arrow))
        adjust = pc.and_(neg, pc.not_equal(rem, pa.scalar(0, rem.type)))
        out = pc.if_else(adjust, pc.subtract_checked(quot, pa.scalar(1, quot.type)), quot)
        return Series.from_arrow(out, self._name)

    def __mod__(self, other):
        other = _as_series(other)
        l, r = _broadcast(self, other)
        la, ra = l._arrow, r._arrow
        if pa.types.is_floating(la.type) or pa.types.is_floating(ra.type):
            la = la.cast(pa.float64()); ra = ra.cast(pa.float64())
            ln, rn = np.asarray(pc.fill_null(la, np.nan)), np.asarray(pc.fill_null(ra, np.nan))
            out = pa.array(np.mod(ln, rn), from_pandas=True)
            out = pc.if_else(pc.and_kleene(pc.is_valid(la), pc.is_valid(ra)), out, pa.nulls(len(out), out.type))
            return Series.from_arrow(out, self._name)
        quot = pc.divide_checked(la, ra)
        rem = pc.subtract_checked(la, pc.multiply_checked(quot, ra))
        fix = pc.and_(pc.not_equal(rem, pa.scalar(0, rem.type)), pc.not_equal(pc.sign(la), pc.sign(ra)))
        out = pc.if_else(fix, pc.add_checked(rem, ra), rem)
        return Series.from_arrow(out, self._name)

    def __pow__(self, other):
        other = _as_series(other)
        l, r = _broadcast(self.cast(DataType.float64()), other.cast(DataType.float64()))
        return Series.from_arrow(pc.power(l._arrow, r._arrow), self._name)

    def __neg__(self):
        return Series.from_arrow(pc.negate_checked(self._arrow), self._name)

    def __abs__(self):
        return Series.from_arrow(pc.abs_checked(self._arrow), self._name)

    # ------------------------------------------------------------------ comparison
    def _cmp(self, other, fn) -> "Series":
        self._require_arrow("comparison")
        other = _as_series(other)
        other._require_arrow("comparison")
        l, r = self, other
        if l._arrow.type != r._arrow.type:
            # ISO-string side of a temporal comparison parses to the temporal
            # type (SQL semantics: date_col <= '1998-09-02')
            if l._dtype.is_temporal() and r._dtype.is_string():
                r = r.cast(l._dtype)
            elif r._dtype.is_temporal() and l._dtype.is_string():
                l = l.cast(r._dtype)
        if l._arrow.type != r._arrow.type:
            sup = try_unify(l._dtype, r._dtype)
            if sup is None:
                raise ValueError(f"cannot compare {l._dtype} with {r._dtype}")
            l = l.cast(sup)
            r = r.cast(sup)
        return Series.from_arrow(fn(*_binary_args(l, r)), self._name, DataType.bool())

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp(other, pc.equal)

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp(other, pc.not_equal)

    def __lt__(self, other):
        return self._cmp(other, pc.less)

    def __le__(self, other):
        return self._cmp(other, pc.less_equal)

    def __gt__(self, other):
        return self._cmp(other, pc.greater)

    def __ge__(self, other):
        return self._cmp(other, pc.greater_equal)

    def eq_null_safe(self, other):
        other = _as_series(other)
        l, r = _broadcast(self, other)
        eq = pc.fill_null(pc.equal(l._arrow, r._arrow), False)
        both_null = pc.and_(pc.is_null(l._arrow), pc.is_null(r._arrow))
        return Series.from_arrow(pc.or_(eq, both_null), self._name, DataType.bool())

    # ------------------------------------------------------------------ logical
    def _logical(self, other, kleene_fn, bit_fn) -> "Series":
        """Kleene logic on bools; bitwise form when both sides are integers
        (matching the planner: mixed bool/int pairs are rejected)."""
        other = _as_series(other)
        l, r = self, other
        if l._dtype.is_integer() and r._dtype.is_integer():
            if l._dtype != r._dtype:
                u = try_unify(l._dtype, r._dtype)
                if u is not None:
                    l, r = l.cast(u), r.cast(u)
            return Series.from_arrow(bit_fn(*_binary_args(l, r)), self._name)
        return Series.from_arrow(kleene_fn(*_binary_args(l, r)), self._name)

    def __and__(self, other):
        return self._logical(other, pc.and_kleene, pc.bit_wise_and)

    def __or__(self, other):
        return self._logical(other, pc.or_kleene, pc.bit_wise_or)

    def __xor__(self, other):
        return self._logical(other, pc.xor, pc.bit_wise_xor)

    def __invert__(self):
        return Series.from_arrow(pc.invert(self._arrow), self._name)

    # ------------------------------------------------------------------ null ops
    def is_null(self) -> "Series":
        if self._arrow is None:
            return Series.from_arrow(pa.array([v is None for v in self._pyobjs]), self._name)
        return Series.from_arrow(pc.is_null(self._arrow), self._name)

    def between(self, lower, upper) -> "Series":
        lo = _as_series(lower)
        hi = _as_series(upper)
        return (self >= lo) & (self <= hi)

    # ------------------------------------------------------------------ selection
    def filter(self, mask: "Series") -> "Series":
        m = mask._arrow if isinstance(mask, Series) else pa.array(mask, type=pa.bool_())
        m = pc.fill_null(m, False)
        if self._arrow is None:
            keep = np.asarray(m)
            return Series(self._name, self._dtype, None, self._pyobjs[keep])
        return Series(self._name, self._dtype, self._arrow.filter(m))

    def take(self, indices: "Series") -> "Series":
        idx = indices._arrow if isinstance(indices, Series) else pa.array(indices)
        if self._arrow is None:
            ii = np.asarray(idx, dtype=np.int64)
            out = self._pyobjs[ii]
            return Series(self._name, self._dtype, None, out)
        return Series(self._name, self._dtype, self._arrow.take(idx))

    def slice(self, start: int, end: int) -> "Series":
        if self._arrow is None:
            return Series(self._name, self._dtype, None, self._pyobjs[start:end])
        return Series(self._name, self._dtype, self._arrow.slice(start, end - start))

    @staticmethod
    def concat(series_list: List["Series"]) -> "Series":
        if not series_list:
            raise ValueError("need at least one series to concat")
        first = series_list[0]
        dt = first._dtype
        for s in series_list[1:]:
            u = try_unify(dt, s._dtype)
            if u is None:
                raise ValueError(f"cannot concat {dt} with {s._dtype}")
            dt = u
        if dt.is_python():
            objs = np.concatenate([np.asarray(s.cast(dt)._pyobjs, dtype=object) for s in series_list])
            return Series(first._name, dt, None, objs)
        arrs = [s.cast(dt)._arrow for s in series_list]
        return Series(first._name, dt, pa.concat_arrays(arrs))

    # ------------------------------------------------------------------ sorting
    def argsort(self, descending: bool = False, nulls_first: Optional[bool] = None) -> "Series":
        self._require_arrow("argsort/sort")
        order = "descending" if descending else "ascending"
        placement = "at_start" if (nulls_first if nulls_first is not None else descending) else "at_end"
        idx = pc.array_sort_indices(self._arrow, order=order, null_placement=placement)
        return Series.from_arrow(idx.cast(pa.uint64()), self._name)

    def sort(self, descending: bool = False, nulls_first: Optional[bool] = None) -> "Series":
        return self.take(self.argsort(descending, nulls_first))

    # ------------------------------------------------------------------ aggregations
    def count(self, mode: str = "valid") -> "Series":
        if self._arrow is None:
            n = len(self._pyobjs) if mode == "all" else int(sum(v is not None for v in self._pyobjs))
            return Series.from_pylist([n], self._name, DataType.uint64())
        n = len(self._arrow) if mode == "all" else len(self._arrow) - self._arrow.null_count
        if mode == "null":
            n = self._arrow.null_count
        return Series.from_pylist([n], self._name, DataType.uint64())

    def sum(self) -> "Series":
        out_dt = _sum_dtype(self._dtype)
        v = pc.sum(self._arrow)
        return Series.from_pylist([v.as_py()], self._name, out_dt)

    def mean(self) -> "Series":
        v = pc.mean(self._arrow)
        return Series.from_pylist([v.as_py()], self._name, DataType.float64())

    def min(self) -> "Series":
        v = pc.min(self._arrow)
        return Series.from_pylist([v.as_py()], self._name, self._dtype)

    def max(self) -> "Series":
        v = pc.max(self._arrow)
        return Series.from_pylist([v.as_py()], self._name, self._dtype)


def _python_object_series(name: str, data) -> "Series":
    """Python-dtype fallback storage (object array; no arrow representation)."""
    objs = np.empty(len(data), dtype=object)
    for i, v in enumerate(data):
        objs[i] = v
    return Series(name, DataType.python(), None, objs)


def _sum_dtype(dt: DataType) -> DataType:
    if dt.is_signed_integer() or dt.is_boolean():
        return DataType.int64()
    if dt.is_unsigned_integer():
        return DataType.uint64()
    return dt


def _as_series(v) -> Series:
    if isinstance(v, Series):
        return v
    return Series.from_pylist([v], "literal")


def _binary_args(a: Series, b: Series):
    """Kernel operands for an elementwise binary op: a length-1 side is passed
    as a pa.Scalar so arrow kernels broadcast natively (no materialized repeat)."""
    na, nb = len(a), len(b)
    if na == nb:
        return a._arrow, b._arrow
    if na == 1:
        return a._arrow[0], b._arrow
    if nb == 1:
        return a._arrow, b._arrow[0]
    raise ValueError(f"length mismatch: {na} vs {nb}")


def _broadcast(a: Series, b: Series):
    if len(a) == len(b):
        return a, b
    if len(a) == 1:
        return _broadcast_to(a, len(b)), b
    if len(b) == 1:
        return a, _broadcast_to(b, len(a))
    raise ValueError(f"length mismatch: {len(a)} vs {len(b)}")


def _broadcast_to(s: Series, n: int) -> Series:
    if len(s) == n:
        return s
    if len(s) != 1:
        raise ValueError(f"cannot broadcast series of length {len(s)} to {n}")
    if s._arrow is None:
        return Series(s._name, s._dtype, None, np.repeat(s._pyobjs, n))
    if n == 0:
        return s.slice(0, 0)
    arr = pa.concat_arrays([s._arrow] * n) if n < 64 else _repeat_arrow(s._arrow, n)
    return Series(s._name, s._dtype, arr)


def _repeat_arrow(arr: pa.Array, n: int) -> pa.Array:
    idx = pa.array(np.zeros(n, dtype=np.int64))
    return arr.take(idx)

