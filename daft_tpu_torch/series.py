"""Series: a named, typed column (the port's copy of daft_tpu/series.py).

Host storage is a single-chunk Arrow array of the logical type's physical arrow
mapping, or a numpy object array for python-dtype columns. The device path
stages numeric columns as torch tensors (see daft_tpu_torch/kernels/device.py).

``Series.hash`` (kernels/host_hash.py, with a stable byte form for python
objects) and ``murmur3_32`` (kernels/murmur.py) back the hash functions and
the Iceberg bucket transform; the row hash of the hash shuffle is
Table.hash_rows, which hashes a table's Arrow columns directly.

Fixed-shape tensor, embedding and fixed-shape image columns give their
values to ``to_numpy`` as one [n, *shape] array (an object array of rows
and Nones where a row is null). An Image column casts to a FixedShapeImage
of its own shape, channels and pixel type (each mismatch raises a
ValueError that names it) and back (multimodal.py holds the layouts).
``approx_count_distinct`` and ``approx_percentiles`` run the sketch
subsystem's estimators (daft_tpu_torch/sketch/), the same the two-stage
plan finalizes, so an answer does not depend on how the input was
partitioned.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .datatypes import DataType, TypeKind, infer_datatype, try_unify
from .kernels.host_hash import hash_array


def _stable_value_bytes(v) -> bytes:
    """A byte form of a python value that is the same in every process, for
    hashing. A plain pickle is not enough: a set iterates in an order that
    follows the process's string hash seed, and two equal dicts can differ
    in insertion order. Containers canonicalize recursively (set members and
    dict items sorted by their own bytes); other values pickle at a fixed
    protocol. Raises for a value that does not pickle."""
    import pickle

    if isinstance(v, (set, frozenset)):
        return b"S(" + b",".join(sorted(_stable_value_bytes(x) for x in v)) + b")"
    if isinstance(v, dict):
        items = sorted((_stable_value_bytes(k), _stable_value_bytes(x)) for k, x in v.items())
        return b"D(" + b",".join(k + b":" + x for k, x in items) + b")"
    if isinstance(v, (list, tuple)):
        tag = b"L(" if isinstance(v, list) else b"T("
        return tag + b",".join(_stable_value_bytes(x) for x in v) + b")"
    return pickle.dumps(v, protocol=4)


class Series:
    __slots__ = ("_name", "_dtype", "_arrow", "_pyobjs")

    def __init__(self, name: str, dtype: DataType, arrow: Optional[pa.Array], pyobjs: Optional[np.ndarray] = None):
        self._name = name
        self._dtype = dtype
        self._arrow = arrow
        self._pyobjs = pyobjs  # numpy object array when dtype is python

    # pickling (the distributed runner's transport): arrow pickles a sliced
    # array with its parent's whole buffers, so a slice ships compacted
    def __getstate__(self):
        arr = self._arrow
        total = getattr(arr, "get_total_buffer_size", None)
        if total is not None and total() > arr.nbytes:
            arr = (pa.concat_arrays([arr]) if isinstance(arr, pa.Array)
                   else pa.chunked_array([pa.concat_arrays([c]) for c in arr.chunks], arr.type))
        return (self._name, self._dtype, arr, self._pyobjs)

    def __setstate__(self, state):
        self._name, self._dtype, self._arrow, self._pyobjs = state

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

    def to_numpy(self) -> np.ndarray:
        """The values as a numpy array (nulls as NaN in a float column, an
        object array where arrow cannot convert; the object array itself for a
        python column). A fixed-shape tensor, embedding or fixed-shape image
        column gives [n, *shape], or an object array of rows and Nones when a
        row is null."""
        if self._arrow is None:
            return self._pyobjs
        if self._dtype.kind in (TypeKind.FIXED_SHAPE_TENSOR, TypeKind.EMBEDDING,
                                TypeKind.FIXED_SHAPE_IMAGE):
            arr = self._arrow
            shape = _static_shape(self._dtype)
            size = int(np.prod(shape)) if shape else 1
            # .values keeps the slots behind null rows (flatten() drops them)
            child = arr.values.slice(arr.offset * size, len(arr) * size)
            if child.null_count:
                child = pc.fill_null(child, np.nan if pa.types.is_floating(child.type) else 0)
            flat = np.asarray(child).reshape((len(self),) + shape)
            if arr.null_count:
                out = np.empty(len(self), dtype=object)
                valid = np.asarray(pc.is_valid(arr))
                for i in range(len(self)):
                    out[i] = flat[i] if valid[i] else None
                return out
            return flat
        try:
            return self._arrow.to_numpy(zero_copy_only=False)
        except pa.ArrowInvalid:
            return np.array(self._arrow.to_pylist(), dtype=object)

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
            if dtype.kind == TypeKind.FIXED_SHAPE_IMAGE and self._dtype.kind == TypeKind.IMAGE:
                return self._to_fixed_image(dtype)
            if dtype.kind == TypeKind.IMAGE and self._dtype.kind == TypeKind.FIXED_SHAPE_IMAGE:
                from .multimodal import image_series_from_arrays, image_series_to_arrays

                arrays = image_series_to_arrays(self)
                return image_series_from_arrays(arrays, self._name,
                                                [self._dtype.params[0]] * len(arrays),
                                                dtype_mode=dtype.params[0])
            if dtype.is_string():
                out = pa.array([None if v is None else str(v) for v in src.to_pylist()], type=pa.large_string())
            elif dtype.is_temporal() and (self._dtype.is_integer() or self._dtype.is_floating()):
                # numeric -> temporal: interpret as epoch count in the target unit
                phys = src.cast(dtype.to_physical().to_arrow())
                out = phys.view(target) if phys.type.bit_width == target.bit_width else phys.cast(target)
            else:
                raise
        return Series(self._name, dtype, out)

    def _to_fixed_image(self, dtype: DataType) -> "Series":
        """An Image column as the FixedShapeImage ``dtype``: every non-null
        image must have its height and width, its channels and its pixel
        type."""
        from .multimodal import (_fixed_image_series, _mode_channels, _mode_np_dtype,
                                 image_series_to_arrays)

        mode, h, w = dtype.params
        want_c = _mode_channels(mode)
        want_np = _mode_np_dtype(mode)
        arrays = image_series_to_arrays(self)
        for a in arrays:
            if a is None:
                continue
            if a.shape[:2] != (h, w):
                raise ValueError(
                    f"cannot cast image of shape {a.shape} to fixed shape ({h}, {w})")
            if a.shape[2] != want_c:
                raise ValueError(
                    f"cannot cast {a.shape[2]}-channel image to mode {mode!r} "
                    f"({want_c} channels); convert with image.to_mode first")
            if a.dtype != want_np:
                raise ValueError(
                    f"cannot cast {a.dtype} image pixels to mode {mode!r} "
                    f"({np.dtype(want_np).name}); convert with image.to_mode first")
        return _fixed_image_series(arrays, self._name, mode, h, w)

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

    def left_shift(self, other):
        return self._binary_numeric(_as_series(other), pc.shift_left, unify=False)

    def right_shift(self, other):
        return self._binary_numeric(_as_series(other), pc.shift_right, unify=False)

    # ------------------------------------------------------------------ numeric fns
    def _unary(self, fn, dtype: Optional[DataType] = None) -> "Series":
        return Series.from_arrow(fn(self._arrow), self._name, dtype)

    def abs(self):
        return self._unary(pc.abs_checked)

    def ceil(self):
        return self._unary(pc.ceil)

    def floor(self):
        return self._unary(pc.floor)

    def sign(self):
        return self._unary(pc.sign)

    def round(self, decimals: int = 0):
        return self._unary(lambda a: pc.round(a, ndigits=decimals))

    def sqrt(self):
        return self.cast(DataType.float64())._unary(pc.sqrt)

    def cbrt(self):
        return self._np_unary(np.cbrt)

    def exp(self):
        return self.cast(DataType.float64())._unary(pc.exp)

    def log(self, base: Optional[float] = None):
        f = self.cast(DataType.float64())
        if base is None:
            return f._unary(pc.ln)
        return f._unary(lambda a: pc.logb(a, pa.scalar(float(base))))

    def log2(self):
        return self.cast(DataType.float64())._unary(pc.log2)

    def log10(self):
        return self.cast(DataType.float64())._unary(pc.log10)

    def log1p(self):
        return self.cast(DataType.float64())._unary(pc.log1p)

    def sin(self):
        return self.cast(DataType.float64())._unary(pc.sin)

    def cos(self):
        return self.cast(DataType.float64())._unary(pc.cos)

    def tan(self):
        return self.cast(DataType.float64())._unary(pc.tan)

    def arcsin(self):
        return self.cast(DataType.float64())._unary(pc.asin)

    def arccos(self):
        return self.cast(DataType.float64())._unary(pc.acos)

    def arctan(self):
        return self.cast(DataType.float64())._unary(pc.atan)

    def arctanh(self):
        return self._np_unary(np.arctanh)

    def arccosh(self):
        return self._np_unary(np.arccosh)

    def arcsinh(self):
        return self._np_unary(np.arcsinh)

    def radians(self):
        return self._np_unary(np.radians)

    def degrees(self):
        return self._np_unary(np.degrees)

    def _np_unary(self, np_fn):
        f = self.cast(DataType.float64())
        vals = np.asarray(pc.fill_null(f._arrow, np.nan))
        with np.errstate(all="ignore"):
            out = pa.array(np_fn(vals), from_pandas=True)
        out = pc.if_else(pc.is_valid(f._arrow), out, pa.nulls(len(out), pa.float64()))
        return Series.from_arrow(out, self._name)

    # float namespace
    def float_is_nan(self):
        return self._unary(pc.is_nan, DataType.bool())

    def float_is_inf(self):
        return self._unary(pc.is_inf, DataType.bool())

    def float_not_nan(self):
        return Series.from_arrow(pc.invert(pc.is_nan(self._arrow)), self._name, DataType.bool())

    def float_fill_nan(self, fill: "Series"):
        fill = _as_series(fill).cast(self._dtype)
        l, r = _broadcast(self, fill)
        isnan = pc.fill_null(pc.is_nan(l._arrow), False)
        return Series.from_arrow(pc.if_else(isnan, r._arrow, l._arrow), self._name, self._dtype)

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

    def not_null(self) -> "Series":
        if self._arrow is None:
            return Series.from_arrow(pa.array([v is not None for v in self._pyobjs]), self._name)
        return Series.from_arrow(pc.is_valid(self._arrow), self._name)

    def fill_null(self, fill: "Series") -> "Series":
        fill = _as_series(fill)
        l, r = _broadcast(self, fill)
        return Series.from_arrow(pc.coalesce(l._arrow, r._arrow), self._name, self._dtype)

    def if_else(self, if_true: "Series", if_false: "Series") -> "Series":
        t = _as_series(if_true)
        f = _as_series(if_false)
        n = max(len(self), len(t), len(f))
        cond = _broadcast_to(self, n)
        t = _broadcast_to(t, n)
        f = _broadcast_to(f, n)
        sup = try_unify(t._dtype, f._dtype)
        if sup is None:
            raise ValueError(f"if_else branches have incompatible types {t._dtype} vs {f._dtype}")
        if sup.is_python():
            cm = cond.to_pylist()
            tv, fv = t.to_pylist(), f.to_pylist()
            return Series.from_pylist([None if c is None else (tv[i] if c else fv[i])
                                       for i, c in enumerate(cm)], t._name, sup)
        out = pc.if_else(cond._arrow, t.cast(sup)._arrow, f.cast(sup)._arrow)
        return Series.from_arrow(out, t._name, sup)

    def is_in(self, items: "Series") -> "Series":
        items = _as_series(items)
        sup = try_unify(self._dtype, items._dtype)
        if sup is None:
            return Series.from_arrow(pa.array([False] * len(self)), self._name)
        lhs = self.cast(sup)
        out = pc.is_in(lhs._arrow, value_set=items.cast(sup)._arrow)
        out = pc.fill_null(out, False)
        out = pc.if_else(pc.is_valid(lhs._arrow), out, pa.nulls(len(out), pa.bool_()))
        return Series.from_arrow(out, self._name, DataType.bool())

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

    # ------------------------------------------------------------------ hashing
    def hash(self, seed: Optional["Series"] = None) -> "Series":
        """uint64 hash of every value (nulls hash too), chained from ``seed``
        row by row when given."""
        seeds = None
        if seed is not None:
            seeds = np.asarray(seed.cast(DataType.uint64())._arrow).astype(np.uint64)
        if self._arrow is None:
            # a python object hashes the crc32 of its stable bytes, never its
            # repr, which holds a memory address for most objects
            import zlib

            from .errors import DaftValueError

            vals = []
            for v in self._pyobjs:
                if v is None:
                    vals.append(None)
                    continue
                try:
                    buf = _stable_value_bytes(v)
                except Exception as e:
                    raise DaftValueError(
                        f"cannot hash unpicklable python object of type "
                        f"{type(v).__name__} in column {self._name!r}: a "
                        "cross-process-stable hash needs a stable byte "
                        f"representation ({e})") from e
                vals.append(zlib.crc32(buf))
            return Series.from_pylist(vals, self._name, DataType.uint64())
        return Series.from_arrow(pa.array(hash_array(self._arrow, seed=seeds)), self._name,
                                 DataType.uint64())

    def murmur3_32(self) -> "Series":
        from .kernels.murmur import murmur3_32_arrow

        return Series.from_arrow(murmur3_32_arrow(self._arrow), self._name, DataType.int32())

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

    def stddev(self) -> "Series":
        v = pc.stddev(self._arrow, ddof=0)
        return Series.from_pylist([v.as_py()], self._name, DataType.float64())

    def min(self) -> "Series":
        v = pc.min(self._arrow)
        return Series.from_pylist([v.as_py()], self._name, self._dtype)

    def max(self) -> "Series":
        v = pc.max(self._arrow)
        return Series.from_pylist([v.as_py()], self._name, self._dtype)

    def any_value(self, ignore_nulls: bool = False) -> "Series":
        """The first value (the first non-null one with ``ignore_nulls``)."""
        vals = self._arrow
        if vals is None:
            lst = [v for v in self._pyobjs if v is not None] if ignore_nulls else list(self._pyobjs)
            return Series.from_pylist(lst[:1] or [None], self._name, self._dtype)
        if ignore_nulls and vals.null_count:
            vals = vals.drop_null()
        out = vals.slice(0, 1) if len(vals) else pa.nulls(1, type=self._arrow.type)
        return Series(self._name, self._dtype, out)

    def agg_list(self) -> "Series":
        """One row: the list of every value, in order."""
        if self._arrow is None:
            return Series.from_pylist([list(self._pyobjs)], self._name, DataType.list(DataType.python()))
        offsets = pa.array([0, len(self._arrow)], type=pa.int64())
        return Series(self._name, DataType.list(self._dtype),
                      pa.LargeListArray.from_arrays(offsets, self._arrow))

    def agg_concat(self) -> "Series":
        """One row: the lists of every row concatenated, in order."""
        if self._dtype.kind != TypeKind.LIST:
            raise ValueError(f"agg_concat requires list type, got {self._dtype}")
        flat = self._arrow.flatten()
        offsets = pa.array([0, len(flat)], type=pa.int64())
        return Series(self._name, self._dtype, pa.LargeListArray.from_arrays(offsets, flat))

    def approx_count_distinct(self) -> "Series":
        """One row: the HyperLogLog estimate of the distinct non-null values
        (sketch/hll.py, the two-stage plan's estimator)."""
        from .sketch import hll

        return Series.from_pylist([hll.count_distinct_estimate(self)], self._name,
                                  DataType.uint64())

    def approx_percentiles(self, percentiles) -> "Series":
        """One row: the percentiles (a float, or a list for a list) of the
        numeric values by the quantile sketch (sketch/quantile.py)."""
        from .sketch import quantile

        out = quantile.percentile_estimate(self, percentiles)
        if isinstance(percentiles, float):
            return Series.from_pylist([out], self._name, DataType.float64())
        return Series.from_pylist([out], self._name, DataType.list(DataType.float64()))


def _static_shape(dt: DataType):
    """The shape of one value of a fixed-shape tensor, embedding or
    fixed-shape image column."""
    if dt.kind == TypeKind.EMBEDDING:
        return (dt.params[1],)
    return dt.tensor_shape


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

