"""Device kernel layer: Arrow <-> torch staging, the expression compiler and
the masked segment reductions (the port's copy of the part of
daft_tpu/kernels/device.py this slice runs).

- A device column is a pair of dense tensors on the card: ``values``, padded
  to a power-of-two size bucket, and ``valid`` (bool). Nulls never use
  sentinel values in kernels; every kernel threads validity.
- String columns stage as int32 codes against a SORTED per-partition
  dictionary, so group codes over string keys run on plain int lanes.
- Embedding and fixed-shape tensor columns of a device inner type, and
  fixed-shape image columns, stage as 2-D lanes: values [bucket, *shape]
  (narrowed by the inner type), one validity bit a row. The mesh exchange
  ships them as it ships the 1-D lanes.
- An expression tree compiles to one Python closure over
  ``{name: (values, valid)}`` that issues eager torch ops. A comparison of a
  string column with a string literal compares dictionary codes: the
  literal's code bounds, bisected into each partition's dictionary, enter
  the env as 0-d int32 tensors (``string_literal_env``), so one compiled
  program serves every partition. A string predicate (contains,
  startswith, endswith, like, match, is_in over strings, or any bool
  row-local expression of one string column) is evaluated on the host over
  each partition's dictionary, and the card gathers the result by code
  (``string_lut_env``); a numeric is_in compares against static items.
- A row-local transform of one string column used as a value (``upper(s)``,
  ``s.str.left(2)``, a fill_null chain) is evaluated over the dictionary on
  the host and recoded through its sorted distinct results; the card
  gathers the ids by code (``string_transform_env``), and they decode
  through that transformed dictionary. An int-valued transform (``length``,
  ``find``, ``count_matches``) gathers its values the same way.
- Column-to-column string compares and string-valued ``if_else`` /
  ``fill_null`` recode each column's codes through a remap into one sorted
  joint dictionary per group (``string_joint_env``); a compare of a
  transform with another column recodes both sides through a pairwise joint
  dictionary (``transform_cmp_env``).
- In the 32-bit mode, timestamp, duration and time values compare and sort
  through exact epoch lanes: the int64 epoch, its sign bit flipped, split
  into 32-bit halves on the host and each half biased by 2**31 into an
  int32 lane, so a signed int32 compare is the unsigned order
  (``epoch_cmp_env``). A computed epoch side is evaluated once on the host
  in exact int64.
- Aggregations are masked segment reductions over dense group codes.
- Sorts are a stable multi-key argsort over order-preserving int64 lanes
  (``device_table_argsort``, the reference's K5).

Two device modes, as daft_tpu has (``ExecutionConfig.device_x64``, read
through ``x64_enabled``):

- the 32-bit mode (False), the one daft_tpu runs on a TPU: int64 columns
  narrow to int32 when every value fits, float64 columns compute as
  float32, and epoch temporals reach the card only as epoch lanes. JAX
  narrows quietly when x64 is off; torch does not, so every narrowing below
  is an explicit cast;
- the 64-bit mode (True), daft_tpu's own default where x64 is on: int64,
  float64 and epoch columns stage and compute at full width (epochs as
  int64, so their compares and arithmetic take the generic closures),
  counts are int64, and a 64-bit sort key splits into (hi, lo) lanes on the
  card. A uint64 column stages as its int64 bits: every uint64 value on the
  card lies in [0, 2**63), so the signed order is the unsigned one (a
  column past it declines at staging, an arithmetic node that could leave
  it declines in ``int64_wrap_safe``), and a sum wraps modulo 2**64 with
  the bits the host reads back as uint64.

Every cache of staged lanes and compiled programs keys on the mode: a
column staged narrow in one mode is never served in the other.

Unsigned columns run on the card in both modes, as the reference's
uint8/16/32 lanes do. uint8 stages as ``torch.uint8``, whose arithmetic
wraps as the reference's does. torch's uint16 and uint32 support is
partial, so uint16 stages in an int32 lane and uint32 in an int64 lane
(``_UNSIGNED_LANES``), and every node that computes such a type masks its
result back to the width (``_wrap_unsigned``): the low bits of a
two's-complement sum, difference or product are exact, so the masked lane
holds the unsigned wrap, and order and equality are those of the wider
signed lane. The reference's declines on these types stay: a uint32 lane
in the 32-bit mode groups and joins on the host (``uint32_key_declines``),
where its sentinel overflows the reference's int32 scalars.

Left out of this slice: fixed-shape tensor columns. ``hash_buckets`` (K6)
is here as a function held against the reference; as in the reference,
nothing on the query path calls it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..context import x64_enabled
from ..datatypes import DataType, TypeKind
from ..errors import DaftKernelError, DaftStagingError

# Pad row counts up to a power-of-two bucket of at least this size (a
# multiple of the segment-sums kernel's 1024-row blocks).
_MIN_BUCKET = 1024


def size_bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def resolve_device(cfg) -> torch.device:
    """The torch device the config asks for. A request for the card where
    there is none raises ``DaftKernelError``: the device path never carries
    on on the CPU."""
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DaftKernelError(
            "ExecutionConfig.device is 'cuda' but torch sees no CUDA device; "
            "set device='cpu' to run the device path on the CPU")
    return dev


_TORCH_DTYPES = {
    TypeKind.BOOL: torch.bool,
    TypeKind.INT8: torch.int8, TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32, TypeKind.INT64: torch.int64,
    TypeKind.UINT8: torch.uint8,
    TypeKind.FLOAT32: torch.float32, TypeKind.FLOAT64: torch.float64,
}

# uint16 and uint32 compute in the next wider signed lane, masked back to
# their width after each node that can wrap: kind -> (lane, numpy lane, mask)
_UNSIGNED_LANES = {TypeKind.UINT16: (torch.int32, np.int32, 0xFFFF),
                   TypeKind.UINT32: (torch.int64, np.int64, 0xFFFFFFFF)}


def _wrap_unsigned(v, dt: DataType):
    """``v`` masked to the width of ``dt`` when ``dt`` is uint16 or uint32
    (the unsigned wrap of its wider lane); any other ``v`` as it is."""
    lane = _UNSIGNED_LANES.get(dt.kind)
    if lane is None or v.is_floating_point() or v.dtype == torch.bool:
        return v
    return v.to(lane[0]) & lane[2]


def uint32_key_declines(dt: DataType) -> bool:
    """The reference's 32-bit mode cannot pass a uint32 lane's sentinel
    (its maximum) as an int32 scalar, so its group codes and join probe
    raise on such a key and run on the host: the port declines the same
    keys."""
    return dt.kind == TypeKind.UINT32 and not x64_enabled()

# 64-bit logical kinds and their 32-bit compute stand-ins. uint64 (the
# count partials a two-stage aggregate merges) takes int32 lanes: the
# reference's uint32 lanes hold more, but its int32 overflow guard sends any
# sum of values past the int32 range to the host all the same. A user's
# uint64 column takes the same lanes: values past 2**31 - 1 decline to the
# host at staging, and int64_wrap_safe holds uint64 arithmetic to [0, 2**31).
_NARROW_64 = {TypeKind.INT64: torch.int32, TypeKind.UINT64: torch.int32,
              TypeKind.FLOAT64: torch.float32}
_NARROW_NP = {TypeKind.INT64: np.int32, TypeKind.UINT64: np.int32,
              TypeKind.FLOAT64: np.float32}


_EPOCH_KINDS = {TypeKind.TIMESTAMP, TypeKind.DURATION, TypeKind.TIME}

# the range of each integer kind: a float cast into it saturates here
_INT_RANGES = {
    TypeKind.INT8: (-2**7, 2**7 - 1), TypeKind.INT16: (-2**15, 2**15 - 1),
    TypeKind.INT32: (-2**31, 2**31 - 1), TypeKind.INT64: (-2**63, 2**63 - 1),
    TypeKind.UINT8: (0, 2**8 - 1), TypeKind.UINT16: (0, 2**16 - 1),
    TypeKind.UINT32: (0, 2**32 - 1), TypeKind.UINT64: (0, 2**64 - 1),
}


def float_cast_bounds(dt: DataType, lane: torch.dtype) -> Tuple[int, int]:
    """``(lo, hi)``: the values a float cast to the integer kind ``dt``
    saturates at in its compute lane ``lane``. The lane narrows the kind's
    range (int64 and uint64 in the 32-bit mode's int32 lanes); the 64-bit
    mode's uint64 lane holds the kind's bits, so its whole range."""
    lo, hi = _INT_RANGES[dt.kind]
    if dt.kind == TypeKind.UINT64 and lane == torch.int64:
        return lo, hi
    info = torch.iinfo(lane)
    return max(lo, info.min), min(hi, info.max)


def float_to_int(v: torch.Tensor, lane: torch.dtype, lo: int, hi: int) -> torch.Tensor:
    """A float tensor cast to the integer ``lane`` as XLA casts: toward zero,
    NaN to 0, saturating at ``lo`` and ``hi``. torch's own conversion of NaN,
    an infinity or an out-of-range value is undefined (the CPU gives the
    lane's minimum), so every such value is replaced before the conversion.
    The bounds compare in the float domain: ``lo`` and ``hi + 1`` are 0 or
    powers of two, exact in float32 and float64, where ``hi`` itself is not."""
    over = v >= float(hi + 1)
    under = v < float(lo)
    t = torch.where(over | under | torch.isnan(v), torch.zeros_like(v), v)
    if hi >= 2**63:
        # the 64-bit mode's uint64 lane: values past the int64 range convert
        # as their two's-complement bits (t - 2**64 is exact there)
        t = torch.where(t >= float(2**63), t - float(2**64), t)
        hi -= 2**64
    return t.to(lane).masked_fill(over, hi).masked_fill(under, lo)


# the 2-D lanes: one row of values a row, [n, *shape] on the device
_SHAPED_KINDS = (TypeKind.EMBEDDING, TypeKind.FIXED_SHAPE_TENSOR, TypeKind.FIXED_SHAPE_IMAGE)


def is_device_dtype(dt: DataType) -> bool:
    """Device-representable in the current mode. Both modes: int64 and
    uint64 (in the 32-bit mode through lossless int32 narrowing, checked per
    column at stage time), float64 (as float32 in the 32-bit mode), dates as
    int32 days. The 64-bit mode adds the epoch temporals as int64. An
    embedding or fixed-shape tensor of such an inner type, and any
    fixed-shape image, stages as a 2-D lane ([n, *shape])."""
    if dt.kind in _EPOCH_KINDS:
        return x64_enabled()
    if dt.kind == TypeKind.FIXED_SHAPE_IMAGE:
        return True
    if dt.kind in (TypeKind.EMBEDDING, TypeKind.FIXED_SHAPE_TENSOR):
        return is_device_dtype(dt.params[0])
    return (dt.kind in _TORCH_DTYPES or dt.kind in _NARROW_64 or dt.kind in _UNSIGNED_LANES
            or dt.kind == TypeKind.DATE)


def _physical_np(arr: pa.Array) -> np.ndarray:
    """Dense physical values of a primitive arrow array (nulls filled with 0)."""
    t = arr.type
    if pa.types.is_date32(t) or pa.types.is_time32(t):
        arr = arr.cast(pa.int32())
    elif pa.types.is_timestamp(t) or pa.types.is_duration(t) or pa.types.is_time64(t):
        arr = arr.cast(pa.int64())
    if arr.null_count:
        zero = pa.scalar(0, arr.type) if not pa.types.is_boolean(arr.type) else pa.scalar(False)
        arr = pc.fill_null(arr, zero)
    return np.asarray(arr)


class DeviceColumn:
    """values + validity on the device, padded to ``bucket`` rows
    (valid[n:] is False). String columns carry their sorted dictionary
    (a host pa.Array) and stage their int32 codes."""

    __slots__ = ("values", "valid", "length", "dtype", "dictionary", "_dict_list",
                 "_literal_codes", "luts")

    def __init__(self, values, valid, length: int, dtype: DataType, dictionary=None):
        self.values = values
        self.valid = valid
        self.length = length
        self.dtype = dtype
        self.dictionary = dictionary
        self._dict_list = None
        self._literal_codes: Dict[str, Tuple] = {}
        # dictionary lookup tables of this column's predicates, by env key
        # (string_lut_env): built once per partition, read by every query
        self.luts: Dict[str, object] = {}

    def dict_list(self):
        """Python-list view of the dictionary (cached: literals bisect into
        it)."""
        if self._dict_list is None and self.dictionary is not None:
            self._dict_list = self.dictionary.to_pylist()
        return self._dict_list

    def literal_codes(self, lit: str) -> Tuple:
        """(eq, lt, le) of a string literal against the sorted dictionary, as
        0-d int32 tensors on the column's device, cached with the column:
        eq is the literal's code (-1 when absent), lt its bisect-left and le
        its bisect-right position."""
        import bisect

        got = self._literal_codes.get(lit)
        if got is None:
            uniq = self.dict_list()
            i = bisect.bisect_left(uniq, lit)
            j = bisect.bisect_right(uniq, lit)
            eq = i if i < len(uniq) and uniq[i] == lit else -1
            got = tuple(torch.tensor(x, dtype=torch.int32, device=self.values.device)
                        for x in (eq, i, j))
            self._literal_codes[lit] = got
        return got


def stage_np(s, bucket: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side staging core: (values [bucket, *shape], valid [bucket], n),
    shared by the one-device path and the mesh exchange. A 2-D lane's rows
    come from the values behind every row, null rows' included."""
    dt = s.dtype
    if not is_device_dtype(dt):
        raise ValueError(f"{dt} is not device-representable")
    n = len(s)
    b = bucket or size_bucket(n)
    arr = s.to_arrow()
    if dt.kind in _SHAPED_KINDS:
        from ..series import _static_shape

        shape = tuple(_static_shape(dt))
        size = int(np.prod(shape))
        child = arr.values.slice(arr.offset * size, n * size)
        vals = _narrow_staged(_physical_np(child).reshape((n,) + shape), dt)
        if b > n:
            vals = np.concatenate([vals, np.zeros((b - n,) + shape, vals.dtype)])
    else:
        vals = _narrow_staged(_physical_np(arr), dt)
        if b > n:
            vals = np.concatenate([vals, np.zeros(b - n, dtype=vals.dtype)])
    return vals, _staged_validity(arr, n, b), n


def _staged_validity(arr: pa.Array, n: int, b: int) -> np.ndarray:
    """Validity lane of a staged column, padding lanes False."""
    valid = np.zeros(b, dtype=bool)
    if n:
        valid[:n] = np.asarray(pc.is_valid(arr)) if arr.null_count else True
    return valid


class _HostStaged(ValueError):
    """A column the port declines at staging where the reference's card
    takes it (a uint64 value of 2**63 or more in the 64-bit mode):
    ``stage_table_columns`` turns it into a decline, not a failure."""


def _narrow_staged(vals: np.ndarray, dt: DataType) -> np.ndarray:
    """32-bit mode: int64 and uint64 narrow to int32 only when every value
    fits; otherwise ``DaftStagingError`` (a ValueError) reaches the device
    attempt, which counts it as a breaker failure, as the reference's
    staging does. float64 rounds to float32. 64-bit mode: no narrowing; a
    uint64 column stages as its int64 bits when every value is below 2**63
    (``_HostStaged`` otherwise). uint16 and uint32 widen to their signed
    lanes in both modes. A 2-D lane narrows by its inner type."""
    if dt.kind in (TypeKind.EMBEDDING, TypeKind.FIXED_SHAPE_TENSOR):
        dt = dt.params[0]
    if dt.kind in _UNSIGNED_LANES:
        return vals.astype(_UNSIGNED_LANES[dt.kind][1], copy=False)
    if x64_enabled():
        if vals.dtype == np.uint64:
            if len(vals) and vals.max() >= np.uint64(1 << 63):
                raise _HostStaged(f"{dt} values reach 2**63; host path")
            return vals.view(np.int64)
        return vals
    if dt.kind not in _NARROW_NP:
        return vals
    target = _NARROW_NP[dt.kind]
    if vals.dtype.kind in "iu":
        info = np.iinfo(target)
        if len(vals) and (vals.min() < info.min or vals.max() > info.max):
            raise DaftStagingError(f"{dt} values exceed int32 range; host path")
    return vals.astype(target, copy=False)


def stageable_dtype(dt: DataType) -> bool:
    """Device-stageable: device-representable numerics or strings (which
    stage as dictionary codes)."""
    return is_device_dtype(dt) or dt.is_string()


def _stage_string_series(s, bucket: Optional[int], device) -> DeviceColumn:
    """Stage a string Series as sorted-dictionary codes (code order equals
    the strings' byte order, which is also pyarrow's string ordering)."""
    n = len(s)
    b = bucket or size_bucket(n)
    arr = s.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    uniq = pc.unique(arr.drop_null())
    uniq = uniq.take(pc.sort_indices(uniq))
    codes = pc.index_in(arr, value_set=uniq)  # null where arr is null
    vals = np.asarray(pc.fill_null(codes, 0), dtype=np.int32)
    if b > n:
        vals = np.concatenate([vals, np.zeros(b - n, dtype=np.int32)])
    valid = _staged_validity(arr, n, b)
    return DeviceColumn(torch.from_numpy(vals).to(device),
                        torch.from_numpy(valid).to(device), n, s.dtype,
                        dictionary=uniq)


def stage_series(s, bucket: Optional[int], device) -> DeviceColumn:
    """Stage a host Series onto the device (values + validity, padded)."""
    if s.dtype.is_string():
        return _stage_string_series(s, bucket, device)
    vals, valid, n = stage_np(s, bucket)
    return DeviceColumn(torch.from_numpy(vals).to(device),
                        torch.from_numpy(valid).to(device), n, s.dtype)


def unstage(col: DeviceColumn):
    """Bring a DeviceColumn (tensors or numpy arrays) back to a host Series."""
    from ..series import Series

    vals = _np(col.values)[:col.length]
    valid = _np(col.valid)[:col.length]
    dt = col.dtype
    if col.dictionary is not None:
        uniq = col.dictionary
        if len(uniq) == 0:
            out = pa.nulls(col.length, pa.large_string())
        else:
            codes = np.clip(vals.astype(np.int64), 0, len(uniq) - 1)
            out = uniq.take(pa.array(codes))
            if not valid.all():
                out = pc.if_else(pa.array(valid), out, pa.nulls(col.length, out.type))
        return Series.from_arrow(out, "device", dt)
    if dt.kind in _SHAPED_KINDS:
        from ..series import _static_shape

        size = int(np.prod(_static_shape(dt)))
        value_type = dt.to_arrow().value_type
        flat = vals.reshape(-1)
        if pa.types.is_uint64(value_type) and flat.dtype == np.int64:
            flat = flat.view(np.uint64)
        flat = pa.array(flat)
        if flat.type != value_type:
            flat = flat.cast(value_type)
        out = pa.FixedSizeListArray.from_arrays(flat, size or 1)
        if not valid.all():
            out = pc.if_else(pa.array(valid), out, pa.nulls(col.length, out.type))
        return Series.from_arrow(out, "device", dt)
    storage = dt.to_arrow()
    if pa.types.is_uint64(storage) and vals.dtype == np.int64:
        vals = vals.view(np.uint64)  # the 64-bit mode's uint64 lanes hold the bits
    if dt.kind in _UNSIGNED_LANES and not valid.all():
        vals = np.where(valid, vals, 0)  # a reduction's identity in a null slot
    out = pa.array(vals)
    if out.type != storage:
        if pa.types.is_timestamp(storage) or pa.types.is_duration(storage) \
                or pa.types.is_time64(storage):
            out = (out.cast(pa.int64()).view(storage) if out.type.bit_width == 64
                   else out.cast(storage))
        elif pa.types.is_date32(storage):
            out = out.cast(pa.int32()).view(storage)
        else:
            out = out.cast(storage)
    if not valid.all():
        out = pc.if_else(pa.array(valid), out, pa.nulls(col.length, out.type))
    return Series.from_arrow(out, "device", dt)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Expression -> torch compiler
# ---------------------------------------------------------------------------

def _literal_to_physical(value, dt: DataType):
    """A python literal's device value (a temporal becomes its epoch int)."""
    if dt.is_temporal():
        scalar = pa.scalar(value, type=dt.to_arrow())
        if dt.kind == TypeKind.DATE:
            return int(scalar.cast(pa.int32()).as_py())
        return int(scalar.value)
    return value


def _jdt(dt: DataType) -> torch.dtype:
    """COMPUTE dtype of a logical dtype in the current mode: 64-bit kinds
    narrow to 32 bits in the 32-bit mode; in the 64-bit mode epochs compute
    as int64 and uint64 as its int64 bits."""
    if dt.kind in _NARROW_64:
        if not x64_enabled():
            return _NARROW_64[dt.kind]
        return torch.float64 if dt.kind == TypeKind.FLOAT64 else torch.int64
    if dt.kind in _TORCH_DTYPES:
        return _TORCH_DTYPES[dt.kind]
    if dt.kind in _UNSIGNED_LANES:
        return _UNSIGNED_LANES[dt.kind][0]
    if dt.kind == TypeKind.DATE:
        return torch.int32
    if dt.kind in _EPOCH_KINDS:
        if not x64_enabled():
            raise ValueError(f"{dt} needs 64-bit epochs; host path in the 32-bit mode")
        return torch.int64
    raise ValueError(f"{dt} has no device dtype")


def _wf() -> torch.dtype:
    """Widest float compute dtype of the current mode."""
    return torch.float64 if x64_enabled() else torch.float32


def _literal_fits_device(lit) -> bool:
    """A literal is device-usable if its dtype has a compute dtype and, for
    int literals, the value fits it (int32 where it narrows; int64, which
    also holds the 64-bit mode's uint64 lanes, otherwise)."""
    if lit.value is None or lit.dtype.is_null():
        return True
    if not is_device_dtype(lit.dtype):
        return False
    try:
        jd = _jdt(lit.dtype)
    except ValueError:
        return False
    if isinstance(lit.value, int) and not isinstance(lit.value, bool) \
            and not jd.is_floating_point and jd != torch.bool:
        if lit.dtype.kind in _UNSIGNED_LANES:
            return 0 <= lit.value <= _UNSIGNED_LANES[lit.dtype.kind][2]
        info = torch.iinfo(jd)
        return info.min <= lit.value <= info.max
    return True


_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_CMP_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
_CMP_FNS = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def _plain_string_column(node, schema) -> Optional[str]:
    """Bare string Column (through Aliases): the only string-valued shape the
    device supports (codes decode at unstage against its dictionary)."""
    from ..expressions import Alias, Column

    while isinstance(node, Alias):
        node = node.child
    if isinstance(node, Column) and node.cname in schema \
            and schema[node.cname].dtype.is_string():
        return node.cname
    return None


def _string_cmp_shape(node, schema):
    """(colname, literal_value, flipped) when ``node`` is a comparison
    between a string Column and a string Literal (either side); else None.
    These compile to dictionary-code comparisons with the literal's code
    bounds injected per partition at staging time."""
    from ..expressions import BinaryOp, Literal

    if not (isinstance(node, BinaryOp) and node.op in _CMP_OPS):
        return None

    def lit_str(n):
        return (isinstance(n, Literal)
                and (n.value is None or isinstance(n.value, str))
                and (n.dtype.is_string() or n.dtype.is_null()))

    lcol = _plain_string_column(node.left, schema)
    rcol = _plain_string_column(node.right, schema)
    if lcol is not None and lit_str(node.right):
        return lcol, node.right.value, False
    if rcol is not None and lit_str(node.left):
        return rcol, node.left.value, True
    return None


def expr_is_device_compilable(node, schema, _normalized: bool = False) -> bool:
    """Can this expression tree run fully on the device against ``schema``?"""
    from ..expressions import (Alias, Between, BinaryOp, Cast, Column, FillNull, Function, IfElse,
                               IsIn, IsNull, Literal, Not, normalize_literals)

    if not _normalized:
        try:
            node = normalize_literals(node, schema)
        except (ValueError, KeyError):
            return False
        return expr_is_device_compilable(node, schema, _normalized=True)

    def rec(n):
        return expr_is_device_compilable(n, schema, _normalized=True)

    def any_string_child(n) -> bool:
        # a string child would reach the device as dictionary codes, which
        # only the string-literal comparison shape interprets
        for c in n.children():
            try:
                if c.to_field(schema).dtype.is_string():
                    return True
            except (ValueError, KeyError):
                return True
        return False

    try:
        out_dt = node.to_field(schema).dtype
    except (ValueError, KeyError):
        return False
    if _string_dict_pred_applies(node, schema) is not None:
        # the whole bool subtree evaluates over the dictionary on the host
        return True
    if _int_transform_applies(node, schema) is not None:
        return True  # values from the dictionary on the host, gathered by code
    if not (is_device_dtype(out_dt) or out_dt.is_null()):
        # a string output rides codes: a bare column's, a choice's joint
        # codes, or a transform's ids (each decoded at unstage); any other
        # string-producing compute stays on the host
        if not out_dt.is_string():
            return False
        if _plain_string_column(node, schema) is not None:
            return True
        ch = _string_choice_shape(node, schema)
        if ch is not None:
            return ch.pred is None or rec(ch.pred)
        return _string_dict_value_shape(node, schema) is not None
    if isinstance(node, Column):
        return stageable_dtype(schema[node.cname].dtype)
    if isinstance(node, Literal):
        return _literal_fits_device(node)
    if isinstance(node, (Alias, Not, IsNull)):
        return all(rec(c) for c in node.children())
    if isinstance(node, Cast):
        if _temporal_recast(node, schema):
            return False
        return (not any_string_child(node) and is_device_dtype(node.dtype)
                and rec(node.child))
    if isinstance(node, BinaryOp):
        if _string_cmp_shape(node, schema) is not None:
            return True
        cc = _string_colcol_shape(node, schema)
        if cc is not None:
            # a joint-dictionary compare; a choice side's predicate must compile
            return all(s[0] != "choice" or s[1].pred is None or rec(s[1].pred) for s in cc)
        if (_epoch_cmp_shape(node, schema) is not None
                or _transform_cmp_shape(node, schema) is not None):
            return True
        return not any_string_child(node) and all(rec(c) for c in node.children())
    if isinstance(node, (FillNull, IfElse, Between)):
        return not any_string_child(node) and all(rec(c) for c in node.children())
    if isinstance(node, Function):
        if _string_lut_shape(node, schema) is not None:
            return True
        # numeric.log with a base is the host's alone (the card's is ln)
        return (node.fname in _DEVICE_FNS and node.kwargs.get("base") is None
                and all(rec(c) for c in node.children()))
    if isinstance(node, IsIn):
        if _string_lut_shape(node, schema) is not None:
            return True
        return _numeric_isin_items(node, schema) is not None and rec(node.child)
    return False


def _temporal_recast(node, schema) -> bool:
    """A cast between two different temporal types (date to timestamp, one
    timestamp unit to another, ...): the host rescales the epoch, a lane
    cast would only reinterpret it, so it stays on the host. It arises in
    the 64-bit mode, where epochs are device types; the reference's card
    reinterprets (a date cast to timestamp[us] gives microseconds after
    1970), and the port declines instead."""
    try:
        src = node.child.to_field(schema).dtype
    except (ValueError, KeyError):
        return False
    return src.is_temporal() and node.dtype.is_temporal() and src != node.dtype


# the numeric functions the card evaluates (a float function computes in
# the widest float of the mode)
_DEVICE_FNS = {
    "numeric.abs": torch.abs,
    "numeric.negate": torch.neg,
    "numeric.ceil": torch.ceil,
    "numeric.floor": torch.floor,
    "numeric.sign": torch.sign,
    "numeric.sqrt": lambda v: torch.sqrt(v.to(_wf())),
    "numeric.exp": lambda v: torch.exp(v.to(_wf())),
    "numeric.log": lambda v: torch.log(v.to(_wf())),
    "numeric.log2": lambda v: torch.log2(v.to(_wf())),
    "numeric.log10": lambda v: torch.log10(v.to(_wf())),
    "numeric.log1p": lambda v: torch.log1p(v.to(_wf())),
    "numeric.sin": lambda v: torch.sin(v.to(_wf())),
    "numeric.cos": lambda v: torch.cos(v.to(_wf())),
    "numeric.tan": lambda v: torch.tan(v.to(_wf())),
    "float.is_nan": torch.isnan,
    "float.is_inf": torch.isinf,
    "float.not_nan": lambda v: ~torch.isnan(v),
}


def _env_column(env):
    """The first COLUMN entry of an env (it also carries the 0-d code
    bounds of string literals, which have no row dimension)."""
    for v in env.values():
        if isinstance(v, tuple):
            return v[0]
    raise AssertionError("projection env has no column entries")


def _env_nrows(env) -> int:
    return _env_column(env).shape[0]


def _env_device(env):
    return _env_column(env).device


def _strlit_keys(colname: str, lit: str) -> Tuple[str, str, str]:
    """Env keys of a (column, literal) pair's code bounds: eq code (-1 when
    absent), bisect-left position, bisect-right position."""
    base = f"__strlit__\x00{colname}\x00{lit}"
    return base + "\x00eq", base + "\x00lt", base + "\x00le"


def collect_string_cmp_literals(nodes, schema):
    """Every (colname, literal) string comparison in the (normalized) trees;
    a null literal needs no bounds."""
    from ..expressions import BinaryOp

    out = []

    def walk(n):
        if isinstance(n, BinaryOp):
            shape = _string_cmp_shape(n, schema)
            if shape is not None and shape[1] is not None:
                out.append((shape[0], shape[1]))
        for c in n.children():
            walk(c)

    for nd in nodes:
        walk(nd)
    return out


def string_literal_env(nodes, schema, dcs, env) -> Optional[dict]:
    """Merge the per-partition code bounds of every string-literal
    comparison into ``env`` ({key: 0-d int32 tensor}). The compiled closure
    is shared across partitions: the literal's code varies, the program
    does not. Returns the (possibly unchanged) env, or None when a needed
    dictionary is missing (the caller declines to the host)."""
    add: Dict[str, torch.Tensor] = {}
    for colname, lit in collect_string_cmp_literals(nodes, schema):
        keq, klt, kle = _strlit_keys(colname, lit)
        if keq in add:
            continue
        dc = dcs.get(colname)
        if dc is None or dc.dictionary is None:
            return None
        add[keq], add[klt], add[kle] = dc.literal_codes(lit)
    if not add:
        return env
    merged = dict(env)
    merged.update(add)
    return merged


# ---------------------------------------------------------------------------
# Dictionary lanes: predicates over ONE string column evaluate on the host
# over the partition's sorted dictionary (O(unique) work, through the
# registered host kernels, so the answer equals the host path's by
# construction); the card gathers the result by dictionary code (O(rows)).
# ---------------------------------------------------------------------------

_CMP_OPS_NULLSAFE = _CMP_OPS + ("<=>",)


def _peel_alias(node):
    from ..expressions import Alias

    while isinstance(node, Alias):
        node = node.child
    return node


# ---------------------------------------------------------------------------
# Epoch lanes: timestamp, duration and time values cannot narrow to int32,
# but they compare and sort exactly as (hi, lo) halves of their
# order-preserving 64-bit pattern. Each half is biased by 2**31 into an
# int32 lane (torch on the CPU has no uint32 compares), so a signed compare
# of the lanes is the reference's unsigned compare of its uint32 lanes.
# ---------------------------------------------------------------------------

_BIAS32 = 1 << 31


def _plain_epoch_column(node, schema) -> Optional[str]:
    """Bare timestamp, duration or time Column (through Aliases)."""
    from ..expressions import Column

    node = _peel_alias(node)
    if isinstance(node, Column) and node.cname in schema \
            and schema[node.cname].dtype.kind in _EPOCH_KINDS:
        return node.cname
    return None


def _epoch_lane_side(node, schema):
    """(ident, dtype, side_node or None) when ``node`` is an epoch-typed
    expression that rides lanes: a plain column (ident = its name, shared
    with the column-lane cache; side_node None), or any computed epoch
    expression (timestamp arithmetic), evaluated once on the host in exact
    int64 (ident = the expression's key)."""
    cname = _plain_epoch_column(node, schema)
    if cname is not None:
        return cname, schema[cname].dtype, None
    try:
        dt = node.to_field(schema).dtype
    except (ValueError, KeyError):
        return None
    if dt.kind not in _EPOCH_KINDS:
        return None
    return f"\x00epochexpr\x00{node._key()}", dt, node


def _epoch_cmp_shape(node, schema):
    """(lspec, rspec, op) when ``node`` is a comparison whose sides are epoch
    lane sides and/or literals, at least one a lane side: in the 32-bit mode
    it compiles as a two-lane compare over split epoch bits. Each spec is
    ("lane", ident, dtype, side_node or None) or ("lit", literal node). Lane
    against lane needs identical dtypes (kind, unit, time zone): the raw
    int64 epochs of different units do not compare. None in the 64-bit
    mode, where epochs stage as int64 and the generic closures compare
    them."""
    from ..expressions import BinaryOp, Literal

    if x64_enabled() or not (isinstance(node, BinaryOp) and node.op in _CMP_OPS):
        return None

    def spec(n):
        if isinstance(n, Literal):
            return ("lit", n)
        side = _epoch_lane_side(n, schema)
        return None if side is None else ("lane", *side)

    ls, rs = spec(node.left), spec(node.right)
    if ls is None or rs is None or (ls[0] == "lit" and rs[0] == "lit"):
        return None
    if ls[0] == "lane" and rs[0] == "lane" and ls[2] != rs[2]:
        return None
    return ls, rs, node.op


def _epoch_lane_keys(ident: str) -> Tuple[str, str]:
    return f"__epochlane__\x00{ident}\x00hi", f"__epochlane__\x00{ident}\x00lo"


def _epoch_lit_keys(ident: str, node_key) -> Tuple[str, str]:
    base = f"__epochlit__\x00{ident}\x00{node_key}"
    return base + "\x00hi", base + "\x00lo"


def _two_lane_cmp(op: str, hi, lo, rhi, rlo):
    """Elementwise compare of (hi, lo) lane pairs: lexicographic over the
    biased halves, which is the unsigned order of the epoch bits."""
    eq_hi = hi == rhi
    if op == "==":
        return eq_hi & (lo == rlo)
    if op == "!=":
        return ~(eq_hi & (lo == rlo))
    if op == "<":
        return (hi < rhi) | (eq_hi & (lo < rlo))
    if op == "<=":
        return (hi < rhi) | (eq_hi & (lo <= rlo))
    if op == ">":
        return (hi > rhi) | (eq_hi & (lo > rlo))
    return (hi > rhi) | (eq_hi & (lo >= rlo))  # ">="


def _epoch_bits_np(vals_i64: np.ndarray) -> np.ndarray:
    """Order-preserving uint64 view of int64 epochs (the sign bit flipped)."""
    return vals_i64.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)


def _biased_halves(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) int32 halves of uint64 bits, each biased by 2**31."""
    hi = ((bits >> np.uint64(32)).astype(np.int64) - _BIAS32).astype(np.int32)
    lo = ((bits & np.uint64(_U32)).astype(np.int64) - _BIAS32).astype(np.int32)
    return hi, lo


def _eval_lane_series(table, node):
    """Host evaluation of a lane-staged key expression -> Series (broadcast
    to the table's length), or None when it fails or gives python storage
    (the caller declines to the host)."""
    from ..expressions import Column

    try:
        if isinstance(node, Column):
            s = table.get_column(node.cname)
        else:
            from ..table import _broadcast_series

            s = _broadcast_series(node.evaluate(table), len(table))
    except Exception:
        return None
    return None if s.is_python() else s


def _epoch_lanes_of_series(s, bucket: int, device):
    n = len(s)
    arr = s.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    bits = _epoch_bits_np(_physical_np(arr).astype(np.int64))
    if bucket > n:
        bits = np.concatenate([bits, np.zeros(bucket - n, dtype=np.uint64)])
    hi, lo = _biased_halves(bits)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
            torch.from_numpy(_staged_validity(arr, n, bucket)).to(device))


def _stage_epoch_lanes(table, cname: str, bucket: int, stage_cache: Optional[dict], device):
    """(hi, lo, valid) lanes of an epoch column, cached with the partition."""
    key = ("__epochlanes__", cname, bucket, str(device))
    cached = stage_cache.get(key) if stage_cache is not None else None
    if cached is None:
        cached = _epoch_lanes_of_series(table.get_column(cname), bucket, device)
        if stage_cache is not None:
            stage_cache[key] = cached
    return cached


def _stage_epoch_expr_lanes(table, node, bucket: int, stage_cache: Optional[dict], device):
    """Lanes of any epoch-typed expression: a plain (aliased) column shares
    the column's cache entry; a computed one is evaluated once on the host
    in exact int64 and cached under its key. None to decline."""
    from ..expressions import Column

    node = _peel_alias(node)
    if isinstance(node, Column):
        return _stage_epoch_lanes(table, node.cname, bucket, stage_cache, device)
    key = ("__epochlanes__", node._key(), bucket, str(device))
    cached = stage_cache.get(key) if stage_cache is not None else None
    if cached is None:
        s = _eval_lane_series(table, node)
        if s is None:
            return None
        cached = _epoch_lanes_of_series(s, bucket, device)
        if stage_cache is not None:
            stage_cache[key] = cached
    return cached


def collect_epoch_cmps(nodes, schema):
    """Every epoch-comparison shape in the trees -> [(lspec, rspec, op)];
    a matched compare's subtree is not walked further."""
    from ..expressions import BinaryOp

    out = []

    def walk(n):
        if isinstance(n, BinaryOp):
            shape = _epoch_cmp_shape(n, schema)
            if shape is not None:
                out.append(shape)
                return
        for c in n.children():
            walk(c)

    for nd in nodes:
        walk(nd)
    return out



def epoch_cmp_env(cmps, schema, table, bucket: int, stage_cache: Optional[dict], env: dict,
                  device) -> Optional[dict]:
    """Merge each epoch compare's lanes into ``env``: every lane side's
    (hi, valid) and (lo, valid) pairs, and each literal's biased halves as
    0-d int32 tensors keyed against its lane side. ``cmps`` comes from one
    ``collect_epoch_cmps`` walk. Returns the (possibly unchanged) env, or
    None when a literal does not convert or a computed side fails on the
    host (the caller declines)."""
    if not cmps:
        return env
    merged = dict(env)
    for lspec, rspec, _op in cmps:
        lane_specs = [s for s in (lspec, rspec) if s[0] == "lane"]
        for _tag, ident, _dt, side_node in lane_specs:
            hi_k, lo_k = _epoch_lane_keys(ident)
            if hi_k in merged:
                continue
            if side_node is None:
                lanes = _stage_epoch_lanes(table, ident, bucket, stage_cache, device)
            else:
                lanes = _stage_epoch_expr_lanes(table, side_node, bucket, stage_cache, device)
            if lanes is None:
                return None
            hi, lo, valid = lanes
            merged[hi_k] = (hi, valid)
            merged[lo_k] = (lo, valid)
        lit = lspec[1] if lspec[0] == "lit" else (rspec[1] if rspec[0] == "lit" else None)
        if lit is None:
            continue
        _tag, ident, lane_dt, _sn = lane_specs[0]
        lhik, llok = _epoch_lit_keys(ident, lit._key())
        if lhik in merged or lit.value is None:
            continue
        ckey = ("__epochlit__", lhik, str(device))
        halves = stage_cache.get(ckey) if stage_cache is not None else None
        if halves is None:
            try:
                epoch = int(pa.scalar(lit.value, type=lane_dt.to_arrow()).value)
            except (ValueError, TypeError, KeyError, pa.ArrowInvalid, pa.ArrowTypeError):
                return None
            hi, lo = _biased_halves(_epoch_bits_np(np.array([epoch])))
            halves = (torch.tensor(int(hi[0]), dtype=torch.int32, device=device),
                      torch.tensor(int(lo[0]), dtype=torch.int32, device=device))
            if stage_cache is not None:
                stage_cache[ckey] = halves
        merged[lhik], merged[llok] = halves
    return merged


# ---------------------------------------------------------------------------
# Joint-dictionary string groups: column-to-column compares and string
# if_else / fill_null. Per-column dictionary codes do not compare across
# columns, so every interacting group of string columns (and literals)
# merges into ONE sorted joint dictionary at staging time; each column gets
# a small remap into the joint code space in the env, and the closures
# compare or select joint codes. Sorted joint codes are order-isomorphic to
# the strings, so inequalities hold too.
# ---------------------------------------------------------------------------

class _StringChoice:
    """Shape of a string-valued FillNull/IfElse over plain string columns and
    string literals: ``operands`` is [("col", name) | ("lit", value) |
    ("null", None)] in positional order, (child, fill) or (if_true,
    if_false); ``pred`` is the IfElse predicate (None for FillNull)."""

    __slots__ = ("kind", "pred", "operands", "cols", "lits")

    def __init__(self, kind, pred, operands):
        self.kind = kind
        self.pred = pred
        self.operands = operands
        self.cols = tuple(sorted({v for k, v in operands if k == "col"}))
        self.lits = tuple(sorted({v for k, v in operands if k == "lit"}))


def _string_choice_shape(node, schema):
    """_StringChoice for a string-valued fill_null/if_else whose values are
    plain string columns and string or null literals; else None."""
    from ..expressions import FillNull, IfElse, Literal

    node = _peel_alias(node)
    if isinstance(node, FillNull):
        kind, pred, vals = "fill_null", None, (node.child, node.fill)
    elif isinstance(node, IfElse):
        kind, pred, vals = "if_else", node.pred, (node.if_true, node.if_false)
    else:
        return None
    try:
        if not node.to_field(schema).dtype.is_string():
            return None
    except (ValueError, KeyError):
        return None
    operands = []
    for v in vals:
        c = _plain_string_column(v, schema)
        if c is not None:
            operands.append(("col", c))
        elif isinstance(v, Literal) and v.value is None:
            operands.append(("null", None))
        elif (isinstance(v, Literal) and isinstance(v.value, str)
              and (v.dtype.is_string() or v.dtype.is_null())):
            operands.append(("lit", v.value))
        else:
            return None
    return _StringChoice(kind, pred, operands)


def _string_cmp_side(node, schema):
    """One side of a general string compare: ("col", name), ("choice",
    _StringChoice), ("lit", value) or ("null", None); else None."""
    from ..expressions import Literal

    c = _plain_string_column(node, schema)
    if c is not None:
        return ("col", c)
    ch = _string_choice_shape(node, schema)
    if ch is not None:
        return ("choice", ch)
    if isinstance(node, Literal):
        if node.value is None:
            return ("null", None)
        if isinstance(node.value, str) and (node.dtype.is_string() or node.dtype.is_null()):
            return ("lit", node.value)
    return None


def _side_group(side):
    """(cols, lits) a compare side contributes to the joint group."""
    kind, v = side
    if kind == "col":
        return (v,), ()
    if kind == "choice":
        return v.cols, v.lits
    if kind == "lit":
        return (), (v,)
    return (), ()


def _string_colcol_shape(node, schema):
    """(lside, rside) when ``node`` is a string compare whose sides are plain
    columns, string choices or literals, at least one not a literal (a
    column against a literal takes the cheaper code-bound lane, tried
    first)."""
    from ..expressions import BinaryOp

    if not (isinstance(node, BinaryOp) and node.op in _CMP_OPS_NULLSAFE):
        return None
    try:
        ldt = node.left.to_field(schema).dtype
        rdt = node.right.to_field(schema).dtype
    except (ValueError, KeyError):
        return None
    if not ((ldt.is_string() or ldt.is_null()) and (rdt.is_string() or rdt.is_null())):
        return None
    lside = _string_cmp_side(node.left, schema)
    rside = _string_cmp_side(node.right, schema)
    if lside is None or rside is None:
        return None
    if lside[0] in ("lit", "null") and rside[0] in ("lit", "null"):
        return None
    return lside, rside


def _cmp_union_group(lside, rside):
    """A general compare's joint group, the union of both sides. Group
    registration and closure compilation both call this, so their env keys
    agree."""
    lc, ll = _side_group(lside)
    rc, rl = _side_group(rside)
    return tuple(sorted(set(lc) | set(rc))), tuple(sorted(set(ll) | set(rl)))


def _joint_group_of(node, schema):
    """(cols, lits) joint-dictionary group of a node, or None. A compare's
    group unions both sides (a choice side's codes must compare with the
    other side's), except where the code-bound lane claims the node."""
    if _string_cmp_shape(node, schema) is None:
        cc = _string_colcol_shape(node, schema)
        if cc is not None:
            return _cmp_union_group(*cc)
    ch = _string_choice_shape(node, schema)
    if ch is not None:
        return ch.cols, ch.lits
    return None


def joint_remap(dictionary, joint, device) -> torch.Tensor:
    """Remap taking one dictionary's codes into a sorted joint dictionary's
    code space, an int32 tensor padded to a size bucket. Shared by the
    in-table string groups and the join's cross-table recoding."""
    if len(dictionary) == 0:
        arr = np.zeros(1, dtype=np.int32)  # an all-null side: every code is masked
    else:
        arr = np.asarray(pc.index_in(dictionary.cast(pa.large_string()), value_set=joint),
                         dtype=np.int32)
    b = size_bucket(len(arr))
    if b > len(arr):
        arr = np.concatenate([arr, np.zeros(b - len(arr), np.int32)])
    return torch.from_numpy(arr).to(device)


def _joint_gkey(cols, lits) -> str:
    # a separator before each literal: no literals and the literal "" differ
    return "\x1f".join(cols) + "\x1e" + "".join("\x1f" + lit for lit in lits)


def _joint_map_key(gkey: str, col: str) -> str:
    return f"__joint__\x00{gkey}\x00map\x00{col}"


def _joint_lit_key(gkey: str, lit: str) -> str:
    return f"__joint__\x00{gkey}\x00lit\x00{lit}"


def _joint_operand_fn(kind, val, gkey):
    """env -> (joint codes, valid) of a column, literal or null operand of a
    joint-dictionary group."""
    if kind == "col":
        mk = _joint_map_key(gkey, val)

        def get(env, _c=val, _mk=mk):
            codes, m = env[_c]
            return env[_mk].index_select(0, codes), m
    elif kind == "lit":
        lk = _joint_lit_key(gkey, val)

        def get(env, _lk=lk):
            n, dev = _env_nrows(env), _env_device(env)
            return (env[_lk].expand(n).clone(), torch.ones(n, dtype=torch.bool, device=dev))
    else:  # a null literal

        def get(env):
            n, dev = _env_nrows(env), _env_device(env)
            return (torch.zeros(n, dtype=torch.int32, device=dev),
                    torch.zeros(n, dtype=torch.bool, device=dev))
    return get


def _choice_code_fn(ch, gkey, schema):
    """env -> (joint codes, valid) of a string fill_null/if_else, in the group
    keyed by ``gkey``: the node's own group as a projected value, the
    enclosing compare's larger group as a compare side."""
    a = _joint_operand_fn(*ch.operands[0], gkey)
    b = _joint_operand_fn(*ch.operands[1], gkey)
    if ch.kind == "fill_null":
        def run(env, _a=a, _b=b):
            av, am = _a(env)
            bv, bm = _b(env)
            return torch.where(am, av, bv), am | bm

        return run
    p, _pdt = _compile_node(ch.pred, schema)

    def run(env, _p=p, _a=a, _b=b):
        pv, pm = _p(env)
        pv = pv.to(torch.bool)  # a null-literal predicate comes as int32 zeros
        av, am = _a(env)
        bv, bm = _b(env)
        return torch.where(pv, av, bv), pm & torch.where(pv, am, bm)

    return run


def _side_code_fn(side, gkey, schema):
    """env -> (joint codes, valid) of one side of a general string compare."""
    kind, v = side
    if kind == "choice":
        return _choice_code_fn(v, gkey, schema)
    return _joint_operand_fn(kind, v, gkey)


def _shape_choice_preds(node, schema):
    """The choice predicates under a matched joint shape: the only subtrees
    below it that may hold further string shapes."""
    ch = _string_choice_shape(node, schema)
    if ch is not None:
        return [ch.pred] if ch.pred is not None else []
    cc = _string_colcol_shape(node, schema)
    preds = []
    if cc is not None:
        for kind, v in cc:
            if kind == "choice" and v.pred is not None:
                preds.append(v.pred)
    return preds


def collect_joint_groups(nodes, schema):
    """Every joint-dictionary group in the trees. A matched shape's string
    sides are not walked again (a choice under a compare emits codes in the
    compare's group); only choice predicates are."""
    out = []

    def walk(n):
        g = _joint_group_of(n, schema)
        if g is not None:
            out.append(g)
            for p in _shape_choice_preds(n, schema):
                walk(p)
            return
        for c in n.children():
            walk(c)

    for nd in nodes:
        walk(nd)
    return out


def string_joint_env(nodes, schema, dcs, env, aux: dict, device) -> Optional[dict]:
    """Merge each joint group's remaps (int32 tensors) and literal codes
    (0-d int32 tensors) into ``env``, and record the group's joint
    dictionary in ``aux[gkey]`` for the decode of string outputs. Returns
    the env, or None when a needed dictionary is missing (the caller
    declines)."""
    groups = collect_joint_groups(nodes, schema)
    if not groups:
        return env
    merged = dict(env)
    for cols, lits in sorted(set(groups)):
        gkey = _joint_gkey(cols, lits)
        if gkey in aux:
            continue
        parts = []
        for c in cols:
            dc = dcs.get(c)
            if dc is None or dc.dictionary is None:
                return None
            parts.append(dc.dictionary.cast(pa.large_string()))
        if lits:
            parts.append(pa.array(list(lits), pa.large_string()))
        joint = pc.unique(pa.concat_arrays(parts))
        joint = joint.take(pc.sort_indices(joint))
        for c in cols:
            merged[_joint_map_key(gkey, c)] = joint_remap(dcs[c].dictionary, joint, device)
        for lit in lits:
            code = pc.index(joint, pa.scalar(lit, pa.large_string())).as_py()
            merged[_joint_lit_key(gkey, lit)] = torch.tensor(code, dtype=torch.int32,
                                                             device=device)
        aux[gkey] = joint
    return merged


# predicates a lookup table over the dictionary evaluates through the
# registered host kernel (regex-backed like/ilike/match included)
_STR_PRED_FNS = ("utf8.contains", "utf8.startswith", "utf8.endswith",
                 "utf8.like", "utf8.ilike", "utf8.match")


def _string_lut_shape(node, schema):
    """(colname, kind, payload, node_key) for a predicate of one plain
    string column evaluable over its dictionary: contains / startswith /
    endswith / like / ilike / match with a literal pattern, and is_in over
    string literals. Else None."""
    from ..expressions import Function, IsIn, Literal

    if isinstance(node, Function) and node.fname in _STR_PRED_FNS:
        if len(node.args) != 2 or node.kwargs:
            return None
        colname = _plain_string_column(node.args[0], schema)
        pat = node.args[1]
        if colname is None or not isinstance(pat, Literal) or not isinstance(pat.value, str):
            return None
        return colname, node.fname, pat.value, node._key()
    if isinstance(node, IsIn):
        colname = _plain_string_column(node.child, schema)
        items = node.items
        if (colname is None or not isinstance(items, Literal)
                or not isinstance(items.value, (list, tuple))):
            return None
        vals = [v for v in items.value if v is not None]
        if not all(isinstance(v, str) for v in vals):
            return None
        return colname, "is_in", tuple(vals), node._key()
    return None


def _strlut_env_key(node_key) -> str:
    return f"__strlut__\x00{node_key}"


# row-local string functions: a predicate built from these over ONE string
# column depends only on that row's value, so it can evaluate over the
# dictionary instead of the rows
_ROWLOCAL_STR_FNS = frozenset(
    f"utf8.{n}" for n in (
        "capitalize", "concat", "contains", "count_matches", "endswith",
        "extract", "find", "ilike", "left", "length", "length_bytes",
        "like", "lower", "lpad", "lstrip", "match", "normalize", "repeat",
        "replace", "reverse", "right", "rpad", "rstrip", "startswith",
        "substr", "upper",
    ))


def _string_dict_pred_shape(node, schema):
    """(colname, node, node_key) when ``node`` is a bool-valued, row-local
    expression whose only column input is one plain string column (for
    example ``upper(s) == "X"`` or ``s.str.left(2).is_in([...])``): the host
    evaluates the whole predicate over the dictionary plus one null slot,
    and the card gathers by code."""
    try:
        if not node.to_field(schema).dtype.is_boolean():
            return None
    except (ValueError, KeyError):
        return None
    colname = _single_string_col_rowlocal(node, schema)
    if colname is None:
        return None
    return colname, node, node._key()


def _single_string_col_rowlocal(node, schema) -> Optional[str]:
    """The one plain string column ``node`` row-locally depends on (every
    operation per row: the row-local utf8 functions, comparisons, choices,
    casts), or None."""
    from ..expressions import (Alias, Between, BinaryOp, Cast, Column, FillNull, Function,
                               IfElse, IsIn, IsNull, Literal, Not)

    cols: set = set()

    def rowlocal(n):
        if isinstance(n, (Literal, Column)):
            if isinstance(n, Column):
                cols.add(n.cname)
            return True
        if isinstance(n, (Alias, Not, IsNull, Cast, Between, FillNull, IfElse, BinaryOp)):
            return all(rowlocal(c) for c in n.children())
        if isinstance(n, IsIn):
            return isinstance(n.items, Literal) and rowlocal(n.child)
        if isinstance(n, Function):
            # kwargs are static configuration (regex=, index=), never columns
            return n.fname in _ROWLOCAL_STR_FNS and all(rowlocal(c) for c in n.args)
        return False

    if not rowlocal(node) or len(cols) != 1:
        return None
    colname = next(iter(cols))
    try:
        return colname if schema[colname].dtype.is_string() else None
    except KeyError:
        return None


def _strdictpred_env_keys(node_key) -> Tuple[str, str, str]:
    base = f"__strdictpred__\x00{node_key}"
    return base + "\x00vals", base + "\x00valid", base + "\x00nullslot"


def _numeric_isin_items(node, schema):
    """The static device values of a numeric, date or bool ``is_in``'s items,
    or None when it is ineligible: a NaN item (arrow's is_in matches NaN,
    an equality compare cannot), a float item against an integer column
    (the host compares in float64, the 32-bit lanes cannot; declined in
    both modes, as the reference does), or in the 32-bit mode an integer
    item outside int32."""
    import math

    from ..expressions import IsIn, Literal

    if not isinstance(node, IsIn):
        return None
    items = node.items
    if not isinstance(items, Literal) or not isinstance(items.value, (list, tuple)):
        return None
    try:
        child_dt = node.child.to_field(schema).dtype
    except (ValueError, KeyError):
        return None
    if not (child_dt.is_numeric() or child_dt.kind in (TypeKind.DATE, TypeKind.BOOL)):
        return None
    int_child = not child_dt.is_floating()
    out = []
    for v in items.value:
        if v is None:
            continue  # a null item never matches
        if isinstance(v, float):
            if math.isnan(v) or int_child:
                return None
        try:
            out.append(_literal_to_physical(v, child_dt))
        except (ValueError, TypeError, pa.ArrowInvalid):
            return None
    if not x64_enabled() and any(isinstance(v, int) and not (_INT32_LO <= v <= _INT32_HI)
                                 for v in out):
        return None
    return tuple(out)


def _string_dict_pred_applies(node, schema):
    """The general dictionary predicate, only where no cheaper shape claims
    the node. The precedence equals ``_compile_node``'s dispatch order, or
    the env builder and the closure would disagree about which lane owns a
    node. Boolean connectives and pass-throughs are left out: each side
    below them gets its own best shape."""
    from ..expressions import Alias, BinaryOp, Column, IsNull, Literal, Not

    if isinstance(node, (Alias, Column, Literal, Not)):
        return None
    if isinstance(node, IsNull) and _plain_string_column(node.child, schema) is not None:
        return None  # a validity lane on the card already
    if isinstance(node, BinaryOp):
        if node.op in ("&", "|", "^"):
            return None
        if (_string_cmp_shape(node, schema) is not None
                or _string_colcol_shape(node, schema) is not None
                or _epoch_cmp_shape(node, schema) is not None):
            return None
    if _string_lut_shape(node, schema) is not None:
        return None
    return _string_dict_pred_shape(node, schema)


def collect_string_luts(nodes, schema):
    """Every dictionary-lane shape in the trees: the single-function lookup
    tables, and the general predicates (tagged "hostpred"), whose subtrees
    evaluate over the dictionary and are not walked further."""
    out = []

    def walk(n):
        shape = _string_lut_shape(n, schema)
        if shape is not None:
            out.append(shape)
        else:
            gshape = _string_dict_pred_applies(n, schema)
            if gshape is not None:
                out.append((gshape[0], "hostpred", gshape[1], gshape[2]))
                return
        for c in n.children():
            walk(c)

    for nd in nodes:
        walk(nd)
    return out


def _eval_over_dictionary(colname: str, node, uniq):
    """``node`` evaluated on the host over the dictionary values plus one
    null slot (index len(uniq)): an arrow array of len(uniq) + 1, or None
    when the host evaluation raises (the caller declines to the host)."""
    from ..table import Table

    try:
        with_null = pa.concat_arrays([uniq, pa.array([None], type=uniq.type)])
        got = node.evaluate(Table.from_arrow(pa.table({colname: with_null})))
        arr = got.to_arrow()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if len(arr) == 1 and len(with_null) > 1:  # a scalar result broadcasts
            arr = pa.concat_arrays([arr] * len(with_null))
        return arr
    except Exception:
        return None


def _padded_bool(arr: np.ndarray, n: int, device) -> torch.Tensor:
    b = size_bucket(max(n, 1))
    if b > len(arr):
        arr = np.concatenate([arr, np.zeros(b - len(arr), dtype=bool)])
    return torch.from_numpy(arr).to(device)


def _dict_pred_tables(dc: "DeviceColumn", colname: str, node, node_key):
    """(values, valid, null slot) of a general dictionary predicate over
    ``dc``'s dictionary, cached with the column; None to decline."""
    vals_k = _strdictpred_env_keys(node_key)[0]
    got = dc.luts.get(vals_k)
    if got is None:
        uniq = dc.dictionary
        arr = _eval_over_dictionary(colname, node, uniq)
        if arr is None:
            return None
        dev = dc.values.device
        vals_np = np.asarray(pc.fill_null(arr, False), dtype=bool)
        valid_np = np.asarray(pc.is_valid(arr), dtype=bool)
        got = (_padded_bool(vals_np, len(uniq) + 1, dev), _padded_bool(valid_np, len(uniq) + 1, dev),
               torch.tensor(len(uniq), dtype=torch.int32, device=dev))
        dc.luts[vals_k] = got
    return got


def _lut_table(dc: "DeviceColumn", kind: str, payload, key: str):
    """The lookup table of one single-function predicate over ``dc``'s
    dictionary, through the registered host kernel, cached with the column."""
    got = dc.luts.get(key)
    if got is None:
        uniq = dc.dictionary
        if kind == "is_in":
            lut = pc.is_in(uniq, value_set=pa.array(list(payload), type=uniq.type))
        else:
            from ..functions import get_function
            from ..series import Series

            lut = get_function(kind).evaluate(
                Series.from_arrow(uniq, "u"),
                Series.from_pylist([payload], "p", DataType.string())).to_arrow()
        got = _padded_bool(np.asarray(pc.fill_null(lut, False), dtype=bool), len(uniq),
                           dc.values.device)
        dc.luts[key] = got
    return got


def string_lut_env(nodes, schema, dcs, env) -> Optional[dict]:
    """Merge the per-partition dictionary lookup tables of every dictionary
    lane in the trees into ``env``: a bool tensor on the partition's device,
    padded to ``size_bucket`` of the dictionary's length (plus the null slot
    and its index for a general predicate). One compiled program serves
    every partition, whose dictionaries differ. Returns the (possibly
    unchanged) env, or None when a dictionary is missing or the host
    evaluation over it fails (the caller declines to the host)."""
    shapes = collect_string_luts(nodes, schema)
    if not shapes:
        return env
    merged = dict(env)
    for colname, kind, payload, node_key in shapes:
        dc = dcs.get(colname)
        if dc is None or dc.dictionary is None:
            return None
        if kind == "hostpred":
            keys = _strdictpred_env_keys(node_key)
            if keys[0] not in merged:
                got = _dict_pred_tables(dc, colname, payload, node_key)
                if got is None:
                    return None
                merged.update(zip(keys, got))
            continue
        key = _strlut_env_key(node_key)
        if key not in merged:
            merged[key] = _lut_table(dc, kind, payload, key)
    return merged


# ---------------------------------------------------------------------------
# Transform lanes: a row-local transform of ONE string column used as a
# value. Equal source strings give equal results, so the host evaluates the
# transform over the dictionary plus a null slot and the card gathers by
# code: sorted-order ids for a string-valued transform (decoded through the
# transformed dictionary), the values themselves for an int-valued one.
# ---------------------------------------------------------------------------

def _string_dict_value_shape(node, schema):
    """(colname, node, node_key) when ``node`` is a row-local computed
    expression of one plain string column used as a value (group, distinct
    or sort key, projected value): ``upper(s)``, ``s.str.left(2)``, fill_null
    chains. A plain column is left to its own dictionary codes."""
    if _plain_string_column(node, schema) is not None:
        return None
    colname = _single_string_col_rowlocal(node, schema)
    if colname is None:
        return None
    return colname, node, node._key()


def _string_value_applies(node, schema):
    """The transformed-string value shape where a node is claimed: string
    valued, not a plain column (its codes) and not a choice over plain
    columns and literals (the joint-dictionary lane), in _compile_node's
    order."""
    try:
        if not node.to_field(schema).dtype.is_string():
            return None
    except (ValueError, KeyError):
        return None
    if _string_choice_shape(node, schema) is not None:
        return None
    return _string_dict_value_shape(node, schema)


def _int_transform_applies(node, schema):
    """(colname, node, node_key) when ``node`` is an integer-valued Function
    that is a row-local expression of one string column (``length(s)``,
    ``find(s, p)``, ``count_matches``): its values gather by source code.
    Integer arithmetic above it compiles through the generic closures."""
    from ..expressions import Function

    if not isinstance(node, Function):
        return None
    try:
        if not node.to_field(schema).dtype.is_integer():
            return None
    except (ValueError, KeyError):
        return None
    colname = _single_string_col_rowlocal(node, schema)
    if colname is None:
        return None
    return colname, node, node._key()


def _inttrans_env_keys(node_key) -> Tuple[str, str]:
    base = f"__inttransval__\x00{node_key}"
    return base + "\x00vals", base + "\x00valid"


def _strtransval_env_keys(node_key) -> Tuple[str, str]:
    base = f"__strtransval__\x00{node_key}"
    return base + "\x00vals", base + "\x00valid"


def _stroutdict_aux_key(node_key):
    return ("__stroutdict__", node_key)


def _dict_gather(dc: "DeviceColumn", table_np: np.ndarray) -> torch.Tensor:
    """``table_np`` (one entry per dictionary value plus the null slot)
    gathered by each row's code; a null row reads the null slot."""
    idx = torch.where(dc.valid, dc.values, len(dc.dictionary))
    return torch.from_numpy(np.array(table_np)).to(dc.values.device).index_select(0, idx)


def _transform_source(table, colname, bucket, stage_cache, device):
    """The staged string column a transform lane reads, or None."""
    staged = stage_table_columns(table, [colname], bucket, stage_cache, device)
    if staged is None:
        return None
    dc = staged[1].get(colname)
    return None if dc is None or dc.dictionary is None else dc


def dict_int_transform_lane(table, shape, bucket: int, stage_cache: Optional[dict], device):
    """(vals, valid) int lanes of an int-valued string transform: evaluated
    on the host over the dictionary plus the null slot, gathered by code on
    the card. In the 32-bit mode the values are range-checked there exactly
    (a value past int32 declines, the wrap guard at O(unique) cost) and
    narrow to int32; the 64-bit mode keeps them int64. Cached with the
    partition; None to decline."""
    colname, node, node_key = shape
    cache_key = ("__inttranslane__", node_key, bucket, str(device), x64_enabled())
    cached = stage_cache.get(cache_key) if stage_cache is not None else None
    if cached is not None:
        return cached
    dc = _transform_source(table, colname, bucket, stage_cache, device)
    if dc is None:
        return None
    arr = _eval_over_dictionary(colname, node, dc.dictionary)
    if arr is None:
        return None
    vals_np = np.asarray(pc.fill_null(arr, 0)).astype(np.int64)
    tvalid = np.asarray(pc.is_valid(arr), dtype=bool)
    if not x64_enabled():
        live = vals_np[tvalid]
        if live.size and (live.min() < _INT32_LO or live.max() > _INT32_HI):
            return None
        vals_np = vals_np.astype(np.int32)
    out = (_dict_gather(dc, vals_np), _dict_gather(dc, tvalid))
    if stage_cache is not None:
        stage_cache[cache_key] = out
    return out


def dict_transform_lane(table, shape, bucket: int, stage_cache: Optional[dict], device):
    """(ids, valid, transformed dictionary) of a string-valued transform: the
    host evaluates it over the dictionary plus the null slot (a fill_null
    can turn the null row into a real value), recodes the results through
    their sorted distinct values (equal results share an id and id order is
    value order, so the lane serves group identity and sorts alike), and the
    card gathers the ids by code. Cached with the partition; None to
    decline."""
    colname, node, node_key = shape
    cache_key = ("__dicttranslane__", node_key, bucket, str(device))
    cached = stage_cache.get(cache_key) if stage_cache is not None else None
    if cached is not None:
        return cached
    dc = _transform_source(table, colname, bucket, stage_cache, device)
    if dc is None:
        return None
    arr = _eval_over_dictionary(colname, node, dc.dictionary)
    if arr is None:
        return None
    try:
        distinct = pc.unique(arr.drop_null())
        tuniq = distinct.take(pc.sort_indices(distinct))
        ids_arr = pc.index_in(arr, value_set=tuniq)  # null -> null id
    except pa.ArrowException:
        return None  # a result type arrow cannot sort or index
    ids = np.asarray(pc.fill_null(ids_arr, 0), dtype=np.int32)
    tvalid = np.asarray(pc.is_valid(ids_arr), dtype=bool)
    out = (_dict_gather(dc, ids), _dict_gather(dc, tvalid), tuniq)
    if stage_cache is not None:
        stage_cache[cache_key] = out
    return out


def string_transform_env(nodes, schema, table, bucket: int, stage_cache: Optional[dict],
                         env: dict, aux: dict, device) -> Optional[dict]:
    """Stage the transform lanes of the trees into ``env`` (ids or values and
    validity, as two 1-D tensors each) and each transformed dictionary into
    ``aux`` for the decode at unstage. Dictionary-predicate subtrees are
    skipped (string_lut_env owns them) and a claimed subtree is not walked
    further. Returns the env, or None when a lane does not stage (the
    caller declines)."""
    merged = env

    def walk(n):
        nonlocal merged
        if (_string_lut_shape(n, schema) is not None
                or _string_dict_pred_applies(n, schema) is not None):
            return True
        vs = _string_value_applies(n, schema)
        if vs is not None:
            lane = dict_transform_lane(table, vs, bucket, stage_cache, device)
            if lane is None:
                return False
            if merged is env:
                merged = dict(env)
            vk, mk = _strtransval_env_keys(vs[2])
            merged[vk], merged[mk] = lane[0], lane[1]
            aux[_stroutdict_aux_key(vs[2])] = lane[2]
            return True
        ivs = _int_transform_applies(n, schema)
        if ivs is not None:
            lane = dict_int_transform_lane(table, ivs, bucket, stage_cache, device)
            if lane is None:
                return False
            if merged is env:
                merged = dict(env)
            vk, mk = _inttrans_env_keys(ivs[2])
            merged[vk], merged[mk] = lane
            return True
        return all(walk(c) for c in n.children())

    for nd in nodes:
        if not walk(nd):
            return None
    return merged


def _transform_cmp_shape(node, schema):
    """(lside, rside, op) of a comparison whose sides are string-valued and
    read two different columns, at least one side a row-local transform
    (``upper(s1) == s2``, ``lstrip(a) < rstrip(b)``). Each side is ("col",
    colname, None) or ("trans", colname, side_node); the sides recode
    through a pairwise sorted joint dictionary and compare as ints. A plain
    pair belongs to the joint groups, one column to the dictionary
    predicate."""
    from ..expressions import BinaryOp

    if not (isinstance(node, BinaryOp) and node.op in _CMP_OPS):
        return None

    def side(n):
        c = _plain_string_column(n, schema)
        if c is not None:
            return ("col", c, None)
        vs = _string_value_applies(n, schema)
        return None if vs is None else ("trans", vs[0], n)

    ls, rs = side(node.left), side(node.right)
    if ls is None or rs is None:
        return None
    if (ls[0] == "col" and rs[0] == "col") or ls[1] == rs[1]:
        return None
    return ls, rs, node.op


def _transcmp_env_keys(node_key) -> Tuple[str, str]:
    base = f"__transcmp__\x00{node_key}"
    return base + "\x00lremap", base + "\x00rremap"


def transform_cmp_env(nodes, schema, table, bucket: int, stage_cache: Optional[dict], dcs,
                      env: dict, aux: dict, device) -> Optional[dict]:
    """Merge the pairwise joint remaps of every cross-column transform
    compare. Runs after string_transform_env: a transform side's lane and
    dictionary are in env/aux already, a plain side's codes and dictionary
    in ``dcs``. Returns the env, or None to decline."""
    from ..expressions import BinaryOp

    merged = env

    def side_dict(s):
        kind, colname, n = s
        if kind == "col":
            dc = dcs.get(colname)
            return None if dc is None or dc.dictionary is None else dc.dictionary
        return aux.get(_stroutdict_aux_key(n._key()))

    def walk(n):
        nonlocal merged
        if isinstance(n, BinaryOp):
            shape = _transform_cmp_shape(n, schema)
            if shape is not None:
                ls, rs, _op = shape
                lk, rk = _transcmp_env_keys(n._key())
                if lk in merged:
                    return True
                cache_key = ("__transcmp__", n._key(), bucket, str(device))
                cached = stage_cache.get(cache_key) if stage_cache is not None else None
                if cached is None:
                    ld, rd = side_dict(ls), side_dict(rs)
                    if ld is None or rd is None:
                        return False
                    joint = pc.unique(pa.concat_arrays([ld.cast(pa.large_string()),
                                                        rd.cast(pa.large_string())]))
                    joint = joint.take(pc.sort_indices(joint))
                    cached = (joint_remap(ld, joint, device), joint_remap(rd, joint, device))
                    if stage_cache is not None:
                        stage_cache[cache_key] = cached
                if merged is env:
                    merged = dict(env)
                merged[lk], merged[rk] = cached
                return True
        return all(walk(c) for c in n.children())

    for nd in nodes:
        if not walk(nd):
            return None
    return merged


def string_output_dictionary(node, schema, dcs, aux):
    """The dictionary a string-valued device output decodes through: the
    column's own for a bare column, the joint group's for a fill_null /
    if_else, the transformed dictionary for a transform; None when none
    resolves. Shared by the projection and the grouped-aggregate
    resolvers."""
    cname = _plain_string_column(node, schema)
    src = dcs.get(cname) if cname else None
    if src is not None and src.dictionary is not None:
        return src.dictionary
    ch = _string_choice_shape(node, schema)
    if ch is not None:
        return aux.get(_joint_gkey(ch.cols, ch.lits))
    vs = _string_dict_value_shape(node, schema)
    if vs is not None:
        return aux.get(_stroutdict_aux_key(vs[2]))
    return None


def _epoch_cmp_fn(shape):
    """The closure of an epoch compare: a two-lane compare of the lane side
    (put on the left, the op flipped when a literal led) against the other
    lane side or the literal's halves; a null literal gives all nulls."""
    lspec, rspec, cop = shape
    if lspec[0] == "lit":
        lspec, rspec, cop = rspec, lspec, _CMP_FLIP[cop]
    ident = lspec[1]
    hi_k, lo_k = _epoch_lane_keys(ident)
    if rspec[0] == "lit":
        lit = rspec[1]
        if lit.value is None:
            def run(env, _hk=hi_k):
                z = torch.zeros_like(env[_hk][1])
                return z, z

            return run
        lhik, llok = _epoch_lit_keys(ident, lit._key())

        def run(env, _op=cop, _hk=hi_k, _lk=lo_k, _lh=lhik, _ll=llok):
            hi, m = env[_hk]
            return _two_lane_cmp(_op, hi, env[_lk][0], env[_lh], env[_ll]), m

        return run
    rhi_k, rlo_k = _epoch_lane_keys(rspec[1])

    def run(env, _op=cop, _hk=hi_k, _lk=lo_k, _rhk=rhi_k, _rlk=rlo_k):
        hi, lm = env[_hk]
        rhi, rm = env[_rhk]
        return _two_lane_cmp(_op, hi, env[_lk][0], rhi, env[_rlk][0]), lm & rm

    return run


def _compile_node(node, schema):
    """Recursively build a closure over {name: (values, valid)} returning
    (values, valid); types are resolved statically via ``schema``."""
    from ..expressions import (Alias, Between, BinaryOp, Cast, Column, FillNull, Function, IfElse,
                               IsIn, IsNull, Literal, Not)

    out_dt = node.to_field(schema).dtype

    gshape = _string_dict_pred_applies(node, schema)
    if gshape is not None:
        # a general dictionary predicate: the whole subtree was evaluated
        # over the dictionary plus a null slot; gather (value, valid) by code
        colname = gshape[0]
        vals_k, valid_k, null_k = _strdictpred_env_keys(gshape[2])

        def run(env, _c=colname, _vk=vals_k, _mk=valid_k, _nk=null_k):
            codes, m = env[_c]
            idx = torch.where(m, codes, env[_nk])
            return env[_vk].index_select(0, idx), env[_mk].index_select(0, idx)

        return run, out_dt

    # a transformed string (its ids, decoded at unstage through the
    # transformed dictionary) or an int-valued transform (its values): the
    # lanes were staged by string_transform_env
    tshape = _string_value_applies(node, schema)
    keys = (_strtransval_env_keys(tshape[2]) if tshape is not None else None)
    if keys is None:
        ishape = _int_transform_applies(node, schema)
        keys = _inttrans_env_keys(ishape[2]) if ishape is not None else None
    if keys is not None:
        def run(env, _vk=keys[0], _mk=keys[1]):
            return env[_vk], env[_mk]

        return run, out_dt

    if isinstance(node, Column):
        name = node.cname

        def run(env):
            return env[name]

        return run, out_dt

    if isinstance(node, Literal):
        if node.value is None:
            def run(env):
                n, dev = _env_nrows(env), _env_device(env)
                return (torch.zeros(n, dtype=torch.int32, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev))
        else:
            v = _literal_to_physical(node.value, node.dtype)
            jd = _jdt(node.dtype)

            def run(env, _v=v, _jd=jd):
                # torch.full rounds a python float to the tensor's dtype, as
                # jnp.full does, so `col_f32 >= 0.05` compares in float32
                n, dev = _env_nrows(env), _env_device(env)
                return (torch.full((n,), _v, dtype=_jd, device=dev),
                        torch.ones(n, dtype=torch.bool, device=dev))

        return run, out_dt

    if isinstance(node, Alias):
        inner, _ = _compile_node(node.child, schema)
        return inner, out_dt

    if isinstance(node, Cast):
        inner, _ = _compile_node(node.child, schema)
        jd = _jdt(node.dtype)

        if node.dtype.kind in _INT_RANGES:
            lo, hi = float_cast_bounds(node.dtype, jd)

            def run(env, _inner=inner, _jd=jd, _dt=node.dtype, _lo=lo, _hi=hi):
                v, m = _inner(env)
                if v.is_floating_point():
                    return float_to_int(v, _jd, _lo, _hi), m
                return _wrap_unsigned(v.to(_jd), _dt), m
        else:
            def run(env, _inner=inner, _jd=jd, _dt=node.dtype):
                v, m = _inner(env)
                return _wrap_unsigned(v.to(_jd), _dt), m

        return run, out_dt

    if isinstance(node, Not):
        inner, _ = _compile_node(node.child, schema)

        def run(env, _inner=inner):
            v, m = _inner(env)
            return ~v, m

        return run, out_dt

    if isinstance(node, IsNull):
        inner, _ = _compile_node(node.child, schema)

        def run(env, _inner=inner, _neg=node.negate):
            _v, m = _inner(env)
            return (m if _neg else ~m), torch.ones_like(m)

        return run, out_dt

    if isinstance(node, (FillNull, IfElse)) and out_dt.is_string():
        ch = _string_choice_shape(node, schema)
        if ch is None:
            raise ValueError("string choice not device-compilable here")
        return _choice_code_fn(ch, _joint_gkey(ch.cols, ch.lits), schema), out_dt

    if isinstance(node, FillNull):
        a, _ = _compile_node(node.child, schema)
        b, _ = _compile_node(node.fill, schema)
        jd = _jdt(out_dt)

        def run(env, _a=a, _b=b, _jd=jd):
            av, am = _a(env)
            bv, bm = _b(env)
            return torch.where(am, av.to(_jd), bv.to(_jd)), am | bm

        return run, out_dt

    if isinstance(node, IfElse):
        p, _ = _compile_node(node.pred, schema)
        t, _ = _compile_node(node.if_true, schema)
        f, _ = _compile_node(node.if_false, schema)
        jd = _jdt(out_dt)

        def run(env, _p=p, _t=t, _f=f, _jd=jd):
            pv, pm = _p(env)
            pv = pv.to(torch.bool)  # a null-literal predicate comes as int32 zeros
            tv, tm = _t(env)
            fv, fm = _f(env)
            return torch.where(pv, tv.to(_jd), fv.to(_jd)), pm & torch.where(pv, tm, fm)

        return run, out_dt

    if isinstance(node, (Function, IsIn)):
        lshape = _string_lut_shape(node, schema)
        if lshape is not None:
            # a lookup table over the dictionary, gathered by code
            lut_k = _strlut_env_key(lshape[3])

            def run(env, _c=lshape[0], _lk=lut_k):
                codes, m = env[_c]
                return env[_lk].index_select(0, codes), m

            return run, out_dt

    if isinstance(node, IsIn):
        items = _numeric_isin_items(node, schema)
        if items is None:
            raise ValueError("is_in not device-compilable here")
        inner, _ = _compile_node(node.child, schema)

        def run(env, _inner=inner, _items=items):
            v, m = _inner(env)
            out = torch.zeros_like(m)
            for it in _items:  # a short static list: one compare each
                out = out | (v == it)
            return out, m

        return run, out_dt

    if isinstance(node, Function):
        if node.fname not in _DEVICE_FNS:
            raise ValueError(f"function {node.fname} not device-compilable")
        inner, _ = _compile_node(node.args[0], schema)

        def run(env, _inner=inner, _fn=_DEVICE_FNS[node.fname], _dt=out_dt):
            v, m = _inner(env)
            return _wrap_unsigned(_fn(v), _dt), m

        return run, out_dt

    if isinstance(node, Between):
        x, _ = _compile_node(node.child, schema)
        lo, _ = _compile_node(node.lower, schema)
        hi, _ = _compile_node(node.upper, schema)

        def run(env, _x=x, _lo=lo, _hi=hi):
            xv, xm = _x(env)
            lv, lm = _lo(env)
            hv, hm = _hi(env)
            ge, ge_m = xv >= lv, xm & lm
            le, le_m = xv <= hv, xm & hm
            # Kleene AND: valid when both valid, or either side is a valid False
            valid = (ge_m & le_m) | (ge_m & ~ge) | (le_m & ~le)
            return ge & le, valid

        return run, out_dt

    if isinstance(node, BinaryOp):
        shape = _string_cmp_shape(node, schema)
        if shape is not None:
            colname, lit, flipped = shape
            cop = _CMP_FLIP[node.op] if flipped else node.op
            if lit is None:
                # a comparison with a null literal: an all-null result (SQL)
                def run(env, _c=colname):
                    z = torch.zeros_like(env[_c][1])
                    return z, z

                return run, out_dt
            keq, klt, kle = _strlit_keys(colname, lit)

            def run(env, _c=colname, _op=cop, _keq=keq, _klt=klt, _kle=kle):
                codes, m = env[_c]
                if _op == "==":
                    out = codes == env[_keq]
                elif _op == "!=":
                    out = codes != env[_keq]
                elif _op == "<":
                    out = codes < env[_klt]
                elif _op == ">=":
                    out = codes >= env[_klt]
                elif _op == "<=":
                    out = codes < env[_kle]
                else:  # ">"
                    out = codes >= env[_kle]
                return out, m

            return run, out_dt
        ccshape = _string_colcol_shape(node, schema)
        if ccshape is not None:
            # both sides as codes of one joint dictionary
            gkey = _joint_gkey(*_cmp_union_group(*ccshape))
            lf2 = _side_code_fn(ccshape[0], gkey, schema)
            rf2 = _side_code_fn(ccshape[1], gkey, schema)

            def run(env, _l=lf2, _r=rf2, _op=node.op):
                lv, lm = _l(env)
                rv, rm = _r(env)
                if _op == "<=>":
                    eq = (lv == rv) & lm & rm
                    return eq | (~lm & ~rm), torch.ones_like(lm)
                return _CMP_FNS[_op](lv, rv), lm & rm

            return run, out_dt
        eshape = _epoch_cmp_shape(node, schema)
        if eshape is not None:
            return _epoch_cmp_fn(eshape), out_dt
        xshape = _transform_cmp_shape(node, schema)
        if xshape is not None:
            # each side's codes (a column's, or a transform's ids) through
            # the pairwise joint remap staged by transform_cmp_env
            lk, rk = _transcmp_env_keys(node._key())

            def reader(side):
                kind, colname, n = side
                if kind == "col":
                    return lambda env, _c=colname: env[_c]
                vk, mk = _strtransval_env_keys(n._key())
                return lambda env, _vk=vk, _mk=mk: (env[_vk], env[_mk])

            def run(env, _lr=reader(xshape[0]), _rr=reader(xshape[1]), _lk=lk, _rk=rk,
                    _f=_CMP_FNS[xshape[2]]):
                lv, lm = _lr(env)
                rv, rm = _rr(env)
                return _f(env[_lk].index_select(0, lv), env[_rk].index_select(0, rv)), lm & rm

            return run, out_dt
        lf, _ = _compile_node(node.left, schema)
        rf, _ = _compile_node(node.right, schema)
        op = node.op
        if op in ("&", "|"):
            def run(env, _l=lf, _r=rf, _op=op):
                lv, lm = _l(env)
                rv, rm = _r(env)
                if _op == "&":
                    # Kleene: valid if both valid, or either side is a valid False
                    valid = (lm & rm) | (lm & ~lv) | (rm & ~rv)
                else:
                    valid = (lm & rm) | (lm & lv) | (rm & rv)
                # on int operands (bitwise ops) the terms read bit 0 and come
                # out as a 0/1 int lane: keep it bool, as every other lane is
                return (lv & rv if _op == "&" else lv | rv), valid.to(torch.bool)

            return run, out_dt
        if op == "^":
            def run(env, _l=lf, _r=rf):
                lv, lm = _l(env)
                rv, rm = _r(env)
                return lv ^ rv, lm & rm

            return run, out_dt
        if op in _CMP_FNS:
            fn = _CMP_FNS[op]

            def run(env, _l=lf, _r=rf, _fn=fn):
                lv, lm = _l(env)
                rv, rm = _r(env)
                return _fn(lv, rv), lm & rm

            return run, out_dt
        if op == "<=>":
            def run(env, _l=lf, _r=rf):
                lv, lm = _l(env)
                rv, rm = _r(env)
                eq = (lv == rv) & lm & rm
                return eq | (~lm & ~rm), torch.ones_like(lm)

            return run, out_dt

        jd = _jdt(out_dt)

        def arith(lv, rv, _op=op, _jd=jd):
            if _op == "+":
                return lv.to(_jd) + rv.to(_jd)
            if _op == "-":
                return lv.to(_jd) - rv.to(_jd)
            if _op == "*":
                return lv.to(_jd) * rv.to(_jd)
            if _op == "/":
                return lv.to(_wf()) / rv.to(_wf())
            if _op == "//":
                if lv.is_floating_point() or rv.is_floating_point():
                    return torch.floor(lv / rv).to(_jd)  # 1.0//0.0 = inf like host
                return torch.floor_divide(lv, rv).to(_jd)
            if _op == "%":
                return torch.remainder(lv, rv).to(_jd)
            if _op == "**":
                return torch.pow(lv.to(_wf()), rv.to(_wf()))
            raise AssertionError(_op)

        def run(env, _l=lf, _r=rf, _arith=arith, _op=op, _dt=out_dt):
            lv, lm = _l(env)
            rv, rm = _r(env)
            if _op in ("//", "%") and not (lv.is_floating_point() or rv.is_floating_point()):
                # INT division by zero: null (the host kernel raises; the
                # device masks instead). Float operands keep inf/nan.
                safe = torch.where(rv == 0, torch.ones_like(rv), rv)
                return _wrap_unsigned(_arith(lv, safe), _dt), lm & rm & (rv != 0)
            return _wrap_unsigned(_arith(lv, rv), _dt), lm & rm

        return run, out_dt

    raise ValueError(f"{type(node).__name__} not device-compilable")


def compile_validity(node, schema):
    """A closure over {name: (values, valid)} returning only ``node``'s valid
    lane, the same bits as ``_compile_node``'s closure gives. Values are
    computed only where validity reads them (Kleene ``&``/``|``, Between, the
    divisor of an integer ``//``/``%``). The deep-fused aggregation uses it
    for the counts of the columns whose values the kernel computes."""
    from ..expressions import Alias, BinaryOp, Cast, Column, FillNull, Function, IsNull, Literal, Not

    if (_string_dict_pred_applies(node, schema) is not None
            or _string_lut_shape(node, schema) is not None
            or _epoch_cmp_shape(node, schema) is not None):
        full, _ = _compile_node(node, schema)
        return lambda env: full(env)[1]
    if isinstance(node, Column):
        name = node.cname
        return lambda env: env[name][1]
    if isinstance(node, IsNull):
        return lambda env: torch.ones(_env_nrows(env), dtype=torch.bool, device=_env_device(env))
    if isinstance(node, FillNull):
        af = compile_validity(node.child, schema)
        bf = compile_validity(node.fill, schema)
        return lambda env: af(env) | bf(env)
    if isinstance(node, Function):
        return compile_validity(node.args[0], schema)
    if isinstance(node, Literal):
        fill = torch.zeros if node.value is None else torch.ones
        return lambda env: fill(_env_nrows(env), dtype=torch.bool, device=_env_device(env))
    if isinstance(node, (Alias, Cast, Not)):
        return compile_validity(node.child, schema)
    if isinstance(node, BinaryOp) and node.op not in ("&", "|", "//", "%"):
        if node.op == "<=>":
            return lambda env: torch.ones(_env_nrows(env), dtype=torch.bool,
                                          device=_env_device(env))
        lf = compile_validity(node.left, schema)
        rf = compile_validity(node.right, schema)
        return lambda env: lf(env) & rf(env)
    full, _ = _compile_node(node, schema)
    return lambda env: full(env)[1]


_PROJ_CACHE: Dict = {}
# one compile per key, whichever pool thread asks first
_PROJ_LOCK = threading.Lock()


def compile_projection(nodes, schema, input_names: Tuple[str, ...]):
    """Compile a list of NORMALIZED expression nodes to one function:
    env dict -> list[(values, valid)]. Cached on (node keys, schema, inputs,
    mode): the closures bake the mode's compute dtypes in."""
    key = (tuple(n._key() for n in nodes), tuple((f.name, f.dtype) for f in schema),
           input_names, x64_enabled())
    with _PROJ_LOCK:
        hit = _PROJ_CACHE.get(key)
        if hit is not None:
            return hit
        compiled = [_compile_node(n, schema) for n in nodes]
        fns = [c[0] for c in compiled]

        def run(env):
            return [f(env) for f in fns]

        hit = _PROJ_CACHE[key] = (run, [c[1] for c in compiled])
        return hit


def stage_table_columns(table, names, bucket: int, stage_cache: Optional[dict], device):
    """Stage the named columns of a host Table: returns (env, dcs) where env
    is {name: (values, valid)} and dcs the backing DeviceColumns (string
    dictionaries live there). Columns already on the device are reused from
    ``stage_cache`` (the partition's residency cache, keyed on the mode too).
    Returns None if any column is ineligible; an int64 column past int32 in
    the 32-bit mode raises (see ``_narrow_staged``)."""
    env = {}
    dcs = {}
    x64 = x64_enabled()
    for name in names:
        ckey = (name, bucket, str(device), x64)
        dc = stage_cache.get(ckey) if stage_cache is not None else None
        if dc is None:
            s = table.get_column(name)
            if not stageable_dtype(s.dtype):
                return None
            try:
                dc = stage_series(s, bucket, device)
            except _HostStaged:
                return None
            if stage_cache is not None:
                stage_cache[ckey] = dc
        env[name] = (dc.values, dc.valid)
        dcs[name] = dc
    return env, dcs


def _rewrite_between(node, schema):
    """Between over string or epoch children rewrites to the conjunction of
    two comparisons, exactly the host's implementation, so the code-bound
    and epoch lanes apply. Numeric Between keeps its fused direct compile."""
    from ..expressions import Between, BinaryOp

    kids = node.children()
    if kids:
        node = node.with_children([_rewrite_between(c, schema) for c in kids])
    if isinstance(node, Between):
        try:
            cdt = node.child.to_field(schema).dtype
        except (ValueError, KeyError):
            return node
        if cdt.is_string() or cdt.kind in _EPOCH_KINDS:
            return BinaryOp("&", BinaryOp(">=", node.child, node.lower),
                            BinaryOp("<=", node.child, node.upper))
    return node


def normalize_and_check(exprs, schema) -> Optional[list]:
    """Normalize each expression's literals against ``schema``, apply device
    rewrites, and verify device compilability. Returns the normalized nodes,
    or None if any is ineligible."""
    from ..expressions import normalize_literals

    try:
        nodes = [_rewrite_between(normalize_literals(e._node, schema), schema)
                 for e in exprs]
    except (ValueError, KeyError):
        return None
    if all(expr_is_device_compilable(nd, schema, _normalized=True) for nd in nodes):
        return nodes
    return None


def device_required_columns(nodes, schema) -> set:
    """Columns that stage as plain columns for the compiled nodes: every
    column read, minus the subtrees of epoch compares, which read epoch
    lanes (an epoch column cannot stage as int32). A column read both there
    and elsewhere still stages."""
    from ..expressions import BinaryOp, Column

    out: set = set()

    def walk(n):
        if isinstance(n, BinaryOp) and _epoch_cmp_shape(n, schema) is not None:
            return
        if isinstance(n, Column):
            out.add(n.cname)
        for c in n.children():
            walk(c)

    for nd in nodes:
        walk(nd)
    return out


def env_inputs(nodes, schema) -> set:
    """Every env entry the compiled nodes read as a column pair: the staged
    columns and the epoch lanes (the inputs of the deep kernel)."""
    out = set(device_required_columns(nodes, schema))
    for lspec, rspec, _op in collect_epoch_cmps(nodes, schema):
        for spec in (lspec, rspec):
            if spec[0] == "lane":
                out.update(_epoch_lane_keys(spec[1]))
    return out


_INT32_LO, _INT32_HI = -(2 ** 31), 2 ** 31 - 1


def int64_wrap_safe(nodes, schema, env, stage_cache: Optional[dict], bucket: int) -> bool:
    """32-bit mode: int64- and uint64-typed arithmetic computes in int32
    lanes and can wrap silently (staging only range-checks the LEAF
    columns). Prove by interval arithmetic over the staged data's actual
    min/max that no such arithmetic node can leave the int32 range (for
    uint64, [0, 2**31)), anything unproven declines to the host path. An
    int64 function counts as arithmetic (``abs`` or ``-`` of -2**31 wraps in
    int32), and with no bounds of its own it declines. The per-column ranges
    cost one reduction + sync each, cached with the partition.

    64-bit mode: int64 computes at full width, as the reference's does, so
    only uint64 arithmetic is checked: its int64 lanes keep the unsigned
    order only below 2**63, so a node that could leave [0, 2**63) declines
    (a wrapped result would compare, cast and divide as a negative)."""
    from ..expressions import Alias, BinaryOp, Column, Function, Literal

    x64 = x64_enabled()
    risky = (DataType.uint64(),) if x64 else (DataType.int64(), DataType.uint64())
    top = 2 ** 63 - 1 if x64 else _INT32_HI
    lanes_memo: dict = {}

    def rides_lanes(n):
        # an epoch compare reads lanes of exact host int64, and a dictionary
        # predicate or a transform is evaluated on the host over the
        # dictionary: no int32 lane computes below them (memoized: has_risky
        # and safe both probe every node, and each probe walks the subtree)
        r = lanes_memo.get(id(n))
        if r is None:
            r = lanes_memo[id(n)] = (
                (isinstance(n, BinaryOp) and _epoch_cmp_shape(n, schema) is not None)
                or _string_dict_pred_applies(n, schema) is not None
                or _string_value_applies(n, schema) is not None
                or _int_transform_applies(n, schema) is not None)
        return r

    def has_risky(n):
        if rides_lanes(n):
            return False
        try:
            if isinstance(n, (BinaryOp, Function)) and n.to_field(schema).dtype in risky:
                return True
        except (ValueError, KeyError):
            return True
        return any(has_risky(c) for c in n.children())

    if not any(has_risky(n) for n in nodes):
        return True

    def col_range(name):
        key = ("__int_range__", name, bucket, x64)
        r = stage_cache.get(key) if stage_cache is not None else None
        if r is None:
            if name not in env:
                return None
            v, m = env[name]
            if v.is_floating_point() or v.dtype == torch.bool:
                return None
            info = torch.iinfo(v.dtype)
            lo = int(torch.where(m, v, info.max).min())
            hi = int(torch.where(m, v, info.min).max())
            if hi < lo:  # all-null column
                lo = hi = 0
            r = (lo, hi)
            if stage_cache is not None:
                stage_cache[key] = r
        return r

    def bounds(n):
        """Exact integer interval of a node, or None = unknown."""
        if isinstance(n, Alias):
            return bounds(n.child)
        if isinstance(n, Column):
            return col_range(n.cname)
        if isinstance(n, Literal):
            v = n.value
            return (v, v) if isinstance(v, int) and not isinstance(v, bool) else None
        if isinstance(n, BinaryOp) and n.op in ("+", "-", "*"):
            a = bounds(n.left)
            b = bounds(n.right)
            if a is None or b is None:
                return None
            if n.op == "+":
                return (a[0] + b[0], a[1] + b[1])
            if n.op == "-":
                return (a[0] - b[1], a[1] - b[0])
            prods = [x * y for x in a for y in b]
            return (min(prods), max(prods))
        if isinstance(n, BinaryOp) and n.op == "%":
            b = bounds(n.right)
            if b is None:
                return None
            m = max(abs(b[0]), abs(b[1]))
            return None if m == 0 else (-(m - 1), m - 1)
        if isinstance(n, BinaryOp) and n.op == "//":
            a = bounds(n.left)
            b = bounds(n.right)
            if a is None or b is None or b[0] <= 0 <= b[1]:
                return None  # divisor range crosses zero
            cands = [a[0] // b[0], a[0] // b[1], a[1] // b[0], a[1] // b[1]]
            return (min(cands), max(cands))
        return None

    def safe(n):
        if rides_lanes(n):
            return True
        if isinstance(n, (BinaryOp, Function)):
            try:
                dt_ = n.to_field(schema).dtype
            except (ValueError, KeyError):
                return False
            if dt_ in risky:
                # a uint64 result below 0 wraps on the host (or raises there,
                # under checked arithmetic), never in the int32 lanes' way
                lo = 0 if dt_ == DataType.uint64() else _INT32_LO
                bd = bounds(n)
                if bd is None or bd[0] < lo or bd[1] > top:
                    return False
        return all(safe(c) for c in n.children())

    return all(safe(n) for n in nodes)


def lane_env(nodes, schema, table, bucket: int, stage_cache: Optional[dict], env: dict, dcs,
             aux: dict, device, epoch_cmps=None) -> Optional[dict]:
    """``env`` with every lane the nodes read merged in, the lane functions
    called in the reference's order: string-literal code bounds, epoch
    lanes, dictionary lookup tables, joint-dictionary remaps, transform
    lanes, transform-compare remaps. ``aux`` receives the dictionaries that
    string outputs decode through. None when a lane declines."""
    env = string_literal_env(nodes, schema, dcs, env)
    if env is not None:
        if epoch_cmps is None:
            epoch_cmps = collect_epoch_cmps(nodes, schema)
        env = epoch_cmp_env(epoch_cmps, schema, table, bucket, stage_cache, env, device)
    if env is not None:
        env = string_lut_env(nodes, schema, dcs, env)
    if env is not None:
        env = string_joint_env(nodes, schema, dcs, env, aux, device)
    if env is not None:
        env = string_transform_env(nodes, schema, table, bucket, stage_cache, env, aux, device)
    if env is not None:
        env = transform_cmp_env(nodes, schema, table, bucket, stage_cache, dcs, env, aux,
                                device)
    return env


def _stage_and_run(table, exprs, stage_cache: Optional[dict], device):
    """Shared device prologue: normalize and check the expressions, stage the
    input columns and lanes, compile and run ONE projection program. Returns
    (outs, out_dts, nodes, dcs, aux) with ``outs`` ([(values, valid)], one
    pair per expression) still on the card and ``aux`` the dictionaries of
    the string outputs, or None when ineligible (an empty table, no input,
    an ineligible expression or column, int64 arithmetic that could wrap in
    int32 lanes, or a lane that does not stage)."""
    schema = table.schema
    n = len(table)
    if n == 0:
        return None
    nodes = normalize_and_check(exprs, schema)
    if nodes is None:
        return None
    epoch_cmps = collect_epoch_cmps(nodes, schema)
    needed = sorted(device_required_columns(nodes, schema))
    if not needed and not epoch_cmps:
        return None
    b = size_bucket(n)
    staged = stage_table_columns(table, needed, b, stage_cache, device)
    if staged is None:
        return None
    env, dcs = staged
    if not int64_wrap_safe(nodes, schema, env, stage_cache, b):
        return None
    aux: dict = {}
    env = lane_env(nodes, schema, table, b, stage_cache, env, dcs, aux, device, epoch_cmps)
    if env is None:
        return None
    run, out_dts = compile_projection(nodes, schema, tuple(needed))
    return run(env), out_dts, nodes, dcs, aux


def eval_projection_device_async(table, exprs, stage_cache: Optional[dict] = None,
                                 device="cuda"):
    """Launch a device projection without blocking: staging and the compute
    are issued now on the current stream; the returned zero-arg resolver
    fetches the columns into a host Table. Returns None if ineligible."""
    from ..schema import Field, Schema
    from ..table import Table

    n = len(table)
    staged = _stage_and_run(table, exprs, stage_cache, torch.device(device))
    if staged is None:
        return None
    outs, out_dts, nodes, dcs, aux = staged
    schema = table.schema

    def resolve():
        cols, fields = [], []
        for e, nd, (v, m), dt in zip(exprs, nodes, outs, out_dts):
            dictionary = None
            if dt.is_string():
                # a bare column's codes, a choice's joint codes or a
                # transform's ids
                dictionary = string_output_dictionary(nd, schema, dcs, aux)
                if dictionary is None:
                    raise RuntimeError(f"string projection {e.name()!r} lost its dictionary")
            s = unstage(DeviceColumn(v, m, n, dt, dictionary=dictionary)).rename(e.name())
            cols.append(s)
            fields.append(Field(e.name(), s.dtype))
        return Table(Schema(fields), cols)

    return resolve


# ---------------------------------------------------------------------------
# Masked segment reductions
# ---------------------------------------------------------------------------

# Up to this many segments the chunked one-hot compare-reduce applies;
# beyond it, scatter: the deterministic scatter-sums kernel for float sums
# (scatter_sums.py, float32 or float64 by the mode), index_add_ for counts
# and integer sums (exact in any order) and scatter_reduce_ for min/max.
_ONEHOT_MAX_SEGMENTS = 4096
_REDUCE_CHUNK = 8192


def _type_max(dt: torch.dtype):
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def _type_min(dt: torch.dtype):
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


def segment_reduce(values, valid, codes, num_segments: int, kind: str):
    """Masked segment reduction -> (per-group values, per-group valid).

    Up to _ONEHOT_MAX_SEGMENTS groups: a chunked one-hot compare-reduce with
    a Kahan-compensated cross-chunk combine for float sums. Beyond that,
    scatter ops (chunked and compensated for float sums). Eager torch
    materializes each (rows, groups) one-hot compare in device memory.
    Counts are int32 in the 32-bit mode and int64 in the 64-bit one; sums
    accumulate in the dtype they are handed (the caller widens)."""
    if kind == "count":
        cnt = _segment_count(valid, codes, num_segments)
        return cnt, torch.ones(num_segments, dtype=torch.bool, device=codes.device)
    if num_segments <= _ONEHOT_MAX_SEGMENTS:
        out = _onehot_reduce(values, valid, codes, num_segments, kind)
    elif kind == "sum" and values.is_floating_point():
        out = _scatter_sum_kahan(torch.where(valid, values, 0), codes, num_segments)
    else:
        out = _segment_agg(values, valid, codes, num_segments, kind)
    return out, _segment_count(valid, codes, num_segments) > 0


def _segment_count(valid, codes, num_segments: int):
    cdt = torch.int64 if x64_enabled() else torch.int32
    if num_segments <= _ONEHOT_MAX_SEGMENTS:
        sel = _onehot(valid, codes, num_segments)
        return sel.sum(dim=1, dtype=cdt).sum(dim=0, dtype=cdt)
    return torch.zeros(num_segments, dtype=cdt, device=codes.device).index_add_(
        0, codes.long(), valid.to(cdt))


def _onehot(valid, codes, num_segments: int):
    """(chunks, chunk, groups) bool: row r of chunk c is valid and in group g."""
    b = valid.shape[0]
    chunk = min(_REDUCE_CHUNK, b)
    nch = b // chunk
    groups = torch.arange(num_segments, dtype=codes.dtype, device=codes.device)
    return (codes.view(nch, chunk, 1) == groups) & valid.view(nch, chunk, 1)


def _kahan_combine(partials):
    """Compensated sum over the leading (chunk) axis, in chunk order."""
    s = torch.zeros_like(partials[0])
    comp = torch.zeros_like(partials[0])
    for p in partials:
        y = p - comp
        t = s + y
        comp = (t - s) - y
        s = t
    return s


def _onehot_reduce(values, valid, codes, num_segments: int, kind: str):
    is_bool = values.dtype == torch.bool
    if is_bool:
        values = values.to(torch.uint8)  # torch has no bool min/max reduce
    sel = _onehot(valid, codes, num_segments)
    vc = values.view(sel.shape[0], sel.shape[1], 1)
    if kind == "sum":
        if values.is_floating_point():
            return _kahan_combine(torch.where(sel, vc, 0).sum(dim=1))
        return torch.where(sel, vc, 0).sum(dim=1, dtype=values.dtype).sum(dim=0, dtype=values.dtype)
    if kind == "min":
        out = torch.where(sel, vc, _type_max(values.dtype)).amin(dim=1).amin(dim=0)
    elif kind == "max":
        out = torch.where(sel, vc, _type_min(values.dtype)).amax(dim=1).amax(dim=0)
    else:
        raise ValueError(kind)
    return out.bool() if is_bool else out


def _segment_agg(values, valid, codes, num_segments: int, kind: str):
    idx = codes.long()
    if kind == "sum":
        out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx, torch.where(valid, values, 0))
    is_bool = values.dtype == torch.bool
    if is_bool:
        values = values.to(torch.uint8)
    ident = _type_max(values.dtype) if kind == "min" else _type_min(values.dtype)
    out = torch.full((num_segments,), ident, dtype=values.dtype, device=values.device)
    out = out.scatter_reduce_(0, idx, torch.where(valid, values, ident),
                              "amin" if kind == "min" else "amax")
    return out.bool() if is_bool else out


def _scatter_sum_kahan(values, codes, num_segments: int):
    """Per-chunk scatter sums combined with compensation across chunks, in a
    fixed order: the hand-written kernel of scatter_sums.py on the card (no
    float atomics, so every run gives the same bits), its plain version on
    the CPU. A build or launch failure raises."""
    from .scatter_sums import scatter_sum_kahan

    return scatter_sum_kahan(values, codes, num_segments)


# ---------------------------------------------------------------------------
# Device sort (K5): a stable argsort over order-preserving int64 lanes
# ---------------------------------------------------------------------------

_U32 = (1 << 32) - 1


def _sortable_bits(values, valid, descending: bool, nulls_first: bool):
    """(values, valid) of a 32-bit key -> one int64 lane whose order is the
    requested total order. It holds the reference's uint32 lanes (torch on
    the CPU has no uint32 shifts, compares or ``~``, so the lane is int64):
    the null selector (0 null-first, 1 value, 2 null-last) in bits 32-33
    above the value's order bits.
    Floats: NaN canonicalizes to the positive quiet NaN, whose bits sort
    above +inf, and -0.0 ties +0.0, as arrow orders them."""
    v = values
    if v.dtype == torch.bool:
        bits = v.to(torch.int64)
    elif v.is_floating_point():
        f = v.to(torch.float32)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)
        b = f.view(torch.int32)
        # sign-magnitude to unsigned order: negative -> ~b, positive -> b ^ 2^31
        bits = torch.where(b < 0, (~b).to(torch.int64), b.to(torch.int64) + (1 << 31))
    else:
        bits = v.to(torch.int64) + (1 << 31)  # int32 bits ^ 2^31, as unsigned
    if descending:
        bits = _U32 - bits
    sel = torch.where(valid, 1, 0 if nulls_first else 2).to(torch.int64)
    return (sel << 32) | torch.where(valid, bits, 0)


_SIGN64 = -(1 << 63)  # int64 with only the sign bit set


def _sortable_halves(values):
    """(hi, lo) int64 lanes, each holding 32 bits, of a 64-bit key (int64,
    float64, an epoch, or the 64-bit mode's uint64 bits, all below 2**63),
    computed on the card: the order-preserving 64-bit pattern of the
    reference's uint64 lanes split into halves. Signed ints flip the sign
    bit; floats canonicalize NaN to the positive quiet NaN (above +inf) and
    -0.0 to +0.0, then negative patterns invert and positive ones flip the
    sign bit."""
    v = values
    if v.is_floating_point():
        f = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)
        b = f.view(torch.int64)
        bits = torch.where(b < 0, ~b, b ^ _SIGN64)
    else:
        bits = v.to(torch.int64) ^ _SIGN64
    return (bits >> 32) & _U32, bits & _U32


def _stage_f64_sort_lanes(table, node, bucket: int, stage_cache: Optional[dict], device):
    """EXACT float64 sort key in the 32-bit mode: the order-preserving bit
    transform of the full 64-bit pattern, on the host (canonical NaN above
    +inf, -0.0 as +0.0), split into (hi, lo) 32-bit halves as int64 tensors,
    plus the validity lane. ``node`` may be any float64 expression: the host
    evaluates it once in exact float64. Cached with the partition under the
    expression's key. The 64-bit mode stages float64 as it is and splits it
    on the card (``_sortable_halves``)."""
    node = _peel_alias(node)
    key = ("__f64lanes__", node._key(), bucket, str(device))
    cached = stage_cache.get(key) if stage_cache is not None else None
    if cached is not None:
        return cached
    s = _eval_lane_series(table, node)
    if s is None:
        return None
    n = len(s)
    arr = s.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    vals = np.asarray(pc.fill_null(arr, 0.0), dtype=np.float64)
    vals = np.where(np.isnan(vals), np.float64("nan"), vals)
    vals = np.where(vals == 0.0, np.float64(0.0), vals)
    bits = vals.view(np.uint64)
    flipped = np.where((bits >> np.uint64(63)) == 1, ~bits, bits ^ np.uint64(1 << 63))
    if bucket > n:
        flipped = np.concatenate([flipped, np.zeros(bucket - n, dtype=np.uint64)])
    hi = (flipped >> np.uint64(32)).astype(np.int64)
    lo = (flipped & np.uint64(_U32)).astype(np.int64)
    out = (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
           torch.from_numpy(_staged_validity(arr, n, bucket)).to(device))
    if stage_cache is not None:
        stage_cache[key] = out
    return out


def device_table_argsort(table, sort_keys, descending=None, nulls_first=None,
                         stage_cache: Optional[dict] = None, device="cuda"):
    """Argsort indices of a Table computed on the card: the keys stage and
    compile like a projection, then one stable multi-key argsort over their
    lanes. Orders exactly as ``Table.argsort`` does, including the default
    that nulls follow the direction. In the 32-bit mode float64 keys sort on
    exact 64-bit lanes made on the host (float32 would tie values the host
    orders), and epoch keys (timestamp, duration, time, computed ones
    included) on their exact epoch lanes; in the 64-bit mode every key
    stages and compiles like a projection, and ``device_argsort`` splits
    the 64-bit ones on the card. Returns np.ndarray[int64], or None when a
    key is ineligible (anything the expression compiler declines); the
    caller then sorts on the host."""
    from ..datatypes import DataType
    from ..expressions import normalize_literals
    from ..table import _norm_flag

    n = len(table)
    if n == 0:
        return None
    device = torch.device(device)
    keys = list(sort_keys)
    k = len(keys)
    desc = _norm_flag(descending, k, False)
    nf = _norm_flag(nulls_first, k, None)
    lane_keys = {}  # key index -> "f64" or "epoch" (32-bit mode)
    try:
        pre = [normalize_literals(e._node, table.schema) for e in keys]
        for i, nd in enumerate(pre):
            dt = nd.to_field(table.schema).dtype
            if x64_enabled():
                continue
            if dt == DataType.float64():
                lane_keys[i] = "f64"
            elif dt.kind in _EPOCH_KINDS:
                lane_keys[i] = "epoch"
    except (ValueError, KeyError):
        return None
    b = size_bucket(n)
    entries: List = [None] * k
    # lane keys stage first: cheap host work that can decline
    for i, kind in lane_keys.items():
        if kind == "f64":
            entries[i] = _stage_f64_sort_lanes(table, pre[i], b, stage_cache, device)
        else:
            lanes = _stage_epoch_expr_lanes(table, pre[i], b, stage_cache, device)
            if lanes is not None:  # the biased int32 halves back to unsigned values
                entries[i] = (lanes[0].to(torch.int64) + _BIAS32,
                              lanes[1].to(torch.int64) + _BIAS32, lanes[2])
        if entries[i] is None:
            return None
    rest = [i for i in range(k) if i not in lane_keys]
    if rest:
        staged = _stage_and_run(table, [keys[i] for i in rest], stage_cache, device)
        if staged is None:
            return None
        for i, vm in zip(rest, staged[0]):
            entries[i] = vm
    nf_resolved = [f if f is not None else d for f, d in zip(nf, desc)]
    return device_argsort(entries, desc, nf_resolved, n)[:n].cpu().numpy().astype(np.int64)


def device_argsort(key_cols: Sequence[Tuple], descending: Sequence[bool],
                   nulls_first: Sequence[bool], length: int):
    """Stable multi-key argsort on the card; padding rows (at and past
    ``length``) sort last. Each key is (values, valid), turned into lanes by
    ``_sortable_bits`` (a 32-bit key) or ``_sortable_halves`` (a 64-bit one),
    or an exact (hi, lo, valid) lane triple made on the host. torch sorts
    one key at a time, so the lanes sort by chained stable argsorts, least
    significant lane first; the padding selector rides in bit 34 of the
    first lane."""
    b = key_cols[0][0].shape[0]
    dev = key_cols[0][0].device
    lanes: List = []
    for entry, d, nf in zip(key_cols, descending, nulls_first):
        if len(entry) == 2 and entry[0].dtype in (torch.int64, torch.float64):
            entry = (*_sortable_halves(entry[0]), entry[1])
        if len(entry) == 3:
            hi, lo, m = entry
            if d:  # the bitwise not of the 64-bit pattern, half by half
                hi, lo = _U32 - hi, _U32 - lo
            sel = torch.where(m, 1, 0 if nf else 2).to(torch.int64)
            lanes += [(sel << 32) | torch.where(m, hi, 0), torch.where(m, lo, 0)]
        else:
            lanes.append(_sortable_bits(entry[0], entry[1], d, nf))
    inbounds = torch.arange(b, device=dev) < length
    lanes = [torch.where(inbounds, lane, 0) for lane in lanes]
    lanes[0] = lanes[0] | torch.where(inbounds, 0, 1 << 34)
    perm = torch.arange(b, device=dev)
    for lane in reversed(lanes):
        perm = perm[torch.argsort(lane[perm], stable=True)]
    return perm


# ---------------------------------------------------------------------------
# Device hash (K6): a bucket id per row, murmur-style 32-bit mixing
# ---------------------------------------------------------------------------

_NULL_HASH32 = 0x9E3779B9


def hash_buckets(columns: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 num_buckets: int) -> torch.Tensor:
    """The bucket id of each row (int32) from its key columns, with the
    reference's bits: each column's 32-bit hash (``_hash32``; a null row
    hashes as 0x9E3779B9) is xor-ed into the running hash and mixed
    (``_mix32``), and the result taken mod ``num_buckets``. torch has no
    uint32 shifts or compares on the CPU, so the uint32 lanes live in int64
    tensors, masked to 32 bits. A lane's width decides its hash, as in the
    reference: pass a uint32 column's int64 lane as ``.to(torch.int32)`` to
    hash the reference's uint32 lane. As in the reference, nothing on the
    query path calls it: the shuffle buckets rows by the host hash."""
    h = torch.zeros(columns[0].shape[0], dtype=torch.int64, device=columns[0].device)
    for v, m in zip(columns, valids):
        h = _mix32(h ^ torch.where(m, _hash32(v), _NULL_HASH32))
    return (h % num_buckets).to(torch.int32)


def _hash32(v: torch.Tensor) -> torch.Tensor:
    """The 32-bit hash of each value (an int64 lane in [0, 2**32)): floats
    by their float32 bits with -0.0 as 0.0, 64-bit ints as mix(lo) ^ hi."""
    if v.is_floating_point():
        f = v.to(torch.float32)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)
        x = f.view(torch.int32).to(torch.int64) & _U32
    elif v.dtype == torch.bool:
        x = v.to(torch.int64)
    elif v.element_size() == 8:
        x64 = v.to(torch.int64)
        x = _mix32(x64 & _U32) ^ ((x64 >> 32) & _U32)
    else:
        x = v.to(torch.int32).to(torch.int64) & _U32
    return _mix32(x)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer over uint32 values held in an int64 lane (the
    low 32 bits of each product are the uint32 product's)."""
    x = x & _U32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _U32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _U32
    return x ^ (x >> 16)
