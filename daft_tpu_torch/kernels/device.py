"""Device kernel layer: Arrow <-> torch staging, the expression compiler and
the masked segment reductions (the port's copy of the part of
daft_tpu/kernels/device.py this slice runs).

- A device column is a pair of dense tensors on the card: ``values``, padded
  to a power-of-two size bucket, and ``valid`` (bool). Nulls never use
  sentinel values in kernels; every kernel threads validity.
- String columns stage as int32 codes against a SORTED per-partition
  dictionary, so group codes over string keys run on plain int lanes.
- An expression tree compiles to one Python closure over
  ``{name: (values, valid)}`` that issues eager torch ops. A comparison of a
  string column with a string literal compares dictionary codes: the
  literal's code bounds, bisected into each partition's dictionary, enter
  the env as 0-d int32 tensors (``string_literal_env``), so one compiled
  program serves every partition.
- Aggregations are masked segment reductions over dense group codes.
- Sorts are a stable multi-key argsort over order-preserving int64 lanes
  (``device_table_argsort``, the reference's K5).

This slice ports the 32-bit device mode (``ExecutionConfig.device_x64`` is
False), the one daft_tpu runs on a TPU: int64 columns narrow to int32 when
every value fits, float64 columns compute as float32, and temporal types other
than dates stay on the host. JAX narrows quietly when x64 is off; torch does
not, so every narrowing below is an explicit cast.

Left out of this slice: the string LUT, joint-dictionary and transform
lanes, the epoch lanes (comparisons and sort keys), device hashing,
fixed-shape tensor columns, and unsigned integers other than uint64
(torch's uint16/32 support is partial, so those columns decline to the host
path).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..datatypes import DataType, TypeKind

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
    there is none raises: the device path never carries on on the CPU."""
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ExecutionConfig.device is 'cuda' but torch sees no CUDA device; "
            "set device='cpu' to run the device path on the CPU")
    return dev


_TORCH_DTYPES = {
    TypeKind.BOOL: torch.bool,
    TypeKind.INT8: torch.int8, TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32, TypeKind.INT64: torch.int64,
    TypeKind.FLOAT32: torch.float32, TypeKind.FLOAT64: torch.float64,
}

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


def is_device_dtype(dt: DataType) -> bool:
    """Device-representable in the 32-bit device mode: int64 and uint64 via
    lossless int32 narrowing (checked per column at stage time), float64 as
    float32, dates as int32 days."""
    return dt.kind in _TORCH_DTYPES or dt.kind in _NARROW_64 or dt.kind == TypeKind.DATE


def _physical_np(arr: pa.Array) -> np.ndarray:
    """Dense physical values of a primitive arrow array (nulls filled with 0)."""
    if pa.types.is_date32(arr.type):
        arr = arr.cast(pa.int32())
    if arr.null_count:
        zero = pa.scalar(0, arr.type) if not pa.types.is_boolean(arr.type) else pa.scalar(False)
        arr = pc.fill_null(arr, zero)
    return np.asarray(arr)


class DeviceColumn:
    """values + validity on the device, padded to ``bucket`` rows
    (valid[n:] is False). String columns carry their sorted dictionary
    (a host pa.Array) and stage their int32 codes."""

    __slots__ = ("values", "valid", "length", "dtype", "dictionary", "_dict_list",
                 "_literal_codes")

    def __init__(self, values, valid, length: int, dtype: DataType, dictionary=None):
        self.values = values
        self.valid = valid
        self.length = length
        self.dtype = dtype
        self.dictionary = dictionary
        self._dict_list = None
        self._literal_codes: Dict[str, Tuple] = {}

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
    """Host-side staging core: (values [bucket], valid [bucket], n)."""
    dt = s.dtype
    if not is_device_dtype(dt):
        raise ValueError(f"{dt} is not device-representable")
    n = len(s)
    b = bucket or size_bucket(n)
    arr = s.to_arrow()
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


def _narrow_staged(vals: np.ndarray, dt: DataType) -> np.ndarray:
    """int64 and uint64 narrow to int32 only when every value fits (raises
    otherwise, so the caller declines to the host path); float64 rounds to
    float32."""
    if dt.kind not in _NARROW_NP:
        return vals
    target = _NARROW_NP[dt.kind]
    if vals.dtype.kind in "iu":
        info = np.iinfo(target)
        if len(vals) and (vals.min() < info.min or vals.max() > info.max):
            raise ValueError(f"{dt} values exceed int32 range; host path")
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
    storage = dt.to_arrow()
    out = pa.array(vals)
    if out.type != storage:
        if pa.types.is_date32(storage):
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
    """A python literal's device value (a date becomes its epoch day)."""
    if dt.kind == TypeKind.DATE:
        return int(pa.scalar(value, type=dt.to_arrow()).cast(pa.int32()).as_py())
    return value


def _jdt(dt: DataType) -> torch.dtype:
    """COMPUTE dtype of a logical dtype: 64-bit kinds narrow to 32 bits."""
    if dt.kind in _NARROW_64:
        return _NARROW_64[dt.kind]
    if dt.kind in _TORCH_DTYPES:
        return _TORCH_DTYPES[dt.kind]
    if dt.kind == TypeKind.DATE:
        return torch.int32
    raise ValueError(f"{dt} has no device dtype")


def _wf() -> torch.dtype:
    """Widest float compute dtype of the 32-bit mode."""
    return torch.float32


def _literal_fits_device(lit) -> bool:
    """A literal is device-usable if its dtype has a compute dtype and, for
    int literals that narrow to int32, the value fits."""
    if lit.value is None or lit.dtype.is_null():
        return True
    if not is_device_dtype(lit.dtype):
        return False
    jd = _jdt(lit.dtype)
    if isinstance(lit.value, int) and not isinstance(lit.value, bool) \
            and not jd.is_floating_point and jd != torch.bool:
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
    from ..expressions import (Alias, Between, BinaryOp, Cast, Column, Literal,
                               Not, normalize_literals)

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
    if not (is_device_dtype(out_dt) or out_dt.is_null()):
        return out_dt.is_string() and _plain_string_column(node, schema) is not None
    if isinstance(node, Column):
        return stageable_dtype(schema[node.cname].dtype)
    if isinstance(node, Literal):
        return _literal_fits_device(node)
    if isinstance(node, (Alias, Not)):
        return all(rec(c) for c in node.children())
    if isinstance(node, Cast):
        return (not any_string_child(node) and is_device_dtype(node.dtype)
                and rec(node.child))
    if isinstance(node, BinaryOp) and _string_cmp_shape(node, schema) is not None:
        return True
    if isinstance(node, (BinaryOp, Between)):
        return not any_string_child(node) and all(rec(c) for c in node.children())
    return False


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


def _compile_node(node, schema):
    """Recursively build a closure over {name: (values, valid)} returning
    (values, valid); types are resolved statically via ``schema``."""
    from ..expressions import Alias, Between, BinaryOp, Cast, Column, Literal, Not

    out_dt = node.to_field(schema).dtype

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

        def run(env, _inner=inner, _jd=jd):
            v, m = _inner(env)
            return v.to(_jd), m

        return run, out_dt

    if isinstance(node, Not):
        inner, _ = _compile_node(node.child, schema)

        def run(env, _inner=inner):
            v, m = _inner(env)
            return ~v, m

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

        def run(env, _l=lf, _r=rf, _arith=arith, _op=op):
            lv, lm = _l(env)
            rv, rm = _r(env)
            if _op in ("//", "%") and not (lv.is_floating_point() or rv.is_floating_point()):
                # INT division by zero: null (the host kernel raises; the
                # device masks instead). Float operands keep inf/nan.
                safe = torch.where(rv == 0, torch.ones_like(rv), rv)
                return _arith(lv, safe), lm & rm & (rv != 0)
            return _arith(lv, rv), lm & rm

        return run, out_dt

    raise ValueError(f"{type(node).__name__} not device-compilable")


def compile_validity(node, schema):
    """A closure over {name: (values, valid)} returning only ``node``'s valid
    lane, the same bits as ``_compile_node``'s closure gives. Values are
    computed only where validity reads them (Kleene ``&``/``|``, Between, the
    divisor of an integer ``//``/``%``). The deep-fused aggregation uses it
    for the counts of the columns whose values the kernel computes."""
    from ..expressions import Alias, BinaryOp, Cast, Column, Literal, Not

    if isinstance(node, Column):
        name = node.cname
        return lambda env: env[name][1]
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


def compile_projection(nodes, schema, input_names: Tuple[str, ...]):
    """Compile a list of NORMALIZED expression nodes to one function:
    env dict -> list[(values, valid)]. Cached on (node keys, schema, inputs)."""
    key = (tuple(n._key() for n in nodes), tuple((f.name, f.dtype) for f in schema),
           input_names)
    if key in _PROJ_CACHE:
        return _PROJ_CACHE[key]
    compiled = [_compile_node(n, schema) for n in nodes]
    fns = [c[0] for c in compiled]

    def run(env):
        return [f(env) for f in fns]

    _PROJ_CACHE[key] = (run, [c[1] for c in compiled])
    return _PROJ_CACHE[key]


def stage_table_columns(table, names, bucket: int, stage_cache: Optional[dict], device):
    """Stage the named columns of a host Table: returns (env, dcs) where env
    is {name: (values, valid)} and dcs the backing DeviceColumns (string
    dictionaries live there). Columns already on the device are reused from
    ``stage_cache`` (the partition's residency cache). Returns None if any
    column is ineligible."""
    env = {}
    dcs = {}
    for name in names:
        ckey = (name, bucket, str(device))
        dc = stage_cache.get(ckey) if stage_cache is not None else None
        if dc is None:
            s = table.get_column(name)
            if not stageable_dtype(s.dtype):
                return None
            try:
                dc = stage_series(s, bucket, device)
            except ValueError:
                return None  # an int64 column that does not fit int32
            if stage_cache is not None:
                stage_cache[ckey] = dc
        env[name] = (dc.values, dc.valid)
        dcs[name] = dc
    return env, dcs


def _rewrite_between(node, schema):
    """Between over string children rewrites to the conjunction of two
    comparisons, exactly the host's implementation. Numeric Between keeps its
    fused direct compile."""
    from ..expressions import Between, BinaryOp

    kids = node.children()
    if kids:
        node = node.with_children([_rewrite_between(c, schema) for c in kids])
    if isinstance(node, Between):
        try:
            cdt = node.child.to_field(schema).dtype
        except (ValueError, KeyError):
            return node
        if cdt.is_string():
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
    """Columns the compiled nodes read."""
    from ..expressions import required_columns

    return {c for nd in nodes for c in required_columns(nd)}


_INT32_LO, _INT32_HI = -(2 ** 31), 2 ** 31 - 1


def int64_wrap_safe(nodes, schema, env, stage_cache: Optional[dict], bucket: int) -> bool:
    """int64- and uint64-typed arithmetic computes in int32 lanes and can
    wrap silently (staging only range-checks the LEAF columns). Prove by
    interval arithmetic over the staged data's actual min/max that no such
    arithmetic node can leave the int32 range (for uint64, [0, 2**31)),
    anything unproven declines to the host path. The per-column ranges cost one reduction + sync each,
    cached with the partition."""
    from ..expressions import Alias, BinaryOp, Column, Literal

    risky = (DataType.int64(), DataType.uint64())

    def has_risky(n):
        try:
            if isinstance(n, BinaryOp) and n.to_field(schema).dtype in risky:
                return True
        except (ValueError, KeyError):
            return True
        return any(has_risky(c) for c in n.children())

    if not any(has_risky(n) for n in nodes):
        return True

    def col_range(name):
        key = ("__int_range__", name, bucket)
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
        if isinstance(n, BinaryOp):
            try:
                dt_ = n.to_field(schema).dtype
            except (ValueError, KeyError):
                return False
            if dt_ in risky:
                # a uint64 result below 0 wraps on the host (or raises there,
                # under checked arithmetic), never in the int32 lanes' way
                lo = 0 if dt_ == DataType.uint64() else _INT32_LO
                bd = bounds(n)
                if bd is None or bd[0] < lo or bd[1] > _INT32_HI:
                    return False
        return all(safe(c) for c in n.children())

    return all(safe(n) for n in nodes)


def _stage_and_run(table, exprs, stage_cache: Optional[dict], device):
    """Shared device prologue: normalize and check the expressions, stage the
    input columns, compile and run ONE projection program. Returns
    (outs, out_dts, nodes, dcs) with ``outs`` ([(values, valid)], one pair
    per expression) still on the card, or None when ineligible (an empty
    table, no input column, an ineligible expression or column, or int64
    arithmetic that could wrap in int32 lanes)."""
    schema = table.schema
    n = len(table)
    if n == 0:
        return None
    nodes = normalize_and_check(exprs, schema)
    if nodes is None:
        return None
    needed = sorted(device_required_columns(nodes, schema))
    if not needed:
        return None
    b = size_bucket(n)
    staged = stage_table_columns(table, needed, b, stage_cache, device)
    if staged is None:
        return None
    env, dcs = staged
    if not int64_wrap_safe(nodes, schema, env, stage_cache, b):
        return None
    env = string_literal_env(nodes, schema, dcs, env)
    if env is None:
        return None
    run, out_dts = compile_projection(nodes, schema, tuple(needed))
    return run(env), out_dts, nodes, dcs


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
    outs, out_dts, nodes, dcs = staged
    schema = table.schema

    def resolve():
        cols, fields = [], []
        for e, nd, (v, m), dt in zip(exprs, nodes, outs, out_dts):
            # the only string output the check admits is a bare string column
            dictionary = (dcs[_plain_string_column(nd, schema)].dictionary
                          if dt.is_string() else None)
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
# (scatter_sums.py), index_add_ for counts and integer sums (exact in any
# order) and scatter_reduce_ for min/max.
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
    materializes each (rows, groups) one-hot compare in device memory."""
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
    if num_segments <= _ONEHOT_MAX_SEGMENTS:
        sel = _onehot(valid, codes, num_segments)
        return sel.sum(dim=1, dtype=torch.int32).sum(dim=0, dtype=torch.int32)
    return torch.zeros(num_segments, dtype=torch.int32, device=codes.device).index_add_(
        0, codes.long(), valid.to(torch.int32))


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


def _stage_f64_sort_lanes(table, node, bucket: int, stage_cache: Optional[dict], device):
    """EXACT float64 sort key in the 32-bit mode: the order-preserving bit
    transform of the full 64-bit pattern, on the host (canonical NaN above
    +inf, -0.0 as +0.0), split into (hi, lo) 32-bit halves as int64 tensors,
    plus the validity lane. ``node`` may be any float64 expression: the host
    evaluates it once in exact float64. Cached with the partition under the
    expression's key."""
    from ..expressions import Alias, Column

    while isinstance(node, Alias):
        node = node.child
    key = ("__f64lanes__", node._key(), bucket, str(device))
    cached = stage_cache.get(key) if stage_cache is not None else None
    if cached is not None:
        return cached
    if isinstance(node, Column):
        s = table.get_column(node.cname)
    else:
        from ..table import _broadcast_series

        s = _broadcast_series(node.evaluate(table), len(table))
    if s.is_python():
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
    that nulls follow the direction. float64 keys sort on exact 64-bit lanes
    made on the host (float32 would tie values the host orders). Returns
    np.ndarray[int64], or None when a key is ineligible (epoch-typed keys and
    anything the expression compiler declines); the caller then sorts on
    the host."""
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
    try:
        pre = [normalize_literals(e._node, table.schema) for e in keys]
        f64 = {i for i, nd in enumerate(pre)
               if nd.to_field(table.schema).dtype == DataType.float64()}
    except (ValueError, KeyError):
        return None
    b = size_bucket(n)
    entries: List = [None] * k
    # lane keys stage first: cheap host work that can decline
    for i in f64:
        entries[i] = _stage_f64_sort_lanes(table, pre[i], b, stage_cache, device)
        if entries[i] is None:
            return None
    rest = [i for i in range(k) if i not in f64]
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
    ``_sortable_bits``, or an exact (hi, lo, valid) lane triple of a 64-bit
    key. torch sorts one key at a time, so the lanes sort by chained stable
    argsorts, least significant lane first; the padding selector rides in
    bit 34 of the first lane."""
    b = key_cols[0][0].shape[0]
    dev = key_cols[0][0].device
    lanes: List = []
    for entry, d, nf in zip(key_cols, descending, nulls_first):
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
