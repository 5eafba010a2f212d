"""Scalar function registry: name -> (type resolution, host kernel) (the
port's copy of the part of daft_tpu/functions.py this slice runs).

Each function declares how its return dtype derives from the argument dtypes
(the planner infers schemas from it without touching data) and a host kernel
over Series (pyarrow/numpy). The device compiler (kernels/device.py) runs a
few numeric ones on the card (``_DEVICE_FNS``), and the dictionary lanes feed
a string column's dictionary through the registered host kernels, so the
card's answer equals the host's by construction.

Ported families: ``numeric.*``, the hash functions (``hash``, ``murmur3_32``,
``minhash``), ``float.*``, ``utf8.*`` (split and extract_all among them),
``dt.*``, ``list.*``, ``struct.*``, ``map.get``, ``partitioning.*``,
``json.query``, ``embedding.cosine_distance`` (float64 on the host), the
sketch finalizers ``sketch.hll_estimate`` and ``sketch.quantile_estimate``
(the final projection of a two-stage approximate aggregation, over merged
binary sketches, daft_tpu_torch/sketch/), and the ``image.*`` and
``url.download``/``url.upload`` functions (registered by multimodal.py,
which the package imports). The device compiler knows none of the list,
struct, map, hash, partitioning, embedding and sketch functions, so an
expression holding one declines to the host at plan time, as in the
reference. The names the reference registers that are still to come raise
a ValueError that points at ROADMAP.md with their queue item:
``utf8.tokenize_encode``/``utf8.tokenize_decode`` (they need the BPE
tokenizer, item 10).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .datatypes import DataType, TypeKind, try_unify
from .series import Series, _broadcast, _broadcast_to


class FunctionSpec(NamedTuple):
    name: str
    resolve: Callable[..., DataType]  # (*arg_dtypes, **kwargs) -> DataType
    evaluate: Callable[..., Series]  # (*arg_series, **kwargs) -> Series


REGISTRY: Dict[str, FunctionSpec] = {}

# names the reference registers that the port does not have yet, each with
# the ROADMAP.md Queue 1 item that brings it
_NOT_PORTED = {"utf8.tokenize_encode": 10, "utf8.tokenize_decode": 10}
_NOT_PORTED_FAMILIES: Dict[str, int] = {}


def register(name: str, resolve, evaluate) -> None:
    if name in REGISTRY:
        raise ValueError(f"function {name!r} already registered")
    REGISTRY[name] = FunctionSpec(name, resolve, evaluate)


def get_function(name: str) -> FunctionSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        item = _NOT_PORTED.get(name) or next(
            (i for fam, i in _NOT_PORTED_FAMILIES.items() if name.startswith(fam)), None)
        if item is not None:
            raise ValueError(f"function {name!r} is not ported to daft_tpu_torch yet "
                             f"(ROADMAP.md, Queue 1, item {item})") from None
        raise ValueError(f"unknown function {name!r}") from None


# ---------------------------------------------------------------------------
# resolve helpers
# ---------------------------------------------------------------------------

def _ret(dtype: DataType):
    def resolve(*_args, **_kw):
        return dtype
    return resolve


def _ret_same(*arg_dtypes, **_kw):
    return arg_dtypes[0]


def _ret_float64(*arg_dtypes, **_kw):
    dt = arg_dtypes[0]
    if not (dt.is_numeric() or dt.is_null() or dt.is_boolean()):
        raise ValueError(f"expected numeric input, got {dt}")
    return DataType.float64()


def _req_string(*arg_dtypes, **_kw):
    for dt in arg_dtypes:
        if not (dt.is_string() or dt.is_null()):
            raise ValueError(f"expected string input, got {dt}")
    return DataType.string()


def _req_string_ret(out: DataType):
    def resolve(*arg_dtypes, **_kw):
        if not (arg_dtypes[0].is_string() or arg_dtypes[0].is_null()):
            raise ValueError(f"expected string input, got {arg_dtypes[0]}")
        return out
    return resolve


def _req_temporal_ret(out: DataType, allow=("date", "timestamp")):
    def resolve(*arg_dtypes, **_kw):
        dt = arg_dtypes[0]
        ok = (dt.kind == TypeKind.DATE and "date" in allow) or (
            dt.kind == TypeKind.TIMESTAMP and "timestamp" in allow
        ) or (dt.kind == TypeKind.TIME and "time" in allow) or dt.is_null()
        if not ok:
            raise ValueError(f"expected temporal ({'/'.join(allow)}) input, got {dt}")
        return out
    return resolve


def _arrow1(fn, out_dtype: Optional[DataType] = None):
    """Lift a pyarrow.compute unary kernel to a Series function."""
    def evaluate(s: Series, **kw) -> Series:
        return Series.from_arrow(fn(s.to_arrow(), **kw), s.name, out_dtype)
    return evaluate


# ---------------------------------------------------------------------------
# numeric
# ---------------------------------------------------------------------------

for _name in ("abs", "ceil", "floor", "sign"):
    register(f"numeric.{_name}", _ret_same, (lambda m: lambda s, **kw: getattr(s, m)(**kw))(_name))

for _name in ("sqrt", "cbrt", "exp", "log2", "log10", "log1p", "sin", "cos", "tan",
              "arcsin", "arccos", "arctan", "arctanh", "arccosh", "arcsinh",
              "radians", "degrees"):
    register(f"numeric.{_name}", _ret_float64, (lambda m: lambda s, **kw: getattr(s, m)(**kw))(_name))

register("numeric.negate", _ret_same, lambda s: -s)
register("numeric.log", _ret_float64, lambda s, base=None: s.log(base))
register("numeric.round", _ret_same, lambda s, decimals=0: s.round(decimals))


def _shift_resolve(*arg_dtypes, **_kw):
    # arrow promotes shift operands to the common integer type; declare the same
    u = try_unify(*arg_dtypes) if len(arg_dtypes) == 2 else arg_dtypes[0]
    if u is None or not u.is_integer():
        raise ValueError(f"shift requires integer operands, got {arg_dtypes}")
    return u


register("numeric.shift_left", _shift_resolve, lambda s, o: s.left_shift(o))
register("numeric.shift_right", _shift_resolve, lambda s, o: s.right_shift(o))
register("numeric.exp2", _ret_float64,
         lambda s: Series.from_pylist([2.0], "two")._binary_numeric(
             s.cast(DataType.float64()), pc.power, s.name))


# ---------------------------------------------------------------------------
# float namespace
# ---------------------------------------------------------------------------

register("float.is_nan", _ret(DataType.bool()), lambda s: s.float_is_nan())
register("float.is_inf", _ret(DataType.bool()), lambda s: s.float_is_inf())
register("float.not_nan", _ret(DataType.bool()), lambda s: s.float_not_nan())
register("float.fill_nan", _ret_same, lambda s, fill: s.float_fill_nan(fill))


# ---------------------------------------------------------------------------
# utf8 namespace: the row-local functions (each row's result depends only on
# that row's string), which the dictionary lanes may evaluate over a
# partition's dictionary instead of its rows
# ---------------------------------------------------------------------------

def _bool_str(arg_dtypes):
    for dt in arg_dtypes:
        if not (dt.is_string() or dt.is_null()):
            raise ValueError(f"expected string input, got {dt}")
    return DataType.bool()


def _utf8_binary_bool(fn):
    def evaluate(s: Series, pat: Series) -> Series:
        if len(pat) == 1:
            # a scalar pattern before broadcasting: the vectorized kernel
            # applies however long ``s`` is (the dictionary lanes feed whole
            # dictionaries through here)
            p = pat.to_arrow()[0].as_py()
            if p is None:
                return Series.full_null(s.name, DataType.bool(), len(s))
            return Series.from_arrow(fn(s.to_arrow(), p), s.name, DataType.bool())
        l, r = _broadcast(s, pat)
        # elementwise pattern: per-row python
        lv, rv = l.to_pylist(), r.to_pylist()
        pyfn = {"match_substring": lambda v, p: p in v,
                "starts_with": lambda v, p: v.startswith(p),
                "ends_with": lambda v, p: v.endswith(p)}[fn.__name__]
        out = [None if (a is None or b is None) else pyfn(a, b) for a, b in zip(lv, rv)]
        return Series.from_pylist(out, s.name, DataType.bool())
    return evaluate


register("utf8.contains", lambda *a, **k: _bool_str(a), _utf8_binary_bool(pc.match_substring))
register("utf8.startswith", lambda *a, **k: _bool_str(a), _utf8_binary_bool(pc.starts_with))
register("utf8.endswith", lambda *a, **k: _bool_str(a), _utf8_binary_bool(pc.ends_with))


def _utf8_match(s: Series, pattern: Series) -> Series:
    pat = pattern.to_arrow()[0].as_py()
    return Series.from_arrow(pc.match_substring_regex(s.to_arrow(), pat), s.name, DataType.bool())


register("utf8.match", lambda *a, **k: _bool_str(a), _utf8_match)

register("utf8.length", _req_string_ret(DataType.uint64()),
         lambda s: Series.from_arrow(pc.utf8_length(s.to_arrow()), s.name, DataType.uint64()))
register("utf8.length_bytes", _req_string_ret(DataType.uint64()),
         lambda s: Series.from_arrow(pc.binary_length(s.to_arrow().cast(pa.large_binary())),
                                     s.name, DataType.uint64()))
register("utf8.lower", _req_string, _arrow1(pc.utf8_lower, DataType.string()))
register("utf8.upper", _req_string, _arrow1(pc.utf8_upper, DataType.string()))
register("utf8.capitalize", _req_string, _arrow1(pc.utf8_capitalize, DataType.string()))
register("utf8.reverse", _req_string, _arrow1(pc.utf8_reverse, DataType.string()))
register("utf8.lstrip", _req_string, _arrow1(pc.utf8_ltrim_whitespace, DataType.string()))
register("utf8.rstrip", _req_string, _arrow1(pc.utf8_rtrim_whitespace, DataType.string()))


def _utf8_replace(s: Series, pat: Series, replacement: Series, regex: bool = False) -> Series:
    p = pat.to_arrow()[0].as_py()
    r = replacement.to_arrow()[0].as_py()
    fn = pc.replace_substring_regex if regex else pc.replace_substring
    return Series.from_arrow(fn(s.to_arrow(), pattern=p, replacement=r), s.name, DataType.string())


register("utf8.replace", _req_string, _utf8_replace)


def _utf8_extract(s: Series, pat: Series, index: int = 0) -> Series:
    rx = re.compile(pat.to_arrow()[0].as_py())
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        m = rx.search(v)
        out.append(None if m is None else (m.group(index) if index <= rx.groups else None))
    return Series.from_pylist(out, s.name, DataType.string())


register("utf8.extract", _req_string, _utf8_extract)


def _utf8_find(s: Series, substr: Series) -> Series:
    p = substr.to_arrow()[0].as_py()
    return Series.from_arrow(pc.find_substring(s.to_arrow(), p).cast(pa.int64()), s.name,
                             DataType.int64())


register("utf8.find", _req_string_ret(DataType.int64()), _utf8_find)


def _utf8_left(s: Series, n: Series) -> Series:
    nn = n.to_arrow()[0].as_py()
    return Series.from_arrow(pc.utf8_slice_codeunits(s.to_arrow(), 0, nn), s.name,
                             DataType.string())


def _utf8_right(s: Series, n: Series) -> Series:
    nn = n.to_arrow()[0].as_py()
    return Series.from_pylist([None if v is None else v[-nn:] if nn else "" for v in s.to_pylist()],
                              s.name, DataType.string())


def _utf8_substr(s: Series, start: Series, length: Optional[Series] = None) -> Series:
    st = start.to_arrow()[0].as_py()
    ln = None if length is None else length.to_arrow()[0].as_py()
    stop = None if ln is None else st + ln
    return Series.from_arrow(pc.utf8_slice_codeunits(s.to_arrow(), st, stop), s.name,
                             DataType.string())


def _req_string_int_args(*arg_dtypes, **_kw):
    """First arg string; remaining args integer (slice offsets/lengths)."""
    if not (arg_dtypes[0].is_string() or arg_dtypes[0].is_null()):
        raise ValueError(f"expected string input, got {arg_dtypes[0]}")
    for dt in arg_dtypes[1:]:
        if not (dt.is_integer() or dt.is_null()):
            raise ValueError(f"expected integer argument, got {dt}")
    return DataType.string()


register("utf8.left", _req_string_int_args, _utf8_left)
register("utf8.right", _req_string_int_args, _utf8_right)
register("utf8.substr", _req_string_int_args, _utf8_substr)


def _utf8_concat(*series: Series) -> Series:
    n = max(len(s) for s in series)
    arrs = [_broadcast_to(s, n).to_arrow().cast(pa.large_string()) for s in series]
    # the separator's type must match the large_string operands
    sep = pa.scalar("", pa.large_string())
    return Series.from_arrow(pc.binary_join_element_wise(*arrs, sep), series[0].name,
                             DataType.string())


register("utf8.concat", _req_string, _utf8_concat)


def _like_to_regex(p: str) -> str:
    out = []
    for ch in p:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _utf8_like(s: Series, pat: Series, case_insensitive: bool = False) -> Series:
    rx = re.compile(_like_to_regex(pat.to_arrow()[0].as_py()),
                    re.IGNORECASE if case_insensitive else 0)
    out = [None if v is None else bool(rx.match(v)) for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.bool())


register("utf8.like", lambda *a, **k: _bool_str(a), _utf8_like)
register("utf8.ilike", lambda *a, **k: _bool_str(a), lambda s, p: _utf8_like(s, p, True))


def _utf8_rpad(s: Series, length: Series, ch: Series) -> Series:
    ln, c = length.to_arrow()[0].as_py(), ch.to_arrow()[0].as_py()
    out = [None if v is None else (v + c * max(0, ln - len(v)))[:ln] for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.string())


def _utf8_lpad(s: Series, length: Series, ch: Series) -> Series:
    ln, c = length.to_arrow()[0].as_py(), ch.to_arrow()[0].as_py()
    out = [None if v is None else (c * max(0, ln - len(v)) + v)[-ln:] if ln else ""
           for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.string())


def _utf8_repeat(s: Series, n: Series) -> Series:
    nn = n.to_arrow()[0].as_py()
    return Series.from_arrow(pc.binary_repeat(s.to_arrow(), nn), s.name, DataType.string())


def _req_pad_args(*arg_dtypes, **_kw):
    """string input, integer length, string pad char."""
    if not (arg_dtypes[0].is_string() or arg_dtypes[0].is_null()):
        raise ValueError(f"expected string input, got {arg_dtypes[0]}")
    if len(arg_dtypes) > 1 and not (arg_dtypes[1].is_integer() or arg_dtypes[1].is_null()):
        raise ValueError(f"expected integer pad length, got {arg_dtypes[1]}")
    if len(arg_dtypes) > 2 and not (arg_dtypes[2].is_string() or arg_dtypes[2].is_null()):
        raise ValueError(f"expected string pad character, got {arg_dtypes[2]}")
    return DataType.string()


register("utf8.rpad", _req_pad_args, _utf8_rpad)
register("utf8.lpad", _req_pad_args, _utf8_lpad)
register("utf8.repeat", _req_string_int_args, _utf8_repeat)


def _utf8_count_matches(s: Series, patterns: Series, whole_words: bool = False,
                        case_sensitive: bool = True) -> Series:
    pats = patterns.to_pylist()
    if pats and isinstance(pats[0], list):
        pats = pats[0]
    flags = 0 if case_sensitive else re.IGNORECASE
    parts = [(r"\b" + re.escape(p) + r"\b") if whole_words else re.escape(p) for p in pats]
    rx = re.compile("|".join(parts), flags) if parts else None
    out = [None if v is None else (0 if rx is None else len(rx.findall(v)))
           for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.uint64())


register("utf8.count_matches", _req_string_ret(DataType.uint64()), _utf8_count_matches)


def _utf8_normalize(s: Series, remove_punct: bool = False, lowercase: bool = False,
                    nfd_unicode: bool = False, white_space: bool = False) -> Series:
    import string as _string
    import unicodedata

    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        if nfd_unicode:
            v = unicodedata.normalize("NFD", v)
        if lowercase:
            v = v.lower()
        if remove_punct:
            v = v.translate(str.maketrans("", "", _string.punctuation))
        if white_space:
            v = " ".join(v.split())
        out.append(v)
    return Series.from_pylist(out, s.name, DataType.string())


register("utf8.normalize", _req_string, _utf8_normalize)


# ---------------------------------------------------------------------------
# temporal components
# ---------------------------------------------------------------------------

def _dt_component(fn, out: DataType):
    def evaluate(s: Series) -> Series:
        return Series.from_arrow(fn(s.to_arrow()), s.name, out)
    return evaluate


register("dt.year", _req_temporal_ret(DataType.int32()), _dt_component(pc.year, DataType.int32()))
register("dt.month", _req_temporal_ret(DataType.uint32()),
         _dt_component(pc.month, DataType.uint32()))
register("dt.day", _req_temporal_ret(DataType.uint32()), _dt_component(pc.day, DataType.uint32()))
register("dt.hour", _req_temporal_ret(DataType.uint32(), ("timestamp", "time")),
         _dt_component(pc.hour, DataType.uint32()))
register("dt.minute", _req_temporal_ret(DataType.uint32(), ("timestamp", "time")),
         _dt_component(pc.minute, DataType.uint32()))
register("dt.second", _req_temporal_ret(DataType.uint32(), ("timestamp", "time")),
         _dt_component(pc.second, DataType.uint32()))
register("dt.day_of_week", _req_temporal_ret(DataType.uint32()),
         _dt_component(lambda a: pc.day_of_week(a, count_from_zero=True), DataType.uint32()))
register("dt.day_of_year", _req_temporal_ret(DataType.uint32()),
         _dt_component(pc.day_of_year, DataType.uint32()))


# ---------------------------------------------------------------------------
# temporal conversions
# ---------------------------------------------------------------------------

def _dt_date(s: Series) -> Series:
    return Series.from_arrow(s.to_arrow().cast(pa.date32()), s.name, DataType.date())


def _time_unit(dt: DataType) -> str:
    """A timestamp's time-of-day unit: ns stays ns, coarser units are us."""
    return dt.params[0] if dt.kind == TypeKind.TIMESTAMP and dt.params[0] in ("us", "ns") else "us"


def _dt_time(s: Series) -> Series:
    unit = _time_unit(s.dtype)
    return Series.from_arrow(s.to_arrow().cast(pa.time64(unit)), s.name, DataType.time(unit))


register("dt.date", _req_temporal_ret(DataType.date()), _dt_date)
register("dt.time", lambda *a, **k: DataType.time(_time_unit(a[0])), _dt_time)

_TRUNC_UNIT_US = {
    "microsecond": 1, "millisecond": 1_000, "second": 1_000_000, "minute": 60_000_000,
    "hour": 3_600_000_000, "day": 86_400_000_000, "week": 7 * 86_400_000_000,
}


def _dt_truncate(s: Series, interval: str, relative_to=None) -> Series:
    m = re.fullmatch(r"\s*(\d+)\s*(\w+)\s*", interval)
    if not m:
        raise ValueError(f"invalid truncate interval {interval!r}")
    mult, unit = int(m.group(1)), m.group(2).rstrip("s")
    if unit not in _TRUNC_UNIT_US and unit not in ("month", "year"):
        raise ValueError(f"unsupported truncate unit {unit!r}")
    if relative_to is None:
        out = pc.floor_temporal(s.to_arrow(), multiple=mult, unit=unit)
        return Series.from_arrow(out, s.name, s.dtype)
    # relative to an origin: floor((t - origin) / step) * step + origin
    if unit not in _TRUNC_UNIT_US:
        raise ValueError(f"truncate with relative_to supports fixed-width units only, not {unit!r}")
    if isinstance(relative_to, Series):
        relative_to = relative_to.to_arrow()[0].as_py()
    # computed in the input's own unit, so the declared dtype holds exactly
    is_ts = s.dtype.kind == TypeKind.TIMESTAMP
    in_unit = s.dtype.params[0] if is_ts else "us"
    unit_us = {"s": 1 / 1_000_000, "ms": 1 / 1_000, "us": 1, "ns": 1_000}[in_unit]
    step = np.int64(max(mult * _TRUNC_UNIT_US[unit] * unit_us, 1))  # sub-tick step: identity
    work_type = pa.timestamp(in_unit, tz=s.dtype.params[1]) if is_ts else pa.timestamp("us")
    origin = np.int64(pa.scalar(relative_to, type=pa.timestamp(in_unit)).value)
    ts = s.to_arrow().cast(work_type)
    delta = np.asarray(pc.fill_null(ts.cast(pa.int64()), 0)) - origin
    out = pa.array((delta - ((delta % step) + step) % step) + origin).view(work_type)
    if ts.null_count:
        out = pc.if_else(pc.is_valid(ts), out, pa.nulls(len(out), out.type))
    return Series.from_arrow(out, s.name, s.dtype if is_ts else DataType.timestamp("us"))


register("dt.truncate", lambda *a, **k: a[0], _dt_truncate)
register("dt.strftime", _req_temporal_ret(DataType.string(), ("date", "timestamp", "time")),
         lambda s, fmt=None: Series.from_arrow(
             pc.strftime(s.to_arrow(), format=fmt or "%Y-%m-%dT%H:%M:%S%f"), s.name,
             DataType.string()))
register("dt.to_unix_epoch", _req_temporal_ret(DataType.int64(), ("date", "timestamp")),
         lambda s, unit="s": Series.from_arrow(
             s.to_arrow().cast(pa.timestamp(unit)).cast(pa.int64()), s.name, DataType.int64()))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

register("hash", _ret(DataType.uint64()), lambda s, seed=None, **kw: s.hash(seed))
register("murmur3_32", _ret(DataType.int32()), lambda s: s.murmur3_32())


def _minhash(s: Series, num_hashes: int = 64, ngram_size: int = 1, seed: int = 1) -> Series:
    from .kernels.sketches import minhash_strings

    out = minhash_strings(s.to_arrow(), num_hashes=num_hashes, ngram_size=ngram_size, seed=seed)
    return Series.from_arrow(out, s.name, DataType.fixed_size_list(DataType.uint32(), num_hashes))


register("minhash",
         lambda *a, num_hashes=64, **k: DataType.fixed_size_list(DataType.uint32(), num_hashes),
         _minhash)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def _cosine_distance(s: Series, other: Series) -> Series:
    """1 - cos(a, b) a row, in float64 (a one-row ``other`` against every
    row); a null side gives a null."""
    a = s.to_numpy()
    b = other.to_numpy()
    if a.dtype == object or b.dtype == object:
        out = []
        bl = b if len(b) == len(a) else [b[0]] * len(a)
        for x, y in zip(a, bl):
            if x is None or y is None:
                out.append(None)
            else:
                x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
                out.append(1.0 - float(np.dot(x, y) / (np.linalg.norm(x) * np.linalg.norm(y))))
        return Series.from_pylist(out, s.name, DataType.float64())
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if b.shape[0] == 1 and a.shape[0] != 1:
        b = np.broadcast_to(b, a.shape)
    num = (a * b).sum(axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = 1.0 - num / den
    return Series.from_arrow(pa.array(out), s.name, DataType.float64())


register("embedding.cosine_distance", lambda *a, **k: DataType.float64(), _cosine_distance)


# ---------------------------------------------------------------------------
# sketch finalizers: the final projection of a two-stage approximate
# aggregation (build, exchange, merge, estimate), over merged binary sketches
# ---------------------------------------------------------------------------

def _resolve_hll_estimate(*arg_dtypes, **_kw):
    dt = arg_dtypes[0]
    if not (dt.is_binary() or dt.is_null()):
        raise ValueError(f"sketch.hll_estimate needs a binary sketch column, got {dt}")
    return DataType.uint64()


def _hll_estimate(s: Series) -> Series:
    from .sketch import hll

    return hll.estimate_series(s)


register("sketch.hll_estimate", _resolve_hll_estimate, _hll_estimate)


def _resolve_quantile_estimate(*arg_dtypes, percentiles=0.5, **_kw):
    dt = arg_dtypes[0]
    if not (dt.is_binary() or dt.is_null()):
        raise ValueError(f"sketch.quantile_estimate needs a binary sketch column, got {dt}")
    if isinstance(percentiles, float):
        return DataType.float64()
    return DataType.list(DataType.float64())


def _quantile_estimate(s: Series, percentiles=0.5) -> Series:
    from .sketch import quantile

    return quantile.estimate_series(s, percentiles)


register("sketch.quantile_estimate", _resolve_quantile_estimate, _quantile_estimate)


# ---------------------------------------------------------------------------
# utf8 functions that return lists
# ---------------------------------------------------------------------------

def _utf8_split(s: Series, pat: Series, regex: bool = False) -> Series:
    p = pat.to_arrow()[0].as_py()
    fn = pc.split_pattern_regex if regex else pc.split_pattern
    return Series.from_arrow(fn(s.to_arrow().cast(pa.large_string()), p), s.name,
                             DataType.list(DataType.string()))


def _utf8_extract_all(s: Series, pat: Series, index: int = 0) -> Series:
    rx = re.compile(pat.to_arrow()[0].as_py())
    out = [None if v is None else [m.group(index) for m in rx.finditer(v)] for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.list(DataType.string()))


def _ret_string_list(*arg_dtypes, **_kw):
    _req_string(*arg_dtypes)
    return DataType.list(DataType.string())


register("utf8.split", _ret_string_list, _utf8_split)
register("utf8.extract_all", _ret_string_list, _utf8_extract_all)


# ---------------------------------------------------------------------------
# list namespace
# ---------------------------------------------------------------------------

def _req_list(*arg_dtypes, **_kw):
    dt = arg_dtypes[0]
    if not (dt.is_list() or dt.is_null() or dt.kind == TypeKind.EMBEDDING):
        raise ValueError(f"expected list input, got {dt}")
    return dt


def _list_inner(dt: DataType) -> DataType:
    return dt.inner if dt.is_list() or dt.kind == TypeKind.EMBEDDING else DataType.null()


def _list_join(s: Series, sep: Series) -> Series:
    d = sep.to_arrow()[0].as_py()
    return Series.from_arrow(pc.binary_join(s.to_arrow(), pa.scalar(d, pa.large_string())),
                             s.name, DataType.string())


register("list.join", _ret(DataType.string()), _list_join)
register("list.lengths", lambda *a, **k: (_req_list(*a), DataType.uint64())[1],
         lambda s: Series.from_arrow(pc.list_value_length(s.to_arrow()).cast(pa.uint64()),
                                     s.name, DataType.uint64()))


def _list_get(s: Series, idx: Series, default: Optional[Series] = None) -> Series:
    arr = s.to_arrow()
    if len(idx) == 1:
        i = idx.to_arrow()[0].as_py()
        if pa.types.is_fixed_size_list(arr.type):
            offs = (np.arange(len(arr) + 1, dtype=np.int64) + arr.offset) * arr.type.list_size
        else:
            offs = np.asarray(arr.offsets).astype(np.int64)
        child = arr.values
        starts, ends = offs[:-1], offs[1:]
        lens = ends - starts
        pos = np.clip(np.where(i >= 0, starts + i, ends + i), 0, max(len(child) - 1, 0))
        valid = (i >= -lens) & (i < lens) & np.asarray(pc.is_valid(arr))
        taken = (child.take(pa.array(pos, type=pa.int64())) if len(child)
                 else pa.nulls(len(arr), arr.type.value_type))
        res = Series.from_arrow(pc.if_else(pa.array(valid), taken, pa.nulls(len(arr), taken.type)),
                                s.name)
        return res if default is None else res.fill_null(default)
    # an index per row
    dv = default.to_pylist()[0] if default is not None else None
    out = [dv if v is None or i is None or not (-len(v) <= i < len(v)) else v[i]
           for v, i in zip(s.to_pylist(), idx.to_pylist())]
    return Series.from_pylist(out, s.name)


register("list.get", lambda *a, **k: _list_inner(_req_list(*a)), _list_get)


def _list_slice(s: Series, start: Series, end: Optional[Series] = None) -> Series:
    st = start.to_arrow()[0].as_py()
    en = None if end is None else end.to_arrow()[0].as_py()
    out = [None if v is None else v[st:en] for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.list(_list_inner(s.dtype)))


register("list.slice", lambda *a, **k: DataType.list(_list_inner(_req_list(*a))), _list_slice)


def _list_chunk(s: Series, size: int) -> Series:
    out = [None if v is None else [v[i * size:(i + 1) * size] for i in range(len(v) // size)]
           for v in s.to_pylist()]
    inner = DataType.fixed_size_list(_list_inner(s.dtype), size)
    return Series.from_pylist(out, s.name, DataType.list(inner))


register("list.chunk",
         lambda *a, size=0, **k: DataType.list(DataType.fixed_size_list(_list_inner(_req_list(*a)),
                                                                         size)),
         _list_chunk)


def _list_agg(fn_name: str):
    def evaluate(s: Series) -> Series:
        arr = s.to_arrow()
        if not (pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type)):
            arr = arr.cast(pa.large_list(arr.type.value_type))
        lens = pc.list_value_length(arr).fill_null(0).to_numpy(zero_copy_only=False)
        # arrow's group-by over the flattened elements, one group per row
        tbl = pa.table({"g": np.repeat(np.arange(len(arr)), lens), "v": arr.flatten()})
        agg = tbl.group_by("g").aggregate([("v", fn_name)])
        got = dict(zip(agg.column("g").to_pylist(), agg.column(f"v_{fn_name}").to_pylist()))
        valid = np.asarray(pc.is_valid(arr))
        return Series.from_pylist([got.get(i) if valid[i] else None for i in range(len(arr))],
                                  s.name)
    return evaluate


register("list.sum", lambda *a, **k: _list_inner(_req_list(*a)), _list_agg("sum"))
register("list.mean", _ret(DataType.float64()), _list_agg("mean"))
register("list.min", lambda *a, **k: _list_inner(_req_list(*a)), _list_agg("min"))
register("list.max", lambda *a, **k: _list_inner(_req_list(*a)), _list_agg("max"))


def _list_count(s: Series, mode: str = "valid") -> Series:
    if mode == "all":
        return Series.from_arrow(pc.list_value_length(s.to_arrow()).cast(pa.uint64()), s.name,
                                 DataType.uint64())
    want_null = mode != "valid"
    out = [None if v is None else sum((x is None) == want_null for x in v) for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.uint64())


register("list.count", _ret(DataType.uint64()), _list_count)


def _list_same_dtype(s: Series) -> DataType:
    return s.dtype if s.dtype.is_list() else DataType.list(DataType.null())


def _list_sort(s: Series, desc: Optional[Series] = None) -> Series:
    d = False if desc is None else bool(desc.to_arrow()[0].as_py())
    out = [None if v is None else
           sorted((x for x in v if x is not None), reverse=d) + [x for x in v if x is None]
           for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, _list_same_dtype(s))


register("list.sort", lambda *a, **k: _req_list(*a), _list_sort)


def _list_unique(s: Series) -> Series:
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        seen, uniq = set(), []
        for x in v:
            key = x if not isinstance(x, (list, dict)) else repr(x)
            if x is not None and key not in seen:
                seen.add(key)
                uniq.append(x)
        out.append(uniq)
    return Series.from_pylist(out, s.name, _list_same_dtype(s))


register("list.unique", lambda *a, **k: _req_list(*a), _list_unique)


def _list_contains(s: Series, item: Series) -> Series:
    iv = item.to_pylist()
    if len(item) == 1:
        iv = iv * len(s)
    out = [None if v is None else (x in v) for v, x in zip(s.to_pylist(), iv)]
    return Series.from_pylist(out, s.name, DataType.bool())


register("list.contains", _ret(DataType.bool()), _list_contains)


# ---------------------------------------------------------------------------
# struct and map namespaces
# ---------------------------------------------------------------------------

def _struct_get_resolve(*arg_dtypes, name: str = "", **_kw):
    dt = arg_dtypes[0]
    if dt.kind != TypeKind.STRUCT:
        raise ValueError(f"expected struct input, got {dt}")
    if name not in dt.fields:
        raise ValueError(f"struct has no field {name!r}; available: {list(dt.fields)}")
    return dt.fields[name]


def _struct_get(s: Series, name: str = "") -> Series:
    arr = s.to_arrow()
    idx = [f.name for f in arr.type].index(name)
    return Series.from_arrow(pc.struct_field(arr, [idx]), name)


register("struct.get", _struct_get_resolve, _struct_get)


def _map_get_resolve(*arg_dtypes, **_kw):
    dt = arg_dtypes[0]
    if dt.kind != TypeKind.MAP:
        raise ValueError(f"expected map input, got {dt}")
    return dt.params[1]


def _map_get(s: Series, key: Series) -> Series:
    k = key.to_pylist()[0]
    out = []
    for row in s.to_pylist():
        if row is None:
            out.append(None)
            continue
        items = row.items() if isinstance(row, dict) else row
        out.append(next((vv for kk, vv in items if kk == k), None))
    return Series.from_pylist(out, s.name)


register("map.get", _map_get_resolve, _map_get)


def _to_struct(*series: Series, names: Optional[List[str]] = None) -> Series:
    names = names or [s.name for s in series]
    n = max(len(s) for s in series)
    arrs = [_broadcast_to(s, n).to_arrow() for s in series]
    return Series.from_arrow(pa.StructArray.from_arrays(arrs, names), "struct")


register("struct.make",
         lambda *a, names=None, **k: DataType.struct(
             dict(zip(names or [f"f{i}" for i in range(len(a))], a))),
         _to_struct)


# ---------------------------------------------------------------------------
# partitioning transforms (the Iceberg ones over murmur3)
# ---------------------------------------------------------------------------

def _part_temporal(fn):
    def evaluate(s: Series) -> Series:
        arr = s.to_arrow()
        if pa.types.is_timestamp(arr.type) or pa.types.is_date32(arr.type):
            return Series.from_arrow(fn(arr), s.name, DataType.int32())
        raise ValueError(f"partitioning transform needs date/timestamp, got {arr.type}")
    return evaluate


register("partitioning.days", _req_temporal_ret(DataType.int32()),
         _part_temporal(lambda a: a.cast(pa.date32()).cast(pa.int32())))
register("partitioning.hours", _req_temporal_ret(DataType.int32()),
         _part_temporal(lambda a: pc.divide(a.cast(pa.timestamp("us")).cast(pa.int64()),
                                            3600_000_000).cast(pa.int32())))
register("partitioning.months", _req_temporal_ret(DataType.int32()),
         _part_temporal(lambda a: pc.add(pc.multiply(pc.subtract(pc.year(a), 1970), 12),
                                         pc.subtract(pc.month(a).cast(pa.int32()), 1))
                        .cast(pa.int32())))
register("partitioning.years", _req_temporal_ret(DataType.int32()),
         _part_temporal(lambda a: pc.subtract(pc.year(a), 1970).cast(pa.int32())))


def _iceberg_bucket(s: Series, n: int) -> Series:
    hv = np.asarray(s.murmur3_32().to_arrow(), dtype=np.int32).astype(np.int64)
    out = pa.array(((hv & 0x7FFFFFFF) % n).astype(np.int32), from_pandas=True)
    arr = s.to_arrow()
    if arr.null_count:
        out = pc.if_else(pc.is_valid(arr), out, pa.nulls(len(out), pa.int32()))
    return Series.from_arrow(out, s.name, DataType.int32())


register("partitioning.iceberg_bucket", lambda *a, n=0, **k: DataType.int32(), _iceberg_bucket)


def _iceberg_truncate(s: Series, w: int) -> Series:
    dt = s.dtype
    if dt.is_integer():
        v = s.to_arrow()
        vv = np.asarray(pc.fill_null(v.cast(pa.int64()), 0))
        out = pa.array(vv - ((vv % w + w) % w), from_pandas=True)  # floor-mod truncate
        if v.null_count:
            out = pc.if_else(pc.is_valid(v), out, pa.nulls(len(out), out.type))
        return Series.from_arrow(out, s.name)
    if dt.is_string():
        return Series.from_pylist([None if x is None else x[:w] for x in s.to_pylist()], s.name,
                                  DataType.string())
    raise ValueError(f"iceberg_truncate unsupported for {dt}")


register("partitioning.iceberg_truncate", lambda *a, w=0, **k: a[0], _iceberg_truncate)


# ---------------------------------------------------------------------------
# json namespace: jq-style paths (.a.b[0].c)
# ---------------------------------------------------------------------------

def _json_query(s: Series, query: str) -> Series:
    import json

    parts = re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]", query)
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        try:
            cur = json.loads(v)
            for key, idx in parts:
                cur = cur[key] if key else cur[int(idx)]
            out.append(cur if isinstance(cur, str) else json.dumps(cur))
        except (KeyError, IndexError, TypeError, ValueError):
            out.append(None)
    return Series.from_pylist(out, s.name, DataType.string())


register("json.query", _req_string, _json_query)
