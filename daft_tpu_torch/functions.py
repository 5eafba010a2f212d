"""Scalar function registry: name -> (type resolution, host kernel) (the
port's copy of the part of daft_tpu/functions.py this slice runs).

Each function declares how its return dtype derives from the argument dtypes
(the planner infers schemas from it without touching data) and a host kernel
over Series (pyarrow/numpy). The device compiler (kernels/device.py) runs a
few numeric ones on the card (``_DEVICE_FNS``), and the dictionary lanes feed
a string column's dictionary through the registered host kernels, so the
card's answer equals the host's by construction.

Ported families: ``numeric.*`` (without the hash functions), ``float.*``, the
row-local ``utf8.*`` functions (those the dictionary lanes may evaluate) and
the ``dt.*`` components. Any other name the reference registers raises a
ValueError that points at ROADMAP.md.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, NamedTuple, Optional

import pyarrow as pa
import pyarrow.compute as pc

from .datatypes import DataType, TypeKind, try_unify
from .series import Series, _broadcast, _broadcast_to


class FunctionSpec(NamedTuple):
    name: str
    resolve: Callable[..., DataType]  # (*arg_dtypes, **kwargs) -> DataType
    evaluate: Callable[..., Series]  # (*arg_series, **kwargs) -> Series


REGISTRY: Dict[str, FunctionSpec] = {}

# names the reference registers that the port does not have yet
_NOT_PORTED = frozenset((
    "hash", "murmur3_32", "minhash", "utf8.split", "utf8.extract_all",
    "utf8.tokenize_encode", "utf8.tokenize_decode", "dt.date", "dt.time",
    "dt.truncate", "dt.strftime", "dt.to_unix_epoch",
))
_NOT_PORTED_FAMILIES = ("list.", "struct.", "map.", "image.", "url.", "embedding.",
                        "json.", "partitioning.", "sketch.")


def register(name: str, resolve, evaluate) -> None:
    if name in REGISTRY:
        raise ValueError(f"function {name!r} already registered")
    REGISTRY[name] = FunctionSpec(name, resolve, evaluate)


def get_function(name: str) -> FunctionSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        if name in _NOT_PORTED or name.startswith(_NOT_PORTED_FAMILIES):
            raise ValueError(f"function {name!r} is not ported to daft_tpu_torch yet "
                             f"(ROADMAP.md, Queue 1)") from None
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
