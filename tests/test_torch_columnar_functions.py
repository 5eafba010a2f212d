"""The rest of the port's columnar functions held against daft_tpu on the CPU:
the hash functions (``hash``, ``murmur3_32``, ``minhash``), ``str.split`` and
``str.extract_all``, the dt conversions (date, time, truncate, strftime,
to_unix_epoch), and the list, struct, map, partitioning and json families.

Every case runs one seeded frame through both packages in the 32-bit device
mode at ``device_min_rows=8`` (``torch_parity.run_both``): the output dtype
the planner infers before any data is read, the values and the routing
counters must equal the reference's. None of these functions is known to
the device compiler, so each declines to the host at plan time in both
packages. Tolerance: none. Both packages run the same host kernels, so
every value is compared for equality, bit for bit for the hashes, murmur3,
minhash, the partitioning transforms and the dt functions.
"""

import datetime
import math

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from torch_parity import counters, fresh_ledgers_and_faults, restore_port_config, run_both  # noqa: F401

N = 48


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()


def _table(n=N, seed=11):
    """Seeded columns of every type the functions read, with nulls."""
    rng = np.random.RandomState(seed)
    words = np.array(["alpha", "beta", "gamma", "w1", "w22", "x7y8", "", "delta epsilon"], object)
    text = [" ".join(words[rng.randint(0, len(words), rng.randint(1, 4))]) for _ in range(n)]
    days = rng.randint(8000, 12000, n)
    lists = [None if rng.rand() < 0.1 else list(rng.randint(-5, 9, rng.randint(0, 5)))
             for _ in range(n)]
    for lst in lists:
        if lst and rng.rand() < 0.3:
            lst[0] = None
    tags = [None if rng.rand() < 0.1 else list(words[rng.randint(0, 6, rng.randint(0, 4))])
            for _ in range(n)]
    docs = [None if rng.rand() < 0.1 else
            f'{{"a": {{"b": [{int(v)}, "s{int(v)}"]}}, "c": "t{int(v) % 3}"}}'
            for v in rng.randint(0, 50, n)]
    maps = [None if rng.rand() < 0.1 else [("x", int(v)), ("y", int(v) * 2)][: 1 + int(v) % 2]
            for v in rng.randint(0, 9, n)]
    return pa.table({
        "k": pa.array(rng.randint(0, 4, n), pa.int64()),
        "i": pa.array(rng.randint(-1000, 1000, n), pa.int64(), mask=rng.rand(n) < 0.15),
        "i32": pa.array(rng.randint(-50, 50, n), pa.int32()),
        "f": pa.array(rng.randn(n) * 10, mask=rng.rand(n) < 0.15),
        "s": pa.array(text, pa.large_string(), mask=rng.rand(n) < 0.15),
        "bin": pa.array([t.encode() for t in text], pa.large_binary(), mask=rng.rand(n) < 0.1),
        "d": pa.array(days.astype("datetime64[D]"), mask=rng.rand(n) < 0.1),
        "ts": pa.array((days * 86400 + rng.randint(0, 86400, n)) * 1_000_000,
                       pa.timestamp("us", tz="America/New_York")),
        "tsn": pa.array((days * 86400 + rng.randint(0, 86400, n)).astype("int64") * 10**9
                        + rng.randint(0, 10**9, n), pa.timestamp("ns")),
        "l": pa.array(lists, pa.large_list(pa.int64())),
        "ls": pa.array(tags, pa.large_list(pa.large_string())),
        "st": pa.array([None if rng.rand() < 0.1 else {"a": int(v), "b": f"b{int(v)}"}
                        for v in rng.randint(0, 20, n)],
                       pa.struct([("a", pa.int64()), ("b", pa.large_string())])),
        "m": pa.array(maps, pa.map_(pa.large_string(), pa.int64())),
        "j": pa.array(docs, pa.large_string()),
    })


def _cases():
    """name -> (function of a package -> Expression)."""
    origin = datetime.datetime(2001, 3, 4, 5, 6, 7)
    cases = {
        # hashing
        **{f"hash_{c}": (lambda c: lambda p: p.col(c).hash())(c)
           for c in ("i", "i32", "f", "s", "bin", "d", "ts", "k")},
        "hash_seed_col": lambda p: p.col("s").hash(p.col("k")),
        "hash_seed_lit": lambda p: p.col("i").hash(p.lit(7)),
        "hash_mod_64": lambda p: p.col("f").hash() % 64,
        **{f"murmur3_{c}": (lambda c: lambda p: p.col(c)._fn("murmur3_32"))(c)
           for c in ("i", "i32", "s", "bin", "d", "ts")},
        "minhash": lambda p: p.col("s").minhash(),
        "minhash_ngram": lambda p: p.col("s").minhash(num_hashes=16, ngram_size=2, seed=5),
        # utf8 lists
        "str_split": lambda p: p.col("s").str.split(" "),
        "str_split_regex": lambda p: p.col("s").str.split(r"[ab]+", regex=True),
        "str_extract_all": lambda p: p.col("s").str.extract_all(r"\w(\d)"),
        "str_extract_all_group": lambda p: p.col("s").str.extract_all(r"(\w)(\d)", 2),
        # dt conversions
        "dt_date": lambda p: p.col("ts").dt.date(),
        "dt_time_us": lambda p: p.col("ts").dt.time(),
        "dt_time_ns": lambda p: p.col("tsn").dt.time(),
        "dt_truncate_month_date": lambda p: p.col("d").dt.truncate("1 month"),
        "dt_truncate_year_ts": lambda p: p.col("ts").dt.truncate("1 year"),
        "dt_truncate_3days_ts": lambda p: p.col("ts").dt.truncate("3 days"),
        "dt_truncate_2hours_ns": lambda p: p.col("tsn").dt.truncate("2 hours"),
        "dt_truncate_week_date": lambda p: p.col("d").dt.truncate("1 week"),
        "dt_truncate_relative_ts": lambda p: p.col("ts").dt.truncate("1 hour", relative_to=origin),
        "dt_truncate_relative_ns": lambda p: p.col("tsn").dt.truncate("90 minutes",
                                                                         relative_to=origin),
        "dt_truncate_relative_date": lambda p: p.col("d").dt.truncate("2 days",
                                                                      relative_to=origin),
        "dt_strftime_date": lambda p: p.col("d").dt.strftime(),
        "dt_strftime_ts": lambda p: p.col("ts").dt.strftime(),
        "dt_strftime_fmt": lambda p: p.col("tsn").dt.strftime("%Y/%m/%d %H"),
        **{f"dt_epoch_{u}_{c}": (lambda u, c: lambda p: p.col(c).dt.to_unix_epoch(u))(u, c)
           for u in ("s", "ms", "us", "ns") for c in ("d", "ts")},
        # list family
        "list_lengths": lambda p: p.col("l").list.lengths(),
        "list_length": lambda p: p.col("ls").list.length(),
        "list_get_0": lambda p: p.col("l").list.get(0),
        "list_get_neg": lambda p: p.col("l").list.get(-1),
        "list_get_default": lambda p: p.col("l").list.get(3, 99),
        "list_get_col": lambda p: p.col("l").list.get(p.col("k") - 1),
        "list_slice": lambda p: p.col("l").list.slice(1),
        "list_slice_end": lambda p: p.col("ls").list.slice(0, 2),
        "list_chunk": lambda p: p.col("l").list.chunk(2),
        "list_join": lambda p: p.col("ls").list.join("-"),
        "list_sum": lambda p: p.col("l").list.sum(),
        "list_mean": lambda p: p.col("l").list.mean(),
        "list_min": lambda p: p.col("l").list.min(),
        "list_max": lambda p: p.col("ls").list.max(),
        **{f"list_count_{m}": (lambda m: lambda p: p.col("l").list.count(m))(m)
           for m in ("valid", "null", "all")},
        "list_sort": lambda p: p.col("l").list.sort(),
        "list_sort_desc": lambda p: p.col("ls").list.sort(True),
        "list_unique": lambda p: p.col("ls").list.unique(),
        "list_distinct": lambda p: p.col("l").list.distinct(),
        "list_contains": lambda p: p.col("l").list.contains(3),
        # struct and map
        "struct_get_a": lambda p: p.col("st").struct.get("a"),
        "struct_get_b": lambda p: p.col("st").struct.get("b"),
        "struct_make": lambda p: p.expressions.Expression(p.expressions.Function(
            "struct.make", [p.col("k")._node, p.col("s")._node], {"names": ["key", "text"]})),
        "map_get": lambda p: p.col("m").map.get("y"),
        # partitioning
        **{f"part_{t}_{c}": (lambda t, c: lambda p: getattr(p.col(c).partitioning, t)())(t, c)
           for t in ("days", "hours", "months", "years") for c in ("d", "ts", "tsn")
           if (t, c) != ("hours", "tsn")},  # see test_hours_of_sub_microsecond_ticks_raise
        **{f"part_bucket_{c}": (lambda c: lambda p: p.col(c).partitioning.iceberg_bucket(16))(c)
           for c in ("i", "i32", "s", "bin", "d", "ts")},
        "part_truncate_int": lambda p: p.col("i").partitioning.iceberg_truncate(10),
        "part_truncate_str": lambda p: p.col("s").partitioning.iceberg_truncate(3),
        # json
        "json_query_nested": lambda p: p.col("j").json.query(".a.b[0]"),
        "json_query_str": lambda p: p.col("j").json.query(".c"),
        "json_query_obj": lambda p: p.col("j").json.query(".a"),
        "json_query_missing": lambda p: p.col("j").json.query(".a.b[5]"),
    }
    return cases


def _plain(v):
    """A value with NaN made comparable."""
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_function_matches_reference(case, nparts, monkeypatch):
    fn = _cases()[case]
    if case == "hash_seed_lit":
        # a one-row seed broadcasts in the reference's numpy route, which the
        # port copies; its compiled route reads the seed array past its one
        # row (ROADMAP.md, Queue 3), so the reference runs its numpy route
        from daft_tpu import native as ref_native

        monkeypatch.setattr(ref_native, "available", lambda: False)
    t = _table()
    parts = [t] if nparts == 1 else [t.slice(0, 16), t.slice(16, 16), t.slice(32)]

    def build(pkg):
        return pkg.from_arrow(parts).select(pkg.col("k"), fn(pkg).alias("o"))

    want_dt = repr(build(daft_tpu).schema["o"].dtype)
    ref, got = run_both(build)
    assert repr(build(daft_tpu_torch).schema["o"].dtype) == want_dt
    assert repr(got.schema["o"].dtype) == want_dt
    r, g = ref.to_pydict(), got.to_pydict()
    assert _plain(g["o"]) == _plain(r["o"]), case
    assert g["k"] == r["k"]
    assert counters(got) == counters(ref)


def test_function_keys_group_and_filter_like_the_reference():
    """The new functions as group keys (a month truncate, the months
    transform, a hash bucket) and in a filter, with the sums of the group
    on the device path: rows (float sums within rtol 1e-6, K1 against the
    reference's Pallas kernel) and routing counters equal."""
    t = _table(400, seed=5)
    parts = [t.slice(0, 130), t.slice(130, 130), t.slice(260)]

    def queries(p):
        c = p.col
        return [
            p.from_arrow([t]).groupby(c("d").dt.truncate("1 month").alias("g"))
            .agg(c("f").sum().alias("s"), c("i").count().alias("n")).sort("g"),
            p.from_arrow(parts).groupby(c("ts").partitioning.months().alias("g"))
            .agg(c("f").sum().alias("s")).sort("g"),
            p.from_arrow([t]).groupby((c("f").hash() % 8).alias("g"))
            .agg(c("f").mean().alias("s")).sort("g"),
            p.from_arrow(parts).where(c("l").list.lengths() > 1)
            .groupby("k").agg(c("f").sum().alias("s")).sort("k"),
        ]

    for qi in range(4):
        ref, got = run_both(lambda p: queries(p)[qi])
        r, g = ref.to_pydict(), got.to_pydict()
        assert list(g) == list(r)
        for name in r:
            if name == "s":
                assert g[name] == pytest.approx(r[name], rel=1e-6, nan_ok=True)
            else:
                assert g[name] == r[name]
        assert counters(got) == counters(ref)


def test_hours_of_sub_microsecond_ticks_raise():
    """partitioning.hours casts to microseconds first, which both packages
    refuse for a nanosecond timestamp with sub-microsecond ticks."""
    t = _table()
    for p in (daft_tpu, daft_tpu_torch):
        if p is daft_tpu_torch:
            p.set_execution_config(device="cpu")
        with pytest.raises(pa.ArrowInvalid, match="would lose data"):
            p.from_arrow([t]).select(p.col("tsn").partitioning.hours()).to_pydict()


def test_split_then_explode_keeps_working():
    """explode (an earlier slice) over a str.split result."""
    t = _table()

    def build(p):
        return (p.from_arrow([t.slice(0, 20), t.slice(20)])
                .with_column("w", p.col("s").str.split(" ")).explode("w")
                .select("k", "w"))

    ref, got = run_both(build)
    assert got.to_pydict() == ref.to_pydict()
    assert repr(got.schema["w"].dtype) == repr(ref.schema["w"].dtype) == "string"
    assert counters(got) == counters(ref)


@pytest.mark.parametrize("change", ["interval", "seed"])
def test_changed_kwarg_is_not_served_the_other_plan(change, monkeypatch):
    """One query run twice with another dt.truncate interval or hash seed:
    the plan cache and the result cache must not serve the first run's plan
    or rows to the second (``runners._plan_key`` holds the kwargs and the
    literal seed)."""
    from torch_parity import clear_adapt

    from daft_tpu import native as ref_native

    monkeypatch.setattr(ref_native, "available", lambda: False)  # a literal seed, as above
    t = _table(200, seed=9)
    clear_adapt()
    outs = []
    for v in (("1 month", 1), ("1 year", 2)):
        def build(p, v=v):
            key = (p.col("d").dt.truncate(v[0]) if change == "interval"
                   else p.col("i").hash(p.lit(v[1])) % 5)
            return p.from_arrow([t]).groupby(key.alias("g")).agg(
                p.col("k").sum().alias("s")).sort("g")

        ref, got = run_both(build, knobs={"enable_result_cache": True})
        assert got.to_pydict() == ref.to_pydict()
        outs.append(got.to_pydict())
    assert outs[0] != outs[1]


# ---------------------------------------------------------------------------
# the reference's own tests of these functions, against the port
# ---------------------------------------------------------------------------

def test_reference_expression_cases():
    """tests/test_expressions.py: the list and agg_list dtypes, str.split,
    the list namespace and struct.get."""
    from daft_tpu_torch import DataType, Schema, Table, col
    from daft_tpu_torch.schema import Field

    schema = Schema([Field("l", DataType.list(DataType.int64())), Field("i64", DataType.int64())])
    assert repr(col("l").list.lengths().to_field(schema).dtype) == "uint64"
    assert repr(col("i64").agg_list().to_field(schema).dtype) == "list[int64]"
    t = Table.from_pydict({"s": ["Hello World", "daft_tpu", None]})
    d = t.eval_expression_list([col("s").str.split(" ").alias("sp")]).to_pydict()
    assert d["sp"] == [["Hello", "World"], ["daft_tpu"], None]
    t = Table.from_pydict({"l": [[3, 1, 2], [], None, [5]]})
    d = t.eval_expression_list([
        col("l").list.lengths().alias("n"), col("l").list.get(0).alias("g0"),
        col("l").list.sum().alias("s"), col("l").list.sort().alias("srt"),
    ]).to_pydict()
    assert d == {"n": [3, 0, None, 1], "g0": [3, None, None, 5], "s": [6, None, None, 5],
                 "srt": [[1, 2, 3], [], None, [5]]}
    t = Table.from_pydict({"st": [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}, None]})
    assert t.eval_expression_list([col("st").struct.get("a")]).to_pydict() == {"a": [1, 2, None]}


@pytest.mark.parametrize("vals", [["iceberg", "", "a", "é世界", None, "abcd", "abcdefg"],
                                  [b"\x00\xff", b"", None, b"1234567"]])
def test_murmur_matches_scalar_and_reference(vals):
    """tests/test_native.py's murmur case, and the reference's bits."""
    from daft_tpu.kernels import murmur as ref_murmur
    from daft_tpu_torch.kernels import murmur

    t = pa.large_binary() if isinstance(vals[0], bytes) else pa.large_string()
    arr = pa.array(vals, t)
    got = murmur.murmur3_32_arrow(arr).to_pylist()
    want = [None if v is None else
            murmur._mm3_scalar_bytes(v.encode() if isinstance(v, str) else v) for v in vals]
    assert got == want == ref_murmur.murmur3_32_arrow(arr).to_pylist()
    ints = pa.array([0, 1, -1, 2**40, None, -(2**63)], pa.int64())
    assert murmur.murmur3_32_arrow(ints).to_pylist() == ref_murmur.murmur3_32_arrow(ints).to_pylist()
    # the Iceberg spec's published value: murmur3_32 of the long 34 is 2017239379
    assert murmur.murmur3_32_arrow(pa.array([34], pa.int64())).to_pylist() == [2017239379]


def _pyobj_values():
    return [object(), {"k": [1, 2]}, ("t", 3), None, {"bw", "cx", "dy", "ez"},
            frozenset(range(20)), 5, "x"]


def test_python_object_hash_matches_reference():
    """tests/test_integrity.py's stable python-object hash: nulls stay null,
    the values equal the reference's, ==-equal containers hash equal."""
    from daft_tpu.datatypes import DataType as RefDataType
    from daft_tpu.series import Series as RefSeries
    from daft_tpu_torch import DataType, Series

    got = Series.from_pylist(_pyobj_values(), "v", DataType.python()).hash().to_pylist()
    want = RefSeries.from_pylist(_pyobj_values(), "v", RefDataType.python()).hash().to_pylist()
    assert got == want
    assert got[3] is None and all(isinstance(v, int) for v in got[:3] + got[4:])
    d2 = {}
    d2["b"] = 2
    d2["a"] = 1
    out = Series.from_pylist([{"x", "y", "z"}, {"a": 1, "b": 2}, {"z", "y", "x"}, d2], "v",
                             DataType.python()).hash().to_pylist()
    assert out[0] == out[2] and out[1] == out[3]


def test_unpicklable_python_object_hash_raises():
    import threading

    from daft_tpu_torch import DataType, Series
    from daft_tpu_torch.errors import DaftValueError

    with pytest.raises(DaftValueError, match="unpicklable"):
        Series.from_pylist([threading.Lock()], "v", DataType.python()).hash()


def test_remaining_families_point_at_their_queue_item():
    from daft_tpu_torch.functions import get_function

    for name, item in (("utf8.tokenize_encode", 10), ("utf8.tokenize_decode", 10)):
        with pytest.raises(ValueError, match=f"ROADMAP.md, Queue 1, item {item}"):
            get_function(name)
    # the url family came with item 9; the image, embedding and sketch
    # families with item 10's first bullet
    for name in ("url.download", "url.upload", "image.decode", "image.resize",
                 "embedding.cosine_distance", "sketch.hll_estimate",
                 "sketch.quantile_estimate"):
        assert get_function(name).name == name
