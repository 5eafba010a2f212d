"""The port's expression function surface held against daft_tpu, on the CPU:
IsNull, FillNull, IsIn, IfElse and Function (the registry of
daft_tpu_torch/functions.py with the str, dt and float namespaces),
count_distinct, into_partitions, and the dictionary lanes that run string
predicates on the device path.

- On the host both packages run the same pyarrow kernels, so every node and
  every ported registry function must give the reference's exact values.
- On the device path (the reference under tests/device_mode.real_tpu_mode_cfg,
  the port at device="cpu", both at device_min_rows=1) a string predicate
  runs as a lookup table over each partition's dictionary (the LUT lane) or
  as a whole predicate evaluated over the dictionary (the dictionary
  predicate), and a numeric is_in as static compares. Results and routing
  counters must equal the reference's, at 1 partition and at 3 partitions
  whose dictionaries differ.
- A string-valued if_else or fill_null runs on the card through the joint
  dictionary of its columns and literals, as in the reference.
- The declines stay declines, with no error: a NaN item, a float item on an
  integer column, an integer item outside int32, timestamp arithmetic, and
  the concatenation of two string columns (new strings, no dictionary).
"""

import dataclasses
import datetime
import math

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from device_mode import real_tpu_mode_cfg


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _table(n=64, seed=3, strings=("apple", "banana", "cherry", "Avocado", "  pad ", "ab-12",
                                 "special requests", "")):
    """Seeded columns of every type the functions read, with nulls."""
    rng = np.random.RandomState(seed)
    days = rng.randint(8000, 12000, n)
    return pa.table({
        "k": pa.array(rng.randint(0, 4, n), pa.int64()),
        "i": pa.array(rng.randint(-20, 20, n), pa.int64(), mask=rng.rand(n) < 0.15),
        "u": pa.array(rng.randint(0, 8, n), pa.int32()),
        "f": pa.array(rng.randn(n) * 10, mask=rng.rand(n) < 0.15),
        "p": pa.array(rng.rand(n) * 0.9 + 0.05),
        "s": pa.array(list(np.array(strings, dtype=object)[rng.randint(0, len(strings), n)]),
                      pa.large_string(), mask=rng.rand(n) < 0.15),
        "d": pa.array(days.astype("datetime64[D]"), mask=rng.rand(n) < 0.1),
        "ts": pa.array((days * 86400 + rng.randint(0, 86400, n)).astype("datetime64[s]")),
        "b": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.1),
    })


def _with_nan(t):
    f = t.column("f").to_numpy(zero_copy_only=False).copy()
    f[::7] = np.nan
    f[3::11] = np.inf
    return t.set_column(t.schema.get_field_index("f"), "f", pa.array(f))


# ---------------------------------------------------------------------------
# the host path: every node and every ported registry function
# ---------------------------------------------------------------------------

def _host_cases():
    """name -> (function of a package's col and lit -> Expression)."""
    d = datetime.date
    return {
        # nodes
        "is_null": lambda c, l: c("i").is_null(),
        "not_null": lambda c, l: c("s").not_null(),
        "fill_null_int": lambda c, l: c("i").fill_null(0),
        "fill_null_col": lambda c, l: c("f").fill_null(c("p")),
        "fill_null_str": lambda c, l: c("s").fill_null("none"),
        "is_in_int": lambda c, l: c("i").is_in([1, 5, -3]),
        "is_in_null_item": lambda c, l: c("i").is_in([None, 2]),
        "is_in_empty": lambda c, l: c("u").is_in([]),
        "is_in_str": lambda c, l: c("s").is_in(["apple", "cherry", None]),
        "is_in_date": lambda c, l: c("d").is_in([d(1995, 1, 1), d(2000, 6, 1)]),
        "if_else_num": lambda c, l: (c("i") > 0).if_else(c("f"), l(0.0)),
        "if_else_int": lambda c, l: c("b").if_else(l(1), l(0)),
        "if_else_str": lambda c, l: (c("u") > 3).if_else(c("s"), l("small")),
        "neg": lambda c, l: -c("i"),
        "abs_op": lambda c, l: abs(c("f")),
        # numeric.*
        **{f"numeric_{m}": (lambda m: lambda c, l: getattr(c("f"), m)())(m)
           for m in ("abs", "ceil", "floor", "sign", "sqrt", "cbrt", "exp", "log2", "log10",
                     "ln", "sin", "cos", "tan", "arctan", "radians", "degrees")},
        **{f"numeric_{m}": (lambda m: lambda c, l: getattr(c("p"), m)())(m)
           for m in ("arcsin", "arccos", "arctanh")},
        "numeric_arccosh": lambda c, l: (c("p") + 1).arccosh(),
        "numeric_arcsinh": lambda c, l: c("f").arcsinh(),
        "numeric_log_base": lambda c, l: c("p").log(3.0),
        "numeric_round": lambda c, l: c("f").round(1),
        "numeric_int_abs": lambda c, l: c("i").abs(),
        "numeric_shift_left": lambda c, l: c("u").shift_left(l(2, daft_dtype(c, "int32"))),
        "numeric_shift_right": lambda c, l: c("u").shift_right(l(1, daft_dtype(c, "int32"))),
        "numeric_log1p": lambda c, l: c("p")._fn("numeric.log1p"),
        "numeric_exp2": lambda c, l: c("u")._fn("numeric.exp2"),
        # float.*
        "float_is_nan": lambda c, l: c("f").float.is_nan(),
        "float_is_inf": lambda c, l: c("f").float.is_inf(),
        "float_not_nan": lambda c, l: c("f").float.not_nan(),
        "float_fill_nan": lambda c, l: c("f").float.fill_nan(-1.0),
        # utf8.*
        "str_contains": lambda c, l: c("s").str.contains("an"),
        "str_startswith": lambda c, l: c("s").str.startswith("a"),
        "str_endswith": lambda c, l: c("s").str.endswith("y"),
        "str_match": lambda c, l: c("s").str.match(".*special.*requests.*"),
        "str_length": lambda c, l: c("s").str.length(),
        "str_length_bytes": lambda c, l: c("s").str.length_bytes(),
        "str_lower": lambda c, l: c("s").str.lower(),
        "str_upper": lambda c, l: c("s").str.upper(),
        "str_capitalize": lambda c, l: c("s").str.capitalize(),
        "str_reverse": lambda c, l: c("s").str.reverse(),
        "str_lstrip": lambda c, l: c("s").str.lstrip(),
        "str_rstrip": lambda c, l: c("s").str.rstrip(),
        "str_replace": lambda c, l: c("s").str.replace("a", "A"),
        "str_replace_regex": lambda c, l: c("s").str.replace("[aeiou]+", "_", regex=True),
        "str_extract": lambda c, l: c("s").str.extract(r"(\w)(\d+)", 2),
        "str_find": lambda c, l: c("s").str.find("an"),
        "str_left": lambda c, l: c("s").str.left(2),
        "str_right": lambda c, l: c("s").str.right(3),
        "str_substr": lambda c, l: c("s").str.substr(1, 3),
        "str_like": lambda c, l: c("s").str.like("%an%"),
        "str_ilike": lambda c, l: c("s").str.ilike("a%"),
        "str_rpad": lambda c, l: c("s").str.rpad(7, "*"),
        "str_lpad": lambda c, l: c("s").str.lpad(7, "*"),
        "str_repeat": lambda c, l: c("s").str.repeat(2),
        "str_count_matches": lambda c, l: c("s").str.count_matches(["a", "e"]),
        "str_normalize": lambda c, l: c("s").str.normalize(remove_punct=True, lowercase=True,
                                                           white_space=True),
        # dt.*
        **{f"dt_{m}": (lambda m: lambda c, l: getattr(c("d").dt, m)())(m)
           for m in ("year", "month", "day", "day_of_week", "day_of_year")},
        **{f"dt_ts_{m}": (lambda m: lambda c, l: getattr(c("ts").dt, m)())(m)
           for m in ("year", "hour", "minute", "second")},
    }


def daft_dtype(c, name):
    pkg = daft_tpu if c is daft_tpu.col else daft_tpu_torch
    return getattr(pkg.DataType, name)()


def test_str_concat_on_large_strings():
    # the reference's utf8.concat passes its "" separator as a string scalar,
    # which pyarrow refuses beside large_string columns; the port passes a
    # large_string separator
    t = _table()
    ref_cfg = daft_tpu.context.get_context().execution_config
    saved = ref_cfg.use_device_kernels
    ref_cfg.use_device_kernels = False
    try:
        with pytest.raises(pa.ArrowNotImplementedError):
            daft_tpu.from_arrow(t).select(daft_tpu.col("s").str.concat(daft_tpu.col("s"))).to_pydict()
    finally:
        ref_cfg.use_device_kernels = saved
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    got = daft_tpu_torch.from_arrow(t).select(
        daft_tpu_torch.col("s").str.concat(daft_tpu_torch.col("s"), "!")).to_pydict()["s"]
    assert got == [None if v is None else v + v + "!" for v in t.column("s").to_pylist()]


@pytest.mark.parametrize("case", sorted(_host_cases()))
def test_host_function_matches_reference(case):
    fn = _host_cases()[case]
    t = _with_nan(_table())
    ref_cfg = daft_tpu.context.get_context().execution_config
    saved = ref_cfg.use_device_kernels
    ref_cfg.use_device_kernels = False
    try:
        ref = daft_tpu.from_arrow(t).select(fn(daft_tpu.col, daft_tpu.lit).alias("o"))
        want_schema = ref.schema
        want = ref.to_pydict()["o"]
    finally:
        ref_cfg.use_device_kernels = saved
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    got = daft_tpu_torch.from_arrow(t).select(
        fn(daft_tpu_torch.col, daft_tpu_torch.lit).alias("o"))
    assert repr(got.schema["o"].dtype) == repr(want_schema["o"].dtype)
    assert len(got.to_pydict()["o"]) == len(want)
    for a, b in zip(got.to_pydict()["o"], want):
        if isinstance(b, float) and math.isnan(b):
            assert isinstance(a, float) and math.isnan(a)
        else:
            assert a == b and type(a) is type(b), case


def test_expression_display_matches_reference():
    # the optimizer tests compare display_tree() text, so display() must too
    for name, fn in sorted(_host_cases().items()):
        ref = fn(daft_tpu.col, daft_tpu.lit)
        got = fn(daft_tpu_torch.col, daft_tpu_torch.lit)
        assert repr(got) == repr(ref), name


def _registry_names():
    from daft_tpu.functions import REGISTRY

    return sorted(REGISTRY)


@pytest.mark.parametrize("name", _registry_names())
def test_registry_name_is_ported_or_points_at_the_roadmap(name):
    from daft_tpu.functions import REGISTRY as REF
    from daft_tpu_torch.datatypes import DataType
    from daft_tpu_torch.functions import REGISTRY, get_function

    if name in REGISTRY:
        assert get_function(name).name == name
        return
    with pytest.raises(ValueError, match="ROADMAP.md"):
        get_function(name)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        daft_tpu_torch.col("x")._fn(name).to_field(
            daft_tpu_torch.Schema([daft_tpu_torch.Field("x", DataType.string())]))
    assert name in REF


def test_unknown_function_raises():
    from daft_tpu_torch.functions import get_function

    with pytest.raises(ValueError, match="unknown function"):
        get_function("utf8.no_such_function")


# ---------------------------------------------------------------------------
# the device path: the LUT lane, the dictionary predicate, numeric is_in
# ---------------------------------------------------------------------------

def _partitioned(nparts):
    """1 partition, or 3 whose string dictionaries differ: partition j holds
    only strings that start with its own letter, so a pattern can match
    nothing in a partition."""
    if nparts == 1:
        return [_table(n=300, seed=1)]
    letters = (("apple", "ant", "avocado", "a-1"), ("banana", "bee", "b", "bb-22"),
               ("cherry", "cat", "cc special requests", "c"))
    return [_table(n=200, seed=10 + j, strings=letters[j]) for j in range(3)]


def _device_cases():
    d = datetime.date
    return {
        "lut_contains": lambda c, f: f.where(c("s").str.contains("a")),
        "lut_startswith_absent_in_some": lambda c, f: f.where(c("s").str.startswith("ba")),
        "lut_endswith": lambda c, f: f.where(~c("s").str.endswith("e")),
        "lut_like": lambda c, f: f.where(c("s").str.like("%a%")),
        "lut_ilike": lambda c, f: f.where(c("s").str.ilike("A%")),
        "lut_match": lambda c, f: f.where(~c("s").str.match(".*special.*requests.*")),
        "lut_is_in_with_null": lambda c, f: f.where(c("s").is_in(["apple", "bee", None, "zzz"])),
        "lut_projection": lambda c, f: f.select(c("s").str.startswith("c").alias("o"), c("k")),
        "hostpred_left_is_in": lambda c, f: f.where(c("s").str.left(2).is_in(["ap", "be", "ca"])),
        "hostpred_upper_eq": lambda c, f: f.where(c("s").str.upper() == "BANANA"),
        "hostpred_length": lambda c, f: f.where(c("s").str.length() > 3),
        "hostpred_fill_null": lambda c, f: f.select(
            c("s").fill_null("apple").str.contains("pp").alias("o")),
        "numeric_is_in": lambda c, f: f.where(c("i").is_in([1, 5, -3, None])),
        "numeric_is_in_float": lambda c, f: f.where(c("p").is_in([0.5, 0.25])),
        "numeric_is_in_date": lambda c, f: f.where(~c("d").is_in([d(1995, 1, 1)])),
        "is_null_fill_null": lambda c, f: f.where(c("f").is_null() | (c("i").fill_null(0) > 2)),
        # a null predicate: every row null, its values int32 zeros on the card
        "if_else_null_pred": lambda c, f: f.select(
            daft_lit(c)(None).if_else(c("p"), 0.0).alias("o"), c("k")),
        "if_else_agg": lambda c, f: f.groupby("k").agg(
            c("s").str.contains("e").if_else(c("p"), 0.0).sum().alias("a"),
            c("i").is_in([1, 2, 3]).if_else(1, 0).sum().alias("b"),
            c("f").fill_null(c("p")).sum().alias("c")).sort("k"),
        "lut_in_agg_filter": lambda c, f: f.where(c("s").str.startswith("b") | c("b")).groupby(
            "k").agg(c("p").sum().alias("sp"), c("p").count().alias("n")).sort("k"),
        # string choices through the joint dictionary of their columns and literals
        "string_if_else": lambda c, f: f.select(
            (c("u") > 3).if_else(c("s"), daft_lit(c)("small")).alias("o")),
        "string_fill_null": lambda c, f: f.select(c("s").fill_null("x").alias("o")),
    }


def _device_run(case, nparts):
    tables = _partitioned(nparts)
    fn = _device_cases()[case]
    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        ref = fn(daft_tpu.col, daft_tpu.from_arrow(tables)).collect()
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = fn(daft_tpu_torch.col, daft_tpu_torch.from_arrow(tables)).collect()
    return (ref.to_pydict(), ref.stats.snapshot()["counters"],
            got.to_pydict(), got.stats.snapshot()["counters"])


_ROUTES = ("device_filters", "host_filters", "device_projections", "host_projections",
           "device_aggregations", "host_aggregations", "device_agg_fallbacks")


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("case", sorted(_device_cases()))
def test_device_lane_matches_reference(case, nparts):
    ref, rc, got, gc = _device_run(case, nparts)
    if case == "if_else_agg":
        # float sums: K1 and the reference's one-hot product add in different orders
        assert got["k"] == ref["k"] and got["b"] == ref["b"]
        for name in ("a", "c"):
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-6)
    elif case == "lut_in_agg_filter":
        assert got["k"] == ref["k"] and got["n"] == ref["n"]
        np.testing.assert_allclose(got["sp"], ref["sp"], rtol=1e-6)
    else:
        assert got == ref
    assert {k: gc.get(k, 0) for k in _ROUTES} == {k: rc.get(k, 0) for k in _ROUTES}
    # every case runs on the card in both packages
    assert not any(gc.get(k, 0) for k in ("host_filters", "host_projections",
                                          "host_aggregations"))


def test_lookup_tables_are_per_partition_and_cached():
    from daft_tpu_torch.kernels import device as dev
    from daft_tpu_torch.kernels.device import normalize_and_check, stage_table_columns
    from daft_tpu_torch.table import Table
    import torch

    expr = daft_tpu_torch.col("s").str.startswith("ba")
    luts = []
    for t in _partitioned(3):
        tbl = Table.from_arrow(t)
        nodes = normalize_and_check([expr], tbl.schema)
        cache = {}
        env, dcs = stage_table_columns(tbl, ["s"], 1024, cache, torch.device("cpu"))
        merged = dev.string_lut_env(nodes, tbl.schema, dcs, env)
        key = dev._strlut_env_key(nodes[0]._key())
        lut = merged[key]
        assert lut.dtype == torch.bool and lut.shape == (1024,)
        uniq = dcs["s"].dictionary.to_pylist()
        assert lut[:len(uniq)].tolist() == [u.startswith("ba") for u in uniq]
        # a second query over the partition reuses the table
        again = dev.string_lut_env(nodes, tbl.schema, dcs, env)[key]
        assert again is lut
        luts.append(lut[:len(uniq)].any().item())
    assert luts == [False, True, False]  # the pattern matches in one partition only


# ---------------------------------------------------------------------------
# declines
# ---------------------------------------------------------------------------

def _decline_cases():
    return {
        "nan_item": lambda c, f: f.where(c("f").is_in([float("nan"), 1.0])),
        "float_item_on_int": lambda c, f: f.where(c("i").is_in([1.5, 2.0])),
        "item_past_int32": lambda c, f: f.where(c("i").is_in([2 ** 40, 3])),
        "log_with_base": lambda c, f: f.select(c("p").log(2.0).alias("o")),
        # epoch arithmetic stays on the host in both packages (only compares
        # and sort keys ride the epoch lanes)
        "timestamp_arithmetic": lambda c, f: f.select(
            (c("ts") + daft_interval(c)(days=1)).alias("o")),
        # concatenation makes new strings, which no dictionary holds
        "string_concat_two_columns": lambda c, f: f.select((c("s") + c("s2")).alias("o")),
    }


def daft_lit(c):
    return daft_tpu.lit if c is daft_tpu.col else daft_tpu_torch.lit


def daft_interval(c):
    return daft_tpu.interval if c is daft_tpu.col else daft_tpu_torch.interval


@pytest.mark.parametrize("case", sorted(_decline_cases()))
def test_ineligible_nodes_decline_to_the_host(case):
    from daft_tpu_torch.kernels.device import expr_is_device_compilable

    t = _with_nan(_table(n=100))
    tables = [t.append_column("s2", pa.array(t.column("s").to_pylist()[::-1], pa.large_string()))]
    fn = _decline_cases()[case]
    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        d = dataclasses.asdict(cfg)
        # the reference's host path: its card computes log with a base as ln
        cfg.use_device_kernels = False
        ref = fn(daft_tpu.col, daft_tpu.from_arrow(tables)).to_pydict()
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got_df = fn(daft_tpu_torch.col, daft_tpu_torch.from_arrow(tables)).collect()
    got, gc = got_df.to_pydict(), got_df.stats.snapshot()["counters"]
    for name in ref:
        for a, b in zip(got[name], ref[name]):
            assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))
    assert gc.get("host_filters", 0) + gc.get("host_projections", 0) == 1
    assert not gc.get("device_filters") and not gc.get("device_projections")
    expr = fn(daft_tpu_torch.col, daft_tpu_torch.from_arrow(tables))._plan
    node = (expr.predicate if hasattr(expr, "predicate") else expr.exprs[0])._node
    assert not expr_is_device_compilable(node, expr.input.schema)


# ---------------------------------------------------------------------------
# count_distinct and into_partitions
# ---------------------------------------------------------------------------

def _cd_tables(nparts):
    rng = np.random.RandomState(8)
    out = []
    for j in range(nparts):
        n = 90
        out.append(pa.table({
            "k": pa.array(rng.randint(0, 5, n), pa.int64(), mask=rng.rand(n) < 0.1),
            "v": pa.array(rng.randint(0, 12, n), pa.int64(), mask=rng.rand(n) < 0.2),
            "s": pa.array([f"x{x}" for x in rng.randint(0, 9, n)], mask=rng.rand(n) < 0.2),
        }))
    return out


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_count_distinct_matches_reference(grouped, nparts):
    def query(pkg):
        f = pkg.from_arrow(_cd_tables(nparts))
        aggs = [pkg.col("v").count_distinct().alias("nv")]
        if grouped:
            aggs.append(pkg.col("s").count_distinct().alias("ns"))
            return f.groupby("k").agg(*aggs)  # no sort: the port gathers it, the reference
        return f.agg(*aggs)                     # range-shuffles it

    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        ref = query(daft_tpu).collect()
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = query(daft_tpu_torch).collect()

    def rows(df):
        d = df.to_pydict()
        return sorted(zip(*d.values()), key=lambda r: tuple((v is None, v or 0) for v in r))

    assert rows(got) == rows(ref)
    assert repr(got.schema["nv"].dtype) == repr(ref.schema["nv"].dtype) == "uint64"
    gc, rc = got.stats.snapshot()["counters"], ref.stats.snapshot()["counters"]
    # the non-decomposable plan: one shuffle of the raw rows (by key, or by
    # the counted value for a global count), no fallback counted
    assert gc.get("shuffles", 0) == rc.get("shuffles", 0) == (1 if nparts > 1 else 0)
    assert gc.get("device_agg_fallbacks", 0) == rc.get("device_agg_fallbacks", 0) == 0


def test_global_count_distinct_plans_a_shuffle_by_value():
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import AggregateOp, GatherOp, ShuffleOp, translate

    f = daft_tpu_torch.from_arrow(_cd_tables(3))
    phys = translate(optimize(f.agg(daft_tpu_torch.col("v").count_distinct())._plan))
    assert isinstance(phys, AggregateOp) and isinstance(phys.children[0], GatherOp)
    shuffle = phys.children[0].children[0].children[0]
    assert isinstance(shuffle, ShuffleOp)
    assert [e._node.display() for e in shuffle.by] == ["col(v)"]


@pytest.mark.parametrize("sizes,num", [([10], 3), ([3, 3, 4], 2), ([5, 0, 7, 2], 3),
                                       ([4, 4], 2), ([6], 1), ([1, 2], 5)])
def test_into_partitions_matches_reference(sizes, num):
    tables = [pa.table({"a": list(range(sum(sizes[:j]), sum(sizes[:j + 1])))},
                       schema=pa.schema([("a", pa.int64())])) for j in range(len(sizes))]

    def parts(pkg):
        df = pkg.from_arrow(tables).into_partitions(num).collect()
        return [(p.to_arrow() if pkg is daft_tpu else p.table().to_arrow()).column("a").to_pylist()
                for p in df._result.partitions]

    ref = parts(daft_tpu)
    daft_tpu_torch.set_execution_config(device="cpu")
    assert parts(daft_tpu_torch) == ref
    assert [len(p) for p in ref] == [len(p) for p in parts(daft_tpu_torch)]
    from daft_tpu.optimizer import optimize as ref_opt
    from daft_tpu_torch.optimizer import optimize as port_opt

    assert (port_opt(daft_tpu_torch.from_arrow(tables).into_partitions(num)._plan).display_tree()
            == ref_opt(daft_tpu.from_arrow(tables).into_partitions(num)._plan).display_tree())


def test_random_and_range_repartitions_still_raise():
    """The random and range schemes are ported now: each gives the
    reference's partitions, row for row, and its plan text. The name dates
    from before their port and is kept, so that test reports stay
    comparable across versions."""
    from daft_tpu.logical import Repartition as RefRepartition
    from daft_tpu.physical import translate as ref_translate
    from daft_tpu_torch.logical import Repartition
    from daft_tpu_torch.physical import translate as port_translate

    data = {"a": [5, 1, 4, 2, 3, 9, 7, 8, 6, 0] * 3}
    daft_tpu_torch.set_execution_config(device="cpu")

    def parts(pkg, plan_of):
        df = pkg.DataFrame(plan_of(pkg, pkg.from_pydict(data).into_partitions(3)))
        plan = df._plan
        out = [(p.to_arrow() if pkg is daft_tpu else p.table().to_arrow()).column("a").to_pylist()
               for p in df.collect()._result.partitions]
        return out, plan

    for plan_of in (lambda pkg, f: f.repartition(2)._plan,
                    lambda pkg, f: (RefRepartition if pkg is daft_tpu else Repartition)(
                        f._plan, "range", 2, [pkg.col("a")], [True])):
        ref, rplan = parts(daft_tpu, plan_of)
        got, gplan = parts(daft_tpu_torch, plan_of)
        assert got == ref and len(got) == 2
        assert (port_translate(gplan).display_tree()
                == ref_translate(rplan, daft_tpu.context.get_context().execution_config)
                .display_tree())
