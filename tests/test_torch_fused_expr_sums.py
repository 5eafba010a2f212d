"""The deep-fused segment-sums kernel K2 of the port
(daft_tpu_torch/kernels/fused_expr_sums.py), on the CPU.

- Queries that engage K2 go through both packages under one configuration:
  daft_tpu under tests/device_mode.real_tpu_mode_cfg with
  use_pallas_deep_fusion (its K2 runs in Pallas interpret mode), the port
  under execution_config_from_dict(...) of that config with device="cpu"
  (K2's plain version). Keys, group order, counts and int sums match
  exactly; float aggregates agree at rtol 1e-6, with each other and with the
  pyarrow oracle. K2 engages in the port exactly where it engages in the
  reference (DEEP_FUSED_TRACES against BUILDS and ENTRIES), but for a
  Function, which the port's K2 declines.
- On the CPU the port's deep and composed (torch derive, stack, K1) results
  are bit-identical: K2's plain version is the composed computation.
- The generated row function is built with g++ and held against the torch
  closures of kernels/device.py, one case per op: bit-identical values and
  validity (``**`` within 1 ulp). Float-to-int casts of NaN or out-of-range
  values are left out here: torch's CPU cast differs from its CUDA cast
  there, and chip_smoke.py checks them on the card.
"""

import ctypes
import dataclasses
import datetime
import shutil
import subprocess

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import parity, q1 as port_q1, q6 as port_q6
from daft_tpu_torch.kernels import fused_expr_sums as fes
from daft_tpu_torch.kernels import segment_sums
from device_mode import real_tpu_mode_cfg
from test_torch_q1_slice import _assert_same

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_programs():
    """Both packages compile their aggregation programs afresh, so each
    query's engagement shows as one new trace (reference) and one new build
    (port)."""
    from daft_tpu.kernels import device_agg as ref_agg
    from daft_tpu_torch.kernels import device_agg

    saved = daft_tpu_torch.get_context().execution_config
    ref_agg._AGG_CACHE.clear()
    device_agg._AGG_CACHE.clear()
    yield
    daft_tpu_torch.set_execution_config(saved)


def _run_both(table, jax_query, port_query, deep=True):
    """One query through both packages under one configuration. Returns
    (reference dict, port dict, port counters, engagement) where engagement
    holds the reference's new deep traces and the port's new K2 builds,
    K2 entries and K1 entries."""
    from daft_tpu.kernels import pallas_ops

    with real_tpu_mode_cfg(device_min_rows=8) as cfg:
        import jax

        saved = cfg.use_pallas_deep_fusion
        cfg.use_pallas_deep_fusion = deep
        try:
            traces = pallas_ops.DEEP_FUSED_TRACES[0]
            ref = jax_query(daft_tpu.from_arrow(table).collect()).collect().to_pydict()
            traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
            d = dataclasses.asdict(cfg)
        finally:
            cfg.use_pallas_deep_fusion = saved
        d["jax_enable_x64"] = bool(jax.config.jax_enable_x64)
    port_cfg = daft_tpu_torch.execution_config_from_dict(d, device="cpu")
    assert port_cfg.use_deep_fusion_kernel == deep
    daft_tpu_torch.set_execution_config(port_cfg)
    before = fes.BUILDS, fes.ENTRIES, segment_sums.ENTRIES
    got = port_query(daft_tpu_torch.from_arrow(table).collect()).collect()
    after = fes.BUILDS, fes.ENTRIES, segment_sums.ENTRIES
    engaged = {"ref_traces": traces, "builds": after[0] - before[0],
               "k2_entries": after[1] - before[1], "k1_entries": after[2] - before[2]}
    return ref, got.to_pydict(), got.stats.snapshot()["counters"], engaged


def _port_only(table, port_query, deep):
    daft_tpu_torch.set_execution_config(use_deep_fusion_kernel=deep)
    return port_query(daft_tpu_torch.from_arrow(table).collect()).collect().to_pydict()


# ---------------------------------------------------------------------------
# TPC-H Q1/Q6 with deep fusion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem():
    return tpch.generate_lineitem_only(scale=20_000 / tpch.LINEITEM_ROWS_PER_SF, seed=7)


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_tpch_deep_matches_reference(lineitem, query):
    jax_q, port_q = {"q1": (tpch.q1, port_q1), "q6": (tpch.q6, port_q6)}[query]
    ref, got, counters, engaged = _run_both(lineitem, jax_q, port_q)
    _assert_same(ref, got)
    oracle = (tpch.oracle_q1(lineitem) if query == "q1"
              else {"revenue": [tpch.oracle_q6(lineitem)]})
    assert parity(ref, oracle, RTOL) and parity(got, oracle, RTOL)
    # one K2 per query on both sides, and no K1 call in the port
    assert engaged == {"ref_traces": 1, "builds": 1, "k2_entries": 1, "k1_entries": 0}
    assert counters.get("device_aggregations") == 1
    assert counters.get("device_agg_fallbacks", 0) == 0
    # the deep result is the composed result, bit for bit
    assert _port_only(lineitem, port_q, deep=False) == got


# ---------------------------------------------------------------------------
# tests/device32/test_real_tpu_mode.py::TestDeepFusedPallas32
# ---------------------------------------------------------------------------

def _q1_shape(n=40_000, seed=11):
    rng = np.random.RandomState(seed)
    return pa.table({
        "g": np.array(["A", "N", "R"])[rng.randint(0, 3, n)],
        "qty": (rng.rand(n) * 50).astype(np.float64),
        "price": (rng.rand(n) * 1e5).astype(np.float64),
        "disc": (rng.rand(n) * 0.1).astype(np.float64),
        "cut": rng.randint(0, 100, n).astype(np.int64),
    })


def _q1_shape_query(col):
    return lambda f: (f.where(col("cut") < 90).groupby("g")
                      .agg((col("price") * (1 - col("disc"))).sum().alias("rev"),
                           col("qty").sum().alias("sq"), col("qty").count().alias("cq"))
                      .sort("g"))


def test_deep_fused_q1_shape_parity_and_engagement():
    table = _q1_shape()
    ref, got, counters, engaged = _run_both(
        table, _q1_shape_query(daft_tpu.col), _q1_shape_query(daft_tpu_torch.col))
    _assert_same(ref, got)
    assert engaged == {"ref_traces": 1, "builds": 1, "k2_entries": 1, "k1_entries": 0}
    assert counters.get("device_aggregations") == 1
    assert _port_only(table, _q1_shape_query(daft_tpu_torch.col), deep=False) == got
    # and the port's host path agrees
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    host = _q1_shape_query(daft_tpu_torch.col)(daft_tpu_torch.from_arrow(table)).collect()
    _assert_same(host.to_pydict(), got)


def test_string_literal_predicate_does_not_engage_deep_kernel():
    # K2 declines on the string-literal env extras in both packages: the
    # aggregate runs on the card with its filter's code bounds in the env,
    # and its float sum takes K1
    table = _q1_shape()

    def query(col):
        return lambda f: (f.where(col("g") != "A").groupby("g")
                          .agg(col("price").sum().alias("sp")).sort("g"))

    ref, got, counters, engaged = _run_both(table, query(daft_tpu.col),
                                            query(daft_tpu_torch.col))
    _assert_same(ref, got)
    assert engaged == {"ref_traces": 0, "builds": 0, "k2_entries": 0, "k1_entries": 1}
    assert counters.get("device_aggregations") == 1
    assert counters.get("device_agg_fallbacks", 0) == 0


def _new_nodes_query(col):
    # the deep program chip_smoke.py times beside Q1: if_else in the summed
    # column, a numeric is_in and is_null in the filter
    return lambda f: (f.where(col("cut").is_in([1, 5, 24, 60]) | col("qty").is_null())
                      .groupby("g")
                      .agg((col("disc") > 0.05).if_else(col("price") * (1 - col("disc")), 0.0)
                           .sum().alias("r"),
                           col("qty").fill_null(0.0).sum().alias("q"))
                      .sort("g"))


def test_deep_kernel_takes_the_new_nodes():
    # if_else, is_in, is_null and fill_null run inside K2 in both packages
    table = _q1_shape()
    ref, got, counters, engaged = _run_both(table, _new_nodes_query(daft_tpu.col),
                                            _new_nodes_query(daft_tpu_torch.col))
    _assert_same(ref, got)
    assert engaged == {"ref_traces": 1, "builds": 1, "k2_entries": 1, "k1_entries": 0}
    assert counters.get("device_aggregations") == 1
    assert _port_only(table, _new_nodes_query(daft_tpu_torch.col), deep=False) == got


def _declining_query(col, lane):
    if lane == "lut":  # a lookup table over the dictionary in the env
        pred = col("g").is_in(["A", "R"])
    elif lane == "dictionary_predicate":  # a whole predicate over the dictionary
        pred = col("g").str.lower() == "n"
    else:  # a Function: its exp bits in CUDA are not certain to equal torch's
        pred = col("price").sqrt() > 100.0
    return lambda f: f.where(pred).groupby("g").agg(col("price").sum().alias("sp")).sort("g")


@pytest.mark.parametrize("lane", ["lut", "dictionary_predicate", "function"])
def test_string_lanes_and_functions_decline_the_deep_kernel(lane):
    # K2 declines before launch and K1 sums: K2's counters stay at 0
    table = _q1_shape()
    launches = fes.LAUNCHES
    ref, got, counters, engaged = _run_both(table, _declining_query(daft_tpu.col, lane),
                                            _declining_query(daft_tpu_torch.col, lane))
    _assert_same(ref, got)
    # the reference's K2 takes a Function (its Pallas body runs the torch
    # closures' counterparts); the port's declines it (ROADMAP Queue 2 D)
    assert engaged == {"ref_traces": int(lane == "function"), "builds": 0, "k2_entries": 0,
                       "k1_entries": 1}
    assert fes.LAUNCHES == launches
    assert counters.get("device_aggregations") == 1
    assert counters.get("device_agg_fallbacks", 0) == 0


# ---------------------------------------------------------------------------
# edge cases: K > 32, nulls in values and predicate, every row filtered out
# ---------------------------------------------------------------------------

def _edge_table(seed=5, n=6000):
    # positive float columns: the two packages sum in different orders, and
    # rtol 1e-6 of a sum says something only where the sum does not cancel
    rng = np.random.RandomState(seed)
    return pa.table({
        "k": pa.array(rng.randint(0, 5, n), pa.int64()),
        "a": pa.array(rng.rand(n) * 100 + 1, mask=rng.rand(n) < 0.15),
        "b": pa.array(rng.rand(n) * 10, pa.float32(), mask=rng.rand(n) < 0.1),
        "i": pa.array(rng.randint(-30, 30, n), pa.int32(), mask=rng.rand(n) < 0.1),
        "p": pa.array(rng.rand(n) < 0.6, mask=rng.rand(n) < 0.2),
    })


def _edge_query(col, case):
    if case == "k_over_32":
        # 36 float sums: K2 launches in two column chunks
        aggs = [((col("a") + j) * col("b")).sum().alias(f"s{j}") for j in range(34)]
        aggs += [col("a").mean().alias("ma"), ((col("i") + 40) / 3).sum().alias("si")]
        return lambda f: f.where(col("a") > 10).groupby("k").agg(*aggs).sort("k")
    if case == "nulls":
        # nulls in the summed columns and a Kleene predicate over nullable lanes
        pred = (col("p") | (col("i") > 0)) & (col("b") < 8.0)
        return lambda f: (f.where(pred).groupby("k")
                          .agg((col("a") * col("b")).sum().alias("ab"),
                               (col("i") // 7).cast(_dtype_of(col, "float64")).sum()
                               .alias("fi"),
                               col("a").mean().alias("ma"), col("i").sum().alias("si"),
                               col("a").count().alias("ca"))
                          .sort("k"))
    if case == "all_filtered":
        return lambda f: (f.where(col("a") > 1e9).groupby("k")
                          .agg(col("a").sum().alias("sa"), col("b").mean().alias("mb"))
                          .sort("k"))
    raise AssertionError(case)


def _dtype_of(col, name):
    """DataType of the package ``col`` comes from."""
    pkg = daft_tpu if col is daft_tpu.col else daft_tpu_torch
    return getattr(pkg.DataType, name)()


@pytest.mark.parametrize("case", ["k_over_32", "nulls", "all_filtered"])
def test_deep_edge_cases_match_reference(case):
    table = _edge_table()
    ref, got, counters, engaged = _run_both(table, _edge_query(daft_tpu.col, case),
                                            _edge_query(daft_tpu_torch.col, case))
    _assert_same(ref, got)
    assert engaged["ref_traces"] == engaged["builds"] == engaged["k2_entries"] == 1
    assert engaged["k1_entries"] == 0
    assert _port_only(table, _edge_query(daft_tpu_torch.col, case), deep=False) == got
    if case == "all_filtered":
        assert got == {"k": [], "sa": [], "mb": []}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _small_schema():
    from daft_tpu_torch.datatypes import DataType
    from daft_tpu_torch.schema import Field, Schema

    return Schema([Field("x", DataType.float64()), Field("d", DataType.int32())])


def _small_program():
    from daft_tpu_torch import col
    from daft_tpu_torch.kernels.device import normalize_and_check

    schema = _small_schema()
    pred, child = normalize_and_check([col("d") < 5, col("x") * 2], schema)
    return fes.program(pred, [child], schema, {"x": torch.float32, "d": torch.int32})


def test_wrapper_checks_shapes_and_types():
    prog = _small_program()
    b = 2048
    rng = np.random.RandomState(0)
    env = {"x": (torch.from_numpy(rng.rand(b).astype(np.float32)), torch.ones(b, dtype=torch.bool)),
           "d": (torch.from_numpy(rng.randint(0, 9, b).astype(np.int32)),
                 torch.ones(b, dtype=torch.bool))}
    codes = torch.from_numpy(rng.randint(0, 3, b).astype(np.int32))
    out = fes.fused_expr_sums(prog, codes, env, 2000, 16)
    assert out.shape == (16, 1) and out.dtype == torch.float32
    x, dd = env["x"][0].double().numpy(), env["d"][0].numpy()
    sel = (dd < 5) & (np.arange(b) < 2000)
    want = np.bincount(codes.numpy()[sel], weights=(x * 2)[sel], minlength=16)
    np.testing.assert_allclose(out[:, 0].numpy(), want, rtol=RTOL)
    bad = [
        (codes.to(torch.int64), env, 2000, 16),                      # codes dtype
        (codes[:1000], env, 500, 16),                                # not a multiple of 1024
        (codes, env, 2000, 0),                                       # no groups
        (codes, env, 2000, 4097),                                    # too many groups
        (codes, env, b + 1, 16),                                     # rows past the padding
        (codes, {"x": env["x"]}, 2000, 16),                          # missing column
        (codes, {**env, "x": (env["x"][0].double(), env["x"][1])}, 2000, 16),  # lane dtype
        (codes, {**env, "d": (env["d"][0], env["d"][1].to(torch.uint8))}, 2000, 16),
        (codes, {**env, "x": (env["x"][0][:1024], env["x"][1][:1024])}, 2000, 16),  # length
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fes.fused_expr_sums(prog, *args)
    # a column the kernel would sum must compute as float
    from daft_tpu_torch import col
    from daft_tpu_torch.kernels.device import normalize_and_check

    schema = _small_schema()
    with pytest.raises(ValueError, match="not float"):
        fes.FusedExprSums(None, normalize_and_check([col("d") + 1], schema), schema,
                          {"x": torch.float32, "d": torch.int32})


def test_kernel_source_is_generated_for_the_expressions():
    prog = _small_program()
    assert '#include "segment_sums_common.cuh"' in prog.source
    assert "fes_row(c, row, &sel, v)" in prog.source and "#define FES_K 1" in prog.source
    assert "__host__ __device__ inline void fes_row" in prog.row_source
    # the predicate and the derived column are in the generated body
    assert "< " in prog.row_source and " * " in prog.row_source


# ---------------------------------------------------------------------------
# the generated row function, built with g++ and held against the closures
# ---------------------------------------------------------------------------

_SHIM = "#define __host__\n#define __device__\n"


def _gxx_lib(source: str, tmp_path, name: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the generated row function on the host")
    src = tmp_path / f"{name}.cpp"
    so = tmp_path / f"{name}.so"
    src.write_text(_SHIM + source)
    res = subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                          "-o", str(so), str(src)], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


def _probe_table(n=4096, seed=3):
    """Seeded columns of every staged lane type, with nulls, zeros, negative
    values, int32 extremes, NaN and signed zeros."""
    rng = np.random.RandomState(seed)
    big = rng.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    big[:4] = [-2 ** 31, 2 ** 31 - 1, -1, 0]
    f = (rng.randn(n) * 100).astype(np.float32)
    f[:6] = [np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40]
    g = rng.choice(np.array([-3.5, -2.0, -0.0, 0.0, 0.5, 2.0, 7.25, np.nan], np.float32), n)
    return pa.table({
        "a": pa.array(big.astype(np.int32), mask=rng.rand(n) < 0.1),
        "b": pa.array(rng.randint(-7, 8, n).astype(np.int32), mask=rng.rand(n) < 0.1),
        "c8": pa.array(rng.randint(-128, 128, n).astype(np.int8), mask=rng.rand(n) < 0.1),
        "d8": pa.array(rng.randint(-3, 4, n).astype(np.int8)),
        "s16": pa.array(rng.randint(-32768, 32768, n).astype(np.int16), mask=rng.rand(n) < 0.1),
        "l": pa.array(rng.randint(-10 ** 6, 10 ** 6, n).astype(np.int64), mask=rng.rand(n) < 0.1),
        "f": pa.array(f, mask=rng.rand(n) < 0.1),
        "g": pa.array(g, mask=rng.rand(n) < 0.1),
        "h": pa.array(rng.rand(n) * 400 - 200, mask=rng.rand(n) < 0.1),  # float64, in int range
        "p": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.2),
        "q": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.2),
        "dt": pa.array((rng.randint(10000, 11000, n)).astype("datetime64[D]"),
                       mask=rng.rand(n) < 0.1),
    })


def _probe_cases():
    from daft_tpu_torch import col, lit
    from daft_tpu_torch.datatypes import DataType as T

    return {
        "int32_add_wraps": col("a") + col("a"),
        "int32_sub_wraps": col("a") - col("b"),
        "int32_mul_wraps": col("a") * col("a"),
        "int8_mul_wraps": col("c8") * col("c8"),
        "int_floordiv_zero_is_null": col("a") // col("b"),
        "int_mod_zero_is_null": col("a") % col("b"),
        "int8_floordiv_negative": col("c8") // col("d8"),
        "int8_mod_negative": col("c8") % col("d8"),
        "int16_floordiv_mixed": col("s16") // col("c8"),
        "float_div": col("f") / col("g"),
        "int_true_div": col("a") / col("b"),
        "float_floordiv": col("f") // col("g"),
        "float_mod": col("f") % col("g"),
        "mixed_floordiv": col("b") // col("g"),
        "mixed_mod": col("c8") % col("g"),
        "float_signed_zero_mul": col("g") * -0.0,
        "float_sub_add": (col("f") - col("g")) + 1.5,
        "pow": col("g") ** col("f"),
        "int_float_add": col("a") + col("f"),
        "narrowed_int64": col("l") * 3 - col("b"),
        "compare_nan_lt": col("f") < col("g"),
        "compare_nan_eq": col("f") == col("g"),
        "compare_nan_ne": col("f") != 0.0,
        "compare_mixed": col("s16") >= col("f"),
        "compare_bool": col("p") < col("q"),
        "null_safe_eq": col("b").eq_null_safe(col("d8")),
        "kleene_and": col("p") & col("q"),
        "kleene_or": col("p") | col("q"),
        "kleene_and_compare": (col("a") > 0) & col("p"),
        "xor_bool": col("p") ^ col("q"),
        "bitwise_and_int": col("b") & col("d8"),
        "bitwise_or_int": col("b") | col("a"),
        "bitwise_xor_int": col("c8") ^ col("d8"),
        "not": ~col("p"),
        "between": col("f").between(-50.0, 50.0),
        "between_int": col("b").between(col("d8"), 5),
        "date_literal": col("dt") <= datetime.date(1998, 9, 2),
        "cast_int_to_float": col("a").cast(T.float32()),
        "cast_float_to_int32": col("h").cast(T.int32()),
        "cast_float_to_int8": (col("h") / 2).cast(T.int8()),
        "cast_float_to_int16": col("h").cast(T.int16()),
        "cast_int_to_int8": col("a").cast(T.int8()),
        "cast_bool_to_int": col("p").cast(T.int32()),
        "cast_bool_to_float": col("p").cast(T.float64()),
        "cast_int_to_bool": col("b").cast(T.bool()),
        "cast_float_to_bool": col("g").cast(T.bool()),
        "literal_null": col("b") + lit(None, T.int32()),
        "literal_float": col("f") * 0.1,
        "alias": (col("b") * 2).alias("twice"),
        "is_null": col("a").is_null(),
        "not_null": col("f").not_null(),
        "fill_null_int": col("a").fill_null(col("b")),
        "fill_null_float_literal": col("f").fill_null(0.5),
        "fill_null_mixed": col("b").fill_null(col("g")),
        "if_else_float": (col("a") > 0).if_else(col("f"), col("g")),
        "if_else_nullable_pred": col("p").if_else(col("b"), 0),
        "if_else_mixed": col("q").if_else(col("c8"), col("h")),
        "if_else_nested": col("p").if_else(col("f").is_null().if_else(1.0, col("f")), -1.0),
        "is_in_int": col("b").is_in([1, -3, 5]),
        "is_in_int8": col("c8").is_in([1, 2, -128]),
        "is_in_float": col("g").is_in([0.5, 2.0, -3.5]),
        "is_in_float_int_items": col("h").is_in([1, 2, 3]),
        "is_in_null_item": col("b").is_in([None, 2]),
        "is_in_empty": col("b").is_in([]),
        "is_in_date": col("dt").is_in([datetime.date(1997, 5, 1), datetime.date(1998, 1, 2)]),
        "is_in_bool": col("p").is_in([True]),
    }


@pytest.fixture(scope="module")
def probe_run(tmp_path_factory):
    """Every probe case through the torch closures, through the emitted row
    function built with g++, and through compile_validity (the deep route's
    counts), over one staged table."""
    from daft_tpu_torch.kernels.device import (_compile_node, compile_validity,
                                               normalize_and_check, stage_table_columns)
    from daft_tpu_torch.table import Table

    tbl = Table.from_arrow(_probe_table())
    schema = tbl.schema
    cases = _probe_cases()
    nodes = normalize_and_check(list(cases.values()), schema)
    assert nodes is not None, "every probe case must be device-compilable"
    n = len(tbl)
    env, _ = stage_table_columns(tbl, schema.field_names(), n, None, torch.device("cpu"))
    dtypes = {k: v.dtype for k, (v, _m) in env.items()}
    src, lane_dts = fes.probe_source(nodes, schema, dtypes)
    lib = _gxx_lib(src, tmp_path_factory.mktemp("probe"), "probe")
    names = sorted(dtypes)
    cols = [t.contiguous() for nm in names for t in env[nm]]
    outs = []
    for dt in lane_dts:
        outs += [torch.empty(n, dtype=dt), torch.empty(n, dtype=torch.bool)]
    lib.fes_probe_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.fes_probe_rows((ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols]), n,
                       (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs]))
    got = {name: (outs[2 * j], outs[2 * j + 1]) for j, name in enumerate(cases)}
    want = {name: _compile_node(nd, schema)[0](env) for name, nd in zip(cases, nodes)}
    valid = {name: compile_validity(nd, schema)(env) for name, nd in zip(cases, nodes)}
    return got, want, valid


@pytest.mark.parametrize("case", list(_probe_cases()))
def test_emitted_row_function_matches_closures(probe_run, case):
    got, want, valid = probe_run
    (gv, gm), (wv, wm) = got[case], want[case]
    assert gv.dtype == wv.dtype, case
    assert torch.equal(gm, wm), f"{case}: validity differs"
    assert torch.equal(valid[case], wm), f"{case}: compile_validity differs from the closure"
    if wv.is_floating_point():
        both_nan = torch.isnan(gv) & torch.isnan(wv)
        if case == "pow":
            # powf against torch's vectorized pow: within one ulp
            ulps = (gv.view(torch.int32).long() - wv.view(torch.int32).long()).abs()
            assert bool(((ulps <= 1) | both_nan).all()), case
        else:
            same = gv.view(torch.int32) == wv.view(torch.int32)
            assert bool((same | both_nan).all()), f"{case}: values differ"
    else:
        assert torch.equal(gv, wv), f"{case}: values differ"


def test_emitted_deep_row_matches_closures(tmp_path):
    # the K2 row function itself (predicate, masking, float columns) for a
    # Q1-shaped expression set over nullable columns
    from daft_tpu_torch import col
    from daft_tpu_torch.kernels.device import normalize_and_check, stage_table_columns
    from daft_tpu_torch.table import Table

    tbl = Table.from_arrow(_probe_table(n=3000, seed=9))
    schema = tbl.schema
    pred, = normalize_and_check([(col("dt") <= datetime.date(1998, 9, 2)) & col("p")], schema)
    disc = col("h") * (1 - col("f"))
    kids = normalize_and_check([disc, disc * (1 + col("g")), col("a") / col("b"),
                                (col("b") // 2).cast(daft_tpu_torch.DataType.float64())],
                               schema)
    env, _ = stage_table_columns(tbl, schema.field_names(), 3000, None, torch.device("cpu"))
    dtypes = {k: v.dtype for k, (v, _m) in env.items()}
    prog = fes.FusedExprSums(pred, kids, schema, dtypes)
    lib = _gxx_lib(prog.host_source(), tmp_path, "rows")
    cols = [t.contiguous() for nm in prog.names for t in env[nm]]
    sel = torch.empty(3000, dtype=torch.bool)
    out = torch.empty((3000, len(kids)), dtype=torch.float32)
    lib.fes_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.fes_rows((ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols]), 3000,
                 sel.data_ptr(), out.data_ptr())
    sub = {nm: env[nm] for nm in prog.names}
    pv, pm = prog._pred_fn(sub)
    want_sel = pv & pm
    assert torch.equal(sel, want_sel)
    for j, fn in enumerate(prog._child_fns):
        v, m = fn(sub)
        want = torch.where(m & want_sel, v.to(torch.float32), 0.0)
        assert torch.equal(out[:, j].view(torch.int32), want.view(torch.int32)), j
