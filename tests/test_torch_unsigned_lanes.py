"""uint8, uint16 and uint32 columns on the card, held against daft_tpu in
both device modes on the CPU.

The reference stages these columns as jnp.uint8/16/32 lanes, whose
arithmetic wraps. The port stages uint8 as torch.uint8 and uint16/uint32 in
int32/int64 lanes masked back to their width after each node that can wrap
(daft_tpu_torch/kernels/device.py ``_UNSIGNED_LANES``). Each case runs one
query over one pyarrow table made from a numpy seed, at 1 and 3
partitions (into_partitions), through the reference (the 32-bit mode of
tests/device_mode.py, or its default x64 mode with device kernels on and
``device_min_rows=8``) and through the port under the same configuration
with device="cpu". Values equal the reference's exactly (a join's rows as
a multiset, its order being unspecified), and so do the routing, exchange
and join-filter counters, the reference's declines included: in the 32-bit
mode a uint32 key groups and joins on the host, and an integer sum past
the int32 guard sums on the host.

The deep-fused kernel K2 takes these lanes too: with deep fusion on and
at least BLOCK_ROWS rows, a predicate and float sums over wrapping uint
arithmetic engage it exactly where the reference's deep kernel engages,
with equal rows (float sums at rtol 1e-6). K2's generated row function is
built with g++ and held bit for bit against the torch closures over the
unsigned lanes, node by node and as a whole row.
"""

import ctypes
import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.kernels import fused_expr_sums as fes
from daft_tpu_torch.kernels import segment_sums
from device_mode import real_tpu_mode_cfg
from test_torch_fused_expr_sums import _gxx_lib
from test_torch_q1_slice import _assert_same

COUNTERS = ("device_filters", "host_filters", "device_projections", "host_projections",
            "device_fused_maps", "host_fused_maps", "device_aggregations", "host_aggregations",
            "device_agg_fallbacks", "device_sorts", "host_sorts", "device_group_codes",
            "device_join_probes", "host_joins", "shuffles", "exchange_rows",
            "exchange_precombined_rows", "join_filter_built", "join_filter_rows_pruned",
            "join_filter_device_probes")
TYPES = {"uint8": (pa.uint8(), 1 << 8), "uint16": (pa.uint16(), 1 << 16),
         "uint32": (pa.uint32(), 1 << 32)}


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def run_both(build, tables, mode: str, nparts: int):
    """``build(pkg, *frames)`` through both packages in ``mode`` ("32" or
    "x64"), each table cut into ``nparts`` partitions; returns ((reference
    dict, counters), (port dict, counters))."""
    from daft_tpu.context import get_context

    def frames(pkg):
        out = [pkg.from_arrow(t) for t in tables]
        return [f.into_partitions(nparts) for f in out] if nparts > 1 else out

    if mode == "32":
        with real_tpu_mode_cfg() as cfg:
            ref = build(daft_tpu, *frames(daft_tpu)).collect()
            d = dataclasses.asdict(cfg)
    else:
        cfg = get_context().execution_config
        saved = cfg.use_device_kernels, cfg.device_min_rows
        cfg.use_device_kernels, cfg.device_min_rows = True, 8
        try:
            ref = build(daft_tpu, *frames(daft_tpu)).collect()
            d = dataclasses.asdict(cfg)
        finally:
            cfg.use_device_kernels, cfg.device_min_rows = saved
    d["jax_enable_x64"] = mode == "x64"
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = build(daft_tpu_torch, *frames(daft_tpu_torch)).collect()
    return ((ref.to_pydict(), ref.stats.snapshot()["counters"]),
            (got.to_pydict(), got.stats.snapshot()["counters"]))


def routes(counters) -> dict:
    return {k: counters.get(k, 0) for k in COUNTERS}


def _table(type_name: str, seed: int = 17, n: int = 300) -> pa.Table:
    typ, top = TYPES[type_name]
    rng = np.random.RandomState(seed)
    u = rng.randint(0, top, n, dtype=np.int64)
    u[::23] = top - 1  # the largest value wraps every op
    v = rng.randint(0, top, n, dtype=np.int64)
    mask = np.arange(n) % 29 == 5
    return pa.table({
        "u": pa.array(u, typ, mask=mask),
        "v": pa.array(v, typ),
        "g": pa.array(rng.randint(0, 12, n) * (top // 16), typ),  # a few distinct keys
        "k": pa.array(rng.randint(0, 7, n), pa.int64()),
        "x": pa.array(rng.rand(n)),
    })


def _query(case: str, top: int):
    """``build(pkg, frame[, right])`` of one case; ``top`` is 2**width."""
    def build(pkg, f, r=None):
        col = pkg.col
        if case == "projection":
            return f.select((col("u") + col("v")).alias("add"), (col("u") * col("v")).alias("mul"),
                            (col("u") - col("v")).alias("sub"), (col("u") // 3).alias("fdiv"),
                            (col("u") % 7).alias("mod"), col("u").fill_null(1).alias("fz"))
        if case == "filter":
            return f.where(col("u") > top // 2)
        if case == "sort":
            return f.sort(["u", "k", "x"], desc=[True, False, False])
        if case == "group_key":
            return f.groupby("g").agg(col("x").count().alias("n"), col("k").min().alias("kmin"))
        if case == "sum":
            return f.groupby("k").agg(col("u").sum().alias("s"), col("u").count().alias("n"))
        if case == "min_max":
            return f.groupby("k").agg(col("u").min().alias("lo"), col("u").max().alias("hi"))
        assert case == "join"
        return f.join(r, on="u")

    return build


CASES = ("projection", "filter", "sort", "group_key", "sum", "min_max", "join")


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("type_name", sorted(TYPES))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["32", "x64"])
def test_unsigned_lane_matches_reference(mode, case, type_name, nparts):
    tbl = _table(type_name)
    build = _query(case, TYPES[type_name][1])
    tables = [tbl]
    if case == "join":
        tables.append(tbl.slice(0, 100).select(["u", "x"]).rename_columns(["u", "w"]))
    (ref, rc), (got, gc) = run_both(build, tables, mode, nparts)
    assert list(got) == list(ref)
    if case == "join":
        def rows(d):
            return sorted(zip(*d.values()), key=repr)

        assert rows(got) == rows(ref)
    else:
        assert got == ref
    assert routes(gc) == routes(rc)


@pytest.mark.parametrize("mode", ["32", "x64"])
@pytest.mark.parametrize("type_name,value,wrapped", [("uint8", 200, 144),
                                                     ("uint16", 40_000, 14_464),
                                                     ("uint32", 3_000_000_000, 1_705_032_704)])
def test_doubling_wraps_on_the_card(mode, type_name, value, wrapped):
    """``u + u`` over eight equal values wraps on the card, as the
    reference's lanes do (its host path, and the port's, raise on the
    overflow instead)."""
    tbl = pa.table({"u": pa.array([value] * 8, TYPES[type_name][0])})
    (ref, rc), (got, gc) = run_both(
        lambda pkg, f: f.select((pkg.col("u") + pkg.col("u")).alias("y")), [tbl], mode, 1)
    assert got == ref == {"y": [wrapped] * 8}
    assert gc.get("device_projections") == rc.get("device_projections") == 1
    assert routes(gc) == routes(rc)


@pytest.mark.parametrize("mode", ["32", "x64"])
def test_uint32_against_int32_compare(mode):
    """``u32 > i32`` on the card gives pyarrow's answer in both modes.
    Pinned: in the 32-bit mode the reference's card differs there, because
    jnp.promote_types(uint32, int32) is int64, which its 32-bit mode
    narrows to int32, so a uint32 value past 2**31 - 1 compares as
    negative (its host path gives pyarrow's answer). Routing is equal."""
    import pyarrow.compute as pc

    u = [3_000_000_000, 5, 4_000_000_000, 2 ** 31, 0, 7, 2 ** 32 - 1, 9]
    i = [-5, 7, 3, -1, 0, 6, 2 ** 31 - 1, -2 ** 31]
    tbl = pa.table({"u": pa.array(u, pa.uint32()), "i": pa.array(i, pa.int32())})
    (ref, rc), (got, gc) = run_both(
        lambda pkg, f: f.select((pkg.col("u") > pkg.col("i")).alias("y")), [tbl], mode, 1)
    want = pc.greater(pc.cast(tbl["u"], pa.int64()), pc.cast(tbl["i"], pa.int64())).to_pylist()
    assert got == {"y": want}
    assert gc.get("device_projections") == rc.get("device_projections") == 1
    assert routes(gc) == routes(rc)
    if mode == "32":
        assert ref != got  # the reference's int32 compare of a uint32 lane
    else:
        assert ref == got


# ---------------------------------------------------------------------------
# the deep-fused kernel K2 over unsigned lanes
# ---------------------------------------------------------------------------

def _deep_table(type_name: str, n: int = 2 * segment_sums.BLOCK_ROWS, seed: int = 29):
    typ, top = TYPES[type_name]
    rng = np.random.RandomState(seed)
    u = rng.randint(0, top, n, dtype=np.int64)
    u[::17] = top - 1
    return pa.table({
        "u": pa.array(u, typ, mask=np.arange(n) % 31 == 4),
        "v": pa.array(rng.randint(0, top, n, dtype=np.int64), typ),
        "k": pa.array(rng.randint(0, 6, n), pa.int64()),
        "x": pa.array(rng.rand(n)),
    })


def _deep_query(pkg, f):
    """A wrapping uint predicate and wrapping uint arithmetic in float sums."""
    col, f64 = pkg.col, pkg.DataType.float64()
    return (f.where((col("u") + col("u")) > col("v"))
            .groupby("k")
            .agg((col("u") * col("v")).cast(f64).sum().alias("mul"),
                 (col("u") - col("v")).cast(pkg.DataType.float32()).sum().alias("sub"),
                 (col("u") // 3 + col("v") % 7).cast(f64).mean().alias("div"),
                 (col("x") * col("u").cast(f64)).sum().alias("xu"),
                 col("u").count().alias("n"), col("x").sum().alias("xs"))
            .sort("k"))


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("type_name", sorted(TYPES))
def test_deep_kernel_takes_unsigned_lanes(type_name, nparts):
    from daft_tpu.kernels import device_agg as ref_agg
    from daft_tpu.kernels import pallas_ops
    from daft_tpu_torch.kernels import device_agg

    tbl = _deep_table(type_name)
    ref_agg._AGG_CACHE.clear()
    device_agg._AGG_CACHE.clear()

    def frame(pkg):
        f = pkg.from_arrow(tbl)
        return f.into_partitions(nparts) if nparts > 1 else f

    with real_tpu_mode_cfg() as cfg:
        saved = cfg.use_pallas_deep_fusion
        cfg.use_pallas_deep_fusion = True
        try:
            traces = pallas_ops.DEEP_FUSED_TRACES[0]
            ref = _deep_query(daft_tpu, frame(daft_tpu)).collect()
            traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
            d = dataclasses.asdict(cfg)
        finally:
            cfg.use_pallas_deep_fusion = saved
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    assert daft_tpu_torch.get_context().execution_config.use_deep_fusion_kernel
    before = fes.BUILDS, fes.ENTRIES, segment_sums.ENTRIES
    got = _deep_query(daft_tpu_torch, frame(daft_tpu_torch)).collect()
    builds, k2, k1 = (a - b for a, b in zip((fes.BUILDS, fes.ENTRIES, segment_sums.ENTRIES),
                                           before))
    _assert_same(ref.to_pydict(), got.to_pydict())
    assert routes(got.stats.snapshot()["counters"]) == routes(ref.stats.snapshot()["counters"])
    # K2 takes the float sums wherever the reference's deep kernel does
    assert traces >= 1 and builds == traces and k2 >= 1 and k1 == 0


def _uint_probe_table(n: int = 4096, seed: int = 41) -> pa.Table:
    """Unsigned columns of each width with their extremes and nulls, an
    int32 column with negative values, and floats in [0, 4e9). A float cast
    to an int lane stays inside that lane's range: torch's CPU cast differs
    from its CUDA cast outside it."""
    rng = np.random.RandomState(seed)
    cols = {}
    for name, (typ, top) in TYPES.items():
        for c in "ab":
            vals = rng.randint(0, top, n, dtype=np.int64)
            vals[:4] = [0, 1, top - 1, top // 2]
            cols[f"{name[4:]}{c}"] = pa.array(vals, typ, mask=rng.rand(n) < 0.1)
    cols["i"] = pa.array(rng.randint(-300, 300, n).astype(np.int32), mask=rng.rand(n) < 0.1)
    cols["f"] = pa.array((rng.rand(n) * 4e9).astype(np.float32), mask=rng.rand(n) < 0.1)
    return pa.table(cols)


def _uint_probe_cases():
    from daft_tpu_torch import col
    from daft_tpu_torch.datatypes import DataType as T

    cases = {}
    for w in ("8", "16", "32"):
        a, b = col(f"{w}a"), col(f"{w}b")
        cases.update({
            f"u{w}_add_wraps": a + b, f"u{w}_sub_wraps": a - b, f"u{w}_mul_wraps": a * b,
            f"u{w}_chain_wraps": a * b * a + b, f"u{w}_floordiv": a // b, f"u{w}_mod": a % b,
            f"u{w}_literal": a * 3 + 1, f"u{w}_compare": (a + b) > b, f"u{w}_eq": a == b,
            f"u{w}_to_float": (a * b).cast(T.float32()), f"u{w}_true_div": a / b,
            f"u{w}_fill_null": a.fill_null(b), f"u{w}_if_else": (a > b).if_else(a, b),
            f"u{w}_is_in": a.is_in([0, 1, 3]), f"u{w}_between": a.between(b, 200),
            f"u{w}_bitwise": (a & b) | (a ^ b),
        })
    cases.update({
        "int_to_uint16_wraps": col("i").cast(T.uint16()),
        "int_to_uint32_wraps": col("i").cast(T.uint32()),
        "int_to_uint8_wraps": col("i").cast(T.uint8()),
        "float_to_uint32": col("f").cast(T.uint32()),
        "float_to_uint16_wraps": (col("f") / 2).cast(T.uint16()),
        "float_to_uint8_wraps": (col("f") / 1e6).cast(T.uint8()),
        "uint32_to_int32_wraps": col("32a").cast(T.int32()),
        "mixed_widths": col("8a") + col("16b") * col("8b"),
        "mixed_compare": col("16a") < col("32b"),
    })
    return cases


@pytest.fixture(scope="module")
def uint_probe_run(tmp_path_factory):
    """Every unsigned probe case through the torch closures and through the
    emitted row function built with g++, over one staged table."""
    from daft_tpu_torch.kernels.device import (_compile_node, normalize_and_check,
                                               stage_table_columns)
    from daft_tpu_torch.table import Table

    tbl = Table.from_arrow(_uint_probe_table())
    schema = tbl.schema
    cases = _uint_probe_cases()
    nodes = normalize_and_check(list(cases.values()), schema)
    assert nodes is not None, "every unsigned probe case must be device-compilable"
    n = len(tbl)
    env, _ = stage_table_columns(tbl, schema.field_names(), n, None, torch.device("cpu"))
    dtypes = {k: v.dtype for k, (v, _m) in env.items()}
    assert {dtypes["8a"], dtypes["16a"], dtypes["32a"]} == {torch.uint8, torch.int32, torch.int64}
    src, lane_dts = fes.probe_source(nodes, schema, dtypes)
    lib = _gxx_lib(src, tmp_path_factory.mktemp("uprobe"), "uprobe")
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
    return got, want


@pytest.mark.parametrize("case", list(_uint_probe_cases()))
def test_emitted_row_function_wraps_unsigned_lanes(uint_probe_run, case):
    got, want = uint_probe_run
    (gv, gm), (wv, wm) = got[case], want[case]
    assert gv.dtype == wv.dtype, case
    assert torch.equal(gm, wm), f"{case}: validity differs"
    if wv.is_floating_point():
        both_nan = torch.isnan(gv) & torch.isnan(wv)
        assert bool(((gv.view(torch.int32) == wv.view(torch.int32)) | both_nan).all()), case
    else:
        assert torch.equal(gv, wv), f"{case}: values differ"


def test_emitted_deep_row_wraps_unsigned_lanes(tmp_path):
    # K2's row function (predicate, masking, float columns) over the three
    # unsigned lanes, held against the closures bit for bit
    from daft_tpu_torch import col
    from daft_tpu_torch.datatypes import DataType as T
    from daft_tpu_torch.kernels.device import normalize_and_check, stage_table_columns
    from daft_tpu_torch.table import Table

    n = 3000
    tbl = Table.from_arrow(_uint_probe_table(n=n, seed=43))
    schema = tbl.schema
    pred, = normalize_and_check([(col("16a") + col("16b")) > col("16a") * col("16b")], schema)
    kids = normalize_and_check([(col("32a") * col("32b")).cast(T.float64()),
                                (col("16a") * col("16b")).cast(T.float32()),
                                (col("8a") - col("8b")).cast(T.float64()),
                                (col("32a") // 5 + col("8b") % 3).cast(T.float64())], schema)
    env, _ = stage_table_columns(tbl, schema.field_names(), n, None, torch.device("cpu"))
    dtypes = {k: v.dtype for k, (v, _m) in env.items()}
    prog = fes.FusedExprSums(pred, kids, schema, dtypes)
    lib = _gxx_lib(prog.host_source(), tmp_path, "urows")
    cols = [t.contiguous() for nm in prog.names for t in env[nm]]
    sel = torch.empty(n, dtype=torch.bool)
    out = torch.empty((n, len(kids)), dtype=torch.float32)
    lib.fes_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.fes_rows((ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols]), n,
                 sel.data_ptr(), out.data_ptr())
    sub = {nm: env[nm] for nm in prog.names}
    pv, pm = prog._pred_fn(sub)
    want_sel = pv & pm
    assert 0 < int(want_sel.sum()) < n and torch.equal(sel, want_sel)
    for j, fn in enumerate(prog._child_fns):
        v, m = fn(sub)
        want = torch.where(m & want_sel, v.to(torch.float32), 0.0)
        assert torch.equal(out[:, j].view(torch.int32), want.view(torch.int32)), j
