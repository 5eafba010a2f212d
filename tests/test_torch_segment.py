"""The port's map-chain fusion and device-resident plan segments
(daft_tpu_torch/fuse/), on the CPU.

TPC-H Q1 written with ``with_column`` (how DataFrame users write its derived
columns) plans as one DeviceSegmentOp in both packages. It runs through
daft_tpu under tests/device_mode.real_tpu_mode_cfg and through the port under
execution_config_from_dict(...) of that config with device="cpu". Keys,
group order, counts and int sums match exactly; float aggregates agree at
rtol 1e-6, with each other and with the pyarrow oracle; the fusion and
residency counters are equal, and so is the deep kernel's engagement.

The with_column Q1 runs over 3 partitions too (stage 1 a DeviceSegmentOp
dispatched per partition). tests/test_segment.py's query shape runs on ONE
partition. Both packages
optimize it before fusion (the filter moves below the projection), so its
fusion counters are equal too.
"""

import dataclasses
import datetime

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import parity
from daft_tpu_torch.kernels import fused_expr_sums as fes
from device_mode import real_tpu_mode_cfg
from test_torch_q1_slice import _assert_same

RTOL = 1e-6
_SEGMENT_COUNTERS = ("device_resident_segments", "device_handoffs_elided", "fused_chains",
                     "cse_hits")


@pytest.fixture(autouse=True)
def _fresh_programs():
    from daft_tpu.kernels import device_agg as ref_agg
    from daft_tpu_torch.kernels import device_agg

    saved = daft_tpu_torch.get_context().execution_config
    ref_agg._AGG_CACHE.clear()
    device_agg._AGG_CACHE.clear()
    yield
    daft_tpu_torch.set_execution_config(saved)


def q1_with_columns(frame, col):
    """TPC-H Q1 with its derived columns as with_column steps."""
    return (frame
            .with_column("disc_price", col("l_extendedprice") * (1 - col("l_discount")))
            .with_column("charge", col("disc_price") * (1 + col("l_tax")))
            .where(col("l_shipdate") <= datetime.date(1998, 9, 2))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 col("disc_price").sum().alias("sum_disc_price"),
                 col("charge").sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


def _run_both(table, query, deep=False, **ref_knobs):
    """``query(frame, col)`` through both packages under one configuration.
    Returns (reference dict, reference counters, port dict, port counters,
    reference deep traces, port K2 builds)."""
    from daft_tpu.kernels import pallas_ops

    with real_tpu_mode_cfg(device_min_rows=8) as cfg:
        import jax

        knobs = {"use_pallas_deep_fusion": deep, "device_residency": True, **ref_knobs}
        saved = {k: getattr(cfg, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cfg, k, v)
        try:
            traces = pallas_ops.DEEP_FUSED_TRACES[0]
            ref = query(daft_tpu.from_arrow(table).collect(), daft_tpu.col).collect()
            traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
            ref_out = ref.to_pydict(), ref.stats.snapshot()["counters"]
            d = dataclasses.asdict(cfg)
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)
        d["jax_enable_x64"] = bool(jax.config.jax_enable_x64)
    daft_tpu_torch.set_execution_config(daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    builds = fes.BUILDS
    got = query(daft_tpu_torch.from_arrow(table).collect(), daft_tpu_torch.col).collect()
    return (*ref_out, got.to_pydict(), got.stats.snapshot()["counters"], traces,
            fes.BUILDS - builds)


@pytest.fixture(scope="module")
def lineitem():
    return tpch.generate_lineitem_only(scale=20_000 / tpch.LINEITEM_ROWS_PER_SF, seed=7)


@pytest.mark.parametrize("deep", [False, True], ids=["composed", "deep"])
def test_with_column_q1_over_three_partitions_matches_reference(lineitem, deep):
    """The same query over 3 partitions (into_partitions): stage 1 runs as
    one DeviceSegmentOp, dispatched once per partition, in both packages,
    with equal segment, fusion and residency counters and equal rows."""
    def query(frame, col):
        return q1_with_columns(frame.into_partitions(3).collect(), col)

    ref, ref_c, got, got_c, traces, builds = _run_both(lineitem, query, deep=deep)
    _assert_same(ref, got)
    oracle = tpch.oracle_q1(lineitem)
    assert parity(ref, oracle, RTOL) and parity(got, oracle, RTOL)
    for name in _SEGMENT_COUNTERS + ("segment_compiles", "segment_dispatches",
                                     "segment_fallbacks", "device_aggregations",
                                     "host_aggregations", "shuffles"):
        assert got_c.get(name, 0) == ref_c.get(name, 0), (name, got_c, ref_c)
    # one segment op (compiled once), dispatched once per partition
    assert got_c["device_resident_segments"] == 1 and got_c["fused_chains"] == 1
    assert got_c["segment_compiles"] == 1 and got_c["segment_dispatches"] == 3
    # deep: stage 1's program and stage 2's (18 partial rows, on the card)
    assert builds == traces == 2 * int(deep)


@pytest.mark.parametrize("deep", [False, True], ids=["composed", "deep"])
def test_with_column_q1_matches_reference(lineitem, deep):
    from daft_tpu_torch.fuse.segment import process_counters

    before = process_counters()
    ref, ref_c, got, got_c, traces, builds = _run_both(lineitem, q1_with_columns, deep=deep)
    after = process_counters()
    for key in ("resident_segments", "handoffs_elided", "segment_compiles"):
        assert after[key] - before[key] == 1, key
    assert after["hbm_resident_bytes_high_water"] >= got_c["hbm_resident_bytes_high_water"] > 0
    _assert_same(ref, got)
    oracle = tpch.oracle_q1(lineitem)
    assert parity(ref, oracle, RTOL) and parity(got, oracle, RTOL)
    for name in _SEGMENT_COUNTERS:
        assert got_c.get(name, 0) == ref_c.get(name, 0), (name, got_c, ref_c)
    assert got_c["device_resident_segments"] == 1 and got_c["fused_chains"] == 1
    assert got_c.get("segment_dispatches") == 1 and got_c.get("segment_fallbacks", 0) == 0
    assert builds == traces == int(deep)


def test_with_column_q1_plans_one_segment(lineitem):
    from daft_tpu_torch.fuse import DeviceSegmentOp, FusedMapOp
    from daft_tpu_torch.physical import translate

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
    plan = q1_with_columns(daft_tpu_torch.from_arrow(lineitem), daft_tpu_torch.col)._plan
    phys = translate(plan)
    seg = phys.children[0]
    assert isinstance(seg, DeviceSegmentOp) and isinstance(seg.map_op, FusedMapOp)
    assert seg.program.n_masks == 0 and seg.program.pred_node is not None
    assert seg.map_op.program.graph.cse_hits == 1  # disc_price feeds charge once
    assert "DeviceSegment[" in phys.display_tree()
    daft_tpu_torch.set_execution_config(device_residency=False)
    assert not isinstance(translate(plan).children[0], DeviceSegmentOp)


def _chain(frame, col):
    """A five-op map chain with no aggregate: two filters (the second, total,
    conjoins with the first) and a derived column used on both sides of a
    filter (a cross-segment carry on the host pass)."""
    return (frame.with_column("w", col("u") * 3).where(col("w") > 30)
            .with_column("z", col("w") + col("v")).where(col("b"))
            .select("k", "z", "w"))


def test_map_chain_fuses_with_masks_and_carries():
    from daft_tpu_torch.fuse import FusedMapOp
    from daft_tpu_torch.physical import translate

    table = _data("some")
    ref, ref_c, got, got_c, _t, _b = _run_both(table, _chain)
    assert got == ref
    # both optimizers merge the two filters before fusion: four ops, one chain
    for name in ("fused_chains", "fused_ops_eliminated", "cse_hits"):
        assert got_c.get(name, 0) == ref_c.get(name, 0), (name, got_c, ref_c)
    assert got_c.get("fused_chains") == 1 and got_c.get("fused_ops_eliminated") == 3
    assert got_c.get("device_fused_map_dispatches") == 1
    # the unoptimized five-op chain, translated as written
    fused = translate(_chain(daft_tpu_torch.from_arrow(table), daft_tpu_torch.col)._plan)
    assert isinstance(fused, FusedMapOp)
    assert fused.program.n_masks == 1 and fused.program.graph.carries == 1
    # the host pass (with its carry) and the unfused chain give the same bytes
    host, c_host = _port(table, _chain, use_device_kernels=False)
    unfused, c_unfused = _port(table, _chain, expr_fusion=False)
    assert host == unfused == got
    assert c_host.get("host_fused_maps") == 1 and "fused_chains" not in c_unfused


# ---------------------------------------------------------------------------
# tests/test_segment.py's query on one partition
# ---------------------------------------------------------------------------

def _data(nulls="some", n=200):
    """str key, never-null int (drives the predicate), int64/float64 agg
    columns under the requested null pattern, and a bool filter column."""
    if nulls == "none":
        v = list(range(n))
        f = [i * 0.25 for i in range(n)]
    elif nulls == "some":
        v = [i if i % 7 else None for i in range(n)]
        f = [i * 0.25 if i % 5 else None for i in range(n)]
    else:
        v = [None] * n
        f = [None] * n
    return pa.table({
        "k": pa.array(["a", "b", "c", "d"] * (n // 4)),
        "u": pa.array(list(range(n)), type=pa.int64()),
        "v": pa.array(v, type=pa.int64()),
        "f": pa.array(f, type=pa.float64()),
        "b": pa.array([True, True, False, True] * (n // 4)),
    })


def _query(frame, col):
    """project -> filter -> grouped agg (test_segment.py::_query)."""
    return (frame.select((col("v") * 2 + 1).alias("x"), (col("f") * 0.5).alias("g"),
                         (col("u") * 3).alias("w"), col("k"), col("b"))
            .where((col("w") > 30) & col("b"))
            .groupby("k")
            .agg(col("x").sum().alias("sx"), col("g").mean().alias("mg"),
                 col("g").max().alias("xg"), col("x").count().alias("c"),
                 col("w").sum().alias("sw"))
            .sort("k"))


@pytest.mark.parametrize("nulls", ["none", "some", "all"])
def test_segment_query_matches_reference(nulls):
    ref, ref_c, got, got_c, _t, _b = _run_both(_data(nulls), _query)
    _assert_same(ref, got)
    for name in ("device_resident_segments", "device_handoffs_elided", "segment_dispatches"):
        assert got_c.get(name, 0) == ref_c.get(name, 0) == 1, (name, got_c, ref_c)
    # both optimizers push the filter below the projection: a two-op chain
    # that fuses, with the shared `w` a CSE hit
    assert got_c.get("fused_chains", 0) == ref_c.get("fused_chains") == 1
    assert got_c.get("cse_hits", 0) == ref_c.get("cse_hits", 0)


def _assert_close(a: dict, b: dict):
    """Ints and counts equal; floats within rtol 1e-6."""
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        assert [v is None for v in x] == [v is None for v in y], name
        if any(isinstance(v, float) for v in y):
            np.testing.assert_allclose([np.nan if v is None else v for v in x],
                                       [np.nan if v is None else v for v in y],
                                       rtol=RTOL, err_msg=name)
        else:
            assert x == y, name


def _port(table, query, **knobs):
    base = dict(device="cpu", device_min_rows=8, use_deep_fusion_kernel=False,
                device_residency=True)
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(**{**base, **knobs}))
    df = query(daft_tpu_torch.from_arrow(table).collect(), daft_tpu_torch.col).collect()
    return df.to_pydict(), df.stats.snapshot()["counters"]


@pytest.mark.parametrize("nulls", ["none", "some", "all"])
def test_residency_on_and_off_agree(nulls):
    # the staged plan materializes the derived float64 columns and stages
    # them as float32 again, so float sums agree to rounding, not to the bit
    on, c_on = _port(_data(nulls), _query, device_residency=True)
    off, c_off = _port(_data(nulls), _query, device_residency=False)
    _assert_close(on, off)
    assert c_on.get("device_resident_segments") == 1
    assert c_off.get("device_resident_segments", 0) == 0
    host, _ = _port(_data(nulls), _query, use_device_kernels=False)
    _assert_close(on, host)


def test_empty_input_declines_without_degrading():
    # a filter inside the segment starves it to zero rows: no decline, no
    # fallback, and the same (empty) result as the reference
    def q(frame, col):
        return (frame.where(col("v") > 10_000).select((col("v") * 2).alias("x"), col("k"))
                .groupby("k").agg(col("x").sum().alias("sx")).sort("k"))

    ref, ref_c, got, got_c, _t, _b = _run_both(_data("some"), q)
    assert ref == got == {"k": [], "sx": []}
    assert got_c.get("segment_fallbacks", 0) == 0 == ref_c.get("segment_fallbacks", 0)


def test_empty_partition_takes_staged_ops_without_degrading():
    table = _data("some").slice(0, 0)
    got, c = _port(table, _query)
    assert got == {"k": [], "sx": [], "mg": [], "xg": [], "c": [], "sw": []}
    assert c.get("segment_fallbacks", 0) == 0 and c.get("device_resident_segments", 0) == 0


def test_wrap_guard_declines_to_staged_ops():
    # int64 arithmetic whose int32 lanes could wrap: the resident attempt
    # declines, the staged ops compute it on the host, and the fallback counts
    table = pa.table({"k": pa.array([1, 2] * 2048, pa.int64()),
                      "v": pa.array(list(range(4096)), pa.int64())})

    def q(frame, col):
        return (frame.with_column("y", col("v") * 1_000_000).groupby("k")
                .agg(col("y").sum().alias("sy")).sort("k"))

    got, c = _port(table, q)
    assert got == {"k": [1, 2], "sy": [sum(range(0, 4096, 2)) * 1_000_000,
                                       sum(range(1, 4096, 2)) * 1_000_000]}
    assert c.get("segment_fallbacks") == 1 and c.get("device_resident_segments", 0) == 0


def test_deep_fusion_on_and_off_on_the_segment_path(lineitem):
    builds = fes.BUILDS
    deep, c_deep = _port(lineitem, q1_with_columns, use_deep_fusion_kernel=True)
    assert fes.BUILDS - builds == 1
    composed, c_comp = _port(lineitem, q1_with_columns, use_deep_fusion_kernel=False)
    assert deep == composed  # K2's plain version is the composed computation
    assert c_deep.get("device_resident_segments") == c_comp.get("device_resident_segments") == 1


def test_warm_rerun_makes_no_segment_compile(lineitem):
    from daft_tpu_torch.execution import ExecutionContext, RuntimeStats, execute_plan
    from daft_tpu_torch.kernels import device_agg
    from daft_tpu_torch.physical import translate

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        use_deep_fusion_kernel=True)
    cfg = daft_tpu_torch.get_context().execution_config
    frame = daft_tpu_torch.from_arrow(lineitem).collect()
    plan_stats = RuntimeStats()
    phys = translate(q1_with_columns(frame, daft_tpu_torch.col)._plan, cfg, plan_stats)
    assert plan_stats.counters.get("segment_compiles") == 1

    def run():
        stats = RuntimeStats()
        parts = list(execute_plan(phys, ExecutionContext(cfg, stats)))
        return [p.table().to_pydict() for p in parts], stats.counters

    cold, c1 = run()
    programs, builds = len(device_agg._AGG_CACHE), fes.BUILDS
    warm, c2 = run()
    assert warm == cold
    # the warm run compiles no segment, no aggregation program, no kernel
    assert c2.get("segment_compiles", 0) == 0
    assert (len(device_agg._AGG_CACHE), fes.BUILDS) == (programs, builds)
    # and claims its own residency and fusion counters
    assert c1.get("device_resident_segments") == c2.get("device_resident_segments") == 1
    assert c2.get("fused_chains") == 1
