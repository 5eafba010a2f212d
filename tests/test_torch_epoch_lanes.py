"""The port's epoch lanes held against daft_tpu in its 32-bit device mode, on
the CPU: timestamp, duration and time compares and sort keys through exact
(hi, lo) lanes of their 64-bit epochs (daft_tpu_torch/kernels/device.py
``epoch_cmp_env``, ``_stage_epoch_expr_lanes``), and the deep kernel K2 over
those lanes.

- Each case runs one query over the same pyarrow table, made from a numpy
  seed, through daft_tpu under tests/device_mode.real_tpu_mode_cfg and
  through the port under that configuration with device="cpu". Rows,
  timestamps and order are equal; float sums agree at the reference
  test's rtol 1e-5; every routing counter is the reference's.
- The cases are those of tests/device32/test_real_tpu_mode.py
  TestDeviceEpoch32, TestComputedEpochCompare32 and
  TestComputedLaneSortKeys32::test_sort_by_epoch_arithmetic_on_device.
- K2 takes an epoch compare of two lane sides (and of a lane side and a null
  literal) exactly where the reference's deep kernel does, and declines a
  compare against a literal, whose halves enter the env as scalars; its
  generated row function, built with g++, equals the torch closures bit for
  bit.
- Hypothesis: random int64 epochs (negative ones and the extremes included)
  compare and sort as in the reference.
"""

import ctypes
import dataclasses
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.kernels import fused_expr_sums as fes
from device_mode import real_tpu_mode_cfg
from test_torch_fused_expr_sums import _gxx_lib

ROUTES = ("device_filters", "host_filters", "device_projections", "host_projections",
          "device_fused_maps", "host_fused_maps", "device_aggregations", "host_aggregations",
          "device_agg_fallbacks", "device_sorts", "host_sorts", "device_group_codes")
BASE = datetime.datetime(2020, 1, 1)
LIT = BASE + datetime.timedelta(seconds=5 * 10 ** 6)


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _table(n=3000, seed=57):
    """Two nullable microsecond timestamps ten million seconds wide, a float
    and an int."""
    rng = np.random.RandomState(seed)
    start = np.datetime64("2020-01-01T00:00:00", "us")

    def ts(every):
        secs = rng.randint(0, 10 ** 7, n).astype("timedelta64[s]")
        return pa.array(start + secs, mask=np.arange(n) % every == 0)

    return pa.table({"t": ts(97), "t2": ts(113), "v": rng.rand(n),
                     "i": rng.randint(0, 1000, n).astype(np.int64)})


def _run_both(build, table, deep=False):
    """``build(pkg, frame)`` through both packages; returns (reference frame,
    port frame, reference deep traces, port K2 builds)."""
    from daft_tpu.kernels import pallas_ops

    with real_tpu_mode_cfg(device_min_rows=8) as cfg:
        saved = cfg.use_pallas_deep_fusion
        cfg.use_pallas_deep_fusion = deep
        traces = pallas_ops.DEEP_FUSED_TRACES[0]
        try:
            ref = build(daft_tpu, daft_tpu.from_arrow(table)).collect()
        finally:
            cfg.use_pallas_deep_fusion = saved
        traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    d["use_pallas_deep_fusion"] = deep
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    builds = fes.BUILDS
    got = build(daft_tpu_torch, daft_tpu_torch.from_arrow(table)).collect()
    return ref, got, traces, fes.BUILDS - builds


def _routes(df):
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ROUTES}


def _assert_same(ref, got, floats=()):
    r, g = ref.to_pydict(), got.to_pydict()
    assert list(g) == list(r)
    for name in r:
        if name in floats:
            np.testing.assert_allclose(g[name], r[name], rtol=1e-5)
        else:
            assert g[name] == r[name], name
    assert _routes(got) == _routes(ref)


def _cases(pkg):
    c, iv = pkg.col, pkg.interval
    ts_us = pkg.DataType.timestamp("us")
    lo = LIT - datetime.timedelta(seconds=10 ** 6)
    return {
        # TestDeviceEpoch32
        "filter_lt": lambda f: f.where(c("t") < LIT),
        "filter_ge": lambda f: f.where(c("t") >= LIT),
        "filter_eq": lambda f: f.where(c("t") == LIT),
        "filter_ne": lambda f: f.where(c("t") != LIT),
        "filter_flip": lambda f: f.where(pkg.lit(LIT) > c("t")),
        "sort_desc": lambda f: f.sort("t", desc=True),
        "fused_predicate_agg": lambda f: f.where(c("t") < LIT).agg(
            c("v").sum().alias("s"), c("v").count().alias("c")),
        "between": lambda f: f.where(c("t").between(lo, LIT)),
        "arithmetic_stays_host": lambda f: f.select((c("t") + iv(days=1)).alias("u")),
        # TestComputedEpochCompare32
        "computed_vs_literal": lambda f: f.where((c("t") + iv(days=3)) < LIT),
        "column_vs_column": lambda f: f.where(c("t") < c("t2")),
        "computed_vs_computed": lambda f: f.where(
            (c("t") + iv(hours=6)) >= (c("t2") - iv(days=1))),
        "computed_predicate_agg": lambda f: f.where((c("t") + iv(days=2)) <= LIT).agg(
            c("v").sum().alias("s"), c("v").count().alias("c")),
        "compare_projection": lambda f: f.select(
            ((c("t") + iv(days=1)) > LIT).alias("late"), c("v")),
        "null_literal_all_null": lambda f: f.select(
            (c("t") == pkg.lit(None).cast(ts_us)).alias("eq"), c("v")),
        # a duration, computed on the host, against an interval literal
        "duration_vs_interval": lambda f: f.where((c("t2") - c("t")) > iv(days=30)),
        # TestComputedLaneSortKeys32::test_sort_by_epoch_arithmetic_on_device
        "sort_by_epoch_arithmetic": lambda f: f.sort(
            [(c("t") + iv(days=3)), c("i")]).select(c("i")),
        "sort_two_epoch_keys": lambda f: f.sort(["t2", "t"], desc=[False, True]),
    }


@pytest.mark.parametrize("case", sorted(_cases(daft_tpu)))
def test_epoch_lane_matches_reference(case):
    ref, got, _t, _b = _run_both(lambda pkg, f: _cases(pkg)[case](f), _table())
    _assert_same(ref, got, floats=("s", "v"))
    routes = _routes(got)
    if case == "arithmetic_stays_host":
        assert routes["host_projections"] == 1 and routes["device_projections"] == 0
    elif case.startswith("sort"):  # the sort on the card (a later select may not be)
        assert routes["device_sorts"] == 1 and routes["host_sorts"] == 0
    else:  # each runs on the card
        assert not any(routes[k] for k in ("host_filters", "host_projections", "host_sorts",
                                           "host_aggregations"))


# ---------------------------------------------------------------------------
# the lanes themselves
# ---------------------------------------------------------------------------

def test_biased_halves_order_as_the_epochs():
    from daft_tpu_torch.kernels.device import (_biased_halves, _epoch_bits_np,
                                               _two_lane_cmp)

    rng = np.random.RandomState(4)
    vals = np.concatenate([rng.randint(-2 ** 62, 2 ** 62, 500, dtype=np.int64),
                           np.array([-2 ** 63, 2 ** 63 - 1, -1, 0, 1, 2 ** 32, -2 ** 32],
                                    dtype=np.int64)])
    hi, lo = (torch.from_numpy(x) for x in _biased_halves(_epoch_bits_np(vals)))
    a, b = np.meshgrid(np.arange(len(vals)), np.arange(len(vals)))
    a, b = a.ravel(), b.ravel()
    for op, fn in (("<", np.less), ("<=", np.less_equal), (">", np.greater),
                   (">=", np.greater_equal), ("==", np.equal), ("!=", np.not_equal)):
        got = _two_lane_cmp(op, hi[a], lo[a], hi[b], lo[b]).numpy()
        assert (got == fn(vals[a], vals[b])).all(), op


def test_epoch_lanes_are_cached_with_the_partition():
    from daft_tpu_torch.kernels.device import _stage_epoch_expr_lanes
    from daft_tpu_torch.table import Table

    tbl = Table.from_arrow(_table(n=100))
    cache = {}
    node = (daft_tpu_torch.col("t") + daft_tpu_torch.interval(days=1))._node
    first = _stage_epoch_expr_lanes(tbl, node, 1024, cache, torch.device("cpu"))
    assert first[0].dtype == torch.int32 and first[0].shape == (1024,)
    assert not first[2][100:].any()  # padding rows are invalid
    assert _stage_epoch_expr_lanes(tbl, node, 1024, cache, torch.device("cpu")) is first


# ---------------------------------------------------------------------------
# K2 over epoch lanes
# ---------------------------------------------------------------------------

def _deep_cases(pkg):
    c, iv = pkg.col, pkg.interval
    ts_us = pkg.DataType.timestamp("us")

    def grouped(pred, child=None):
        child = c("v") if child is None else child
        return lambda f: (f.where(pred).groupby((c("i") % 4).alias("g"))
                          .agg(child.sum().alias("s"), c("v").count().alias("n")).sort("g"))

    return {
        # (query, K2 engages in the reference)
        "column_vs_column": (grouped(c("t") < c("t2")), True),
        "computed_vs_computed": (grouped((c("t") + iv(hours=6)) >= (c("t2") - iv(days=1))),
                                 True),
        "compare_in_the_summed_column": (
            grouped(c("i") >= 0, (c("t") <= c("t2")).if_else(c("v"), 0.0)), True),
        "null_literal": (grouped((c("t") == pkg.lit(None).cast(ts_us)) | (c("i") > 500)),
                         True),
        # a literal's halves are 0-d env entries: K2 declines, K1 sums
        "literal_declines": (grouped(c("t") < LIT), False),
    }


@pytest.mark.parametrize("case", sorted(_deep_cases(daft_tpu)))
def test_deep_kernel_over_epoch_lanes(case):
    ref, got, traces, builds = _run_both(lambda pkg, f: _deep_cases(pkg)[case][0](f),
                                         _table(), deep=True)
    _assert_same(ref, got, floats=("s",))
    engaged = _deep_cases(daft_tpu)[case][1]
    assert traces == builds == int(engaged)
    # the deep result is the composed result, bit for bit
    daft_tpu_torch.set_execution_config(use_deep_fusion_kernel=False)
    composed = _deep_cases(daft_tpu_torch)[case][0](daft_tpu_torch.from_arrow(_table())).collect()
    assert composed.to_pydict() == got.to_pydict()


def test_emitted_epoch_compares_match_closures(tmp_path):
    """The K2 row function of a program whose predicate and summed column
    read epoch lanes, built with g++, against the torch closures: the same
    selection and the same float bits."""
    from daft_tpu_torch import col, interval, lit
    from daft_tpu_torch.kernels.device import lane_env, normalize_and_check, stage_table_columns
    from daft_tpu_torch.table import Table

    n = 3000
    tbl = Table.from_arrow(_table(n=n, seed=8))
    schema = tbl.schema
    ops = [col("t") < col("t2"), col("t") <= col("t2"), col("t") > col("t2"),
           col("t") >= col("t2"), col("t") == col("t"), col("t") != col("t2"),
           (col("t") + interval(days=1)) > (col("t2") - interval(hours=5))]
    pred = ops[0]
    for extra in ops[1:]:
        pred = pred | extra
    pred, = normalize_and_check([pred | (col("t") == lit(None).cast(
        daft_tpu_torch.DataType.timestamp("us")))], schema)
    kids = normalize_and_check([op.if_else(col("v"), -1.0) for op in ops], schema)
    env, dcs = stage_table_columns(tbl, ["v"], n, None, torch.device("cpu"))
    env = lane_env([pred] + kids, schema, tbl, n, None, env, dcs, {}, torch.device("cpu"))
    dtypes = {k: v.dtype for k, (v, _m) in env.items()}
    prog = fes.FusedExprSums(pred, kids, schema, dtypes)
    assert all("epochlane" in nm for nm in prog.names if nm != "v")
    assert "epochlane" not in prog.source  # operands bind by position
    lib = _gxx_lib(prog.host_source(), tmp_path, "epoch_rows")
    cols = [t.contiguous() for nm in prog.names for t in env[nm]]
    sel = torch.empty(n, dtype=torch.bool)
    out = torch.empty((n, len(kids)), dtype=torch.float32)
    lib.fes_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.fes_rows((ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols]), n,
                 sel.data_ptr(), out.data_ptr())
    sub = {nm: env[nm] for nm in prog.names}
    pv, pm = prog._pred_fn(sub)
    assert torch.equal(sel, pv & pm)
    assert 0 < int(sel.sum()) < n
    for j, fn in enumerate(prog._child_fns):
        v, m = fn(sub)
        want = torch.where(m & sel, v.to(torch.float32), 0.0)
        assert torch.equal(out[:, j].view(torch.int32), want.view(torch.int32)), j


# ---------------------------------------------------------------------------
# hypothesis: random epochs, both packages
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_EPOCH = st.one_of(st.none(), st.integers(-2 ** 62, 2 ** 62),
                   st.sampled_from([-2 ** 62, 2 ** 62, -1, 0, 1, 2 ** 32, -2 ** 32]))


def _epoch_table(a, b):
    return pa.table({"a": pa.array(a, pa.int64()).cast(pa.duration("us")),
                     "b": pa.array(b, pa.int64()).cast(pa.duration("us")),
                     "r": pa.array(np.arange(len(a)), pa.int64())})


@st.composite
def _two_epoch_cols(draw):
    n = draw(st.integers(min_value=1, max_value=24))
    return (draw(st.lists(_EPOCH, min_size=n, max_size=n)),
            draw(st.lists(_EPOCH, min_size=n, max_size=n)))


@given(_two_epoch_cols(), st.sampled_from(["==", "!=", "<", "<=", ">", ">="]))
@settings(max_examples=25, deadline=None)
def test_epoch_compare_property(case, op):
    table = _epoch_table(*case)

    def build(pkg, f):
        a, b = pkg.col("a"), pkg.col("b")
        pred = {"==": a == b, "!=": a != b, "<": a < b, "<=": a <= b, ">": a > b,
                ">=": a >= b}[op]
        return f.select(pred.alias("p"), (a < pkg.lit(datetime.timedelta(0))).alias("neg"))

    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        ref = build(daft_tpu, daft_tpu.from_arrow(table)).collect()
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = build(daft_tpu_torch, daft_tpu_torch.from_arrow(table)).collect()
    assert got.to_pydict() == ref.to_pydict()
    assert _routes(got) == _routes(ref)


@given(_two_epoch_cols(), st.booleans())
@settings(max_examples=25, deadline=None)
def test_epoch_sort_property(case, desc):
    table = _epoch_table(*case)

    def build(pkg, f):
        return f.sort(["a", "r"], desc=[desc, False]).select(pkg.col("r"))

    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        ref = build(daft_tpu, daft_tpu.from_arrow(table)).collect()
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = build(daft_tpu_torch, daft_tpu_torch.from_arrow(table)).collect()
    assert got.to_pydict() == ref.to_pydict()
    assert _routes(got) == _routes(ref)
