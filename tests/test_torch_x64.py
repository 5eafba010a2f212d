"""The port's 64-bit device mode (``device_x64=True``) held against daft_tpu
in its own default x64 mode (tests/conftest.py turns jax_enable_x64 on),
on the CPU.

Each case runs one query over the same pyarrow table, made from a numpy
seed, through daft_tpu with ``use_device_kernels=True`` and
``device_min_rows=8`` (the configuration of
tests/test_tpch_suite.py::test_tpch_query_device_mode) and through the port
under that configuration, mapped by ``execution_config_from_dict`` with
device="cpu". Values equal the reference's (float sums at rtol 1e-12, ints
exactly), and so do the routing counters.

- Projections: tests/test_device_kernels.py's PROJ_EXPRS, int64 arithmetic
  past 2**31 and timestamp, duration and time compares of columns,
  computed sides and literals (plain int64 closures in this mode, no epoch
  lanes).
- Staging: int64 past int32, float64, timestamps and uint64 stage at full
  width; the 32-bit mode declines or splits them.
- Aggregates: int64, float64, mean, count, min and max up to 4096 groups
  and above (the float64 scatter-sums wrapper); K1 and K2 never run.
- Sorts, joins with a composite key past int32, the float64 scatter
  kernel's plain version against the reference's ``_scatter_sum_kahan``
  bit for bit, and the caches' isolation of the two modes.
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import daft_tpu
import daft_tpu_torch
from daft_tpu.kernels import device as ref_device
from daft_tpu_torch.kernels import device as port_device
from daft_tpu_torch.kernels import fused_expr_sums as fes
from daft_tpu_torch.kernels import scatter_sums, segment_sums

ROUTES = ("device_filters", "host_filters", "device_projections", "host_projections",
          "device_fused_maps", "host_fused_maps", "device_aggregations", "host_aggregations",
          "device_agg_fallbacks", "device_sorts", "host_sorts", "device_group_codes",
          "device_join_probes", "host_joins", "device_distincts", "host_distincts",
          "device_resident_segments", "segment_fallbacks")
BASE = datetime.datetime(2020, 1, 1)
LIT = BASE + datetime.timedelta(seconds=5 * 10 ** 6)


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def x64_config(**ref_knobs):
    """The port's config for the reference's x64 device-mode settings (and
    ``ref_knobs`` set on a copy of the reference's config)."""
    from daft_tpu.context import get_context

    d = dataclasses.asdict(get_context().execution_config)
    d.update(use_device_kernels=True, device_min_rows=8, **ref_knobs)
    d["jax_enable_x64"] = True
    return daft_tpu_torch.execution_config_from_dict(d, device="cpu")


def run_both(build, tables, **ref_knobs):
    """``build(pkg, *frames)`` through both packages under one
    configuration: the reference in its x64 mode with device kernels on and
    ``device_min_rows=8``, the port mapped from it. Returns (reference
    frame, port frame), both collected."""
    from daft_tpu.context import get_context

    assert jax.config.jax_enable_x64
    cfg = get_context().execution_config
    knobs = dict(use_device_kernels=True, device_min_rows=8, **ref_knobs)
    saved = {k: getattr(cfg, k) for k in knobs}
    for k, v in knobs.items():
        setattr(cfg, k, v)
    try:
        ref = build(daft_tpu, *[daft_tpu.from_arrow(t) for t in tables]).collect()
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)
    daft_tpu_torch.set_execution_config(x64_config(**ref_knobs))
    got = build(daft_tpu_torch, *[daft_tpu_torch.from_arrow(t) for t in tables]).collect()
    return ref, got


def routes(df):
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ROUTES}


def assert_same(ref, got, floats=(), ordered=True):
    r, g = ref.to_pydict(), got.to_pydict()
    assert list(g) == list(r)
    if not ordered:
        def rows(d):
            return sorted(zip(*d.values()), key=lambda row: tuple(
                (x is None, x if x is not None else 0) for x in row))

        assert rows(g) == rows(r)
    for name in r:
        if name in floats:
            a = np.array([np.nan if x is None else x for x in g[name]], dtype=float)
            b = np.array([np.nan if x is None else x for x in r[name]], dtype=float)
            np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
        elif ordered:
            assert g[name] == r[name], name
    assert routes(got) == routes(ref)


# ---------------------------------------------------------------------------
# Projections and filters
# ---------------------------------------------------------------------------

def _proj_table():
    """tests/test_device_kernels.py's table, plus int64 past int32, two
    nullable timestamps, a duration and a time."""
    n = 200
    rng = np.random.RandomState(11)
    start = np.datetime64("2020-01-01T00:00:00", "us")

    def ts(every):
        secs = rng.randint(0, 10 ** 7, n).astype("timedelta64[s]")
        return pa.array(start + secs, mask=np.arange(n) % every == 0)

    return pa.table({
        "a": pa.array([1, 2, None, 4, 5] * 40, pa.int64()),
        "b": pa.array([1.5, 2.5, 3.5, None, 0.0] * 40, pa.float64()),
        "d": pa.array([datetime.date(2020, 1, i + 1) for i in range(5)] * 40),
        "flag": pa.array([True, False, None, True, False] * 40),
        "i": pa.array(rng.randint(-3 * 10 ** 9, 3 * 10 ** 9, n), pa.int64()),
        "j": pa.array(rng.randint(10 ** 4, 3 * 10 ** 5, n), pa.int64()),
        "t": ts(7),
        "t2": ts(11),
        "du": pa.array(rng.randint(-10 ** 12, 10 ** 12, n).astype("timedelta64[us]"),
                       mask=np.arange(n) % 13 == 0),
        "tm": pa.array(rng.randint(0, 86_400 * 10 ** 6, n), pa.time64("us")),
        "tm2": pa.array(rng.randint(0, 86_400 * 10 ** 6, n), pa.time64("us"),
                        mask=np.arange(n) % 17 == 0),
    })


def _proj_exprs(pkg):
    c, lit = pkg.col, pkg.lit
    return [
        # tests/test_device_kernels.py PROJ_EXPRS
        (c("a") * 2 + 1).alias("x"),
        (c("b") / c("a")).alias("div"),
        (c("a") > 2).alias("gt"),
        c("a").fill_null(0).alias("fz"),
        ((c("d") <= datetime.date(2020, 1, 3)) & c("a").not_null()).alias("pred"),
        (c("a") % 3).alias("mod"),
        (c("a") // 2).alias("fdiv"),
        c("b").float.is_nan().alias("nan"),
        (c("a") > 1).if_else(c("b"), lit(0.0)).alias("ie"),
        c("a").between(2, 4).alias("btw"),
        (~c("flag")).alias("nf"),
        (c("flag") | (c("a") > 3)).alias("or_k"),
        c("a").is_null().alias("isn"),
        c("b").abs().alias("ab"),
        c("a").cast(pkg.DataType.float32()).alias("cf"),
        # int64 past 2**31: the product int64_wrap_safe's docstring names
        (c("j") * c("j")).alias("sq"),
        (c("i") + c("i") - 7).alias("i2"),
        (c("i") > 2 ** 33).alias("ibig"),
        c("i").is_in([2 ** 40, -5, 7]).alias("iin"),
        # epoch compares: columns, computed sides and literals
        (c("t") < LIT).alias("t_lt"),
        (pkg.lit(LIT) >= c("t")).alias("t_flip"),
        (c("t") == c("t2")).alias("t_eq"),
        (c("t") <= c("t2")).alias("t_le"),
        (c("t").between(BASE, LIT)).alias("t_btw"),
        (c("du") > datetime.timedelta(days=2)).alias("du_gt"),
        (c("tm") < c("tm2")).alias("tm_lt"),
        c("t").alias("t_out"),
    ]


def test_projection_matches_reference():
    tbl = _proj_table()
    ref, got = run_both(lambda pkg, f: f.select(*_proj_exprs(pkg)), [tbl])
    assert_same(ref, got, floats=("div", "ie", "ab", "cf"))
    assert routes(got)["device_projections"] == 1 and routes(got)["host_projections"] == 0
    sq = got.to_pydict()["sq"]
    assert max(sq) > 2 ** 31  # past int32, exact


@pytest.mark.parametrize("case", ["ts_lit", "ts_colcol", "ts_computed", "duration", "time",
                                  "int64_big"])
def test_filter_matches_reference(case):
    def build(pkg, f):
        c, iv = pkg.col, pkg.interval
        pred = {
            "ts_lit": (c("t") >= LIT) & (c("t") < LIT + datetime.timedelta(days=30)),
            "ts_colcol": c("t") > c("t2"),
            "ts_computed": (c("t") + iv(days=3)) < c("t2"),
            "duration": c("du") <= datetime.timedelta(hours=-5),
            "time": c("tm") >= c("tm2"),
            "int64_big": (c("i") * 3) > 2 ** 32,
        }[case]
        return f.where(pred).select("a", "i", "t", "du")

    ref, got = run_both(build, [_proj_table()])
    assert_same(ref, got)
    if case != "ts_computed":  # timestamp arithmetic is the host's in both
        assert routes(got)["device_filters"] == 1


@pytest.mark.parametrize("target", ["timestamp_us", "timestamp_ms", "date"])
def test_temporal_recast_stays_on_the_host(target):
    """A cast between temporal types rescales the epoch on the host; the
    64-bit mode's int64 lanes would only reinterpret it, so the port
    declines it (the reference's card reinterprets: a date cast to
    timestamp[us] comes out as microseconds after 1970). Held against the
    port's host path."""
    tbl = pa.table({"d": pa.array([datetime.date(2020, 1, i + 1) for i in range(20)]),
                    "t": pa.array([BASE + datetime.timedelta(seconds=i) for i in range(20)],
                                  pa.timestamp("us"))})

    def build(pkg, f):
        dt = {"timestamp_us": pkg.DataType.timestamp("us"),
              "timestamp_ms": pkg.DataType.timestamp("ms"), "date": pkg.DataType.date()}[target]
        src = "d" if target == "timestamp_us" else "t"
        return f.select(pkg.col(src).cast(dt).alias("x"), (pkg.col("t") > LIT).alias("p"))

    daft_tpu_torch.set_execution_config(x64_config())
    dev = build(daft_tpu_torch, daft_tpu_torch.from_arrow(tbl)).collect()
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    host = build(daft_tpu_torch, daft_tpu_torch.from_arrow(tbl)).collect()
    assert dev.to_pydict() == host.to_pydict()
    assert routes(dev)["device_projections"] == 0 and routes(dev)["host_projections"] == 1


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------

def test_staging_is_full_width_and_the_32bit_mode_declines():
    from daft_tpu_torch.table import Table

    tbl = Table.from_arrow(pa.table({
        "big": pa.array([1, 2 ** 40, None, -(2 ** 35)], pa.int64()),
        "f": pa.array([0.1, 1e300, None, -2.5]),
        "t": pa.array([BASE, None, LIT, BASE], pa.timestamp("us")),
        "u": pa.array([1, 2 ** 62, 3, None], pa.uint64()),
        "uhuge": pa.array([1, 2 ** 63, 3, 4], pa.uint64()),
    }))
    dev = torch.device("cpu")
    daft_tpu_torch.set_execution_config(device="cpu", device_x64=True)
    env, dcs = port_device.stage_table_columns(tbl, ["big", "f", "t", "u"], 1024, {}, dev)
    assert [env[k][0].dtype for k in ("big", "f", "t", "u")] == [
        torch.int64, torch.float64, torch.int64, torch.int64]
    assert env["big"][0][1] == 2 ** 40 and env["f"][0][1] == 1e300
    assert env["u"][0][1] == 2 ** 62
    assert port_device.stage_table_columns(tbl, ["uhuge"], 1024, {}, dev) is None
    # the 32-bit mode declines the wide int (by raising, as the reference's
    # staging does: the device attempt counts it against the breaker) and
    # the epoch column (epochs ride split lanes there), and rounds float64
    # to float32
    daft_tpu_torch.set_execution_config(device="cpu", device_x64=False)
    with pytest.raises(ValueError, match="exceed int32 range"):
        port_device.stage_table_columns(tbl, ["big"], 1024, {}, dev)
    assert port_device.stage_table_columns(tbl, ["t"], 1024, {}, dev) is None
    env32, _ = port_device.stage_table_columns(tbl, ["f"], 1024, {}, dev)
    assert env32["f"][0].dtype == torch.float32


def test_uint64_staging_decline_is_pinned():
    """A uint64 column with a value of 2**63 or more declines to the host:
    its int64 lanes would order it below 0 (the reference's uint64 lanes do
    not), so compares, min/max and sort keys would go wrong. Pinned: the
    reference runs this projection on the card, the port on the host."""
    tbl = pa.table({"u": pa.array([1, 2 ** 63 + 5, 3, 7] * 4, pa.uint64())})
    ref, got = run_both(lambda pkg, f: f.select((pkg.col("u") > 2).alias("g")), [tbl])
    assert got.to_pydict() == ref.to_pydict()
    assert (routes(got)["device_projections"], routes(ref)["device_projections"]) == (0, 1)
    assert routes(got)["host_projections"] == 1


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

def _agg_table(n, groups, seed):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, groups, n)
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "i": pa.array(rng.randint(-2 ** 40, 2 ** 40, n), pa.int64(),
                      mask=rng.rand(n) < 0.05),
        "i32": pa.array(rng.randint(2 ** 30, 2 ** 31 - 1, n).astype(np.int32)),
        "f": pa.array(rng.rand(n) * 1e6 - 3e5, mask=rng.rand(n) < 0.05),
        "t": pa.array(np.datetime64("2020-01-01", "us")
                      + rng.randint(0, 10 ** 12, n).astype("timedelta64[us]")),
    })


def _aggs(pkg):
    c = pkg.col
    return [c("i").sum().alias("si"), c("i32").sum().alias("s32"), c("f").sum().alias("sf"),
            c("f").mean().alias("mf"), c("i").mean().alias("mi"), c("f").count().alias("n"),
            c("i").min().alias("mn"), c("i").max().alias("mx"), c("f").min().alias("fmn"),
            c("f").max().alias("fmx"), (c("f") * 2.5 - c("i32")).sum().alias("sd"),
            c("t").min().alias("tmn"), c("t").max().alias("tmx")]


@pytest.mark.parametrize("groups,n", [(50, 6000), (6000, 20_000)],
                         ids=["onehot_50_groups", "scatter_6000_groups"])
@pytest.mark.parametrize("deep", [False, True], ids=["composed", "deep_knob"])
def test_grouped_aggregate_matches_reference(groups, n, deep):
    tbl = _agg_table(n, groups, seed=groups)
    before = (segment_sums.ENTRIES, fes.ENTRIES, fes.BUILDS, scatter_sums.ENTRIES,
              scatter_sums.ENTRIES_F64)
    ref, got = run_both(lambda pkg, f: f.where(pkg.col("i32") > 2 ** 30 + 5).groupby("k")
                        .agg(*_aggs(pkg)).sort("k"),
                        [tbl], use_pallas_deep_fusion=deep)
    after = (segment_sums.ENTRIES, fes.ENTRIES, fes.BUILDS, scatter_sums.ENTRIES,
             scatter_sums.ENTRIES_F64)
    assert_same(ref, got, floats=("sf", "mf", "mi", "fmn", "fmx", "sd"))
    r = got.to_pydict()
    assert max(abs(x) for x in r["si"] if x is not None) > 2 ** 31
    assert max(r["s32"]) > 2 ** 31  # int32 inputs sum exactly in int64
    assert routes(got)["device_aggregations"] == 1
    # K1 and K2 never run in the 64-bit mode, whatever the knobs say; above
    # 4096 groups every float sum goes through the float64 scatter wrapper
    assert after[:4] == before[:4]
    assert after[4] - before[4] == (3 if groups > 4096 else 0)


def test_ungrouped_aggregate_matches_reference():
    tbl = _agg_table(5000, 10, seed=3)
    ref, got = run_both(lambda pkg, f: f.agg(*_aggs(pkg)), [tbl])
    assert_same(ref, got, floats=("sf", "mf", "mi", "fmn", "fmx", "sd"))


def test_map_chain_aggregate_runs_as_one_segment():
    """A with_column chain with a timestamp filter feeding an aggregate: one
    DeviceSegmentOp in both packages (the epoch compare is a plain int64
    closure in this mode, so the segment does not decline)."""
    tbl = _agg_table(6000, 40, seed=8)

    def build(pkg, f):
        c = pkg.col
        return (f.with_column("d", c("f") * 2.5 - c("i32"))
                .where(c("t") < datetime.datetime(2020, 1, 5))
                .groupby("k").agg(c("d").sum().alias("sd"), c("i").sum().alias("si"),
                                  c("d").count().alias("n")).sort("k"))

    ref, got = run_both(build, [tbl])
    assert_same(ref, got, floats=("sd",))
    assert routes(got)["device_resident_segments"] == 1


def test_float64_sum_needs_the_mode():
    """Values 1e8 + k/8 sum to different bits in float32: the 32-bit mode
    lands far from the reference's x64 sum, the 64-bit mode on it."""
    n = 4096
    rng = np.random.RandomState(5)
    tbl = pa.table({"k": pa.array(rng.randint(0, 3, n), pa.int64()),
                    "v": pa.array(1e8 + rng.randint(0, 8, n) / 8.0)})

    def build(pkg, f):
        return f.groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k")

    ref, got = run_both(build, [tbl])
    want = np.array(ref.to_pydict()["s"])
    np.testing.assert_allclose(got.to_pydict()["s"], want, rtol=1e-12)
    daft_tpu_torch.set_execution_config(dataclasses.replace(
        daft_tpu_torch.get_context().execution_config, device_x64=False))
    got32 = build(daft_tpu_torch, daft_tpu_torch.from_arrow(tbl)).collect()
    assert routes(got32)["device_aggregations"] == 1
    assert np.abs(np.array(got32.to_pydict()["s"]) - want).max() > 1e-12 * np.abs(want).max()


def test_count_partials_merge_in_uint64():
    """Three partitions: the two-stage aggregate merges uint64 count partials
    on the card (int64 bits), exactly."""
    tbls = [_agg_table(3000, 40, seed=s) for s in (1, 2, 3)]

    def build(pkg, f):
        return f.groupby("k").agg(pkg.col("i").count().alias("n"),
                                  pkg.col("f").sum().alias("s"))

    ref, got = run_both(build, [tbls])  # one frame of three partitions
    order = np.argsort(ref.to_pydict()["k"])
    r = {k: np.array(v)[order] for k, v in ref.to_pydict().items()}
    g = got.to_pydict()
    gorder = np.argsort(g["k"])
    g = {k: np.array(v)[gorder] for k, v in g.items()}
    assert (g["k"] == r["k"]).all() and (g["n"] == r["n"]).all()
    np.testing.assert_allclose(g["s"], r["s"], rtol=1e-12)
    assert routes(got) == routes(ref)
    assert routes(got)["device_aggregations"] >= 4  # stage 1 on each partition, then stage 2


# ---------------------------------------------------------------------------
# Sorts
# ---------------------------------------------------------------------------

def _sort_table(n=3000, seed=9):
    rng = np.random.RandomState(seed)
    f = rng.randn(n) * 1e3
    f[rng.rand(n) < 0.05] = np.nan
    f[rng.rand(n) < 0.05] = 0.0
    f[rng.rand(n) < 0.05] = -0.0
    f[:4] = [np.inf, -np.inf, 1e-300, -1e-300]
    return pa.table({
        "i": pa.array(rng.randint(-2 ** 62, 2 ** 62, n) // rng.choice([1, 2 ** 40], n),
                      pa.int64(), mask=rng.rand(n) < 0.05),
        "f": pa.array(f, mask=rng.rand(n) < 0.05),
        "t": pa.array(np.datetime64("2020-01-01", "us")
                      + rng.randint(-10 ** 14, 10 ** 14, n).astype("timedelta64[us]"),
                      mask=rng.rand(n) < 0.05),
        "g": pa.array(rng.randint(0, 5, n), pa.int64()),
        "row": pa.array(np.arange(n), pa.int64()),
    })


@pytest.mark.parametrize("keys,desc", [
    (["i"], False), (["i"], True), (["f"], False), (["f"], True), (["t"], False),
    (["t"], True), (["g", "f"], [False, True]), (["g", "t", "i"], [True, False, True]),
])
def test_sort_matches_reference(keys, desc):
    ref, got = run_both(lambda pkg, f: f.sort(keys, desc=desc), [_sort_table()])
    assert got.to_pydict()["row"] == ref.to_pydict()["row"]
    assert routes(got) == routes(ref)
    assert routes(got)["device_sorts"] == 1


@settings(max_examples=25, deadline=None)
@given(ints=st.lists(st.integers(-2 ** 63, 2 ** 63 - 1), min_size=9, max_size=40),
       floats=st.lists(st.floats(allow_nan=True, allow_infinity=True, allow_subnormal=False,
                                 width=64), min_size=9, max_size=40),
       desc=st.booleans())
def test_sort_property_over_the_64bit_ranges(ints, floats, desc):
    """Subnormal floats are left to the next test: the reference's XLA CPU
    backend flushes them to zero, so its order ties them with 0.0."""
    n = min(len(ints), len(floats))
    tbl = pa.table({"i": pa.array(ints[:n], pa.int64()), "f": pa.array(floats[:n]),
                    "row": pa.array(np.arange(n), pa.int64())})
    for key in ("i", "f"):
        ref, got = run_both(lambda pkg, f: f.sort(key, desc=desc), [tbl])
        assert got.to_pydict()["row"] == ref.to_pydict()["row"], key
        assert routes(got)["device_sorts"] == 1


def test_sort_orders_subnormals_as_the_host_does():
    """The port keeps subnormal float64 keys apart, as its host sort (arrow)
    does and as a card's float64 compare does."""
    vals = [5e-324, -5e-324, 0.0, -0.0, 1e-310, -1e-310, None, float("nan")] * 4
    tbl = pa.table({"f": pa.array(vals), "row": pa.array(np.arange(len(vals)), pa.int64())})
    daft_tpu_torch.set_execution_config(x64_config())
    for desc in (False, True):
        dev = daft_tpu_torch.from_arrow(tbl).sort("f", desc=desc).collect()
        assert routes(dev)["device_sorts"] == 1
        daft_tpu_torch.set_execution_config(use_device_kernels=False)
        host = daft_tpu_torch.from_arrow(tbl).sort("f", desc=desc).collect()
        daft_tpu_torch.set_execution_config(use_device_kernels=True)
        assert dev.to_pydict()["row"] == host.to_pydict()["row"]


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

def test_composite_key_past_int32_joins_on_the_card():
    """Two int64 keys spanning 2e5 each: a key space of 4e10, past int32,
    inside int64. The probe packs it into int64 lanes."""
    rng = np.random.RandomState(21)
    n = 2000
    a = rng.randint(0, 200_000, n)
    b = rng.randint(0, 200_000, n)
    left = pa.table({"a": pa.array(a, pa.int64()), "b": pa.array(b, pa.int64()),
                     "x": pa.array(np.arange(n), pa.int64())})
    pick = rng.choice(n, 700, replace=False)
    right = pa.table({"a": pa.array(np.r_[a[pick], [0, 199_999]], pa.int64()),
                      "b": pa.array(np.r_[b[pick], [199_999, 0]], pa.int64()),
                      "y": pa.array(np.arange(702) * 10, pa.int64())})
    ref, got = run_both(lambda pkg, l, r: l.join(r, on=["a", "b"]), [left, right])
    assert_same(ref, got, ordered=False)
    assert routes(got)["device_join_probes"] == 1 and routes(got)["host_joins"] == 0
    assert len(got.to_pydict()["x"]) == len(ref.to_pydict()["x"]) >= 700


def test_uint64_key_join_probes_on_the_card_where_the_reference_joins_on_the_host():
    """A uint64-key self join (keys 2**40 + 0..7). Pinned: the reference's
    probe passes the uint64 maximum to jnp.where as its sentinel
    (daft_tpu/kernels/device_join.py:58-59), jax raises OverflowError, and
    the pair joins on the host (host_joins 1). The port's uint64 lanes hold
    int64 bits below 2**63 and probe on the card (device_join_probes 1).
    The rows are equal."""
    tbl = pa.table({"u": pa.array(2 ** 40 + np.arange(8), pa.uint64()),
                    "x": pa.array(np.arange(8), pa.int64())})
    ref, got = run_both(lambda pkg, l, r: l.join(r, on="u"), [tbl, tbl])
    r, g = ref.to_pydict(), got.to_pydict()
    assert sorted(zip(*g.values())) == sorted(zip(*r.values())) and len(g["u"]) == 8
    assert (routes(got)["device_join_probes"], routes(ref)["host_joins"]) == (1, 1)
    assert (routes(got)["host_joins"], routes(ref)["device_join_probes"]) == (0, 0)


# ---------------------------------------------------------------------------
# The float64 scatter kernel's plain version
# ---------------------------------------------------------------------------

def _bits64(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("g,b", [(4097, 16_384), (20_000, 65_536), (5000, 4096)])
def test_scatter_plain_f64_equals_reference_bit_for_bit(g, b):
    rng = np.random.RandomState(g)
    codes = rng.randint(0, g, b).astype(np.int32)
    vals = rng.rand(b) * 104100.0 + 900.0 + rng.rand(b) * 1e-7
    vals[rng.rand(b) < 0.2] = 0.0
    ref = np.asarray(ref_device._scatter_sum_kahan(jnp.asarray(vals), jnp.asarray(codes), g))
    assert ref.dtype == np.float64
    got = scatter_sums.scatter_sum_kahan(torch.from_numpy(vals), torch.from_numpy(codes), g)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(_bits64(got.numpy()), _bits64(ref))


def test_scatter_f64_order_and_zero_rows():
    """The order-of-additions case of tests/test_torch_scatter_sums.py in
    float64: row order within a chunk and chunk order across chunks change
    the bits, and the plain version and the reference follow the forward
    order; rows of +-0.0 leave every sum as it is, and no sum is -0.0."""
    g, b = 4100, 32_768
    chunk = scatter_sums.chunk_rows(b)
    codes = np.zeros(b, dtype=np.int32)
    vals = np.zeros(b)
    codes[:3] = 1
    vals[:3] = [1.0, 1e17, -1e17]  # (1 + 1e17) - 1e17 != (-1e17 + 1e17) + 1
    for c, v in enumerate([1e17, -1e17, 0.7, 0.7]):
        codes[c * chunk + 10] = 2
        vals[c * chunk + 10] = v
    codes[20:26] = 5
    vals[20:26] = [-0.0, 3.5, -3.5, -0.0, -0.0, 0.0]
    ref = np.asarray(ref_device._scatter_sum_kahan(jnp.asarray(vals), jnp.asarray(codes), g))
    got = scatter_sums.scatter_sum_kahan_plain(torch.from_numpy(vals), torch.from_numpy(codes),
                                               g).numpy()
    np.testing.assert_array_equal(_bits64(got), _bits64(ref))
    assert got[1] == 0.0 and got[2] == 1.4  # the forward orders
    rev = vals.copy()
    rev[:3] = vals[:3][::-1]
    assert scatter_sums.scatter_sum_kahan_plain(torch.from_numpy(rev), torch.from_numpy(codes),
                                                g).numpy()[1] != got[1]
    assert not (np.signbit(got) & (got == 0)).any()


def test_segment_reduce_routes_float64_sums_above_4096_through_the_wrapper():
    daft_tpu_torch.set_execution_config(device="cpu", device_x64=True)
    g = 6000
    rng = np.random.RandomState(3)
    codes = rng.randint(0, g, 16_384).astype(np.int32)
    vals = rng.rand(16_384) * 1e5
    valid = torch.from_numpy(rng.rand(16_384) > 0.2)
    before = scatter_sums.ENTRIES, scatter_sums.ENTRIES_F64, scatter_sums.LAUNCHES_F64
    out, ok = port_device.segment_reduce(torch.from_numpy(vals), valid,
                                         torch.from_numpy(codes), g, "sum")
    assert (scatter_sums.ENTRIES, scatter_sums.ENTRIES_F64 - 1,
            scatter_sums.LAUNCHES_F64) == before  # a CPU tensor never launches
    assert out.dtype == torch.float64
    m = valid.numpy()
    ref = np.asarray(ref_device._scatter_sum_kahan(jnp.asarray(np.where(m, vals, 0.0)),
                                                   jnp.asarray(codes), g))
    np.testing.assert_array_equal(_bits64(out.numpy()), _bits64(ref))
    cnt, _ = port_device.segment_reduce(valid, valid, torch.from_numpy(codes), g, "count")
    assert cnt.dtype == torch.int64


# ---------------------------------------------------------------------------
# Cache isolation and the config mapping
# ---------------------------------------------------------------------------

def test_the_modes_do_not_share_staged_columns_or_programs():
    """One collected frame queried in the 32-bit mode, then the 64-bit one,
    then the 32-bit one again: each run gives its mode's own answer."""
    tbl = pa.table({"k": pa.array([1, 2, 3, 1] * 1024, pa.int64()),
                    "v": pa.array((1e8 + np.arange(4096) / 8.0)),
                    "w": pa.array(np.arange(4096) * 2 ** 21, pa.int64())})

    def build(pkg, f):
        return f.groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k")

    def build_w(pkg, f):
        return f.groupby("k").agg(pkg.col("w").sum().alias("sw")).sort("k")

    ref, fresh64 = run_both(build, [tbl])
    ref_w, _ = run_both(build_w, [tbl])
    cfg64 = daft_tpu_torch.get_context().execution_config
    cfg32 = dataclasses.replace(cfg64, device_x64=False)
    daft_tpu_torch.set_execution_config(cfg32)
    fresh32 = build(daft_tpu_torch, daft_tpu_torch.from_arrow(tbl)).collect().to_pydict()
    frame = daft_tpu_torch.from_arrow(tbl).collect()
    answers, w_routes = [], []
    for cfg in (cfg32, cfg64, cfg32):
        daft_tpu_torch.set_execution_config(cfg)
        answers.append(build(daft_tpu_torch, frame).collect())
        w = build_w(daft_tpu_torch, frame).collect()
        assert w.to_pydict() == ref_w.to_pydict()
        w_routes.append(routes(w)["device_aggregations"])
    assert answers[0].to_pydict() == fresh32 == answers[2].to_pydict()
    assert answers[1].to_pydict() == fresh64.to_pydict()
    np.testing.assert_allclose(answers[1].to_pydict()["s"], ref.to_pydict()["s"], rtol=1e-12)
    assert fresh32["s"] != answers[1].to_pydict()["s"]  # float32 sums in the 32-bit mode
    # w's values pass int32: the 32-bit mode sums them on the host, the
    # 64-bit mode on the card
    assert w_routes == [0, 1, 0]


def test_config_maps_x64_and_full_width_float64():
    from daft_tpu.context import ExecutionConfig as RefConfig

    d = dataclasses.asdict(RefConfig(use_device_kernels=True, device_min_rows=8))
    d["device_reduced_precision"] = False
    with pytest.raises(NotImplementedError):
        daft_tpu_torch.execution_config_from_dict({**d, "jax_enable_x64": False})
    cfg = daft_tpu_torch.execution_config_from_dict({**d, "jax_enable_x64": True},
                                                    device="cpu")
    assert cfg.device_x64 and cfg.device == "cpu"
    assert daft_tpu_torch.ExecutionConfig(device_x64=True).device == "cuda"
