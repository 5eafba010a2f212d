"""The port's string-key joins held against daft_tpu in its 32-bit device
mode, on the CPU: plain string keys and row-local transforms of one string
column recode both sides' codes through their sorted joint dictionary and
probe on the card (daft_tpu_torch/kernels/device_join.py
``_stage_key_pair``, ``_string_code_side``, ``_joint_remaps``).

- Each case runs one join over the same pyarrow tables, made from a numpy
  seed, through daft_tpu under tests/device_mode.real_tpu_mode_cfg and
  through the port under that configuration with device="cpu". Join output
  order is unspecified engine-wide, so rows compare as multisets;
  device_join_probes and host_joins equal the reference's.
- The cases are the string-key cases of
  tests/device32/test_real_tpu_mode.py TestDeviceJoin and the string-key
  seeds of TestRandomizedDeviceJoins32.
- chip_smoke.py's phase-5 queries (lane_queries) at SF0.005 of
  benchmarks/tpch_full: the port's rows and every routing counter equal the
  reference's and chip_smoke.LANE_ROUTES, which phase 5 holds the card to
  at SF1; K2 engages on the deep query in both packages.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch_full
from chip_smoke import (LANE_COUNTERS, LANE_K1, LANE_ROUTES, lane_queries, lane_rows,
                        lane_tables, tpch22_match)
from daft_tpu_torch.kernels import fused_expr_sums as fes
from daft_tpu_torch.kernels import segment_sums
from device_mode import real_tpu_mode_cfg

JOIN_ROUTES = ("device_join_probes", "host_joins")


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _run_both(build, deep=False):
    """``build(pkg)`` (a DataFrame of package ``pkg``) collected through both
    packages; returns (reference frame, port frame, reference deep traces,
    port K2 builds)."""
    from daft_tpu.kernels import pallas_ops

    with real_tpu_mode_cfg(device_min_rows=8) as cfg:
        saved = cfg.use_pallas_deep_fusion
        cfg.use_pallas_deep_fusion = deep
        traces = pallas_ops.DEEP_FUSED_TRACES[0]
        try:
            ref = build(daft_tpu).collect()
        finally:
            cfg.use_pallas_deep_fusion = saved
        traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    d["use_pallas_deep_fusion"] = deep
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    builds = fes.BUILDS
    got = build(daft_tpu_torch).collect()
    return ref, got, traces, fes.BUILDS - builds


def _counters(df, names):
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in names}


def _sorted_rows(df):
    cols = df.to_pydict()
    keys = sorted(cols)
    return sorted(zip(*[cols[k] for k in keys]), key=lambda t: tuple((x is None, x) for x in t))


def _strs(values):
    return pa.array(values, pa.large_string())


def _assert_join(ref, got):
    assert _sorted_rows(got) == _sorted_rows(ref)
    assert _counters(got, JOIN_ROUTES) == _counters(ref, JOIN_ROUTES)
    assert _counters(got, JOIN_ROUTES)["device_join_probes"] >= 1


# ---------------------------------------------------------------------------
# TestDeviceJoin's string-key cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_string_key_join_on_device(how):
    rng = np.random.RandomState(29)
    codes = [f"n{i:03d}" for i in range(40)]
    lvals = np.array(codes)[rng.randint(0, 40, 4000)].tolist()
    lvals[11] = None
    left = pa.table({"nk": _strs(lvals), "lv": np.arange(4000, dtype=np.int64)})
    right = pa.table({"nk2": _strs(codes[5:]), "rv": np.arange(35, dtype=np.int64)})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(left).join(
        pkg.from_arrow(right), left_on="nk", right_on="nk2", how=how))
    _assert_join(ref, got)


def test_transformed_string_key_join_on_device():
    # '  mail ' joins 'MAIL' through the transform lane's dictionary
    rng = np.random.RandomState(37)
    base = ["mail", "ship", "air", "rail", "truck"]
    lvals = [f"  {base[i]} " if i % 2 else base[i].upper() for i in rng.randint(0, 5, 3000)]
    lvals[7] = None
    left = pa.table({"nk": _strs(lvals), "lv": np.arange(3000, dtype=np.int64)})
    right = pa.table({"nk2": _strs([b.upper() for b in base[:4]]),
                      "rv": np.arange(4, dtype=np.int64)})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(left).join(
        pkg.from_arrow(right), left_on=pkg.col("nk").str.lstrip().str.rstrip().str.upper(),
        right_on="nk2"))
    _assert_join(ref, got)


def test_fillnull_transform_key_join_no_phantom_padding():
    # the build side's padding lanes must not match through the null slot
    rng = np.random.RandomState(43)
    lvals = ["zz"] * 50 + np.array(["aa", "bb"])[rng.randint(0, 2, 400)].tolist()
    left = pa.table({"k": _strs(lvals), "lv": np.arange(len(lvals), dtype=np.int64)})
    right = pa.table({"s": _strs(["aa", None, "bb"]), "rv": np.arange(3, dtype=np.int64)})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(left).join(
        pkg.from_arrow(right), left_on="k", right_on=pkg.col("s").fill_null("zz")))
    _assert_join(ref, got)
    assert len(got.to_pydict()["lv"]) == 450  # one 'zz' build row, not the padding


def test_fillnull_int_key_join_no_phantom_padding():
    rng = np.random.RandomState(47)
    left = pa.table({"k": rng.randint(0, 3, 300).astype(np.int64),
                     "lv": np.arange(300, dtype=np.int64)})
    right = pa.table({"i": pa.array([1, None, 2], pa.int64()), "rv": np.arange(3, dtype=np.int64)})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(left).join(
        pkg.from_arrow(right), left_on="k", right_on=pkg.col("i").fill_null(0)))
    _assert_join(ref, got)


def test_int_transform_key_joins_as_ints_never_strings():
    left = pa.table({"s": _strs(["a", "bb", "ccc", "dddd"] * 100),
                     "lv": np.arange(400, dtype=np.int64)})
    right = pa.table({"n": np.array([1, 2, 3], dtype=np.int64),
                      "rv": np.array([10, 20, 30], dtype=np.int64)})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(left).join(
        pkg.from_arrow(right), left_on=pkg.col("s").str.length(), right_on="n"))
    _assert_join(ref, got)
    assert len(got.to_pydict()["lv"]) == 300


def test_join_key_embedding_cross_column_compare():
    rng = np.random.RandomState(53)
    n = 2000
    left = pa.table({"a": _strs(np.array(["x", "X", "y", "z"])[rng.randint(0, 4, n)].tolist()),
                     "b": _strs(np.array(["X", "Y", "Z"])[rng.randint(0, 3, n)].tolist()),
                     "lv": np.arange(n, dtype=np.int64)})
    right = pa.table({"m": np.array([0, 1], dtype=np.int64), "tag": ["miss", "hit"]})

    def build(pkg):
        key = (pkg.col("a").str.upper() == pkg.col("b")).if_else(1, 0)
        return pkg.from_arrow(left).join(pkg.from_arrow(right), left_on=key, right_on="m")

    ref, got, _t, _b = _run_both(build)
    _assert_join(ref, got)


def test_mixed_int_string_multikey_join():
    rng = np.random.RandomState(31)
    left = pa.table({"a": rng.randint(0, 20, 3000).astype(np.int64),
                     "s": _strs(np.array(["x", "y", "z"])[rng.randint(0, 3, 3000)].tolist())})
    right = pa.table({"a2": rng.randint(0, 20, 2000).astype(np.int64),
                      "s2": _strs(np.array(["x", "y", "z"])[rng.randint(0, 3, 2000)].tolist())})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(left).join(
        pkg.from_arrow(right), left_on=["a", "s"], right_on=["a2", "s2"]))
    _assert_join(ref, got)


# TestRandomizedDeviceJoins32's N:M string-key seeds (seed % 3 == 2)
@pytest.mark.parametrize("seed", [2, 5])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_random_string_key_joins(seed, how):
    rng = np.random.RandomState(100 + seed)
    nb = rng.randint(50, 400)
    npr = rng.randint(200, 2000)
    pool = np.array([f"k{i:03d}" for i in range(nb // 2 + 1)])
    bk = pool[rng.randint(0, len(pool), nb)].tolist()
    pool2 = np.array([f"k{i:03d}" for i in range(nb)])
    pk = pool2[rng.randint(0, len(pool2), npr)].tolist()
    for i in range(0, nb, 17):
        bk[i] = None
    for i in range(0, npr, 23):
        pk[i] = None
    build_t = pa.table({"k": _strs(bk), "bv": rng.randint(0, 1000, nb).astype(np.int64)})
    probe_t = pa.table({"k": _strs(pk), "pv": rng.randint(0, 1000, npr).astype(np.int64)})
    ref, got, _t, _b = _run_both(lambda pkg: pkg.from_arrow(probe_t).join(
        pkg.from_arrow(build_t), on="k", how=how))
    _assert_join(ref, got)


def test_joint_remaps_are_cached_in_both_sides_caches():
    import torch

    from daft_tpu_torch.kernels.device_join import _joint_remaps, _string_code_side
    from daft_tpu_torch.table import Table

    lt = Table.from_arrow(pa.table({"k": _strs(["b", "a", None, "d"])}))
    rt = Table.from_arrow(pa.table({"k": _strs(["d", "c", "b"])}))
    lcache, rcache = {}, {}
    dev = torch.device("cpu")
    ls = _string_code_side(lt, daft_tpu_torch.col("k"), lcache, dev)
    rs = _string_code_side(rt, daft_tpu_torch.col("k"), rcache, dev)
    lremap, rremap = _joint_remaps(ls, rs, lcache, rcache, dev)
    # joint dictionary a b c d: the left's a b d and the right's b c d
    assert lremap[:3].tolist() == [0, 1, 3] and rremap[:3].tolist() == [1, 2, 3]
    again = _joint_remaps(ls, rs, {}, rcache, dev)  # found through the right side's cache
    assert again[0] is lremap and again[1] is rremap
    entry = next(v for k, v in rcache.items() if k[0] == "__jointremap__")
    assert entry[0] is ls.dictionary and entry[1] is rs.dictionary  # the ids stay live


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-5 queries at SF0.005
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lane_data():
    return lane_tables(tpch_full.generate(scale=0.005, seed=7))


@pytest.mark.parametrize("name", sorted(LANE_ROUTES))
def test_lane_query_matches_reference(name, lane_data):
    deep = lane_queries(daft_tpu)[name][1]
    k1 = segment_sums.ENTRIES

    def build(pkg):
        return lane_queries(pkg)[name][0]({k: pkg.from_arrow(v) for k, v in lane_data.items()})

    ref, got, traces, builds = _run_both(build, deep=deep)
    k1 = segment_sums.ENTRIES - k1
    assert tpch22_match(lane_rows(got.to_arrow()), lane_rows(ref.to_arrow()))
    assert _counters(got, LANE_COUNTERS) == _counters(ref, LANE_COUNTERS)
    assert _counters(got, LANE_COUNTERS) == {k: LANE_ROUTES[name].get(k, 0)
                                             for k in LANE_COUNTERS}
    assert traces == builds == int(deep)
    assert (k1 >= 1) == (name in LANE_K1)
