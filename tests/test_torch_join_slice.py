"""The port's join slice (TPC-H Q3 and Q5, the device join probe K7, the
device argsort K5 and Limit) held against daft_tpu in its 32-bit device
mode, on the CPU.

Every case builds one query over the same data in both packages: daft_tpu
under tests/device_mode.real_tpu_mode_cfg (x64 off, device kernels on), the
port under execution_config_from_dict(...) of that config with device="cpu".
Join output order is unspecified engine-wide (daft_tpu/table.py hash_join),
so N:M joins compare as row multisets; primary-key joins, whose device probe
emits the host's (left row, right row) order, and sorts compare exactly.
Float sums agree at rtol 1e-6 (both sides sum in float32 with compensation).
"""

import dataclasses
import datetime
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import oracle_q3_groups, parity, q3 as port_q3, q3_parity, q5 as port_q5
from device_mode import real_tpu_mode_cfg

RTOL = 1e-6
MIN_ROWS = 8


@pytest.fixture(autouse=True)
def _restore_port_config():
    """Each case sets the port's process-wide config; the next test file in
    this process gets the config back as it found it."""
    ctx = daft_tpu_torch.context.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _port_cfg(cfg, **overrides):
    d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    return daft_tpu_torch.execution_config_from_dict(d, device="cpu", **overrides)


def _both(build, min_rows=MIN_ROWS, **port_overrides):
    """Run ``build(pkg)`` (a collected DataFrame of package ``pkg``) through
    both packages; returns (reference frame, port frame)."""
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        ref = build(daft_tpu)
        port_cfg = _port_cfg(cfg, **port_overrides)
    daft_tpu_torch.set_execution_config(port_cfg)
    return ref, build(daft_tpu_torch)


def _counters(df):
    return df.stats.snapshot()["counters"]


def _sorted_rows(df):
    """Order-insensitive row multiset; None sorts before every value."""
    cols = df.to_pydict()
    keys = sorted(cols)
    return sorted(zip(*[cols[k] for k in keys]),
                  key=lambda t: tuple((x is None, x) for x in t))


def _nullable(pkg, values, name, dtype="int64"):
    return pkg.Series.from_pylist(values, name, getattr(pkg.DataType, dtype)())


# ---------------------------------------------------------------------------
# TPC-H Q3 and Q5
# ---------------------------------------------------------------------------

# counters on which the two packages must agree, for both queries
_SHARED = ("broadcast_joins", "device_join_dispatches", "device_join_probes",
           "device_aggregations", "device_group_codes", "device_resident_segments",
           "device_handoffs_elided", "segment_compiles", "segment_dispatches",
           "device_sorts", "host_sorts", "host_joins", "device_agg_fallbacks",
           "fused_chains", "fused_ops_eliminated", "device_fused_maps",
           "device_fused_map_dispatches", "host_fused_maps", "device_filters",
           "device_filter_dispatches", "host_filters", "device_projections",
           "device_projection_dispatches", "host_projections")


@pytest.fixture(scope="module")
def tables():
    return tpch.generate_tables(scale=0.01, seed=42)


def _run_tpch(tables, name):
    ref_q, port_q, args = {
        "q3": (tpch.q3, port_q3, ("customer", "orders", "lineitem")),
        "q5": (tpch.q5, port_q5, ("customer", "orders", "lineitem", "nation")),
    }[name]

    def build(pkg):
        q = ref_q if pkg is daft_tpu else port_q
        return q(*[pkg.from_arrow(tables[a]).collect() for a in args]).collect()

    # 64 rows: the result partitions (10 and 5 rows) stay under it, so the
    # final sorts take the host in both packages, as at scale
    ref, got = _both(build, min_rows=64)
    return ref, got, [tables[a] for a in args]


def _assert_same(got: dict, ref: dict):
    assert list(got) == list(ref)
    for name in ref:
        if any(isinstance(x, float) for x in ref[name]):
            np.testing.assert_allclose(got[name], ref[name], rtol=RTOL, err_msg=name)
        else:
            assert got[name] == ref[name], name  # keys and group order: exact


@pytest.mark.parametrize("query", ["q3", "q5"])
def test_tpch_join_query_matches_reference(tables, query):
    ref, got, args = _run_tpch(tables, query)
    g, r = got.to_pydict(), ref.to_pydict()
    _assert_same(g, r)
    if query == "q3":
        want = tpch.oracle_q3(*args)
        groups = oracle_q3_groups(*args)
        assert q3_parity(g, want, groups, RTOL) and q3_parity(r, want, groups, RTOL)
    else:
        want = tpch.oracle_q5(*args)
        assert parity(g, want, RTOL) and parity(r, want, RTOL)

    gc, rc = _counters(got), _counters(ref)
    assert {k: gc.get(k, 0) for k in _SHARED} == {k: rc.get(k, 0) for k in _SHARED}
    assert gc["device_join_probes"] == {"q3": 2, "q5": 3}[query]
    # each broadcast join builds the runtime join filter over its replicated
    # side and prunes the streamed side with it, as the reference does
    jf = ("join_filter_built", "join_filter_probe_rows", "join_filter_rows_pruned",
          "join_filter_device_probes")
    assert {k: gc.get(k, 0) for k in jf} == {k: rc.get(k, 0) for k in jf}
    assert gc.get("join_filter_built", 0) >= 1
    # both optimizers prune each join side under a Project; the chains fuse
    # and run on the card (Q3's c_mktsegment == "BUILDING" through the
    # string-literal lane; Q5's 25-row nation chain stays on the host)
    assert {k: gc.get(k, 0) for k in ("fused_chains", "device_fused_maps",
                                        "device_filters", "host_filters",
                                        "device_projections", "host_projections")} == {
        "q3": {"fused_chains": 3, "device_fused_maps": 3, "device_filters": 3,
               "host_filters": 0, "device_projections": 6, "host_projections": 0},
        "q5": {"fused_chains": 2, "device_fused_maps": 1, "device_filters": 1,
               "host_filters": 1, "device_projections": 4, "host_projections": 1},
    }[query]
    # - the group codes take the device route in both packages at this
    #   scale (Q3's three keys pack into one int32 lane; Q5's key is a string)
    assert gc["device_group_codes"] == 1


def test_aggregate_over_join_above_4096_groups_takes_scatter_sums():
    """An aggregate over a join's output with more groups than the one-hot
    route and K1 take (4096), as TPC-H Q3 has at SF1 and above: its float
    sum goes through the deterministic scatter-sums kernel's wrapper (its
    plain version on the CPU), and matches the reference."""
    from daft_tpu_torch.kernels import scatter_sums, segment_sums

    rng = np.random.RandomState(21)
    n = 30_000
    ldata = {"k": rng.randint(0, 6000, n).astype(np.int64), "x": rng.rand(n) * 1e4}
    rdata = {"k2": np.arange(6000, dtype=np.int64), "w": rng.rand(6000)}
    before = scatter_sums.ENTRIES, segment_sums.ENTRIES

    def build(pkg):
        col = pkg.col
        return (pkg.from_pydict(ldata).join(pkg.from_pydict(rdata), left_on="k", right_on="k2")
                .with_column("y", col("x") * (1 - col("w")))
                .groupby("k").agg(col("y").sum().alias("s"), col("y").count().alias("c"))
                .collect())

    ref, got = _both(build)
    assert scatter_sums.ENTRIES - before[0] == 1
    assert segment_sums.ENTRIES - before[1] == 0
    c = _counters(got)
    assert c["device_resident_segments"] == 1 and c["device_join_probes"] == 1
    _assert_same(got.to_pydict(), ref.to_pydict())


def test_q5_aggregate_reaches_k1_through_its_module(tables, monkeypatch):
    """Q5's aggregate over three joins calls K1's wrapper by its module
    attribute, segment_sums.masked_segment_sums_padded, when it runs, once a
    query: a caller that wraps that name (chip_smoke.py does, to hold K1 at
    Q5's operands against its plain version) sees every call, also from a
    cached program."""
    from daft_tpu_torch.kernels import segment_sums

    seen = []
    real = segment_sums.masked_segment_sums_padded

    def record(*operands):
        seen.append(operands)
        return real(*operands)

    with real_tpu_mode_cfg(device_min_rows=64) as cfg:
        daft_tpu_torch.set_execution_config(_port_cfg(cfg))
    monkeypatch.setattr(segment_sums, "masked_segment_sums_padded", record)
    args = [daft_tpu_torch.from_arrow(tables[a]).collect()
            for a in ("customer", "orders", "lineitem", "nation")]
    want = tpch.oracle_q5(*[tables[a] for a in ("customer", "orders", "lineitem", "nation")])
    for runs in (1, 2):
        assert parity(port_q5(*args).collect().to_pydict(), want, RTOL)
        assert len(seen) == runs
    codes, mask, vals, g = seen[0]
    assert codes.dtype == torch.int32 and codes.shape == mask.shape == (vals.shape[0], 1)
    assert vals.dtype == torch.float32 and vals.shape[1] == 1 and g == 16


# ---------------------------------------------------------------------------
# the device join probe (tests/device32/test_real_tpu_mode.py TestDeviceJoin)
# ---------------------------------------------------------------------------

def _pk_tables(n_left=12_000, n_right=3_000):
    rng = np.random.RandomState(7)
    rk = np.arange(n_right, dtype=np.int64) * 3
    return ({"fk": rng.choice(rk, n_left), "lv": rng.rand(n_left)},
            {"pk": rk, "rv": np.array(["s%d" % i for i in range(n_right)])})


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_pk_join_matches_reference(how):
    ldata, rdata = _pk_tables()
    if how == "anti":  # misses, so that anti keeps rows
        ldata["fk"] = ldata["fk"] + 1
    ref, got = _both(lambda pkg: pkg.from_pydict(ldata).join(
        pkg.from_pydict(rdata), left_on="fk", right_on="pk", how=how).collect())
    assert _counters(got).get("device_join_probes", 0) > 0, how
    assert got.to_pydict() == ref.to_pydict(), how  # the host's order, exactly


def test_left_build_inner_matches_reference():
    rng = np.random.RandomState(9)
    ldata = {"pk": np.arange(3000, dtype=np.int64), "lv": rng.rand(3000)}
    rdata = {"fk": rng.randint(0, 3000, 12_000), "rv": rng.rand(12_000)}
    ref, got = _both(lambda pkg: pkg.from_pydict(ldata).join(
        pkg.from_pydict(rdata), left_on="pk", right_on="fk").collect())
    assert _counters(got).get("device_join_probes", 0) > 0
    assert got.to_pydict() == ref.to_pydict()


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_nm_join_matches_reference(how):
    rng = np.random.RandomState(11)
    ldata = {"k": rng.randint(0, 60, 5000).astype(np.int64),
             "lv": np.arange(5000, dtype=np.int64)}
    rdata = {"k2": rng.randint(0, 80, 3000).astype(np.int64),
             "rv": np.arange(3000, dtype=np.int64)}
    ref, got = _both(lambda pkg: pkg.from_pydict(ldata).join(
        pkg.from_pydict(rdata), left_on="k", right_on="k2", how=how).collect())
    assert _counters(got).get("device_join_probes", 0) > 0, how
    assert _sorted_rows(got) == _sorted_rows(ref), how


def test_nm_join_null_keys_never_match():
    ks = [1, None, 2, 2, None, 1] * 200
    rs = [2, 1, None, 1] * 175
    ref, got = _both(lambda pkg: pkg.from_pydict({"k": _nullable(pkg, ks, "k")}).join(
        pkg.from_pydict({"k2": _nullable(pkg, rs, "k2")}), left_on="k", right_on="k2",
        how="left").collect())
    assert _counters(got).get("device_join_probes", 0) > 0
    assert _sorted_rows(got) == _sorted_rows(ref)


def test_null_reviving_key_has_no_phantom_padding():
    """A key expression that is valid where its input is null (here
    ``i <=> None``) must not make the build side's padding lanes valid:
    each real build row matches, no padding row does."""
    rng = np.random.RandomState(47)
    k = rng.randint(0, 3, 300).astype(np.int64)
    ldata = {"k": k, "lv": np.arange(300, dtype=np.int64)}

    def build(pkg):
        right = pkg.from_pydict({"i": _nullable(pkg, [1, None, 2], "i"),
                                 "rv": np.arange(3, dtype=np.int64)})
        key = pkg.col("i").eq_null_safe(None).cast(pkg.DataType.int64())
        return pkg.from_pydict(ldata).join(right, left_on="k", right_on=key).collect()

    ref, got = _both(build)
    assert _counters(got).get("device_join_probes", 0) >= 1
    assert _sorted_rows(got) == _sorted_rows(ref)
    # key 0 matches the two non-null build rows, key 1 the null one
    assert len(got.to_pydict()["lv"]) == 2 * int((k == 0).sum()) + int((k == 1).sum())


# ---------------------------------------------------------------------------
# multi-key joins (TestMultiKeyDeviceJoin32)
# ---------------------------------------------------------------------------

def _two_key_data(n=3000, k1_card=50, k2_card=40):
    rng = np.random.RandomState(5)
    left = {"a": rng.randint(0, k1_card, n).astype(np.int64),
            "b": rng.randint(0, k2_card, n).astype(np.int64), "v": rng.rand(n)}
    pairs = [(i, j) for i in range(k1_card) for j in range(k2_card)][::3]
    right = {"a2": np.array([p[0] for p in pairs], dtype=np.int64),
             "b2": np.array([p[1] for p in pairs], dtype=np.int64),
             "w": np.arange(len(pairs), dtype=np.int64)}
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_two_key_join_matches_reference(how):
    left, right = _two_key_data()
    ref, got = _both(lambda pkg: pkg.from_pydict(left).join(
        pkg.from_pydict(right), left_on=["a", "b"], right_on=["a2", "b2"], how=how)
        .sort(["a", "b", "v"]).collect())
    assert _counters(got).get("device_join_probes", 0) >= 1
    assert got.to_pydict() == ref.to_pydict(), how


def test_key_space_overflow_takes_the_host_join():
    rng = np.random.RandomState(6)
    n = 2000
    left = {"a": rng.randint(0, 1 << 20, n).astype(np.int64),
            "b": rng.randint(0, 1 << 20, n).astype(np.int64)}
    right = {"a2": rng.randint(0, 1 << 20, n).astype(np.int64),
             "b2": rng.randint(0, 1 << 20, n).astype(np.int64)}
    ref, got = _both(lambda pkg: pkg.from_pydict(left).join(
        pkg.from_pydict(right), left_on=["a", "b"], right_on=["a2", "b2"]).collect())
    c = _counters(got)
    assert c.get("device_join_probes", 0) == 0 and c.get("host_joins", 0) >= 1
    assert _sorted_rows(got) == _sorted_rows(ref)


def test_null_key_component_never_matches():
    def build(pkg):
        left = pkg.from_pydict({"a": _nullable(pkg, [1, 1, None, 2] * 30, "a"),
                                "b": _nullable(pkg, [7, None, 7, 8] * 30, "b")})
        right = pkg.from_pydict({"a2": _nullable(pkg, [1, 2, None], "a2"),
                                 "b2": _nullable(pkg, [7, 8, None], "b2")})
        return left.join(right, left_on=["a", "b"], right_on=["a2", "b2"]).agg(
            pkg.col("a").count().alias("c")).collect()

    ref, got = _both(build)
    assert _counters(got).get("device_join_probes", 0) >= 1
    assert got.to_pydict()["c"] == ref.to_pydict()["c"] == [60]


# ---------------------------------------------------------------------------
# randomized joins (TestRandomizedDeviceJoins32, its integer-key seeds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 3, 4])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_random_int_key_joins_match_reference(seed, how):
    rng = np.random.RandomState(100 + seed)
    nb = rng.randint(50, 400)
    npr = rng.randint(200, 2000)
    if seed % 3 == 0:  # unique build keys
        bk = np.random.RandomState(seed).permutation(nb * 2)[:nb].astype(np.int64).tolist()
        pk = rng.randint(0, nb * 2, npr).astype(np.int64).tolist()
    else:  # duplicate keys on the build side
        bk = rng.randint(0, nb // 2 + 1, nb).astype(np.int64).tolist()
        pk = rng.randint(0, nb, npr).astype(np.int64).tolist()
    for i in range(0, nb, 17):
        bk[i] = None
    for i in range(0, npr, 23):
        pk[i] = None
    bv = rng.randint(0, 1000, nb).astype(np.int64)
    pv = rng.randint(0, 1000, npr).astype(np.int64)

    def build(pkg):
        bdf = pkg.from_pydict({"k": _nullable(pkg, bk, "k"), "bv": bv})
        pdf = pkg.from_pydict({"k": _nullable(pkg, pk, "k"), "pv": pv})
        return pdf.join(bdf, on="k", how=how).collect()

    ref, got = _both(build)
    assert _counters(got).get("device_join_probes", 0) >= 1, (how, seed)
    assert _sorted_rows(got) == _sorted_rows(ref), (how, seed)


# ---------------------------------------------------------------------------
# string keys through the joint dictionary; the host join: right and outer joins
# ---------------------------------------------------------------------------

def test_string_key_join_takes_the_host_join():
    """A string key recodes both sides' dictionary codes into their sorted
    joint dictionary and probes on the card, not through the host join, as
    the reference does, with the reference's rows and routing."""
    rng = np.random.RandomState(29)
    codes = [f"n{i:03d}" for i in range(40)]
    lvals = np.array(codes)[rng.randint(0, 40, 4000)].tolist()
    lvals[11] = None
    rdata = {"nk2": codes[5:], "rv": np.arange(35, dtype=np.int64)}

    def build(pkg):
        left = pkg.from_pydict({"nk": _nullable(pkg, lvals, "nk", "string"),
                                "lv": np.arange(4000, dtype=np.int64)})
        return left.join(pkg.from_pydict(rdata), left_on="nk", right_on="nk2").collect()

    ref, got = _both(build)
    c, rc = _counters(got), _counters(ref)
    assert c.get("device_join_probes", 0) >= 1 and c.get("host_joins", 0) == 0
    assert {k: c.get(k, 0) for k in ("device_join_probes", "host_joins")} == \
        {k: rc.get(k, 0) for k in ("device_join_probes", "host_joins")}
    assert _sorted_rows(got) == _sorted_rows(ref)


@pytest.mark.parametrize("how", ["right", "outer"])
@pytest.mark.parametrize("strategy", [None, "hash"])
def test_right_and_outer_joins_match_reference(how, strategy):
    rng = np.random.RandomState(31)
    ldata = {"k": rng.randint(0, 300, 2000).astype(np.int64), "lv": rng.rand(2000)}
    rdata = {"k": rng.randint(100, 500, 1500).astype(np.int64),
             "rv": rng.randint(0, 9, 1500).astype(np.int64)}
    ref, got = _both(lambda pkg: pkg.from_pydict(ldata).join(
        pkg.from_pydict(rdata), on="k", how=how, strategy=strategy).collect())
    assert _counters(got).get("host_joins", 0) >= 1
    assert got.column_names == ref.column_names
    assert _sorted_rows(got) == _sorted_rows(ref)


def test_multi_partition_hash_join_gathers():
    """A hash join over several partitions no longer gathers them: both
    sides hash-shuffle to the larger partition count (3), each
    co-partitioned pair probes on the card, and the left exchange's join
    filter prunes the right side, as in the reference. The name dates from
    when such a join gathered both sides and is kept, so that test reports
    stay comparable across versions."""
    rng = np.random.RandomState(3)
    parts = [pa.table({"k": rng.randint(0, 200, 500), "v": rng.rand(500)}) for _ in range(3)]
    right = pa.table({"k": np.arange(200), "w": rng.rand(200)})

    def build(pkg):
        left = pkg.from_arrow(parts)
        return left.join(pkg.from_arrow(right), on="k", strategy="hash").collect()

    ref, got = _both(build)
    c, rc = _counters(got), _counters(ref)
    shared = ("device_join_probes", "host_joins", "shuffles", "exchange_rows",
              "join_filter_built", "join_filter_probe_rows", "join_filter_rows_pruned")
    assert {k: c.get(k, 0) for k in shared} == {k: rc.get(k, 0) for k in shared}
    assert c.get("device_join_probes", 0) == 3 and "broadcast_joins" not in c
    assert c["shuffles"] == 2 and c["join_filter_built"] == 1
    assert _sorted_rows(got) == _sorted_rows(ref)


# ---------------------------------------------------------------------------
# the device argsort (TestDeviceSort32) and Limit
# ---------------------------------------------------------------------------

def _sort_both(data_fn, by, desc=False, **kw):
    ref, got = _both(lambda pkg: pkg.from_pydict(data_fn(pkg)).sort(by, desc=desc, **kw)
                     .collect())
    assert _counters(got).get("device_sorts", 0) >= 1, _counters(got)
    assert _counters(ref).get("device_sorts", 0) >= 1
    return ref, got


def test_sort_with_nulls_and_desc_matches_reference():
    rng = np.random.RandomState(3)
    vals = [None if rng.rand() < 0.05 else float(v) for v in rng.randint(-500, 500, 20_000)]
    tie = rng.randint(0, 50, 20_000).astype(np.int64)
    ref, got = _sort_both(lambda pkg: {"v": _nullable(pkg, vals, "v", "float32"), "t": tie},
                          ["t", "v"], desc=[False, True])
    assert got.to_pydict() == ref.to_pydict()


@pytest.mark.parametrize("desc", [False, True])
def test_f64_sort_keys_exact(desc):
    """float64 keys sort on exact 64-bit lanes: values that tie in float32
    keep their float64 order."""
    rng = np.random.RandomState(4)
    vals = np.repeat(rng.rand(5000) * 1e6, 2)
    vals[1::2] += 1e-9  # invisible in float32, significant in float64
    ks = vals.tolist()
    ks[17] = None
    ks[4021] = None
    t = rng.randint(0, 9, 10_000).astype(np.int64)
    ref, got = _sort_both(lambda pkg: {"v": _nullable(pkg, ks, "v", "float64"), "t": t},
                          ["v", "t"], desc=[desc, False])
    assert got.to_pydict() == ref.to_pydict()


def test_signed_zero_ties_like_the_host():
    data = {"v": np.array([0.0, -0.0, 1.0, -0.0, 0.0] * 400),
            "t": np.arange(2000, dtype=np.int64)}
    ref, got = _sort_both(lambda pkg: data, ["v", "t"])
    assert got.to_pydict() == ref.to_pydict()
    f32 = {"v": data["v"].astype(np.float32), "t": data["t"][::-1].copy()}
    ref, got = _sort_both(lambda pkg: f32, "v")
    assert got.to_pydict() == ref.to_pydict()


def test_nan_sorts_after_inf_like_the_host():
    vals = [1.0, float("inf"), 5.0, None, float("nan")] * 10

    ref, got = _sort_both(lambda pkg: {"v": _nullable(pkg, vals, "v", "float32")}, "v")
    norm = [("nan" if isinstance(x, float) and math.isnan(x) else x)
            for x in got.to_pydict()["v"]]
    assert norm == [("nan" if isinstance(x, float) and math.isnan(x) else x)
                    for x in ref.to_pydict()["v"]]
    assert norm == [1.0] * 10 + [5.0] * 10 + [float("inf")] * 10 + ["nan"] * 10 + [None] * 10


@pytest.mark.parametrize("key", ["computed_f64", "computed_int", "string", "date_desc_nulls"])
def test_sort_keys_match_reference(key):
    rng = np.random.RandomState(8)
    x = rng.rand(8000) * 1e6
    i = rng.randint(-1000, 1000, 8000).astype(np.int64)
    s = np.array(["b", "a", "c"])[rng.randint(0, 3, 8000)]
    base = datetime.date(1995, 1, 1)
    dates = [None if j % 97 == 0 else base + datetime.timedelta(days=int(d))
             for j, d in enumerate(rng.randint(0, 2000, 8000))]
    data = {"x": x, "i": i, "s": s, "v": np.arange(8000, dtype=np.int64)}

    def build(pkg):
        col = pkg.col
        df = pkg.from_pydict({**data, "d": _nullable(pkg, dates, "d", "date")})
        by = {"computed_f64": (col("x") * 1.0000001).alias("k"),
              "computed_int": (col("i") * -1).alias("k"),
              "string": col("s"),
              "date_desc_nulls": col("d")}[key]
        return df.sort(by, desc=key == "date_desc_nulls").collect()

    ref, got = _both(build)
    assert _counters(got).get("device_sorts", 0) >= 1, _counters(got)
    assert got.to_pydict() == ref.to_pydict()


def test_epoch_sort_key_takes_the_host_sort():
    """A timestamp key sorts on the card over its exact epoch lanes, not
    through the host sort: counted as device_sorts as in the reference, with
    the reference's order."""
    rng = np.random.RandomState(12)
    ts = (rng.randint(0, 10**6, 3000).astype("datetime64[s]")).astype("datetime64[us]")
    tbl = pa.table({"ts": pa.array(ts), "v": np.arange(3000)})
    ref, got = _both(lambda pkg: pkg.from_arrow(tbl).sort("ts").collect())
    c = _counters(got)
    assert c.get("device_sorts", 0) == 1 and "host_sorts" not in c
    assert c.get("device_sorts") == _counters(ref).get("device_sorts")
    assert got.to_pydict() == ref.to_pydict()


@pytest.mark.parametrize("n", [0, 7, 5000, 9000])
def test_limit_and_head(n):
    data = {"k": np.arange(6000, dtype=np.int64)[::-1].copy(), "v": np.arange(6000) * 0.5}
    ref, got = _both(lambda pkg: pkg.from_pydict(data).sort("k").limit(n).collect())
    assert got.to_pydict() == ref.to_pydict()
    assert len(got.to_pydict()["k"]) == min(n, 6000)
    daft_tpu_torch.set_execution_config(device="cpu")
    assert daft_tpu_torch.from_pydict(data).head(3).to_pydict() == {
        "k": [5999, 5998, 5997], "v": [0.0, 0.5, 1.0]}


# ---------------------------------------------------------------------------
# planning over joins
# ---------------------------------------------------------------------------

def test_plan_fuses_join_sides_and_segments_over_the_join():
    """The fusion passes run over a join as over any other op: a map chain
    under a join side becomes a FusedMapOp, and a map chain feeding an
    aggregate over the join's output becomes a DeviceSegmentOp; both run on
    the card."""
    from daft_tpu_torch import col
    from daft_tpu_torch.fuse import DeviceSegmentOp, FusedMapOp
    from daft_tpu_torch.physical import BroadcastJoinOp, translate

    rng = np.random.RandomState(2)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=MIN_ROWS)
    left = daft_tpu_torch.from_pydict({"k": rng.randint(0, 100, 4000), "x": rng.rand(4000)})
    right = daft_tpu_torch.from_pydict({"k2": np.arange(100), "g": np.arange(100) % 7})
    side = left.with_column("y", col("x") * 2.0).where(col("y") > 0.5)
    q = (side.join(right, left_on="k", right_on="k2")
         .with_column("z", col("y") + 1.0).groupby("g").agg(col("z").sum().alias("s")))
    plan = q._plan
    root = translate(plan)
    assert isinstance(root, DeviceSegmentOp)
    join = root.children[0]
    assert isinstance(join, BroadcastJoinOp)
    assert isinstance(join.children[0], FusedMapOp)
    got = q.collect()
    c = _counters(got)
    assert c["device_resident_segments"] == 1 and c["device_fused_maps"] == 1
    assert c["device_join_probes"] == 1

    daft_tpu_torch.set_execution_config(device="cpu", use_device_kernels=False)
    host = daft_tpu_torch.dataframe.DataFrame(plan).collect()
    _assert_same(got.sort("g").to_pydict(), host.sort("g").to_pydict())


def test_join_plan_errors():
    """The join planner's errors, as the reference raises them: keys on a
    cross join, an unknown strategy, no keys on an equi-join, a negative
    limit. (The name is kept from when cross joins and the sort-merge
    strategy raised NotImplementedError, so that runs stay comparable.)"""
    daft_tpu_torch.set_execution_config(device="cpu")
    for pkg in (daft_tpu, daft_tpu_torch):
        b = pkg.from_pydict({"k": [1, 2]})
        with pytest.raises(ValueError, match="cross join takes no keys"):
            b.join(b, on="k", how="cross")
        with pytest.raises(ValueError, match="unknown join strategy"):
            b.join(b, on="k", strategy="merge")
    a = daft_tpu_torch.from_pydict({"k": [1, 2]})
    with pytest.raises(ValueError, match="join requires"):
        a.join(a)
    with pytest.raises(ValueError, match="limit"):
        a.limit(-1)
