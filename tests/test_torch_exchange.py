"""The exchange between partitions (daft_tpu_torch/physical.py ShuffleOp,
daft_tpu_torch/exchange/) held against daft_tpu on the CPU, the applicable
cases of tests/test_exchange.py among them.

Each case builds one query over pyarrow tables made from a numpy seed, cut
into partitions, and runs it through daft_tpu in its 32-bit device mode
(tests/device_mode.py, ``device_min_rows=8`` unless a case says otherwise,
the exchange knobs at their defaults) and through the port under the same
configuration with device="cpu". The rows equal the reference's (a join's
as a multiset, its order being unspecified), and so do the routing
counters, ``exchange_rows``, ``exchange_precombined_rows`` and the join
filter's counters. Where tests/test_exchange.py runs a query with the knobs
on and off, the port's two results are equal too.

Left out with the modules they test: the payload encoding, the memory
ledger and budget gates of the combine, the fault sites and the
sort-merge join.
"""

import dataclasses
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from device_mode import real_tpu_mode_cfg

KNOBS = ("runtime_join_filters", "hierarchical_exchange_combine")
COUNTERS = ("device_filters", "host_filters", "device_projections", "host_projections",
            "device_fused_maps", "host_fused_maps", "device_aggregations", "host_aggregations",
            "device_agg_fallbacks", "device_sorts", "host_sorts", "device_group_codes",
            "device_join_probes", "host_joins", "broadcast_joins", "device_distincts",
            "host_distincts", "shuffles", "exchange_rows", "exchange_precombined_rows",
            "join_filter_built", "join_filter_probe_rows", "join_filter_rows_pruned",
            "join_filter_device_probes")


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def run_both(build, min_rows: int = 8, **knobs):
    """``build(pkg)`` (a DataFrame) through both packages, ``knobs`` set on
    the reference's config and mapped onto the port's. Returns ((reference
    dict, counters), (port dict, counters))."""
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        knobs = {"enable_result_cache": False, **knobs}
        saved = {k: getattr(cfg, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cfg, k, v)
        try:
            ref = build(daft_tpu).collect()
            d = dataclasses.asdict(cfg)
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = build(daft_tpu_torch).collect()
    return ((ref.to_pydict(), ref.stats.snapshot()["counters"]),
            (got.to_pydict(), got.stats.snapshot()["counters"]))


def counters(c) -> dict:
    return {k: c.get(k, 0) for k in COUNTERS}


def rows(d: dict) -> list:
    return sorted(zip(*d.values()), key=lambda r: tuple((v is None, repr(v)) for v in r))


def assert_rows_close(got: dict, ref: dict, rtol: float):
    """Equal rows as multisets, floats within ``rtol`` (the 32-bit mode's
    float32 sums), everything else exactly."""
    assert list(got) == list(ref)
    g, r = rows(got), rows(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert x == pytest.approx(y, rel=rtol, nan_ok=True), (a, b)
            else:
                assert x == y, (a, b)


def check(build, rtol: float = 0.0, min_rows: int = 8, off_too: bool = True):
    """The query through both packages (rows and counters equal), and, with
    ``off_too``, the port again with the exchange knobs off (rows equal).
    Returns the port's counters with the knobs on and off."""
    (ref, rc), (got, gc) = run_both(build, min_rows)
    assert_rows_close(got, ref, rtol)
    assert counters(gc) == counters(rc)
    if not off_too:
        return gc, None
    (_, _), (off, oc) = run_both(build, min_rows, **{k: False for k in KNOBS})
    assert_rows_close(off, got, 1e-12)
    return gc, oc


def frame(pkg, tbl: pa.Table, nparts: int):
    return pkg.from_arrow(tbl).into_partitions(nparts)


# ---------------------------------------------------------------------------
# the results with the knobs on equal those with the knobs off:
# tests/test_exchange.py TestByteIdentityMatrix
# ---------------------------------------------------------------------------

KEY_SAMPLES = {
    "int64": (pa.int64(), lambda i: i % 37),
    "int32": (pa.int32(), lambda i: i % 37),
    "float64": (pa.float64(), lambda i: (i % 37) * 0.5),
    "string": (pa.large_string(), lambda i: f"k{i % 37}"),
    "binary": (pa.large_binary(), lambda i: b"b%d" % (i % 37)),
    "date": (pa.date32(), lambda i: datetime.date(2024, 1, 1) + datetime.timedelta(days=i % 37)),
    "bool": (pa.bool_(), lambda i: bool(i % 2)),
}
NULL_PATTERNS = {"none": lambda i: False, "some": lambda i: i % 11 == 0,
                 "heavy": lambda i: i % 2 == 0}


@pytest.mark.parametrize("dtype_name", sorted(KEY_SAMPLES))
@pytest.mark.parametrize("nulls", sorted(NULL_PATTERNS))
def test_join_key_matrix(dtype_name, nulls):
    typ, mk = KEY_SAMPLES[dtype_name]
    isnull = NULL_PATTERNS[nulls]
    n = 600
    left = pa.table({"k": pa.array([None if isnull(i) else mk(i) for i in range(n)], typ),
                     "lv": pa.array(np.arange(n), pa.int64())})
    right = pa.table({"k": pa.array([None if isnull(i + 1) else mk(i * 3) for i in range(n // 2)],
                                    typ),
                      "rv": pa.array(np.arange(n // 2), pa.int64())})
    check(lambda pkg: frame(pkg, left, 3).join(frame(pkg, right, 3), on="k", how="inner",
                                               strategy="hash"))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer", "semi", "anti"])
@pytest.mark.parametrize("strategy", ["hash", "broadcast"])
def test_join_types_x_strategies(how, strategy):
    n = 500
    rng = np.random.RandomState(7)
    left = pa.table({"k": rng.randint(0, 40, n), "lv": rng.rand(n)})
    right = pa.table({"k": np.arange(25) * 2, "rv": np.arange(25)})
    check(lambda pkg: frame(pkg, left, 4).join(frame(pkg, right, 2), on="k", how=how,
                                               strategy=strategy))


def test_grouped_agg_exact_kinds():
    n = 4000
    rng = np.random.RandomState(3)
    tbl = pa.table({"g": rng.randint(0, 50, n), "i": rng.randint(-1000, 1000, n),
                    "f": rng.rand(n), "s": [f"s{v % 9}" for v in range(n)]})
    on, off = check(lambda pkg: frame(pkg, tbl, 6).groupby("g").agg(
        pkg.col("i").sum().alias("si"), pkg.col("i").count().alias("ci"),
        pkg.col("f").min().alias("lo"), pkg.col("f").max().alias("hi"),
        pkg.col("s").min().alias("smin")))
    assert on["exchange_precombined_rows"] > 0 and "exchange_precombined_rows" not in off
    assert on["exchange_rows"] < off["exchange_rows"]


def test_float_sum_mean_identity():
    n = 4000
    rng = np.random.RandomState(4)
    tbl = pa.table({"g": rng.randint(0, 20, n), "f": rng.rand(n)})
    on, _ = check(lambda pkg: frame(pkg, tbl, 6).groupby("g").agg(
        pkg.col("f").sum().alias("s"), pkg.col("f").mean().alias("m")), rtol=1e-6)
    # a float sum declines the combine: an early fold would reorder its additions
    assert "exchange_precombined_rows" not in on


def test_compose_with_expr_fusion_and_join():
    n = 3000
    rng = np.random.RandomState(6)
    fact = pa.table({"k": rng.randint(0, 400, n), "a": rng.rand(n), "b": rng.rand(n)})
    dim = pa.table({"k": np.arange(0, 400, 10), "seg": np.arange(40) % 3})

    def q(pkg):
        c = pkg.col
        j = (frame(pkg, dim, 2).join(frame(pkg, fact, 4), on="k", how="inner", strategy="hash")
             .select(c("seg"), (c("a") * 2 + c("b")).alias("x")).filter(c("x") > 0.5))
        return j.groupby("seg").agg(c("x").count().alias("n"))

    on, _ = check(q)
    assert on["join_filter_built"] >= 1


# ---------------------------------------------------------------------------
# join-filter semantics per join type and strategy:
# tests/test_exchange.py TestJoinFilterSemantics
# ---------------------------------------------------------------------------

def _selective(n=5000, keys=2000, keep=60):
    rng = np.random.RandomState(11)
    build = pa.table({"k": np.arange(0, keep * 10, 10), "bv": np.arange(keep)})
    probe = pa.table({"k": rng.randint(0, keys, n), "pv": rng.rand(n)})
    return build, probe


@pytest.mark.parametrize("how", ["inner", "semi", "left"])
def test_prunable_hash_joins_prune(how):
    build, probe = _selective()
    c, _ = check(lambda pkg: frame(pkg, build, 3).join(frame(pkg, probe, 3), on="k", how=how,
                                                       strategy="hash"), off_too=False)
    assert c["join_filter_built"] == 1 and c["join_filter_rows_pruned"] > 3000
    assert c["join_filter_device_probes"] == 3  # K10, one per probe partition


@pytest.mark.parametrize("how", ["right", "outer", "anti"])
def test_nonprunable_hash_joins_decline(how):
    build, probe = _selective()
    c, _ = check(lambda pkg: frame(pkg, build, 3).join(frame(pkg, probe, 3), on="k", how=how,
                                                       strategy="hash"), off_too=False)
    assert "join_filter_built" not in c and "join_filter_rows_pruned" not in c


def test_broadcast_inner_prunes():
    build, probe = _selective()
    c, _ = check(lambda pkg: frame(pkg, probe, 3).join(frame(pkg, build, 3), on="k", how="inner",
                                                       strategy="broadcast"), off_too=False)
    assert c["join_filter_built"] == 1 and c["join_filter_rows_pruned"] > 3000


def test_broadcast_left_declines():
    build, probe = _selective()
    c, _ = check(lambda pkg: frame(pkg, probe, 3).join(frame(pkg, build, 3), on="k", how="left",
                                                       strategy="broadcast"), off_too=False)
    assert "join_filter_rows_pruned" not in c


def test_null_probe_keys_pruned_and_identical():
    n = 2000
    probe = pa.table({"k": pa.array([None if i % 3 == 0 else i % 50 for i in range(n)],
                                    pa.int64()),
                      "pv": np.arange(n)})
    build = pa.table({"k": np.arange(0, 50, 2), "bv": np.arange(25)})
    on, _ = check(lambda pkg: frame(pkg, build, 2).join(frame(pkg, probe, 3), on="k",
                                                        how="inner", strategy="hash"))
    assert on["join_filter_rows_pruned"] >= n // 3  # the null keys go


def test_nan_float_keys_bypass_filter():
    lk = [1.0, 2.0, float("nan"), 4.0] * 100
    rk = [float("nan"), 2.0] * 60
    left = pa.table({"k": lk, "lv": np.arange(len(lk))})
    right = pa.table({"k": rk, "rv": np.arange(len(rk))})
    check(lambda pkg: frame(pkg, left, 3).join(frame(pkg, right, 2), on="k", how="inner",
                                               strategy="hash"))


def test_multi_key_join_filtered():
    n = 3000
    rng = np.random.RandomState(12)
    probe = pa.table({"a": rng.randint(0, 40, n), "b": rng.randint(0, 40, n),
                      "pv": np.arange(n)})
    build = pa.table({"a": [1, 2, 3], "b": [1, 2, 3], "bv": [10, 20, 30]})
    on, _ = check(lambda pkg: frame(pkg, build, 2).join(
        frame(pkg, probe, 3), left_on=["a", "b"], right_on=["a", "b"], how="inner",
        strategy="hash"))
    assert on["join_filter_rows_pruned"] > 2000


def test_mismatched_key_dtypes_still_correct():
    # int32 probe keys against int64 build keys: both sides hash the unified dtype
    probe = pa.table({"k": pa.array(list(range(200)) * 4, pa.int32()), "pv": np.arange(800)})
    build = pa.table({"k": np.arange(0, 200, 5), "bv": np.arange(40)})
    check(lambda pkg: frame(pkg, build, 2).join(frame(pkg, probe, 3), on="k", how="inner",
                                                strategy="hash"))


# ---------------------------------------------------------------------------
# the hierarchical combine: tests/test_exchange.py TestHierarchicalCombine
# ---------------------------------------------------------------------------

def test_exchange_rows_fold():
    n, parts, groups = 16000, 8, 32
    rng = np.random.RandomState(9)
    tbl = pa.table({"g": np.arange(n) % groups, "c": rng.randint(0, 100, n)})
    on, off = check(lambda pkg: frame(pkg, tbl, parts).groupby("g").agg(
        pkg.col("c").sum().alias("s"), pkg.col("c").count().alias("n")))
    # off: one stage-1 piece per (partition x group); on: one row per group
    assert off["exchange_rows"] == parts * groups
    assert on["exchange_rows"] == groups
    assert on["exchange_precombined_rows"] == (parts - 1) * groups


def test_combine_tag_in_plan():
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import translate

    cfg = daft_tpu_torch.ExecutionConfig(device="cpu")
    df = daft_tpu_torch.from_pydict({"g": [1, 2] * 10, "c": list(range(20))}).into_partitions(4)
    assert "<combine>" in translate(optimize(df.groupby("g").agg(
        daft_tpu_torch.col("c").sum())._plan), cfg).display_tree()
    fplan = df.groupby("g").agg(
        daft_tpu_torch.col("c").cast(daft_tpu_torch.DataType.float64()).sum())._plan
    assert "<combine>" not in translate(optimize(fplan), cfg).display_tree()  # a float sum declines
    off = dataclasses.replace(cfg, hierarchical_exchange_combine=False)
    assert "<combine>" not in translate(optimize(df.groupby("g").agg(
        daft_tpu_torch.col("c").sum())._plan), off).display_tree()


def test_combine_applicability_gate():
    from daft_tpu_torch import DataType, col
    from daft_tpu_torch.exchange.combine import combine_spec_applicable
    from daft_tpu_torch.physical import _stage_schema, populate_aggregation_stages
    from daft_tpu_torch.schema import Field, Schema

    in_schema = Schema([Field("g", DataType.int64()), Field("i", DataType.int64()),
                        Field("f", DataType.float64())])
    key_cols = [col("g")]
    _s1, s2, _ = populate_aggregation_stages([col("i").sum().alias("x")])
    assert combine_spec_applicable(s2, key_cols, _stage_schema(in_schema, _s1, key_cols))
    _s1f, s2f, _ = populate_aggregation_stages([col("f").sum().alias("x")])
    assert not combine_spec_applicable(s2f, key_cols, _stage_schema(in_schema, _s1f, key_cols))


def test_combiner_abandons_on_poor_shrink():
    """Near-unique keys: the first fold that does not shrink abandons the
    combiner and hands every staged piece back raw."""
    from daft_tpu_torch import col
    from daft_tpu_torch.exchange.combine import FOLD_EVERY, BucketCombiner
    from daft_tpu_torch.micropartition import MicroPartition

    comb = BucketCombiner([col("x").sum().alias("x")], [col("g")])
    flushed = None
    for i in range(FOLD_EVERY + 1):
        flushed = comb.add(0, MicroPartition.from_pydict(
            {"g": list(range(i * 8, i * 8 + 8)), "x": [1] * 8}))
        if flushed is not None:
            break
    assert comb.failed and flushed is not None
    assert sum(len(p) for _, p in flushed) == (FOLD_EVERY + 1) * 8


def test_combiner_folds_to_one_partial():
    from daft_tpu_torch import col
    from daft_tpu_torch.exchange.combine import FOLD_EVERY, BucketCombiner
    from daft_tpu_torch.micropartition import MicroPartition

    comb = BucketCombiner([col("x").sum().alias("x")], [col("g")])
    for i in range(FOLD_EVERY + 2):
        assert comb.add(0, MicroPartition.from_pydict({"g": [1, 2], "x": [i, i + 1]})) is None
    out = list(comb.finish())
    assert not comb.failed and len(out) == 1
    assert out[0][1].table().to_pydict() == {
        "g": [1, 2], "x": [sum(range(FOLD_EVERY + 2)), sum(range(1, FOLD_EVERY + 3))]}


def test_multi_partition_min_routes_as_the_reference():
    """The re-anchor's case: 300 rows with 7 keys in 3 partitions, the min
    of an int64 within int32. The fold leaves stage 2 under
    device_min_rows, so stage 1 runs on the card and stage 2 on the host,
    as in the reference (3 and 3)."""
    rng = np.random.RandomState(5)
    tbl = pa.table({"k": rng.randint(0, 7, 300), "j": rng.randint(-1000, 1000, 300)})
    c, _ = check(lambda pkg: frame(pkg, tbl, 3).groupby("k").agg(pkg.col("j").min()))
    assert (c["device_aggregations"], c["host_aggregations"]) == (3, 3)


# ---------------------------------------------------------------------------
# range and random repartition, the sort over several partitions, plans
# ---------------------------------------------------------------------------

def _wide(n=600, seed=21):
    rng = np.random.RandomState(seed)
    return pa.table({
        "a": pa.array(rng.randint(0, 50, n), pa.int64(), mask=rng.rand(n) < 0.05),
        "b": pa.array(rng.rand(n) * 100),
        "s": pa.array([f"s{v}" for v in rng.randint(0, 30, n)]),
        "d": pa.array(np.datetime64("2020-01-01") + rng.randint(0, 900, n).astype("timedelta64[D]")),
    })


def _partitions(pkg, df):
    res = df.collect()._result
    return [(p.to_arrow() if pkg is daft_tpu else p.table().to_arrow()).to_pydict()
            for p in res.partitions]


def _parts_both(build, min_rows: int = 8):
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        cfg.enable_result_cache, saved = False, cfg.enable_result_cache
        try:
            ref_df = build(daft_tpu)
            ref = _partitions(daft_tpu, ref_df)
            d = dataclasses.asdict(cfg)
        finally:
            cfg.enable_result_cache = saved
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got_df = build(daft_tpu_torch)
    got = _partitions(daft_tpu_torch, got_df)
    return (ref, ref_df.stats.snapshot()["counters"]), (got, got_df.stats.snapshot()["counters"])


@pytest.mark.parametrize("nparts,num", [(3, 4), (1, 3), (4, 2)])
def test_random_repartition_matches_reference(nparts, num):
    tbl = _wide()
    (ref, rc), (got, gc) = _parts_both(lambda pkg: frame(pkg, tbl, nparts).repartition(num))
    assert got == ref and len(got) == num
    assert counters(gc) == counters(rc) and gc["shuffles"] == 1


@pytest.mark.parametrize("keys,desc", [(["a"], [False]), (["a"], [True]), (["s", "b"], [False, True]),
                                       (["d"], [True])])
def test_range_repartition_matches_reference(keys, desc):
    from daft_tpu.logical import Repartition as RefRepartition
    from daft_tpu_torch.logical import Repartition

    tbl = _wide()

    def build(pkg):
        node = RefRepartition if pkg is daft_tpu else Repartition
        f = frame(pkg, tbl, 3)
        return pkg.DataFrame(node(f._plan, "range", 4, [pkg.col(k) for k in keys], desc))

    (ref, rc), (got, gc) = _parts_both(build)
    assert got == ref and len(got) == 4
    assert counters(gc) == counters(rc)


@pytest.mark.parametrize("min_rows", [8, 180, 10_000])
@pytest.mark.parametrize("keys,desc,nulls_first", [
    (["a", "b"], [False, False], None), (["a", "b"], [True, False], None),
    (["s", "a"], [False, True], [True, False]), (["d", "b"], [True, True], None)])
def test_sort_over_three_partitions(min_rows, keys, desc, nulls_first):
    """A sort over 3 partitions range-shuffles them and sorts each range
    partition: three sorts, on the card where a partition clears
    device_min_rows (8: all three; 180: some; 10,000: none), split as in
    the reference."""
    tbl = _wide()
    (ref, rc), (got, gc) = _parts_both(
        lambda pkg: frame(pkg, tbl, 3).sort(keys, desc=desc, nulls_first=nulls_first), min_rows)
    assert got == ref and len(got) == 3
    assert counters(gc) == counters(rc)
    assert gc.get("device_sorts", 0) + gc.get("host_sorts", 0) == 3


@pytest.mark.parametrize("num", [2, 4, 7])
def test_sample_boundaries_equal_the_reference(num):
    """The boundary rows of a range shuffle: each partition's keys sampled
    (RandomState(0), sample_size rows per output partition), the samples
    sorted, the quantile rows taken."""
    from daft_tpu.micropartition import MicroPartition as RefPart
    from daft_tpu.physical import sample_boundaries as ref_sample
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.physical import sample_boundaries

    tbl = _wide()
    parts = [tbl.slice(0, 250), tbl.slice(250, 100), tbl.slice(350)]
    for keys, desc in ((["a"], [False]), (["s", "b"], [True, False])):
        ref = ref_sample([RefPart.from_arrow(p) for p in parts],
                         [daft_tpu.col(k) for k in keys], num, desc, sample_size=5)
        got = sample_boundaries([MicroPartition.from_arrow(p) for p in parts],
                                [daft_tpu_torch.col(k) for k in keys], num, desc,
                                sample_size=5)
        assert got.to_pydict() == ref.to_pydict() and len(got) == num - 1


def _physical(pkg, df):
    if pkg is daft_tpu:
        from daft_tpu.optimizer import optimize
        from daft_tpu.physical import translate

        return translate(optimize(df._plan), daft_tpu.context.get_context().execution_config)
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import translate

    return translate(optimize(df._plan), daft_tpu_torch.ExecutionConfig(device="cpu"))


PLANS = {
    "random": lambda pkg, f, g: f.repartition(4),
    "hash": lambda pkg, f, g: f.repartition(4, "a"),
    "sort": lambda pkg, f, g: f.sort(["a", "b"], desc=[True, False]),
    "hash_join": lambda pkg, f, g: f.join(g, on="a", strategy="hash"),
    "broadcast_join": lambda pkg, f, g: f.join(g, on="a", strategy="broadcast"),
    "grouped_agg": lambda pkg, f, g: f.groupby("a").agg(pkg.col("b").max()),
    "distinct": lambda pkg, f, g: f.distinct("a"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_describe_as_the_reference(name):
    tbl = _wide()
    trees = []
    for pkg in (daft_tpu, daft_tpu_torch):
        f = frame(pkg, tbl, 3)
        g = frame(pkg, tbl.select(["a", "s"]).rename_columns(["a", "t"]), 2)
        trees.append(_physical(pkg, PLANS[name](pkg, f, g)).display_tree())
    assert trees[1] == trees[0]
    if name in ("random", "sort", "hash_join"):
        assert "GatherOp" not in trees[1] and "Shuffle[" in trees[1]


def test_shuffle_describe_tags():
    build, probe = _selective()
    f = frame(daft_tpu_torch, build, 3).join(frame(daft_tpu_torch, probe, 3), on="k",
                                             how="inner", strategy="hash")
    tree = _physical(daft_tpu_torch, f).display_tree()
    assert "join-filter-feed" in tree and "join-filter-probe" in tree


# ---------------------------------------------------------------------------
# K6 as a function, and K10 on the card
# ---------------------------------------------------------------------------

def test_hash_buckets_equal_the_reference_bit_for_bit():
    """K6 over int32, int64, float32 (with -0.0 and 0.0), bool and null
    rows, one column at a time and all together, equals the reference's
    hash_buckets (tests/test_device_kernels.py's case, widened)."""
    import jax.numpy as jnp

    from daft_tpu.kernels import device as ref_dev
    from daft_tpu_torch.kernels import device as port_dev

    rng = np.random.RandomState(31)
    n = 4096
    cols = [rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
            rng.randint(-2 ** 62, 2 ** 62, n).astype(np.int64),
            np.where(rng.rand(n) < 0.1, -0.0, rng.randn(n)).astype(np.float32),
            rng.rand(n) < 0.5]
    cols[2][:4] = [0.0, -0.0, np.inf, -np.inf]
    valids = [rng.rand(n) > 0.1 for _ in cols]
    for num in (1, 7, 8, 1000):
        for picked in ([0], [1], [2], [3], [0, 1, 2, 3]):
            ref = np.asarray(ref_dev.hash_buckets(tuple(jnp.asarray(cols[i]) for i in picked),
                                                  tuple(jnp.asarray(valids[i]) for i in picked),
                                                  num))
            got = port_dev.hash_buckets([torch.from_numpy(cols[i]) for i in picked],
                                        [torch.from_numpy(valids[i]) for i in picked], num)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)
    # -0.0 and 0.0 bucket alike; a null row hashes as the constant
    z = port_dev.hash_buckets([torch.tensor([0.0, -0.0])], [torch.ones(2, dtype=torch.bool)], 97)
    assert int(z[0]) == int(z[1])


def test_bloom_probe_on_the_card_equals_the_host_probe():
    """K10 (probe_bits_device) gives the host probe's bits."""
    from daft_tpu_torch.exchange.joinfilter import BLOOM_PROBES, probe_bits_device

    rng = np.random.RandomState(8)
    table = rng.rand(1 << 13) < 0.3
    idx = rng.randint(0, 1 << 13, (BLOOM_PROBES, 5000)).astype(np.int32)
    want = table[idx].all(axis=0)
    got = probe_bits_device(torch.from_numpy(table.astype(np.uint8)), idx)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_a_failure_of_the_device_bloom_probe_reaches_the_caller(monkeypatch):
    """A failure of the port itself around the Bloom probe on the card (a
    ``DaftKernelError`` while the bit table stages) is caught neither by the
    device attempt nor by the prune's fail-open: collect() raises."""
    from daft_tpu_torch.errors import DaftKernelError
    from daft_tpu_torch.exchange import joinfilter

    def broken(self, device):
        raise DaftKernelError("bit table staging failed")

    monkeypatch.setattr(joinfilter.RuntimeJoinFilter, "_staged_bits", broken)
    build, probe = _selective()
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
    q = frame(daft_tpu_torch, build, 3).join(frame(daft_tpu_torch, probe, 3), on="k",
                                             strategy="hash")
    with pytest.raises(DaftKernelError, match="bit table staging failed"):
        q.collect()


def test_a_device_error_of_the_bloom_probe_probes_on_the_host(monkeypatch):
    """A failure of the device layer the breaker takes (an out-of-memory
    error on the card) while the bit table stages is a device attempt's
    failure, in both packages: each probe partition probes on the host
    instead (no ``join_filter_device_probes``), the third failure trips the
    breaker, and the rows and counters equal the reference's."""
    import torch

    from daft_tpu.exchange import joinfilter as ref_jf
    from daft_tpu_torch.exchange import joinfilter

    def broken(self, *a):
        raise torch.cuda.OutOfMemoryError("bit table staging failed")

    monkeypatch.setattr(ref_jf.RuntimeJoinFilter, "_staged_bits", broken)
    monkeypatch.setattr(joinfilter.RuntimeJoinFilter, "_staged_bits", broken)
    build, probe = _selective()
    (ref, rc), (got, gc) = run_both(lambda pkg: frame(pkg, build, 3).join(
        frame(pkg, probe, 3), on="k", strategy="hash"))
    assert_rows_close(got, ref, 0.0)
    assert counters(gc) == counters(rc)
    assert gc.get("join_filter_device_probes", 0) == 0 and gc["join_filter_rows_pruned"] > 3000
    assert gc.get("device_breaker_trips") == rc.get("device_breaker_trips") == 1
