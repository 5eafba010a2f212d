"""The port's new aggregation kinds held against daft_tpu on the CPU:
any_value, list (``agg_list``), concat (``agg_concat``), stddev and skew,
over one partition (one AggregateOp) and over three (stage 1 per partition,
the hash exchange or the gather, stage 2, the final projection), grouped
and global, with the DataFrame and GroupedDataFrame shorthands.

Both packages run in the 32-bit device mode at ``device_min_rows=8``
(``torch_parity.run_both``) unless a case says x64. The routing counters
must equal the reference's: an aggregate holding any kind outside sum,
count, min, max and mean runs on the host in both, so a one-partition
stddev runs on the host, while stage 1 of a multi-partition stddev is sums
and counts and runs on the device path (K1, or K2 with deep fusion).

Tolerances, per value:
- lists, any_value, concat, counts, keys: equal, in order;
- skew and a one-partition stddev: equal (both run numpy or pyarrow on the
  same rows);
- a multi-partition stddev in the 32-bit mode: rtol 1e-5, the tolerance
  of the reference's own kernel tests (tests/test_pallas.py). Its float32
  stage-1 sums come from K1's plain version here and from the Pallas kernel
  in interpret mode there, added in another order, and E[x^2] - mean^2
  loses digits to cancellation in both;
- a multi-partition stddev in x64: rtol 1e-12 (float64 sums).
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from torch_parity import counters, fresh_ledgers_and_faults, restore_port_config, run_both  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()


def _table(n=240, seed=21):
    rng = np.random.RandomState(seed)
    v = rng.randn(n) * 3 + 10
    v[rng.rand(n) < 0.1] = np.nan  # nulls, below
    f = pa.array(v, mask=np.isnan(v))
    k = rng.randint(0, 6, n)
    lists = [None if rng.rand() < 0.1 else list(rng.randint(0, 9, rng.randint(0, 4))) for _ in range(n)]
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "s": pa.array(np.array(["a", "b", "c"], object)[k % 3], pa.large_string()),
        "f": f,
        "g": pa.array(rng.rand(n).astype(np.float32) * 100),
        "i": pa.array(rng.randint(-50, 50, n), pa.int64(), mask=rng.rand(n) < 0.2),
        "l": pa.array(lists, pa.large_list(pa.int64())),
    })


def _parts(t, nparts):
    if nparts == 1:
        return [t]
    step = -(-len(t) // nparts)
    return [t.slice(i * step, step) for i in range(nparts)]


def _close(g, r, rel):
    if r is None or g is None:
        return g is None and r is None
    if isinstance(r, float) and math.isnan(r):
        return isinstance(g, float) and math.isnan(g)
    return g == pytest.approx(r, rel=rel, abs=0.0)


def _check(ref, got, float_cols=(), rel=0.0):
    r, g = ref.to_pydict(), got.to_pydict()
    assert list(g) == list(r)
    for name in r:
        assert len(g[name]) == len(r[name])
        if name in float_cols:
            assert all(_close(a, b, rel) for a, b in zip(g[name], r[name])), (name, g[name], r[name])
        else:
            assert g[name] == r[name], name
    for f in ref.schema:
        assert repr(got.schema[f.name].dtype) == repr(f.dtype)
    assert counters(got) == counters(ref)


_KINDS = {
    "any_value": (lambda c: c("i").any_value(), False),
    "any_value_ignore_nulls": (lambda c: c("i").any_value(ignore_nulls=True), False),
    "list": (lambda c: c("f").agg_list(), False),
    "list_str": (lambda c: c("s").agg_list(), False),
    "concat": (lambda c: c("l").agg_concat(), False),
    "stddev": (lambda c: c("f").stddev(), True),
    "stddev_f32": (lambda c: c("g").stddev(), True),
    "skew": (lambda c: c("f").skew(), True),
}


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_kind_matches_reference(kind, nparts, grouped):
    fn, is_float = _KINDS[kind]
    t = _table()
    parts = _parts(t, nparts)

    def build(p):
        df = p.from_arrow(parts)
        a = fn(p.col).alias("a")
        return df.groupby("k").agg(a).sort("k") if grouped else df.agg(a)

    ref, got = run_both(build)
    # a device-summed stddev (stage 1 over several partitions) takes rtol 1e-5
    rel = 1e-5 if kind.startswith("stddev") and nparts > 1 else 0.0
    _check(ref, got, ("a",) if is_float else (), rel)
    c = counters(got)
    if kind.startswith("stddev") and nparts > 1:
        assert c["device_aggregations"] >= nparts  # stage 1 on the device path
    elif nparts == 1:
        assert c["device_aggregations"] == 0 and c["host_aggregations"] == 1


@pytest.mark.parametrize("nparts", [1, 3])
def test_stddev_routes_stage_one_through_k1(nparts):
    """K1's wrapper runs once for each aggregate on the device path: each
    stage-1 partition of a multi-partition stddev (its sums of x and x*x),
    and the stage-2 partition whose partials reach ``device_min_rows``; never
    for one partition."""
    from daft_tpu_torch.kernels import segment_sums

    t = _table(600)
    entries = segment_sums.ENTRIES
    ref, got = run_both(lambda p: p.from_arrow(_parts(t, nparts)).groupby("k").agg(
        p.col("f").stddev().alias("sd"), p.col("f").mean().alias("m")).sort("k"))
    _check(ref, got, ("sd", "m"), 1e-5 if nparts > 1 else 0.0)
    dev = counters(got)["device_aggregations"]
    assert segment_sums.ENTRIES - entries == dev
    assert dev >= nparts if nparts > 1 else dev == 0


def test_stddev_deep_route_runs_k2_like_the_reference():
    """With deep fusion, stage 1 of a filtered stddev over three partitions
    evaluates ``child * child`` inside K2: one K2 build for each reference
    deep trace, K2 entered once for each aggregate on the device path (the
    three stage-1 partitions and a stage-2 one), K1 not at all."""
    from daft_tpu.kernels import pallas_ops
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums

    t = _table(900)
    traces = pallas_ops.DEEP_FUSED_TRACES[0]
    before = fes.BUILDS, fes.ENTRIES, segment_sums.ENTRIES
    ref, got = run_both(
        lambda p: p.from_arrow(_parts(t, 3)).where(p.col("g") > 20.0).groupby("k")
        .agg(p.col("g").stddev().alias("sd"), (p.col("g") * 2).sum().alias("s")).sort("k"),
        knobs={"use_pallas_deep_fusion": True})
    _check(ref, got, ("sd", "s"), 1e-5)
    traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
    assert traces > 0
    dev = counters(got)["device_aggregations"]
    assert dev > 3
    assert (fes.BUILDS - before[0], fes.ENTRIES - before[1], segment_sums.ENTRIES - before[2]) \
        == (traces, dev, 0)


@pytest.mark.parametrize("nparts", [1, 3])
def test_stddev_x64_matches_reference(nparts):
    t = _table()
    ref, got = run_both(lambda p: p.from_arrow(_parts(t, nparts)).groupby("k").agg(
        p.col("f").stddev().alias("sd"), p.col("f").sum().alias("s")).sort("k"), x64=True)
    _check(ref, got, ("sd", "s"), 1e-12)


def test_stddev_shares_partials_with_sum_and_mean():
    """sum, mean and stddev of one child need three stage-1 partials (the
    sum, the sum of squares, the count), named as in the reference."""
    from daft_tpu.physical import populate_aggregation_stages as ref_stages
    from daft_tpu_torch.physical import populate_aggregation_stages

    def aggs(p):
        c = p.col("f")
        return [c.sum().alias("s"), c.mean().alias("m"), c.stddev().alias("sd"),
                c.count().alias("n"), p.col("i").agg_list().alias("l"),
                p.col("i").any_value(ignore_nulls=True).alias("a")]

    got = populate_aggregation_stages(aggs(daft_tpu_torch))
    want = ref_stages(aggs(daft_tpu))
    for g, w in zip(got, want):
        assert [repr(e) for e in g] == [repr(e) for e in w]
    assert [e.name() for e in got[0]] == ["__s1_0_sum", "__s1_1_count", "__s1_2_sum",
                                          "__s1_3_list", "__s1_4_any_value"]


def test_skew_stays_whole_over_partitions():
    """skew does not decompose: grouped, the raw rows shuffle by key; global,
    they gather into one partition, as in the reference."""
    from daft_tpu_torch import physical
    from daft_tpu_torch.optimizer import optimize

    t = _table()
    df = daft_tpu_torch.from_arrow(_parts(t, 3))
    grouped = physical.translate(optimize(df.groupby("k").agg(
        daft_tpu_torch.col("f").skew())._plan), daft_tpu_torch.get_context().execution_config)
    tree = grouped.display_tree()
    assert "Shuffle" in tree and tree.count("Aggregate") == 1
    whole = physical.translate(optimize(df.agg(daft_tpu_torch.col("f").skew())._plan),
                               daft_tpu_torch.get_context().execution_config)
    assert "Gather" in whole.display_tree()


# ---------------------------------------------------------------------------
# nulls and empties
# ---------------------------------------------------------------------------

def _nulls_table():
    return pa.table({
        "k": pa.array([1, 1, 2, 2, 3, 3, 3, 4], pa.int64()),
        "v": pa.array([None, None, None, 4.0, 5.0, 5.0, 5.0, 2.5], pa.float64()),
        "w": pa.array([None, 7, None, 3, 1, None, 2, None], pa.int64()),
    })


@pytest.mark.parametrize("nparts", [1, 3])
def test_nulls_and_empties_match_reference(nparts):
    """stddev of an all-null group (k=1) and of a one-row group, any_value
    with ignore_nulls over a group whose first row is null (k=1, k=2), skew
    of a constant group (k=3: 0.0), through both packages."""
    t = _nulls_table()
    parts = _parts(t, nparts)

    def build(p):
        c = p.col
        return p.from_arrow(parts).groupby("k").agg(
            c("v").stddev().alias("sd"), c("w").any_value(ignore_nulls=True).alias("a"),
            c("w").any_value().alias("a0"), c("v").skew().alias("sk"),
            c("w").agg_list().alias("l")).sort("k")

    ref, got = run_both(build, min_rows=1)
    _check(ref, got, ("sd", "sk"), 1e-5 if nparts > 1 else 0.0)
    g = got.to_pydict()
    assert g["a"][:2] == [7, 3] and g["sk"][2] == 0.0


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("nparts", [1, 3])
def test_stddev_of_empty_input_matches_reference(nparts, grouped):
    """stddev over no rows (a filter that keeps none): null on one path and
    NaN on another in the reference; the port matches each."""
    t = _nulls_table()

    def build(p):
        df = p.from_arrow(_parts(t, nparts)).where(p.col("k") > 100)
        a = [p.col("v").stddev().alias("sd"), p.col("w").agg_list().alias("l")]
        return df.groupby("k").agg(*a) if grouped else df.agg(*a)

    ref, got = run_both(build, min_rows=1)
    _check(ref, got, ("sd",))


# ---------------------------------------------------------------------------
# the shorthands
# ---------------------------------------------------------------------------

_SHORT = ("sum", "mean", "min", "max", "stddev", "any_value", "count", "agg_list")


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("method", _SHORT + ("agg_concat",))
@pytest.mark.parametrize("grouped", [False, True], ids=["frame", "grouped"])
def test_shorthand_matches_reference(method, grouped, nparts):
    t = _table().select(["k", "f", "g", "i", "l"])
    cols = ("l",) if method == "agg_concat" else ()

    def build(p):
        df = p.from_arrow(_parts(t, nparts))
        if not grouped:
            return getattr(df, method)(*cols)
        return getattr(df.groupby("k"), method)(*cols).sort("k")

    ref, got = run_both(build)
    rel = 1e-5 if nparts > 1 and method in ("sum", "mean", "stddev") else 0.0
    _check(ref, got, ("f", "g"), rel)


# ---------------------------------------------------------------------------
# the reference's own tests of these kinds, against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", [1, 3])
def test_reference_dataframe_cases(nparts):
    """tests/test_dataframe.py: a global agg with stddev, a grouped agg_list
    and any_value."""
    import daft_tpu_torch as d

    d.set_execution_config(device="cpu", device_min_rows=1)
    out = d.from_pydict({"a": [1, 2, 3, 4], "b": [1.0, 2.0, 3.0, 4.0]}).into_partitions(
        nparts).agg(d.col("a").sum().alias("s"), d.col("b").mean().alias("m"),
                    d.col("a").count().alias("n"), d.col("b").stddev().alias("sd")).to_pydict()
    assert out["s"] == [10] and out["m"] == [2.5] and out["n"] == [4]
    assert out["sd"][0] == pytest.approx(1.118033988749895)
    out = d.from_pydict({"k": ["a", "b", "a"], "v": [1, 2, 3]}).into_partitions(
        nparts).groupby("k").agg_list("v").sort("k").to_pydict()
    assert sorted(out["v"][0]) == [1, 3] and out["v"][1] == [2]
    out = d.from_pydict({"k": ["a", "a", "b"], "v": [1, 2, 3]}).into_partitions(
        nparts).groupby("k").any_value("v").sort("k").to_pydict()
    assert out["k"] == ["a", "b"] and out["v"][0] in (1, 2) and out["v"][1] == 3


def test_reference_table_cases():
    """tests/test_table.py: grouped agg_concat, stddev beside any_value, and
    a multi-key stddev."""
    from daft_tpu_torch import Table, col

    t = Table.from_pydict({"k": [1, 1, 2], "v": [[1], [2, 3], [4]]})
    out = t.agg([col("v").agg_concat().alias("c")], group_by=[col("k")]).sort([col("k")])
    assert out.to_pydict() == {"k": [1, 2], "c": [[1, 2, 3], [4]]}
    t = Table.from_pydict({"k": [1, 1, 2], "v": [2.0, 4.0, 9.0]})
    out = t.agg([col("v").stddev().alias("sd"), col("v").any_value().alias("av")],
                group_by=[col("k")]).sort([col("k")])
    assert out.to_pydict() == {"k": [1, 2], "sd": [1.0, 0.0], "av": [2.0, 9.0]}
    t = Table.from_pydict({"a": ["x", "x", "y", "y", "x"], "b": [1, 2, 1, 1, 2],
                           "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    out = t.agg([col("v").sum().alias("s"), col("v").stddev().alias("sd")],
                group_by=[col("a"), col("b")]).to_pydict()
    assert out == {"a": ["x", "x", "y"], "b": [1, 2, 1], "s": [1.0, 7.0, 7.0],
                   "sd": [0.0, 1.5, 0.5]}


def test_concat_needs_a_list_or_a_string():
    from daft_tpu_torch import DataType, Schema, col
    from daft_tpu_torch.errors import DaftValueError
    from daft_tpu_torch.schema import Field

    with pytest.raises(DaftValueError, match="agg_concat needs list/string"):
        col("i").agg_concat().to_field(Schema([Field("i", DataType.int64())]))
