"""The two-stage aggregate over several partitions (stage 1 per partition, a
hash shuffle of the partials by group key or a gather, stage 2, the final
projection) held against daft_tpu in its 32-bit device mode, on the CPU.

Every case runs one query over the same partitions in both packages: daft_tpu
under tests/device_mode.real_tpu_mode_cfg (x64 off, device kernels on), the
port under execution_config_from_dict(...) of that config with device="cpu".
Keys, group order and counts must match exactly; float aggregates agree at
rtol 1e-6, of each result or, where a group's values cancel, of its summed
magnitudes; min and max bit for bit. The group
order of a grouped result is the shuffle's buckets in bucket order, with
first occurrence inside each, so it equals the reference's only if the row
hash does bit for bit; the hash is checked against the reference's on its own.
"""

import dataclasses
import datetime

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import parity, q1 as port_q1, q6 as port_q6
from daft_tpu.kernels.host_hash import hash_table_columns as ref_hash
from daft_tpu_torch.kernels.host_hash import hash_table_columns as port_hash
from device_mode import real_tpu_mode_cfg

RTOL = 1e-6
# the counters of the plan's route, on which the two packages must agree
ROUTE = ("shuffles", "device_aggregations", "host_aggregations")


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.context.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _both(parts, query, min_rows):
    """``query(pkg, frame)`` over ``parts`` (one partition each) in both
    packages; returns ((reference dict, counters), (port dict, counters))."""
    out = []
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        ref = query(daft_tpu, daft_tpu.from_arrow(parts)).collect()
        out.append((ref.to_pydict(), ref.stats.snapshot()["counters"]))
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = query(daft_tpu_torch, daft_tpu_torch.from_arrow(parts)).collect()
    out.append((got.to_pydict(), got.stats.snapshot()["counters"]))
    return out


def _route(counters):
    return {k: counters.get(k, 0) for k in ROUTE}


def _assert_same(got: dict, ref: dict):
    assert list(got) == list(ref)
    for name in ref:
        a, b = got[name], ref[name]
        assert len(a) == len(b), name
        if any(isinstance(x, float) for x in b):
            assert [x is None for x in a] == [x is None for x in b], name
            np.testing.assert_allclose(
                np.array([np.nan if x is None else x for x in a], dtype=float),
                np.array([np.nan if x is None else x for x in b], dtype=float),
                rtol=RTOL, err_msg=name)
        else:
            assert a == b, name  # keys, group order, counts: exact


def _bits(values) -> np.ndarray:
    return np.array([np.nan if x is None else x for x in values], np.float64).view(np.uint64)


# ---------------------------------------------------------------------------
# the smallest input of the fault: a float32 sum per partition keeps 2**24 + 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_partials_sum_exactly_across_partitions(grouped):
    # one partition's float32 sum is exact; adding 1.0 to 2**24 in float32
    # is not, so summing the three rows at once gives 16777216.0, while
    # stage 2 adds the exact partials 16777216.0 and 2.0
    parts = [pa.table({"k": [1], "v": [16777216.0]}),
             pa.table({"k": [1, 1], "v": [1.0, 1.0]})]

    def query(pkg, frame):
        agg = pkg.col("v").sum().alias("s")
        return frame.groupby("k").agg(agg) if grouped else frame.agg(agg)

    (ref, ref_c), (got, got_c) = _both(parts, query, min_rows=1)
    assert ref["s"] == [16777218.0] == got["s"]
    assert got == ref
    assert _route(got_c) == _route(ref_c)
    # stage 1 on each partition and stage 2 on the partials, all on the card
    # side; the grouped plan's second bucket is empty and takes the host
    assert got_c["device_aggregations"] == 3
    assert got_c.get("shuffles", 0) == int(grouped)
    assert got_c.get("device_agg_fallbacks", 0) == 0


# ---------------------------------------------------------------------------
# many groups over four partitions
# ---------------------------------------------------------------------------

def _normals(seed=11, n=3000, keys=500, nparts=4):
    rng = np.random.RandomState(seed)
    t = pa.table({"k": pa.array(rng.randint(0, keys, n), pa.int64()),
                  "v": pa.array(rng.randn(n) * 1000.0)})
    step = n // nparts
    return [t.slice(i * step, step) for i in range(nparts)]


def _grouped_aggs(pkg, frame):
    v = pkg.col("v")
    return frame.groupby("k").agg(v.sum().alias("s"), v.mean().alias("m"),
                                  v.min().alias("lo"), v.max().alias("hi"),
                                  v.count().alias("n"))


# min_rows 8: both stages on the card side; 4096 (the default): both on the host
@pytest.mark.parametrize("min_rows", [8, 4096], ids=["device", "host"])
def test_grouped_aggregate_over_four_partitions(min_rows):
    parts = _normals()
    (ref, ref_c), (got, got_c) = _both(parts, _grouped_aggs, min_rows)
    assert list(got) == list(ref)
    assert got["k"] == ref["k"] and got["n"] == ref["n"]  # keys, group order, counts
    assert 450 < len(got["k"]) <= 500 and sum(got["n"]) == 3000
    assert _route(got_c) == _route(ref_c) and got_c["shuffles"] == 1
    # min and max are bit-equal. The sums and means are not, on either route:
    # on the card side the reference's Pallas kernel sums a partition's rows
    # through a one-hot product and K1 adds them in row order (about 95 % of
    # stage-1 sums come out bit-equal), and on the host the reference's
    # native grouped sum and the port's bincount add float64 in other orders
    for name in ("lo", "hi"):
        assert (_bits(got[name]) == _bits(ref[name])).all(), name
    # The sums hold at rtol 1e-6 of each group's summed magnitudes, against
    # the reference and against float64 over all rows. (Plain rtol 1e-6 of
    # the result fails on the card side for three groups whose normals
    # cancel to 0.2 % of their magnitudes: there both packages are within
    # 4e-8 of those magnitudes, in different float32 orders.)
    table = pa.concat_tables(parts).to_pydict()
    exact, mags = {}, {}
    for k, v in zip(table["k"], table["v"]):
        exact[k] = exact.get(k, 0.0) + v
        mags[k] = mags.get(k, 0.0) + abs(v)
    for k, n, s, rs, m, rm in zip(got["k"], got["n"], got["s"], ref["s"], got["m"], ref["m"]):
        tol = RTOL * mags[k]
        assert abs(s - rs) <= tol and abs(s - exact[k]) <= tol and abs(rs - exact[k]) <= tol
        assert abs(m - rm) <= tol / n and abs(m - exact[k] / n) <= tol / n
    if min_rows == 4096:  # float64 on the host: rtol 1e-6 of each result too
        _assert_same(got, ref)


def _keyed_parts(seed=5, n=1200, nparts=3):
    rng = np.random.RandomState(seed)
    floats = np.array([0.0, -0.0, np.nan, 1.5, -2.25, 7.0])
    t = pa.table({
        "i": pa.array(rng.randint(-3, 40, n), pa.int64(), mask=rng.rand(n) < 0.05),
        "s": pa.array([f"k{x}" for x in rng.randint(0, 30, n)], mask=rng.rand(n) < 0.05),
        "d": pa.array([datetime.date(1995, 1, 1) + datetime.timedelta(days=int(x))
                       for x in rng.randint(0, 20, n)], mask=rng.rand(n) < 0.05),
        "b": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.05),
        "f": pa.array(floats[rng.randint(0, len(floats), n)], mask=rng.rand(n) < 0.05),
        "v": pa.array(rng.rand(n) * 100.0),
    })
    step = n // nparts
    return [t.slice(i * step, step) for i in range(nparts)]


@pytest.mark.parametrize("keys", [["i"], ["s"], ["d"], ["b"], ["f"], ["s", "d"], ["i", "b"]],
                         ids=lambda k: "_".join(k))
def test_group_order_follows_the_reference_hash(keys):
    # null keys form a group; no sort: the output order is the shuffle's
    # bucket order with first occurrence inside each bucket
    def query(pkg, frame):
        v = pkg.col("v")
        return frame.groupby(*keys).agg(v.sum().alias("s_v"), v.count().alias("n"),
                                        v.max().alias("hi"))

    (ref, ref_c), (got, got_c) = _both(_keyed_parts(), query, min_rows=8)
    _assert_same(got, ref)
    assert _route(got_c) == _route(ref_c) and got_c["shuffles"] == 1
    assert sum(got["n"]) == 1200


def test_global_aggregate_over_four_partitions():
    parts = _normals(seed=12)

    def query(pkg, frame):
        v = pkg.col("v")
        return frame.agg(v.sum().alias("s"), v.mean().alias("m"), v.min().alias("lo"),
                         v.max().alias("hi"), v.count().alias("n"))

    (ref, ref_c), (got, got_c) = _both(parts, query, min_rows=8)
    _assert_same(got, ref)
    assert got["n"] == [3000]
    assert _route(got_c) == _route(ref_c) and got_c.get("shuffles", 0) == 0


# ---------------------------------------------------------------------------
# TPC-H Q1 and Q6 in three partitions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem():
    return tpch.generate_lineitem_only(scale=20_000 / tpch.LINEITEM_ROWS_PER_SF, seed=7)


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_tpch_query_in_three_partitions(lineitem, query):
    n = lineitem.num_rows
    parts = [lineitem.slice(0, n // 3), lineitem.slice(n // 3, n // 3),
             lineitem.slice(2 * (n // 3))]
    ref_q, port_q = {"q1": (tpch.q1, port_q1), "q6": (tpch.q6, port_q6)}[query]
    (ref, ref_c), (got, got_c) = _both(
        parts, lambda pkg, f: (ref_q if pkg is daft_tpu else port_q)(f), min_rows=8)
    _assert_same(got, ref)
    oracle = (tpch.oracle_q1(lineitem) if query == "q1"
              else {"revenue": [tpch.oracle_q6(lineitem)]})
    assert parity(got, oracle, RTOL) and parity(ref, oracle, RTOL)
    # three stage-1 aggregations on the card side and stage 2 over the few
    # partials; Q1's sort range-shuffles its three partitions in both
    # packages (its second shuffle) and sorts each of them
    assert got_c["device_aggregations"] == ref_c["device_aggregations"] >= 3
    assert got_c.get("host_aggregations", 0) == ref_c.get("host_aggregations", 0)
    assert got_c.get("shuffles", 0) == ref_c.get("shuffles", 0) == 2 * int(query == "q1")
    for k in ("device_sorts", "host_sorts"):
        assert got_c.get(k, 0) == ref_c.get(k, 0), k
    assert got_c.get("device_agg_fallbacks", 0) == 0


# ---------------------------------------------------------------------------
# empty input, and a kind the port lacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_empty_partitions(grouped):
    empty = pa.table({"k": pa.array([], pa.int64()), "v": pa.array([], pa.float64())})

    def query(pkg, frame):
        v = pkg.col("v")
        aggs = (v.sum().alias("s"), v.mean().alias("m"), v.count().alias("n"))
        return frame.groupby("k").agg(*aggs) if grouped else frame.agg(*aggs)

    (ref, ref_c), (got, got_c) = _both([empty, empty, empty], query, min_rows=1)
    assert got == ref
    assert got == ({"k": [], "s": [], "m": [], "n": []} if grouped
                   else {"s": [None], "m": [None], "n": [0]})
    assert _route(got_c) == _route(ref_c)


def test_kind_the_port_lacks_raises():
    # stddev splits into stages since the columnar-core slice; a kind that
    # does not split (skew, count_distinct) raises as in the reference
    from daft_tpu_torch.physical import populate_aggregation_stages

    with pytest.raises(ValueError, match="'skew' is not decomposable"):
        populate_aggregation_stages([daft_tpu_torch.col("v").skew().alias("x")])


def test_stages_share_partials_with_reference_names():
    from daft_tpu.physical import populate_aggregation_stages as ref_stages
    from daft_tpu_torch.physical import populate_aggregation_stages as port_stages

    def aggs(pkg):
        v, w = pkg.col("v"), pkg.col("w")
        return [v.mean().alias("m"), v.sum().alias("s"), v.count().alias("n"),
                v.count("all").alias("na"), w.min().alias("lo"), (v * 2).max().alias("hi")]

    for got, want in zip(port_stages(aggs(daft_tpu_torch)), ref_stages(aggs(daft_tpu))):
        assert [e.name() for e in got] == [e.name() for e in want]
        assert [repr(e) for e in got] == [repr(e) for e in want]
    s1, _s2, _final = port_stages(aggs(daft_tpu_torch))
    # mean's sum and count are the sum() and count() of the same child
    assert [e.name() for e in s1] == ["__s1_0_sum", "__s1_1_count", "__s1_2_count",
                                      "__s1_3_min", "__s1_4_max"]


# ---------------------------------------------------------------------------
# the row hash and the shuffle's buckets
# ---------------------------------------------------------------------------

_HASH_COLUMNS = {
    "int64": pa.array([0, 1, -1, 2**62, -(2**63), None, 7], pa.int64()),
    "int32": pa.array([0, 5, -5, 2**31 - 1, None, 3, 3], pa.int32()),
    "float64": pa.array([0.0, -0.0, float("nan"), float("inf"), -1.5, None, 1e300]),
    "float32": pa.array([0.0, -0.0, float("nan"), 2.5, -1.5, None, 3.0], pa.float32()),
    "string": pa.array(["", "a", "BUILDING", "x" * 5000, None, "é", "a"]),
    "date": pa.array([datetime.date(1970, 1, 1), datetime.date(1998, 9, 2), None,
                      datetime.date(1900, 1, 1), datetime.date(2100, 12, 31),
                      datetime.date(1995, 3, 15), datetime.date(1995, 3, 15)]),
    "bool": pa.array([True, False, None, True, False, True, None]),
    "null": pa.nulls(7),
}


@pytest.mark.parametrize("kind", list(_HASH_COLUMNS))
def test_row_hash_equals_reference(kind):
    arr = _HASH_COLUMNS[kind]
    for seed in (0, 12345):
        got = port_hash([arr], seed=seed)
        assert got.dtype == np.uint64
        assert (got == ref_hash([arr], seed=seed)).all()
    # and a slice, whose buffers start at an offset
    assert (port_hash([arr.slice(2)]) == ref_hash([arr.slice(2)])).all()


@pytest.mark.parametrize("pair", [("int64", "string"), ("date", "float64"), ("bool", "null")])
def test_two_column_row_hash_equals_reference(pair):
    cols = [_HASH_COLUMNS[p] for p in pair]
    got = port_hash(cols)
    assert (got == ref_hash(cols)).all()
    # the seed chains across the columns: the order of the columns matters
    assert not (got == port_hash(cols[::-1])).all()


def test_partition_by_hash_equals_reference():
    rng = np.random.RandomState(4)
    n = 2000
    t = pa.table({"k": pa.array(rng.randint(0, 50, n), pa.int64()),
                  "s": pa.array([f"s{i % 37}" for i in range(n)]),
                  "v": pa.array(rng.rand(n))})
    by = ["k", "s"]
    want = [p.to_pydict() for p in daft_tpu.Table.from_arrow(t).partition_by_hash(
        [daft_tpu.col(c) for c in by], 5)]
    port = daft_tpu_torch.Table.from_arrow(t)
    got = [p.to_pydict() for p in port.partition_by_hash([daft_tpu_torch.col(c) for c in by], 5)]
    assert got == want
    # a partition of two chained tables splits chunk by chunk to the same rows
    from daft_tpu_torch.micropartition import MicroPartition

    mp = MicroPartition.concat([MicroPartition.from_arrow(t.slice(0, 700)),
                                MicroPartition.from_arrow(t.slice(700))])
    chained = mp.partition_by_hash([daft_tpu_torch.col(c) for c in by], 5)
    assert [p.table().to_pydict() for p in chained] == want


# ---------------------------------------------------------------------------
# uint64 columns, which stage as int32 lanes for stage 2's count partials:
# user columns of that type take the same lanes and must give the reference's
# results (the reference stages them as uint32 lanes, so its device route
# also covers values in [2**31, 2**32), which the port runs on the host)
# ---------------------------------------------------------------------------

def _run_or_raise(pkg, table, query):
    try:
        r = query(pkg, pkg.from_arrow(table)).collect()
    except Exception as e:  # both packages' host arithmetic is checked
        return type(e).__name__, {}
    return r.to_pydict(), r.stats.snapshot()["counters"]


def _both_single(table, query):
    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        ref = _run_or_raise(daft_tpu, table, query)
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    return ref, _run_or_raise(daft_tpu_torch, table, query)


def _u64_table(big: bool):
    keys = [1, 2, 2**31 + 5, 2**32 - 1] if big else [1, 2, 3, 4]
    return pa.table({"k": pa.array(keys * 8, pa.uint64()),
                     "v": pa.array(list(range(32)), pa.uint64()),
                     "w": pa.array([5] * 32, pa.uint64())})


# query, and whether the port's fused filter/projection chain may run on the
# card for the (small-valued, large-valued) table: values past the int32
# range, and uint64 arithmetic whose interval reaches below 0, decline
_U64_QUERIES = {
    "filter": (lambda p, f: f.where(p.col("v") > 20).select("k", "v"), (True, False)),
    # the literal 2**31 itself does not fit an int32 lane
    "filter_on_key": (lambda p, f: f.where(p.col("k") > 2**31).select("k", "v"), (False, False)),
    "filter_on_key_small": (lambda p, f: f.where(p.col("k") > 2).select("k", "v"),
                            (True, False)),
    "add": (lambda p, f: f.where(p.col("v") >= 0).with_column("y", p.col("k") + 1), (True, False)),
    "mul_add": (lambda p, f: f.where(p.col("v") >= 0)
                .with_column("y", p.col("v") * 3 + p.col("w")), (True, False)),
    # w - v goes below 0 for v > 5: the host's checked subtract raises in
    # both packages (so no counters come back), and the port's card must
    # not wrap it into a result instead
    "sub_below_zero": (lambda p, f: f.where(p.col("v") >= 0)
                       .with_column("y", p.col("w") - p.col("v")), None),
    # the rows that reach the subtract keep it at or above 0, but the
    # guard bounds it over the whole column
    "sub_filtered": (lambda p, f: f.where(p.col("v") < 3)
                     .with_column("y", p.col("w") - p.col("v")), (False, False)),
    "group_key": (lambda p, f: f.groupby("k").agg(p.col("v").sum().alias("s")).sort("k"), None),
    "join_key": (lambda p, f: f.join(f.select(p.col("k"), p.col("w").alias("w2")).limit(4),
                                     on="k").sort(["k", "v"]), None),
}


@pytest.mark.parametrize("big", [False, True], ids=["below_2_31", "past_2_31"])
@pytest.mark.parametrize("name", list(_U64_QUERIES))
def test_uint64_columns_match_the_reference(name, big):
    query, on_card = _U64_QUERIES[name]
    (ref, _), (got, got_c) = _both_single(_u64_table(big), query)
    assert got == ref
    if on_card is not None:
        assert got_c.get("device_fused_maps", 0) == int(on_card[big])
        assert got_c.get("host_fused_maps", 0) == int(not on_card[big])


@pytest.mark.parametrize("arrow_type", [pa.int64(), pa.uint64()], ids=["int64", "uint64"])
def test_arithmetic_past_int32_declines_to_the_host(arrow_type):
    # v * 1_000_000 reaches 4.1e9: int32 lanes would wrap it, so the wrap
    # guard declines the chain and the host computes it exactly
    t = pa.table({"v": pa.array(list(range(4096)), arrow_type)})

    def query(p, f):
        return f.where(p.col("v") >= 0).with_column("y", p.col("v") * 1_000_000)

    (ref, _), (got, got_c) = _both_single(t, query)
    assert got["y"] == [v * 1_000_000 for v in range(4096)]
    assert got == ref
    assert got_c.get("host_fused_maps") == 1 and "device_fused_maps" not in got_c


@pytest.mark.parametrize("op", ["abs", "negate"])
def test_int64_function_past_int32_declines_to_the_host(op):
    # -2**31 fits an int32 lane, but its abs and its negation do not: the
    # wrap guard treats an int64 function as arithmetic, and with no bounds
    # for it the chain declines to the host, as in the reference
    vals = [-2**31, -5, 0, 7, 2**31 - 1] * 8
    t = pa.table({"v": pa.array(vals, pa.int64())})

    def query(p, f):
        y = p.col("v").abs() if op == "abs" else -p.col("v")
        return f.where(p.col("v") >= -2**31).with_column("y", y)

    (ref, ref_c), (got, got_c) = _both_single(t, query)
    assert got["y"] == [abs(v) if op == "abs" else -v for v in vals]
    assert got == ref
    assert got_c.get("host_fused_maps") == 1 and "device_fused_maps" not in got_c
    assert ref_c.get("device_fused_maps", 0) == 0
