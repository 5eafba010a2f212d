"""The rest of the in-memory plan nodes in the port (concat, sample,
explode, unpivot, pivot and monotonic ids, daft_tpu_torch/logical.py and
physical.py) and the DataFrame compositions over ported nodes (count_rows,
drop_null, drop_nan, exclude, with_column(s)_renamed), held against daft_tpu
on the CPU: the cases of tests/test_dataframe.py and tests/test_table.py
TestReshape that run them, the optimizer's branches for the new nodes, and
the routing of device queries over monotonic ids in the 32-bit mode.

Each query runs over data made from a numpy seed through both packages
under one configuration (tests/torch_parity.py: the 32-bit device mode with
``device_min_rows=8``); rows and routing counters are equal.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.optimizer import optimize as ref_optimize
from daft_tpu_torch.optimizer import optimize as port_optimize
from benchmarks import tpch
from chip_smoke import ID_PARTS, ID_PINS, ID_QUERIES
from torch_parity import check, counters, restore_port_config  # noqa: F401

PARTS = [1, 3]


def make_df(pkg, data: dict, repartition: int = 1):
    """tests/conftest.py make_df over arrow: a random repartition into
    ``repartition`` partitions."""
    df = pkg.from_pydict(data)
    return df.repartition(repartition) if repartition != 1 else df


def both(fn):
    """``fn(pkg)`` (a plain value) in both packages, the port on the CPU."""
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
    return fn(daft_tpu), fn(daft_tpu_torch)


# ---------------------------------------------------------------------------
# tests/test_dataframe.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", PARTS)
def test_concat(nparts):
    def build(pkg):
        a = make_df(pkg, {"x": [1, 2]}, repartition=nparts)
        b = make_df(pkg, {"x": [3, 4]})
        return a.concat(b).sort("x")

    ref, got = check(build, ordered=True)
    assert got.to_pydict() == {"x": [1, 2, 3, 4]}


@pytest.mark.parametrize("nparts", PARTS)
def test_concat_unifies_types_after_a_staged_query(nparts):
    """int64 concat float64 gives float64. The left frame's int64 column
    was staged on the card by an earlier query over the same partitions;
    the concat's cast partitions stage afresh, as float64."""
    rng = np.random.RandomState(2)
    a_data = {"g": rng.randint(0, 4, 60).tolist(), "x": rng.randint(0, 1000, 60).tolist()}
    b_data = {"g": rng.randint(0, 4, 30).tolist(), "x": (rng.rand(30) * 10).tolist()}

    def build(pkg):
        c = pkg.col
        a = make_df(pkg, a_data, nparts).collect()
        a.groupby("g").agg(c("x").sum().alias("s")).collect()  # stages a's int64 x
        return a.concat(pkg.from_pydict(b_data)).groupby("g").agg(c("x").sum().alias("s"))

    ref, got = check(build, rtol=1e-6)
    assert got.schema["s"].dtype == daft_tpu_torch.DataType.float64()
    assert counters(got)["device_aggregations"] >= nparts + 1


@pytest.mark.parametrize("nparts", PARTS)
def test_explode_unpivot(nparts):
    ref, got = check(lambda pkg: make_df(pkg, {"k": [1, 2, 3], "vs": [[1, 2], [3], None]},
                                         nparts).explode("vs").sort(["k", "vs"]), ordered=True)
    assert got.to_pydict() == {"k": [1, 1, 2, 3], "vs": [1, 2, 3, None]}
    ref, got = check(lambda pkg: make_df(pkg, {"id": [1], "a": [10], "b": [20]}, nparts)
                     .unpivot("id").sort("variable"), ordered=True)
    assert got.to_pydict() == {"id": [1, 1], "variable": ["a", "b"], "value": [10, 20]}
    ref, got = check(lambda pkg: make_df(pkg, {"id": [1, 2], "a": [10, 11], "b": [2.5, 3.5]},
                                         nparts).melt(["id"], ["b", "a"], "var", "val"))
    assert got.schema["val"].dtype == daft_tpu_torch.DataType.float64()


@pytest.mark.parametrize("nparts", PARTS)
def test_explode_then_device_aggregate(nparts):
    """Lists of a seeded table's values grouped by key (some keys without
    a list, some lists empty or null), exploded and summed on the card:
    phase 9 (e) of chip_smoke.py in small."""
    rng = np.random.RandomState(4)
    n = 400
    lists = [None if i % 17 == 0 else rng.randint(0, 9, rng.randint(0, 6)).tolist()
             for i in range(n)]

    def build(pkg):
        c = pkg.col
        df = make_df(pkg, {"k": [i % 7 for i in range(n)], "vs": lists}, nparts)
        return df.explode("vs").groupby("k").agg(c("vs").sum().alias("s"),
                                                  c("vs").count().alias("n"))

    ref, got = check(build)
    d = got.to_pydict()
    assert sum(d["n"]) == sum(len(v) for v in lists if v)
    assert counters(got)["device_aggregations"] >= 1


@pytest.mark.parametrize("nparts", PARTS)
def test_pivot(nparts):
    def build(pkg):
        df = make_df(pkg, {"g": ["x", "x", "y"], "p": ["a", "b", "a"], "v": [1, 2, 3]}, nparts)
        return df.pivot("g", "p", "v", "sum").sort("g")

    ref, got = check(build, ordered=True)
    assert got.to_pydict() == {"g": ["x", "y"], "a": [1, 3], "b": [2, None]}


def test_pivot_names_through_the_device_distinct():
    """Without ``names``, the pivot column's distinct values (nulls
    dropped) come from a distinct query over more than device_min_rows
    rows; the pivot itself aggregates on the host."""
    rng = np.random.RandomState(6)
    n = 300
    data = {"g": rng.randint(0, 5, n).tolist(),
            "p": [None if i % 23 == 0 else f"p{v}" for i, v in enumerate(rng.randint(0, 4, n))],
            "v": (rng.rand(n) * 10).tolist()}
    ref, got = check(lambda pkg: make_df(pkg, data, 3).pivot("g", "p", "v", "mean"), rtol=1e-12)
    assert sorted(got.column_names[1:]) == ["p0", "p1", "p2", "p3"]
    ref, got = check(lambda pkg: make_df(pkg, data, 3).select("p").distinct())
    assert counters(got)["device_distincts"] >= 3


@pytest.mark.parametrize("nparts", PARTS)
def test_sample_and_monotonic_id(nparts):
    """With a seed the draws are equal row for row; without one, only the
    count is (round(0.5 n) of each partition of n rows)."""
    ref, got = check(lambda pkg: make_df(pkg, {"a": list(range(100))}, nparts)
                     .sample(0.5, seed=1), ordered=True)
    assert 20 <= len(got.to_pydict()["a"]) <= 80
    ref, got = check(lambda pkg: make_df(pkg, {"a": list(range(100))}, nparts)
                     .sample(0.3, with_replacement=True, seed=5), ordered=True)
    ref_n, got_n = both(lambda pkg: make_df(pkg, {"a": list(range(100))}, nparts)
                        .sample(0.5).count_rows())
    assert got_n == ref_n
    ref, got = check(lambda pkg: make_df(pkg, {"a": list(range(100))}, nparts)
                     .with_monotonically_increasing_id("rid"), ordered=True)
    ids = got.to_pydict()["rid"]
    assert len(set(ids)) == 100
    assert got.column_names == ["rid", "a"]
    for i, p in enumerate(got._result.partitions):
        assert p.table().to_pydict()["rid"] == list(range(i << 36, (i << 36) + len(p)))
    with pytest.raises(ValueError, match="fraction"):
        daft_tpu_torch.from_pydict({"a": [1]}).sample(1.5)


def test_drop_null_nan():
    def counts(pkg):
        df = pkg.from_pydict({"a": [1.0, None, float("nan"), 4.0], "b": [1, 2, 3, None]})
        return [df.drop_null("a").count_rows(), df.drop_nan("a").count_rows(),
                df.drop_null().drop_nan().count_rows(), df.drop_nan().count_rows()]

    ref, got = both(counts)
    assert got == ref == [3, 3, 1, 3]
    check(lambda pkg: pkg.from_pydict({"a": [float(i) if i % 5 else float("nan")
                                             for i in range(40)]}).drop_nan())


def test_exclude_rename():
    def names(pkg):
        df = pkg.from_pydict({"a": [1], "b": [2], "c": [3]})
        return [df.exclude("b").column_names, df.with_column_renamed("a", "z").column_names,
                df.with_columns_renamed({"a": "x", "c": "y"}).to_pydict()]

    ref, got = both(names)
    assert got == ref
    assert got[:2] == [["a", "c"], ["z", "b", "c"]]


@pytest.mark.parametrize("nparts", PARTS)
def test_count_rows(nparts):
    ref, got = both(lambda pkg: (make_df(pkg, {"a": list(range(42))}, nparts).count_rows(),
                                 len(make_df(pkg, {"a": list(range(42))}, nparts))))
    assert got == ref == (42, 42)


# ---------------------------------------------------------------------------
# tests/test_table.py TestReshape
# ---------------------------------------------------------------------------

class TestReshape:
    @staticmethod
    def tables(fn):
        from daft_tpu.table import Table as RefTable
        from daft_tpu_torch.table import Table

        ref = fn(RefTable, daft_tpu.col)
        got = fn(Table, daft_tpu_torch.col)
        assert got.to_pydict() == ref.to_pydict()
        return got.to_pydict()

    def test_explode_with_empty_and_null(self):
        out = self.tables(lambda T, col: T.from_pydict(
            {"i": [1, 2, 3], "l": [[1, 2], [], None]}).explode([col("l")]))
        assert out == {"i": [1, 1, 2, 3], "l": [1, 2, None, None]}

    def test_explode_sliced_and_unequal(self):
        out = self.tables(lambda T, col: T.from_pydict(
            {"i": [0, 1, 2, 3], "l": [["z"], ["a", "b"], None, ["c"]],
             "m": [[1], [2, 3], [], [4]]}).slice(1, 4).explode([col("l"), col("m")]))
        assert out == {"i": [1, 1, 2, 3], "l": ["a", "b", None, "c"], "m": [2, 3, None, 4]}
        from daft_tpu_torch import col
        from daft_tpu_torch.table import Table

        with pytest.raises(ValueError, match="equal list lengths"):
            Table.from_pydict({"l": [[1, 2]], "m": [[1]]}).explode([col("l"), col("m")])

    def test_distinct_with_nulls(self):
        from daft_tpu_torch.table import Table

        t = Table.from_pydict({"x": [1, 1, None, None, 2]})
        assert sorted(t.distinct().to_pydict()["x"], key=lambda v: (v is None, v)) == [1, 2, None]

    def test_unpivot(self):
        out = self.tables(lambda T, col: T.from_pydict({"id": [1], "a": [10], "b": [20]})
                          .unpivot([col("id")], [col("a"), col("b")], "var", "val"))
        assert out == {"id": [1, 1], "var": ["a", "b"], "val": [10, 20]}

    def test_pivot(self):
        out = self.tables(lambda T, col: T.from_pydict(
            {"g": ["x", "x", "y"], "p": ["m", "n", "m"], "v": [1, 2, 3]})
            .pivot([col("g")], col("p"), col("v"), ["m", "n"]).sort([col("g")]))
        assert out == {"g": ["x", "y"], "m": [1, 3], "n": [2, None]}

    def test_monotonic_id(self):
        out = self.tables(lambda T, col: T.from_pydict({"v": ["a", "b"]})
                          .add_monotonic_id(1000, "id"))
        assert out == {"id": [1000, 1001], "v": ["a", "b"]}

    def test_concat_unifies_types(self):
        out = self.tables(lambda T, col: T.concat([T.from_pydict({"x": [1, 2]}),
                                                   T.from_pydict({"x": [3.5]})]))
        assert out["x"] == [1.0, 2.0, 3.5]

    def test_sample_draws(self):
        for kw in ({"size": 7, "seed": 3}, {"fraction": 0.4, "seed": 9},
                   {"fraction": 0.4, "with_replacement": True, "seed": 9}):
            self.tables(lambda T, col: T.from_pydict({"x": list(range(20))}).sample(**kw))


# ---------------------------------------------------------------------------
# the optimizer's branches for the new nodes
# ---------------------------------------------------------------------------

DATA = {"a": list(range(20)), "b": [i % 5 for i in range(20)],
        "c": [str(i % 3) for i in range(20)], "l": [[i, i + 1] for i in range(20)]}


def _f(pkg):
    return pkg.from_pydict(DATA)


RULES = {
    "filter_crosses_monotonic_id": lambda pkg: _f(pkg)._add_monotonic_id("rid")
    .where(pkg.col("a") > 3),
    "filter_on_the_id_stays": lambda pkg: _f(pkg)._add_monotonic_id("rid")
    .where(pkg.col("rid") > 3),
    "filter_into_concat": lambda pkg: _f(pkg).concat(_f(pkg)).where(pkg.col("b") == 1),
    "limit_into_concat": lambda pkg: _f(pkg).concat(_f(pkg)).limit(5),
    "limit_into_limited_concat": lambda pkg: _f(pkg).limit(3).concat(_f(pkg).limit(2)).limit(5),
    "pruning_through_concat": lambda pkg: _f(pkg).concat(_f(pkg)).select("a"),
    "pruning_through_pivot": lambda pkg: _f(pkg).pivot("b", "c", "a", "sum", ["0", "1"]),
    "pruning_through_explode": lambda pkg: _f(pkg).explode("l").select("l", "b"),
    "pruning_through_unpivot": lambda pkg: _f(pkg).unpivot("b", ["a"]).select("value"),
    "pruning_through_sample": lambda pkg: _f(pkg).sample(0.5, seed=1).select("a"),
    "pruning_stops_at_monotonic_id": lambda pkg: _f(pkg)._add_monotonic_id().select("id", "a"),
    "filter_stays_above_cross_join": lambda pkg: _f(pkg).select("a").join(
        _f(pkg).select("b"), how="cross").where(pkg.col("a") > pkg.col("b")),
    "cross_join_pruned": lambda pkg: _f(pkg).join(_f(pkg), how="cross").select("a", "right.a"),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_optimized_plan_matches_reference(case):
    ref = RULES[case](daft_tpu)
    got = RULES[case](daft_tpu_torch)
    assert got._plan.display_tree() == ref._plan.display_tree()
    assert port_optimize(got._plan).display_tree() == ref_optimize(ref._plan).display_tree()
    check(RULES[case], ordered=case.startswith("limit"))


# ---------------------------------------------------------------------------
# monotonic ids in the 32-bit mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ID_PINS))
def test_monotonic_id_device_routing_is_pinned(name):
    """chip_smoke.py phase 9 (h)'s queries over ID_PARTS partitions of a
    small lineitem: both packages route them alike (``check``), and the
    port's counters equal ID_PINS, which the phase holds the card to. The
    ids of partitions 1 and later are at least 2**36, past the 32-bit
    staging's int32 guard: a query that stages the id column fails its
    device attempt there (DaftStagingError, a failure on the breaker in
    both packages, which only the port counts as device_attempt_failures)
    and completes on the host; a query that does not read the ids never
    stages them."""
    li = tpch.generate_lineitem_only(scale=8000 / tpch.LINEITEM_ROWS_PER_SF, seed=3)

    def build(pkg):
        frame = pkg.from_arrow(li).into_partitions(ID_PARTS)
        return ID_QUERIES[name](frame.with_monotonically_increasing_id("rid"), pkg.col)

    ref, got = check(build, rtol=1e-6)
    c = got.stats.snapshot()["counters"]
    assert {k: c.get(k, 0) for k in ID_PINS[name]} == ID_PINS[name]
