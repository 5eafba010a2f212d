"""The sort-merge and cross joins of the port (daft_tpu_torch/physical.py
SortMergeJoinOp and CrossJoinOp, Table.sort_merge_join) held against
daft_tpu on the CPU: the cases of tests/test_exchange.py,
tests/test_distributed_ops.py, tests/test_table.py and tests/test_dataframe.py
that run these joins.

Each case runs one query over data made from a numpy seed through both
packages under one configuration (tests/torch_parity.py: the 32-bit device
mode with ``device_min_rows=8``, or the 64-bit mode): the rows are equal as
multisets (a join's order within equal keys is acero's), and so are the
routing and exchange counters, ``aligned_boundary_shuffles`` and
``exchange_rows`` among them.
"""

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.optimizer import optimize
from daft_tpu_torch.physical import SortMergeJoinOp, translate
from torch_parity import check, counters, restore_port_config, rows  # noqa: F401

HOWS = ["inner", "left", "right", "outer", "semi", "anti"]


def _frames(pkg, nparts: int):
    """tests/test_exchange.py test_join_types_x_strategies' sides: 500 left
    rows over 40 keys (a few null), 25 right rows on the even keys."""
    rng = np.random.RandomState(7)
    n = 500
    k = rng.randint(0, 40, n)
    left = pa.table({"k": pa.array(k, pa.int64(), mask=rng.rand(n) < 0.03),
                     "lv": pa.array(rng.rand(n))})
    right = pa.table({"k": pa.array(np.arange(25) * 2, pa.int64()),
                      "rv": pa.array(np.arange(25), pa.int64())})
    return (pkg.from_arrow(left).into_partitions(nparts),
            pkg.from_arrow(right).into_partitions(max(nparts - 1, 1)))


def _key_sorted(got, key: str = "k") -> bool:
    """The key column non-decreasing across the collected partitions, its
    nulls after every value."""
    keys = [v for p in got._result.partitions for v in p.table().to_pydict()[key]]
    vals = [v for v in keys if v is not None]
    return vals == sorted(vals) and keys[:len(vals)] == vals


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("how", HOWS)
def test_sort_merge_join_matches_reference(how, nparts):
    def build(pkg):
        left, right = _frames(pkg, nparts)
        return left.join(right, on="k", how=how, strategy="sort_merge")

    ref, got = check(build)
    c = counters(got)
    assert c["aligned_boundary_shuffles"] == (1 if nparts > 1 else 0)
    assert c["exchange_rows"] == (500 + 25 if nparts > 1 else 0)
    assert c["device_join_probes"] == 0 and c["host_joins"] == 0
    assert _key_sorted(got)


def test_sort_merge_join_on_string_keys_of_two_names():
    """Keys of different names and a clashing payload column over 3 and 2
    partitions: the right side's samples are cast to the left's names."""
    rng = np.random.RandomState(5)

    def build(pkg):
        left = pkg.from_arrow(pa.table({
            "s": pa.array([f"k{v:02d}" for v in rng_l]), "v": pa.array(np.arange(300))}))
        right = pkg.from_arrow(pa.table({
            "t": pa.array([f"k{v:02d}" for v in rng_r]), "v": pa.array(np.arange(120) * 10)}))
        return left.into_partitions(3).join(right.into_partitions(2), left_on="s",
                                            right_on="t", strategy="sort_merge")

    rng_l = rng.randint(0, 60, 300)
    rng_r = rng.randint(0, 60, 120)
    ref, got = check(build)
    assert got.column_names == ["s", "v", "right.v"]
    assert _key_sorted(got, "s")


def _smj(pkg, how: str = "inner", parts: int = 4):
    """tests/test_distributed_ops.py _smj: two sides randomly repartitioned
    into ``parts`` partitions, joined on keys of different names."""
    rng = np.random.RandomState(11)
    ldata = {"k": rng.randint(0, 500, 5000), "lv": rng.rand(5000)}
    rdata = {"k2": rng.randint(0, 500, 3000), "rv": rng.rand(3000)}
    l = pkg.from_pydict(ldata).repartition(parts)
    r = pkg.from_pydict(rdata).repartition(parts)
    return l.join(r, left_on="k", right_on="k2", how=how, strategy="sort_merge")


class TestDistributedSortMergeJoin:
    """tests/test_distributed_ops.py TestDistributedSortMergeJoin."""

    def test_multi_partition_no_gather(self):
        daft_tpu_torch.set_execution_config(device="cpu")
        phys = translate(optimize(_smj(daft_tpu_torch)._plan))
        assert "SortMergeJoin" in phys.display_tree()

        def find(op):
            if isinstance(op, SortMergeJoinOp):
                return op
            return next((f for f in map(find, op.children) if f is not None), None)

        smj = find(phys)
        assert smj is not None and smj.num_partitions == 4
        assert smj.describe() == "SortMergeJoinOp [4 parts]"

    def test_parity_with_hash_join(self):
        ref, got = check(_smj)
        rng = np.random.RandomState(11)
        ldata = {"k": rng.randint(0, 500, 5000), "lv": rng.rand(5000)}
        rdata = {"k2": rng.randint(0, 500, 3000), "rv": rng.rand(3000)}
        hj = (daft_tpu_torch.from_pydict(ldata)
              .join(daft_tpu_torch.from_pydict(rdata), left_on="k", right_on="k2")
              .to_pydict())
        assert rows(got.to_pydict()) == rows(hj)
        c = counters(got)
        # the random repartitions under both sides, then the aligned split,
        # each moving all 8000 rows
        assert c["shuffles"] == 2
        assert c["aligned_boundary_shuffles"] == 1 and c["exchange_rows"] == 2 * 8000

    def test_output_globally_sorted_by_key(self):
        ref, got = check(lambda pkg: _smj(pkg, "left"))
        assert _key_sorted(got)
        assert [len(p) for p in got._result.partitions] == [
            len(p) for p in ref._result.partitions]


def test_smj_host_exchange_counts_payload():
    """tests/test_exchange.py: the aligned-boundary exchange counts both
    sides' rows and bytes, as the reference does."""
    n = 4000
    rng = np.random.RandomState(3)
    lk, rk = rng.randint(0, 500, n), rng.randint(0, 500, n)

    def build(pkg):
        left = pkg.from_pydict({"k": lk.tolist(), "a": list(range(n))}).into_partitions(4)
        right = pkg.from_pydict({"k": rk.tolist(), "b": list(range(n))}).into_partitions(4)
        return left.join(right, on="k", how="inner", strategy="sort_merge")

    ref, got = check(build)
    c = got.stats.snapshot()["counters"]
    assert c["exchange_rows"] == 2 * n
    assert c["exchange_bytes"] == ref.stats.snapshot()["counters"]["exchange_bytes"] > 0


def test_table_sort_merge_join_sorted_output():
    """tests/test_table.py test_sort_merge_join_sorted_output."""
    from daft_tpu_torch import col
    from daft_tpu_torch.table import Table

    l = Table.from_pydict({"k": [3, 1, 2], "v": [30, 10, 20]})
    r = Table.from_pydict({"k": [2, 3], "w": [200, 300]})
    out = l.sort_merge_join(r, [col("k")], [col("k")], "inner")
    assert out.to_pydict() == {"k": [2, 3], "v": [20, 30], "w": [200, 300]}


def test_cross_join():
    """tests/test_dataframe.py test_cross_join."""
    def build(pkg):
        l = pkg.from_pydict({"a": [1, 2]})
        r = pkg.from_pydict({"b": ["x", "y", "z"]})
        return l.join(r, how="cross").sort(["a", "b"])

    ref, got = check(build, ordered=True)
    assert got.to_pydict() == {"a": [1, 1, 1, 2, 2, 2], "b": ["x", "y", "z"] * 2}


def _cross_tables():
    rng = np.random.RandomState(13)
    cust = pa.table({"c_key": pa.array(rng.randint(0, 6, 40), pa.int64()),
                     "bal": pa.array(rng.rand(40) * 100), "name": pa.array(["c"] * 40)})
    nation = pa.table({"n_key": pa.array(np.arange(6), pa.int64()),
                       "name": pa.array([f"n{i}" for i in range(6)])})
    return cust, nation


def _cross(pkg):
    cust, nation = _cross_tables()
    return (pkg.from_arrow(cust).into_partitions(3)
            .join(pkg.from_arrow(nation).into_partitions(2), how="cross"))


def test_cross_join_name_clash_over_partitions():
    """A right column named like a left one takes the suffix, and the
    literal key never reaches the output; 3 left and 2 right partitions."""
    ref, got = check(_cross)
    assert got.column_names == ["c_key", "bal", "name", "n_key", "right.name"]
    assert len(got.to_pydict()["c_key"]) == 40 * 6
    assert got._result.schema.field_names() == got.column_names


def test_cross_join_filter_and_grouped_sum():
    """The cross join, a filter on the card and a grouped sum (phase 9 (b)
    of chip_smoke.py in small), held against the reference and against the
    equi-join of the same sides."""
    def summed(pkg, by="n_key"):
        c = pkg.col
        return (_cross(pkg).where(c("c_key") == c("n_key")).groupby(by)
                .agg(c("bal").sum().alias("s")))

    ref, got = check(summed, rtol=1e-6)
    c = counters(got)
    # the predicate is the mask of each partition's stage-1 aggregate on the card
    assert c["device_aggregations"] >= 3 and c["host_filters"] == 0 and c["host_joins"] == 0
    cust, nation = _cross_tables()
    want = {}
    for k, b in zip(cust["c_key"].to_pylist(), cust["bal"].to_pylist()):
        want[k] = want.get(k, 0.0) + b
    d = got.to_pydict()
    assert dict(zip(d["n_key"], d["s"])) == pytest.approx(want, rel=1e-6)


def test_cross_join_suffixed_column_survives_pruning():
    """A query that reads only the suffixed right column: the port's
    column pruning keeps the left column the suffix comes from. The
    reference prunes it, so that the right column loses its suffix, and
    its plan fails to build (a KeyError at optimize time)."""
    def q(pkg):
        return _cross(pkg).groupby("right.name").agg(pkg.col("bal").sum().alias("s"))

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
    d = q(daft_tpu_torch).sort("right.name").to_pydict()
    total = sum(_cross_tables()[0]["bal"].to_pylist())
    assert d["right.name"] == [f"n{i}" for i in range(6)]
    assert d["s"] == pytest.approx([total] * 6, rel=1e-6)  # float32 sums on the card
    with pytest.raises(KeyError, match="right.name"):
        q(daft_tpu).collect()


def test_cross_join_takes_no_keys():
    for pkg in (daft_tpu, daft_tpu_torch):
        a = pkg.from_pydict({"k": [1, 2]})
        with pytest.raises(ValueError, match="cross join takes no keys"):
            a.join(a, on="k", how="cross")
        assert a.join(a, how="cross")._plan.display_tree().splitlines()[0] == "Join: cross"


@pytest.mark.parametrize("how", ["inner", "outer"])
def test_sort_merge_join_x64(how):
    ref, got = check(lambda pkg: _smj(pkg, how, parts=3), x64=True)
    assert counters(got)["aligned_boundary_shuffles"] == 1
    assert _key_sorted(got)


def test_cross_join_x64():
    def build(pkg):
        c = pkg.col
        l = pkg.from_pydict({"a": list(range(30)), "f": [i * 0.5 for i in range(30)]})
        r = pkg.from_pydict({"b": [1, 2, 3]})
        return (l.into_partitions(2).join(r, how="cross").where(c("a") % 3 == c("b"))
                .groupby("b").agg(c("f").sum().alias("s")))

    check(build, x64=True)
