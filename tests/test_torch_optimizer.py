"""The port's logical optimizer (daft_tpu_torch/optimizer.py) held against
daft_tpu's, on the CPU.

Each case builds one query in both packages over the same in-memory data
and compares ``optimize(plan).display_tree()``: the rules of
tests/test_optimizer.py that have an in-memory counterpart (the scan
pushdowns wait for ScanSource, the UDF case for udf), and TPC-H Q1, Q3, Q5
and Q6. Results of the optimized plans are compared with the reference's
where a rule moves work.
"""

import dataclasses

import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import q1 as port_q1, q3 as port_q3, q5 as port_q5, q6 as port_q6
from daft_tpu.optimizer import optimize as ref_optimize
from daft_tpu_torch.optimizer import optimize as port_optimize
from device_mode import real_tpu_mode_cfg


@pytest.fixture(autouse=True)
def _restore_port_config():
    """Each case runs the port on the CPU and gives the next test file in
    this process the config back as it found it."""
    ctx = daft_tpu_torch.context.get_context()
    saved = ctx.execution_config
    daft_tpu_torch.set_execution_config(device="cpu")
    yield
    ctx.execution_config = saved


DATA = {"a": list(range(20)), "b": [i % 5 for i in range(20)],
        "c": [str(i % 3) for i in range(20)]}


def _frame(pkg, data=DATA):
    return pkg.from_pydict(data)


def _join(pkg):
    c = pkg.col
    left = pkg.from_pydict({"k": [1, 2, 3], "x": [10, 20, 30]})
    right = pkg.from_pydict({"k": [1, 2, 3], "y": [30, 40, 50]})
    return left.join(right, on="k").where((c("x") > 5) & (c("y") > 35))


RULES = {
    "filter_crosses_project": lambda pkg: _frame(pkg).select(
        (pkg.col("a") + 1).alias("a1"), "b").where(pkg.col("b") > 2),
    "filter_on_computed_column": lambda pkg: _frame(pkg).select(
        (pkg.col("a") + 1).alias("a1")).where(pkg.col("a1") > 5),
    "filters_merge": lambda pkg: _frame(pkg).where(pkg.col("a") > 1).where(pkg.col("b") > 2),
    "limit_merges": lambda pkg: _frame(pkg).limit(15).limit(10),
    "limit_crosses_project": lambda pkg: _frame(pkg).select(
        (pkg.col("a") * 2).alias("d")).limit(4),
    "drop_repartition": lambda pkg: _frame(pkg).repartition(4, "a").repartition(2, "a"),
    "drop_repartition_into_one": lambda pkg: _frame(pkg).repartition(1, "b"),
    "fold_projections": lambda pkg: _frame(pkg).select(
        (pkg.col("a") + 1).alias("b")).select((pkg.col("b") * 2).alias("c")),
    "column_pruning_into_source": lambda pkg: _frame(pkg).select("a"),
    "column_pruning_through_agg": lambda pkg: _frame(pkg).groupby("b").agg(
        pkg.col("a").sum()),
    "filter_into_join_sides": _join,
    "filter_crosses_sort_and_distinct": lambda pkg: _frame(pkg).sort("a").distinct().where(
        pkg.col("b") == 1),
    "pruning_stops_at_distinct": lambda pkg: _frame(pkg).distinct().select("a"),
    "pruning_through_sort_and_limit": lambda pkg: _frame(pkg).sort("b", desc=True)
    .limit(5).select("a"),
    "string_filter_between_projects": lambda pkg: _frame(pkg).where(
        pkg.col("c") == "1").select("a"),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_optimized_plan_matches_reference(case):
    ref = RULES[case](daft_tpu)
    got = RULES[case](daft_tpu_torch)
    assert port_optimize(got._plan).display_tree() == ref_optimize(ref._plan).display_tree()
    # the optimized plan returns the reference's rows
    assert got.to_pydict() == ref.to_pydict()


def test_rules_do_what_the_reference_tests_check():
    from daft_tpu_torch.logical import Filter, Join, Limit, Project, Repartition

    def find(plan, klass):
        out = [plan] if isinstance(plan, klass) else []
        for c in plan.children():
            out += find(c, klass)
        return out

    opt = port_optimize(RULES["limit_merges"](daft_tpu_torch)._plan)
    assert [lim.limit for lim in find(opt, Limit)] == [10]
    opt = port_optimize(RULES["drop_repartition"](daft_tpu_torch)._plan)
    assert [r.num for r in find(opt, Repartition)] == [2]
    assert not find(port_optimize(RULES["drop_repartition_into_one"](daft_tpu_torch)._plan),
                    Repartition)
    fold = RULES["fold_projections"](daft_tpu_torch)
    assert len(find(port_optimize(fold._plan), Project)) == 1
    assert fold.to_pydict() == {"c": [2 * (i + 1) for i in range(20)]}
    j = find(port_optimize(_join(daft_tpu_torch)._plan), Join)[0]
    assert [f.predicate._node.display() for f in find(j.left, Filter)] == ["(col(x) > lit(5))"]
    assert [f.predicate._node.display() for f in find(j.right, Filter)] == ["(col(y) > lit(35))"]


@pytest.fixture(scope="module")
def tables():
    return tpch.generate_tables(scale=0.01, seed=42)


@pytest.mark.parametrize("query", ["q1", "q6", "q3", "q5"])
def test_tpch_optimized_plan_matches_reference(tables, query):
    ref_q, port_q, args = {
        "q1": (tpch.q1, port_q1, ("lineitem",)),
        "q6": (tpch.q6, port_q6, ("lineitem",)),
        "q3": (tpch.q3, port_q3, ("customer", "orders", "lineitem")),
        "q5": (tpch.q5, port_q5, ("customer", "orders", "lineitem", "nation")),
    }[query]
    ref = ref_q(*[daft_tpu.from_arrow(tables[a]) for a in args])
    got = port_q(*[daft_tpu_torch.from_arrow(tables[a]) for a in args])
    assert port_optimize(got._plan).display_tree() == ref_optimize(ref._plan).display_tree()


def test_q1_q6_still_plan_as_fused_filter_aggregates(tables):
    """The pruning Project under each filter splices out, so Q1 and Q6 keep
    the masked aggregate over the source (K1's and K2's route)."""
    from daft_tpu_torch.physical import FusedFilterAggregateOp, InMemoryOp, translate

    for q in (port_q1, port_q6):
        phys = translate(port_optimize(q(daft_tpu_torch.from_arrow(tables["lineitem"]))._plan))
        agg = phys.children[0] if q is port_q1 else phys
        assert isinstance(agg, FusedFilterAggregateOp), phys.display_tree()
        assert isinstance(agg.children[0], InMemoryOp)


def test_explain_shows_the_three_plans(capsys):
    frame = RULES["filter_crosses_project"]
    ref = frame(daft_tpu).explain(show_all=True)
    got = frame(daft_tpu_torch).explain(show_all=True)
    heads = ("== Unoptimized Logical Plan ==", "== Optimized Logical Plan ==",
             "== Physical Plan ==")
    assert [ln for ln in got.splitlines() if ln in heads] == list(heads)
    # the two logical sections are the reference's, line for line
    cut = got.index("== Physical Plan ==")
    assert got[:cut] == ref[:ref.index("== Physical Plan ==")]


def test_optimizer_prunes_join_sides_on_the_device_route(tables):
    """Q3's optimized join sides run as fused map chains on the card (the
    CPU device route here), with the reference's routing counters."""
    def build(pkg, q):
        args = ("customer", "orders", "lineitem")
        return q(*[pkg.from_arrow(tables[a]).collect() for a in args]).collect()

    with real_tpu_mode_cfg(device_min_rows=64) as cfg:
        ref = build(daft_tpu, tpch.q3)
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = build(daft_tpu_torch, port_q3)
    keys = ("fused_chains", "device_fused_maps", "device_filters", "host_filters",
            "device_projections", "host_projections", "device_join_probes",
            "broadcast_joins", "device_resident_segments")
    gc, rc = got.stats.snapshot()["counters"], ref.stats.snapshot()["counters"]
    assert {k: gc.get(k, 0) for k in keys} == {k: rc.get(k, 0) for k in keys} == {
        "fused_chains": 3, "device_fused_maps": 3, "device_filters": 3, "host_filters": 0,
        "device_projections": 6, "host_projections": 0, "device_join_probes": 2,
        "broadcast_joins": 2, "device_resident_segments": 1}
    assert got.to_pydict() == ref.to_pydict()
