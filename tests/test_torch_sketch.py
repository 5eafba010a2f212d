"""The approximate aggregations of the port (daft_tpu_torch/sketch/, the HLL
and quantile sketches of kernels/sketches.py, K9's register scatter and the
mesh's register merge) held against daft_tpu on the CPU, case by case after
tests/test_sketch_aggs.py.

Every query runs in both packages over the same seeded data: the reference
in its 32-bit device mode (tests/device_mode.py, device_min_rows 8), the
port under that config mapped, device="cpu" (torch_parity.under_both).
Estimates and serialized sketches are held equal byte for byte, and the
routing counters (device_sketch_builds, collective_sketch_merges,
exchange_rows, exchange_bytes) equal. One pinned difference: the port's
K9 resolver takes only execution.DEVICE_FAILURES as a breaker failure
(test_resolver_catches_only_device_failures); the reference's takes any
exception.
"""

import collections

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.sketch import HLL_M, HLL_STANDARD_ERROR, QUANTILE_CAP, SKETCH_STAGE_KINDS
from torch_parity import fresh_ledgers_and_faults, restore_port_config, under_both  # noqa: F401

PKGS = (daft_tpu, daft_tpu_torch)
# the sketch path's counters, held equal in both packages
SKETCH_COUNTERS = ("device_sketch_builds", "device_sketch_fallbacks", "exchange_rows",
                   "exchange_bytes", "exchange_precombined_rows", "shuffles",
                   "host_aggregations", "device_aggregations")


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


def _data(n=20000, card=4000, groups=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"k": (np.arange(n) % groups).tolist(),
            "v": rng.randint(0, card, n).tolist(),
            "x": rng.rand(n).tolist()}


def _frame(pkg, data, parts=8):
    return pkg.from_pydict(data).into_partitions(parts)


def under_x64(fn):
    """``fn(pkg)`` under the reference's own default, the 64-bit mode, with
    its device kernels on (device_min_rows 8), then under the port's config
    mapped from it. The 32-bit mode rounds a float64 column that a device
    projection hands back to float32, so a partition-invariance case over
    float values runs here, as tests/test_sketch_aggs.py runs in that mode."""
    import dataclasses

    from daft_tpu.context import get_context

    cfg = get_context().execution_config
    knobs = dict(use_device_kernels=True, device_min_rows=8, enable_result_cache=False)
    saved = {k: getattr(cfg, k) for k in knobs}
    for k, v in knobs.items():
        setattr(cfg, k, v)
    try:
        ref = fn(daft_tpu)
        d = dataclasses.asdict(cfg)
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)
    d["jax_enable_x64"] = True
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    return ref, fn(daft_tpu_torch)


def _both_collect(build, knobs=None, x64=False):
    """``build(pkg)`` collected in both packages: [(dict, counters)] x 2."""
    def run(pkg):
        q = build(pkg).collect()
        c = q.stats.snapshot()["counters"]
        return q.to_pydict(), {k: c.get(k, 0) for k in SKETCH_COUNTERS}

    return under_x64(run) if x64 else under_both(run, knobs or {})


def _same(build, knobs=None, x64=False):
    """Equal rows (estimates byte for byte) and equal sketch counters;
    returns the port's (dict, counters)."""
    (ref, rc), (got, gc) = _both_collect(build, knobs, x64)
    assert got == ref
    assert gc == rc
    return got, gc


def _physical(pkg, df):
    from importlib import import_module

    opt = import_module(f"{pkg.__name__}.optimizer")
    phys = import_module(f"{pkg.__name__}.physical")
    return phys.translate(opt.optimize(df._plan), pkg.get_context().execution_config
                          if pkg is daft_tpu_torch else
                          import_module("daft_tpu.context").get_context().execution_config)


def _ops(op, name):
    out = [op] if type(op).__name__ == name else []
    for c in op.children:
        out.extend(_ops(c, name))
    return out


def _kinds(agg_op):
    kinds = set()
    for e in agg_op.aggregations:
        n = e._node
        while type(n).__name__ == "Alias":
            n = n.child
        kinds.add(n.kind)
    return kinds


# ---------------------------------------------------------------------------
# plan shape: sketch -> exchange (bytes) -> merge -> estimate
# ---------------------------------------------------------------------------

class TestPlanShape:
    def test_grouped_approx_plans_sketch_merge_stages(self):
        data = _data()

        def shape(pkg):
            df = _frame(pkg, data).groupby("k").agg(
                pkg.col("v").approx_count_distinct().alias("acd"))
            plan = _physical(pkg, df)
            shuffles = _ops(plan, "ShuffleOp")
            child = shuffles[0].children[0]
            merges = [op for op in _ops(plan, "AggregateOp")
                      if "merge_sketch_hll" in _kinds(op)]
            est = any("hll_estimate" in e._node.display()
                      for p in _ops(plan, "ProjectOp") for e in p.exprs)
            return (len(shuffles), type(child).__name__, _kinds(child), len(merges), est,
                    plan.display_tree())

        ref, got = under_both(shape, {})
        assert got[:5] == ref[:5] == (1, "AggregateOp", {"sketch_hll"}, 1, True)
        assert "sketch_hll" in got[5] and "merge_sketch_hll" in got[5]

    def test_global_approx_gathers_sketches_not_rows(self):
        data = _data()

        def shape(pkg):
            plan = _physical(pkg, _frame(pkg, data).agg(
                pkg.col("x").approx_percentiles(0.5).alias("p")))
            gathers = _ops(plan, "GatherOp")
            return (len(gathers), type(gathers[0].children[0]).__name__,
                    _kinds(gathers[0].children[0]), len(_ops(plan, "ShuffleOp")))

        ref, got = under_both(shape, {})
        assert got == ref == (1, "AggregateOp", {"sketch_quantile"}, 0)

    def test_mixed_agg_list_decomposes_in_one_pipeline(self):
        data = _data()

        def build(pkg):
            return _frame(pkg, data).groupby("k").agg(
                pkg.col("v").sum().alias("s"),
                pkg.col("v").approx_count_distinct().alias("acd"))

        got, c = _same(build)
        assert c["shuffles"] == 1  # one exchange: the partials and the sketches together
        sums = collections.defaultdict(int)
        for k, v in zip(data["k"], data["v"]):
            sums[k] += v
        assert dict(zip(got["k"], got["s"])) == dict(sums)

    def test_explain_shows_sketch_stages(self):
        data = _data()

        def text(pkg):
            return _frame(pkg, data).groupby("k").agg(
                pkg.col("v").approx_count_distinct()).explain(show_all=True)

        ref, got = under_both(text, {})
        for t in (ref, got):
            assert "sketch_hll" in t and "merge_sketch_hll" in t and "hll_estimate" in t

    def test_disabled_knob_restores_raw_row_plan(self):
        data = _data()

        def shape(pkg):
            plan = _physical(pkg, _frame(pkg, data).groupby("k").agg(
                pkg.col("v").approx_count_distinct()))
            shuffles = _ops(plan, "ShuffleOp")
            return len(shuffles), type(shuffles[0].children[0]).__name__

        ref, got = under_both(shape, {"sketch_aggregations": False})
        assert got == ref
        assert got[0] == 1 and got[1] != "AggregateOp"

    def test_aggs_decomposable_gate(self):
        from daft_tpu_torch import col
        from daft_tpu_torch.physical import aggs_decomposable

        e = [col("v").approx_count_distinct()]
        assert not aggs_decomposable(e)
        assert aggs_decomposable(e, include_sketch=True)
        assert not aggs_decomposable([col("v").count_distinct()], include_sketch=True)


# ---------------------------------------------------------------------------
# the exchange's payload: sketches, never raw rows
# ---------------------------------------------------------------------------

class TestExchangePayload:
    def test_rows_exchanged_bounded_by_partitions_x_groups(self):
        data = _data()
        _, c = _same(lambda pkg: _frame(pkg, data).groupby("k").agg(
            pkg.col("v").approx_count_distinct()))
        assert c["exchange_rows"] <= 8 * 8
        assert c["exchange_rows"] < 20000 / 100
        assert c["device_sketch_builds"] == 8

    def test_before_after_counter_comparison(self):
        # bench.measure_sketch_exchange's numbers from the port's own counters
        rng = np.random.RandomState(7)
        n = 30000
        data = {"k": (np.arange(n) % 16).tolist(), "v": rng.randint(0, n // 2, n).tolist()}
        out = {}
        for label, flag in (("raw", False), ("sketch", True)):
            _, c = _same(lambda pkg: _frame(pkg, data).groupby("k").agg(
                pkg.col("v").approx_count_distinct()), {"sketch_aggregations": flag})
            out[f"{label}_rows"] = c["exchange_rows"]
            out[f"{label}_bytes"] = c["exchange_bytes"]
        assert out["raw_rows"] == 30000
        assert out["sketch_rows"] <= 8 * 16
        assert out["raw_rows"] / out["sketch_rows"] > 100
        assert out["sketch_bytes"] < out["raw_bytes"]

    def test_high_group_cardinality_stays_sparse(self):
        n = 20000
        got, c = _same(lambda pkg: pkg.from_pydict(
            {"k": list(range(n)), "v": list(range(n))}).into_partitions(4).groupby("k").agg(
                pkg.col("v").approx_count_distinct().alias("a")))
        assert all(a == 1 for a in got["a"])
        assert 0 < c["exchange_bytes"] < n * 256

    def test_sparse_dense_encodings_merge_identically(self):
        from daft_tpu.sketch import hll as ref_hll
        from daft_tpu_torch.sketch import hll

        rng = np.random.RandomState(3)
        arr = pa.array(rng.randint(0, 100000, 30000))
        dense = hll.build_grouped_registers(arr, None, 1)
        assert np.array_equal(dense, ref_hll.build_grouped_registers(arr, None, 1))
        binary = hll.registers_to_binary(dense)
        assert binary.equals(ref_hll.registers_to_binary(dense))
        assert np.array_equal(dense, hll.binary_to_registers(binary))
        small = pa.array([1, 2, 3])
        sregs = hll.build_grouped_registers(small, None, 1)
        sbin = hll.registers_to_binary(sregs)
        assert len(sbin[0].as_py()) < 100
        assert sbin.equals(ref_hll.registers_to_binary(sregs))
        assert np.array_equal(sregs, hll.binary_to_registers(sbin))


# ---------------------------------------------------------------------------
# error bounds
# ---------------------------------------------------------------------------

class TestErrorBounds:
    @pytest.mark.parametrize("card,seed", [(100, 1), (1000, 2), (5000, 3),
                                           (20000, 4), (60000, 5)])
    def test_hll_relative_error_bound(self, card, seed):
        rng = np.random.RandomState(seed)
        vals = rng.randint(0, card * 10, card * 3)
        exact = len(np.unique(vals))
        got, _ = _same(lambda pkg: pkg.from_pydict({"v": vals.tolist()}).into_partitions(7)
                       .agg(pkg.col("v").approx_count_distinct().alias("a")))
        assert abs(got["a"][0] - exact) / exact <= 2 * HLL_STANDARD_ERROR

    @pytest.mark.parametrize("n,seed", [(1000, 1), (50000, 2), (200000, 3)])
    def test_quantile_rank_error_bound(self, n, seed):
        rng = np.random.RandomState(seed)
        vals = np.sort(rng.randn(n) * 100)
        qs = [0.01, 0.25, 0.5, 0.75, 0.99]
        got, _ = _same(lambda pkg: pkg.from_pydict({"x": vals}).into_partitions(6)
                       .agg(pkg.col("x").approx_percentiles(qs).alias("p")))
        for q, est in zip(qs, got["p"][0]):
            rank = np.searchsorted(vals, est) / n
            assert abs(rank - q) <= 8.0 / QUANTILE_CAP, (q, est, rank)

    def test_grouped_bounds_hold_per_group(self):
        data = _data(n=60000, card=8000, groups=4)
        got, _ = _same(lambda pkg: _frame(pkg, data).groupby("k").agg(
            pkg.col("v").approx_count_distinct().alias("a")).sort("k"))
        exact = collections.defaultdict(set)
        for k, v in zip(data["k"], data["v"]):
            exact[k].add(v)
        for k, a in zip(got["k"], got["a"]):
            assert abs(a - len(exact[k])) / len(exact[k]) <= 2 * HLL_STANDARD_ERROR


# ---------------------------------------------------------------------------
# determinism and invariance
# ---------------------------------------------------------------------------

class TestInvariance:
    def test_partition_count_invariant(self):
        data = _data(n=3000, card=900)
        results = []
        for parts in (1, 2, 8):
            got, _ = _same(lambda pkg: _frame(pkg, data, parts).agg(
                pkg.col("v").approx_count_distinct().alias("a"),
                pkg.col("x").approx_percentiles(0.5).alias("p")), x64=True)
            results.append((got["a"][0], got["p"][0]))
        assert results[0] == results[1] == results[2]

    def test_partition_variance_within_rank_bound_when_compressed(self):
        data = _data(n=40000)
        xs = np.sort(np.asarray(data["x"]))
        acd = []
        for parts in (1, 8):
            got, _ = _same(lambda pkg: _frame(pkg, data, parts).agg(
                pkg.col("x").approx_percentiles(0.5).alias("p"),
                pkg.col("v").approx_count_distinct().alias("a")), x64=True)
            assert abs(np.searchsorted(xs, got["p"][0]) / len(xs) - 0.5) <= 8.0 / QUANTILE_CAP
            acd.append(got["a"][0])
        assert acd[0] == acd[1]

    def test_single_partition_grouped_matches_two_phase(self):
        data = _data(n=5000, card=800)
        one, _ = _same(lambda pkg: pkg.from_pydict(data).groupby("k").agg(
            pkg.col("v").approx_count_distinct().alias("a")).sort("k"))
        many, _ = _same(lambda pkg: _frame(pkg, data).groupby("k").agg(
            pkg.col("v").approx_count_distinct().alias("a")).sort("k"))
        assert one == many

    def test_rerun_deterministic(self):
        data = _data(n=30000)

        def twice(pkg):
            df = _frame(pkg, data)
            q = lambda: df.groupby("k").agg(  # noqa: E731
                pkg.col("x").approx_percentiles([0.1, 0.9]).alias("p")).sort("k") \
                .collect().to_pydict()
            return q(), q()

        ref, got = under_both(twice, {})
        assert got[0] == got[1] == ref[0] == ref[1]


# ---------------------------------------------------------------------------
# kernels: serialization and edge cases
# ---------------------------------------------------------------------------

class TestKernels:
    def test_hll_roundtrip_and_merge_associativity(self):
        from daft_tpu.kernels.sketches import HllSketch as RefHll
        from daft_tpu_torch.kernels.sketches import HllSketch

        rng = np.random.RandomState(0)
        h1 = rng.randint(0, 2**63, 1000).astype(np.uint64)
        h2 = rng.randint(0, 2**63, 1000).astype(np.uint64)
        a, b = HllSketch().add_hashes(h1), HllSketch().add_hashes(h2)
        whole = HllSketch().add_hashes(np.concatenate([h1, h2]))
        merged = HllSketch.from_bytes(a.to_bytes()).merge(HllSketch.from_bytes(b.to_bytes()))
        assert np.array_equal(merged.registers, whole.registers)
        assert whole.to_bytes() == RefHll().add_hashes(np.concatenate([h1, h2])).to_bytes()
        assert whole.estimate() == RefHll.from_bytes(whole.to_bytes()).estimate()
        arr = pa.array(rng.randint(0, 5000, 3000))
        assert HllSketch().add_array(arr).to_bytes() == RefHll().add_array(arr).to_bytes()

    def test_quantile_bytes_roundtrip(self):
        from daft_tpu.kernels.sketches import QuantileSketch as RefQ
        from daft_tpu_torch.kernels.sketches import QuantileSketch

        s = QuantileSketch().add(np.arange(100.0))
        r = QuantileSketch.from_bytes(s.to_bytes())
        assert np.array_equal(r.values, s.values) and np.array_equal(r.weights, s.weights)
        assert r.quantiles([0.5])[0] == s.quantiles([0.5])[0]
        big = np.random.RandomState(1).randn(10000)
        assert QuantileSketch().add(big).to_bytes() == RefQ().add(big).to_bytes()

    def test_quantile_compress_deterministic(self):
        from daft_tpu.kernels.sketches import quantile_compress as ref_compress
        from daft_tpu_torch.kernels.sketches import quantile_compress

        v = np.random.RandomState(3).rand(20000)
        w = np.ones(20000)
        a = quantile_compress(v.copy(), w.copy(), 512)
        b = ref_compress(v.copy(), w.copy(), 512)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert len(a[0]) == 512

    def test_empty_and_all_null_inputs(self):
        got, _ = _same(lambda pkg: pkg.from_pydict(
            {"k": [0, 0, 1], "v": [None, None, None], "x": [None, None, None]}
        ).into_partitions(2).groupby("k").agg(
            pkg.col("v").approx_count_distinct().alias("a"),
            pkg.col("x").cast(pkg.DataType.float64()).approx_percentiles(0.5).alias("p")
        ).sort("k"))
        assert got["a"] == [0, 0]
        assert got["p"] == [None, None]

    def test_binary_sketch_dtype_on_stage_schema(self):
        for pkg in PKGS:
            from importlib import import_module

            ex = import_module(f"{pkg.__name__}.expressions")
            for kind in ("sketch_hll", "sketch_quantile"):
                e = ex.Expression(ex.AggExpr(kind, pkg.col("v")._node))
                f = e._node.to_field(pkg.from_pydict({"v": [1]}).schema)
                assert f.dtype == pkg.DataType.binary()

    def test_corrupt_sketch_raises_typed_error(self):
        from daft_tpu_torch.errors import DaftValueError
        from daft_tpu_torch.kernels.sketches import estimate_from_registers
        from daft_tpu_torch.sketch.hll import binary_to_registers

        with pytest.raises(DaftValueError, match="max rank"):
            estimate_from_registers(np.full((1, HLL_M), 200, dtype=np.uint8))
        with pytest.raises(DaftValueError, match="bad payload length"):
            binary_to_registers(daft_tpu_torch.Series.from_pylist(
                [b"xx"], "s", daft_tpu_torch.DataType.binary()))

    def test_saturated_sketch_finite_ceiling(self):
        from daft_tpu.kernels.sketches import estimate_from_registers as ref_est
        from daft_tpu_torch.kernels.sketches import estimate_from_registers

        sat = np.full((1, HLL_M), 51, dtype=np.uint8)
        assert estimate_from_registers(sat)[0] == ref_est(sat)[0] == 1 << 63
        rng = np.random.RandomState(5)
        regs = rng.randint(0, 30, (6, HLL_M)).astype(np.uint8)
        regs[0] = 0
        assert np.array_equal(estimate_from_registers(regs), ref_est(regs))

    def test_quantile_merge_preserves_custom_cap(self):
        from daft_tpu.sketch import quantile as ref_q
        from daft_tpu_torch.kernels.sketches import (quantile_state_from_bytes,
                                                     quantile_state_to_bytes)
        from daft_tpu_torch.sketch import quantile as q

        v = np.random.RandomState(0).rand(20000)
        sk = quantile_state_to_bytes(v, np.ones(len(v)), 16384)
        merged = q.merge_grouped(daft_tpu_torch.Series.from_pylist(
            [sk, sk], "s", daft_tpu_torch.DataType.binary()), np.zeros(2, np.int64), 1)
        ref = ref_q.merge_grouped(daft_tpu.Series.from_pylist(
            [sk, sk], "s", daft_tpu.DataType.binary()), np.zeros(2, np.int64), 1)
        mv, _, cap = quantile_state_from_bytes(merged.to_pylist()[0])
        assert cap == 16384 and len(mv) <= 16384
        assert merged.to_pylist() == ref.to_pylist()

    def test_stage_kind_registry(self):
        from daft_tpu.sketch import SKETCH_STAGE_KINDS as REF_KINDS

        assert SKETCH_STAGE_KINDS == REF_KINDS == {
            "sketch_hll", "sketch_quantile", "merge_sketch_hll", "merge_sketch_quantile"}
        assert HLL_M == 1 << 14


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

def _faults(pkg):
    from importlib import import_module

    return import_module(f"{pkg.__name__}.faults")


class TestFaultSites:
    def test_sites_registered(self):
        for pkg in PKGS:
            assert {"sketch.merge", "collective.sketch"} <= set(_faults(pkg).SITES)

    def test_sketch_merge_fault_fires_and_propagates(self):
        data = _data(n=2000)

        def run(pkg):
            q = _frame(pkg, data, 4).groupby("k").agg(pkg.col("v").approx_count_distinct())
            with _faults(pkg).inject("sketch.merge", "always"):
                with pytest.raises(pkg.errors.DaftTransientError):
                    q.collect()
            snap = _faults(pkg).snapshot()
            return snap["armed"], snap["injected"]["sketch.merge"] >= 1

        ref, got = under_both(run, {})
        assert got == ref == ({}, True)

    def test_sketch_merge_heals_after_first_n(self):
        data = _data(n=2000)

        def run(pkg):
            with _faults(pkg).inject("sketch.merge", "first_n", n=1):
                q = _frame(pkg, data, 4).groupby("k").agg(
                    pkg.col("v").approx_count_distinct().alias("a")).sort("k")
                with pytest.raises(pkg.errors.DaftTransientError):
                    q.collect()
                out = _frame(pkg, data, 4).groupby("k").agg(
                    pkg.col("v").approx_count_distinct().alias("a")).sort("k") \
                    .collect().to_pydict()
                return out, _faults(pkg).snapshot()["injected"]["sketch.merge"]

        ref, got = under_both(run, {})
        assert got == ref
        assert len(got[0]["a"]) == 8 and got[1] == 1

    def test_failed_merge_releases_the_ledger_where_the_reference_keeps_it(self):
        # pinned difference: a fold of the exchange's combiner that fails at
        # sketch.merge hands its staged pieces' charge back in the port; the
        # reference's combiner keeps it in the process-wide ledger
        from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
        from daft_tpu_torch.spill import MEMORY_LEDGER

        data = _data(n=2000)

        def run(pkg):
            with _faults(pkg).inject("sketch.merge", "always"):
                with pytest.raises(pkg.errors.DaftTransientError):
                    _frame(pkg, data, 8).groupby("k").agg(
                        pkg.col("v").approx_count_distinct()).collect()
            return (REF_LEDGER if pkg is daft_tpu else MEMORY_LEDGER).current

        ref, got = under_both(run, {})
        assert ref > 0 and got == 0

    def test_collective_sketch_fault_falls_back_to_host(self):
        data = _data(n=4000, card=500)

        def run(pkg):
            with _faults(pkg).inject("collective.sketch", "always"):
                parts, c = _mesh_run(pkg, _frame(pkg, data, 4).agg(
                    pkg.col("v").approx_count_distinct().alias("a")))
            return (parts[0].to_pydict()["a"][0], c.get("collective_sketch_merges", 0),
                    _faults(pkg).snapshot()["injected"]["collective.sketch"] >= 1)

        ref, got = under_both(run, {})
        want = under_both(lambda pkg: pkg.from_pydict(data).agg(
            pkg.col("v").approx_count_distinct().alias("a")).collect().to_pydict()["a"][0], {})
        assert got == ref == (want[0], 0, True)
        assert want[0] == want[1]


# ---------------------------------------------------------------------------
# device paths: the mesh's register merge and K9 behind the breaker
# ---------------------------------------------------------------------------

def _mesh_run(pkg, df):
    """``df``'s plan through a MeshExecutionContext on default_mesh(8):
    (partitions, counters)."""
    from importlib import import_module

    par = import_module(f"{pkg.__name__}.parallel")
    ex = import_module(f"{pkg.__name__}.execution")
    if pkg is daft_tpu:
        cfg = import_module("daft_tpu.context").get_context().execution_config
    else:
        cfg = pkg.get_context().execution_config
    ctx = par.MeshExecutionContext(cfg, mesh=par.default_mesh(8))
    plan = _physical(pkg, df)
    if pkg is daft_tpu:
        parts = list(ex.execute_plan(plan, ctx, trace=False))
    else:
        parts = list(ex.execute_plan(plan, ctx))
    return parts, dict(ctx.stats.counters)


class TestDevicePaths:
    def test_mesh_collective_register_merge(self):
        data = _data(n=4000, card=700)

        def run(pkg):
            parts, c = _mesh_run(pkg, _frame(pkg, data, 4).agg(
                pkg.col("v").approx_count_distinct().alias("a")))
            return (parts[0].to_pydict()["a"][0], c.get("collective_sketch_merges", 0),
                    c.get("device_sketch_builds", 0))

        ref, got = under_both(run, {})
        want = under_both(lambda pkg: pkg.from_pydict(data).agg(
            pkg.col("v").approx_count_distinct().alias("a")).collect().to_pydict()["a"][0], {})
        assert got == ref == (want[1], 1, 4)

    def test_register_allmerge_collective_matches_numpy(self):
        from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh

        daft_tpu_torch.set_execution_config(device="cpu")
        ctx = MeshExecutionContext(daft_tpu_torch.get_context().execution_config,
                                   mesh=default_mesh(8))
        rng = np.random.RandomState(0)
        for k in (5, 8, 19):  # fewer rows than slots, as many, more (folded first)
            regs = rng.randint(0, 30, (k, HLL_M)).astype(np.uint8)
            out = ctx.try_sketch_register_merge(regs)
            assert out is not None and np.array_equal(out, regs.max(axis=0))
        assert ctx.stats.counters["collective_sketch_merges"] == 3

    def test_device_register_scatter_matches_host(self):
        from daft_tpu.sketch.device import hll_scatter_device as ref_scatter
        from daft_tpu_torch.sketch import device as k9
        from daft_tpu_torch.sketch.hll import build_grouped_registers, scatter_operands

        rng = np.random.RandomState(1)
        arr = pa.array(rng.randint(0, 1000, 5000))
        codes = rng.randint(0, 4, 5000).astype(np.int64)
        host = build_grouped_registers(arr, codes, 4)
        gcodes, idx, rank = scatter_operands(arr, codes)
        before = k9.LAUNCHES
        dev = k9.hll_scatter_device_launch(gcodes, idx, rank, 4, "cpu")()
        assert np.array_equal(host, dev)
        assert np.array_equal(dev, ref_scatter(gcodes, idx, rank, 4))
        assert k9.LAUNCHES == before  # the CPU runs the plain version: no launch
        # past the slot ceiling the device path declines
        assert k9.hll_scatter_device_launch(gcodes, idx, rank,
                                            k9.MAX_DEVICE_REGISTERS // HLL_M + 1, "cpu") is None

    def test_sketch_build_device_route_with_breaker_fallback(self):
        from daft_tpu_torch.expressions import AggExpr, Expression
        from daft_tpu_torch.execution import ExecutionContext
        from daft_tpu_torch.micropartition import MicroPartition

        daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
        cfg = daft_tpu_torch.get_context().execution_config
        part = MicroPartition.from_pydict({"v": list(range(2000)) * 2})
        aggs = [Expression(AggExpr("sketch_hll", daft_tpu_torch.col("v")._node)).alias("s")]
        ctx = ExecutionContext(cfg)
        out = ctx.eval_agg(part, aggs, None)
        assert ctx.stats.counters.get("device_sketch_builds") == 1
        ctx2 = ExecutionContext(cfg)
        with daft_tpu_torch.faults.inject("device.kernel", "always"):
            out2 = ctx2.eval_agg(part, aggs, None)
        assert not ctx2.stats.counters.get("device_sketch_builds")
        assert out.to_pydict() == out2.to_pydict()
        # the reference's sketch of the same partition, byte for byte
        from daft_tpu.sketch import hll as ref_hll

        want = ref_hll.build_grouped(daft_tpu.Series.from_pylist(list(range(2000)) * 2, "v"),
                                     None, 1)
        assert out.to_pydict()["s"] == want.to_pylist()

    def test_resolver_catches_only_device_failures(self, monkeypatch):
        # pinned difference: the reference's resolver takes any exception as
        # a breaker failure; the port's only DEVICE_FAILURES, so a defect
        # reaches the caller
        from daft_tpu_torch.errors import DaftStagingError
        from daft_tpu_torch.expressions import AggExpr, Expression
        from daft_tpu_torch.execution import ExecutionContext
        from daft_tpu_torch.micropartition import MicroPartition
        from daft_tpu_torch.sketch import device as k9

        daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
        cfg = daft_tpu_torch.get_context().execution_config
        part = MicroPartition.from_pydict({"v": list(range(300))})
        aggs = [Expression(AggExpr("sketch_hll", daft_tpu_torch.col("v")._node)).alias("s")]
        want = ExecutionContext(cfg).eval_agg(part, aggs, None).to_pydict()
        real = k9.hll_scatter_device_launch

        def failing(exc):
            def launch(*a, **k):
                real(*a, **k)

                def resolve():
                    raise exc
                return resolve
            return launch

        monkeypatch.setattr(k9, "hll_scatter_device_launch", failing(DaftStagingError("x")))
        ctx = ExecutionContext(cfg)
        assert ctx.eval_agg(part, aggs, None).to_pydict() == want
        c = ctx.stats.counters
        assert (c.get("device_sketch_builds", 0), c["device_sketch_fallbacks"],
                c["device_attempt_failures"]) == (0, 1, 1)
        monkeypatch.setattr(k9, "hll_scatter_device_launch", failing(RuntimeError("defect")))
        with pytest.raises(RuntimeError, match="defect"):
            ExecutionContext(cfg).eval_agg(part, aggs, None)


# ---------------------------------------------------------------------------
# observability: the throughput of the new stages
# ---------------------------------------------------------------------------

class TestThroughputStats:
    def test_op_throughput_populated(self):
        data = _data(n=10000)
        daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
        q = _frame(daft_tpu_torch, data).groupby("k").agg(
            daft_tpu_torch.col("v").approx_count_distinct())
        q.collect()
        agg = next((v for k, v in q.stats.op_throughput().items() if "Aggregate" in k), None)
        assert agg is not None and agg["rows_per_sec"] > 0
        assert "op_bytes" in q.stats.snapshot()

    def test_explain_analyze_renders_throughput_columns(self):
        data = _data(n=5000)
        daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
        text = _frame(daft_tpu_torch, data).groupby("k").agg(
            daft_tpu_torch.col("v").approx_count_distinct()).explain_analyze()
        assert "rows/s" in text and "MB/s" in text


def test_sql_approx_count_distinct_matches_reference():
    data = _data(n=6000, card=1500)

    def run(pkg):
        df = _frame(pkg, data, 4)
        return pkg.sql("SELECT k, APPROX_COUNT_DISTINCT(v) AS a FROM df GROUP BY k "
                       "ORDER BY k", df=df).collect().to_pydict()

    ref, got = under_both(run, {})
    assert got == ref
    assert len(got["a"]) == 8
