"""Python UDFs in the port (daft_tpu_torch/udf.py, actor_pool.py, the
admission of execution.py, the UDF pinning of fuse/graph.py, the UDF
refusals of the plan cache and the sub-plan result cache, and
GroupedDataFrame.map_groups), held against daft_tpu on the CPU.

- ``run_udf``: batch sizes, class UDFs and literal arguments, called
  through both packages' trampolines on the same columns.
- tests/test_actor_pool.py's cases and tests/test_admission.py's UDF cases
  in both packages. One difference is pinned: the port runs a map op's
  partitions one at a time (its pooled fan-out comes with scheduler.py,
  ROADMAP Queue 1 item 7), so a task's resource request is checked once
  against the host and the partitions run with at most one in flight,
  where the reference's worker pool admits two at once
  (``test_cpu_request_limits_task_concurrency``).
- tests/test_fuse.py's TestUdfBarriers in both packages (one call per
  partition, never merged, never moved across a filter; a resource request
  declines fusion), and a pinned UDF whose column feeds an aggregate on the
  card in the 32-bit mode, with rows, routing counters and calls equal.
- The plan cache, the whole-plan result cache and the sub-plan result cache
  refuse a plan with a UDF in both packages.
- ``map_groups`` and ``Expression.apply`` give the reference's rows.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import UDF_Q1_ROUTES, q1_udf
from torch_parity import check, clear_adapt, restore_port_config  # noqa: F401


@pytest.fixture(autouse=True)
def _pools_down():
    """Both packages' actor pools and pinned models torn down around a case."""
    from daft_tpu.actor_pool import shutdown_all as ref_shutdown
    from daft_tpu_torch.actor_pool import shutdown_all

    ref_shutdown()
    shutdown_all()
    daft_tpu_torch.set_execution_config(device="cpu")
    yield
    ref_shutdown()
    shutdown_all()


def both(fn):
    """``fn(pkg)`` in both packages (the port on the CPU): (reference, port)."""
    return fn(daft_tpu), fn(daft_tpu_torch)


# ---------------------------------------------------------------------------
# run_udf
# ---------------------------------------------------------------------------

class Scaler:
    inits = {"n": 0}

    def __init__(self, k=2):
        Scaler.inits["n"] += 1
        self.k = k

    def __call__(self, s, bias):
        # a literal argument arrives as a column broadcast to the batch
        return [v * self.k + b for v, b in zip(s.to_pylist(), bias.to_pylist())]


@pytest.mark.parametrize("batch_size", [None, 1, 3, 7, 100])
def test_run_udf_batches_as_the_reference(batch_size):
    seen = {}

    def fn_for(pkg):
        calls = seen.setdefault(pkg.__name__, [])

        def plus(s, k):
            calls.append((len(s), len(k)))
            return np.asarray(s.to_pylist(), dtype=np.int64) + np.asarray(k.to_pylist())

        return plus

    def run(pkg):
        from importlib import import_module

        udf = import_module(f"{pkg.__name__}.udf")
        s = pkg.Series.from_pylist(list(range(10)), "x")
        k = pkg.Series.from_pylist([5], "k")  # a literal argument: broadcast
        out = udf.run_udf(fn_for(pkg), [s, k], pkg.DataType.int64(), 10, batch_size)
        return out.name, out.to_pylist()

    ref, got = both(run)
    assert got == ref == ("x", [v + 5 for v in range(10)])
    assert seen["daft_tpu_torch"] == seen["daft_tpu"]


def test_class_udf_and_literal_args_as_the_reference():
    def run(pkg):
        Scaler.inits["n"] = 0
        u = pkg.udf(return_dtype=pkg.DataType.int64())(Scaler).with_init_args(k=3)
        df = pkg.from_pydict({"x": [1, 2, 3, 4]}).into_partitions(2)
        out = df.select(u(pkg.col("x"), 10).alias("y")).to_pydict()
        return out, Scaler.inits["n"]

    ref, got = both(run)
    assert got == ref == ({"y": [13, 16, 19, 22]}, 1)


@pytest.mark.parametrize("parts", [1, 3])
def test_udf_end_to_end_as_the_reference(parts):
    """tests/test_dataframe.py::test_udf_end_to_end, and Expression.apply."""
    def run(pkg):
        @pkg.udf(return_dtype=pkg.DataType.int64())
        def double(s):
            return np.asarray(s.to_pylist()) * 2

        df = pkg.from_pydict({"a": [1, 2, 3]}).into_partitions(parts)
        out = df.select(double(pkg.col("a")).alias("d"),
                        pkg.col("a").apply(lambda v: v * 10, pkg.DataType.int64()).alias("t"))
        return out.to_pydict()

    ref, got = both(run)
    assert got == ref == {"d": [2, 4, 6], "t": [10, 20, 30]}


def test_udf_errors_as_the_reference():
    def run(pkg):
        @pkg.udf(return_dtype=pkg.DataType.int64())
        def short(s):
            return [1]

        with pytest.raises(ValueError) as ei:
            pkg.from_pydict({"a": [1, 2, 3]}).select(short(pkg.col("a"))).collect()
        return str(ei.value)

    ref, got = both(run)
    assert got == ref == "UDF returned 1 rows, expected 3"


def test_map_groups_as_the_reference():
    """tests/test_dataframe.py::test_map_groups."""
    def run(pkg):
        @pkg.udf(return_dtype=pkg.DataType.float64())
        def demean(s):
            v = np.asarray(s.to_pylist())
            return v - v.mean()

        df = pkg.from_pydict({"k": ["a", "a", "b"], "v": [1.0, 3.0, 5.0]})
        return (df.groupby("k").map_groups(demean(pkg.col("v")).alias("d"))
                .sort(["k", "d"]).to_pydict())

    ref, got = both(run)
    assert got == ref == {"k": ["a", "a", "b"], "d": [-1.0, 1.0, 0.0]}


def test_udf_projection_not_moved_as_the_reference():
    """tests/test_optimizer.py::test_udf_projection_not_folded: the filter on
    a UDF's output stays above the projection, in equal optimized trees."""
    from daft_tpu.optimizer import optimize as ref_optimize
    from daft_tpu_torch.optimizer import optimize as port_optimize

    def build(pkg):
        @pkg.udf(return_dtype=pkg.DataType.int64())
        def plus1(s):
            return np.asarray(s.to_pylist()) + 1

        return pkg.from_pydict({"a": [1, 2, 3]}).select(plus1(pkg.col("a")).alias("b")).where(
            pkg.col("b") > 2)

    ref, got = both(build)
    assert (port_optimize(got._plan).display_tree()
            == ref_optimize(ref._plan).display_tree())
    assert got.to_pydict() == ref.to_pydict() == {"b": [3, 4]}


# ---------------------------------------------------------------------------
# actor pools: tests/test_actor_pool.py
# ---------------------------------------------------------------------------

_init = {"n": 0}
_init_lock = threading.Lock()


class Doubler:
    def __init__(self, bias=0):
        with _init_lock:
            _init["n"] += 1
        self.bias = bias

    def __call__(self, s):
        return [v * 2 + self.bias for v in s.to_pylist()]


def _pool_case(name, pkg):
    from importlib import import_module

    pools = import_module(f"{pkg.__name__}.actor_pool")._pools
    _init["n"] = 0
    u = pkg.udf(return_dtype=pkg.DataType.int64())(Doubler)
    col = pkg.col
    if name == "one_instance_per_worker_and_order":
        out = pkg.from_pydict({"x": list(range(100))}).select(
            u.with_concurrency(3)(col("x")).alias("y")).to_pydict()
        return out["y"], _init["n"]
    if name == "pool_reused_across_queries":
        df = pkg.from_pydict({"x": [1, 2, 3, 4]})
        df.select(u.with_concurrency(2)(col("x")).alias("y")).to_pydict()
        first = _init["n"]
        df.select(u.with_concurrency(2)(col("x")).alias("y")).to_pydict()
        return first, _init["n"]
    if name == "init_args_separate_pools":
        df = pkg.from_pydict({"x": [1, 2]})
        o1 = df.select(u.with_init_args(bias=100).with_concurrency(2)(col("x")).alias("y"))
        o2 = df.select(u.with_init_args(bias=200).with_concurrency(2)(col("x")).alias("y"))
        return o1.to_pydict()["y"], o2.to_pydict()["y"], len(pools)
    if name == "stateful_without_concurrency_single_instance":
        out = pkg.from_pydict({"x": [5, 6]}).select(u(col("x")).alias("y")).to_pydict()
        return out["y"], _init["n"]
    raise AssertionError(name)


POOL_WANT = {"one_instance_per_worker_and_order": ([v * 2 for v in range(100)], 3),
             "pool_reused_across_queries": (2, 2),
             "init_args_separate_pools": ([102, 104], [202, 204], 2),
             "stateful_without_concurrency_single_instance": ([10, 12], 1)}


@pytest.mark.parametrize("name", sorted(POOL_WANT))
def test_actor_pool_as_the_reference(name):
    from daft_tpu.udf import _STATEFUL_INSTANCES as ref_instances
    from daft_tpu_torch.udf import _STATEFUL_INSTANCES

    ref_instances.clear()
    _STATEFUL_INSTANCES.clear()
    ref, got = both(lambda pkg: _pool_case(name, pkg))
    assert got == ref == POOL_WANT[name]


@pytest.mark.parametrize("kind", ["call", "init"])
def test_actor_pool_errors_as_the_reference(kind):
    class Boom:
        def __call__(self, s):
            raise RuntimeError("actor failed")

    class BadInit:
        def __init__(self):
            raise ValueError("no weights file")

        def __call__(self, s):
            return s

    cls, err = (Boom, RuntimeError) if kind == "call" else (BadInit, ValueError)

    def run(pkg):
        u = pkg.udf(return_dtype=pkg.DataType.int64())(cls).with_concurrency(2)
        with pytest.raises(err) as ei:
            pkg.from_pydict({"x": [1, 2, 3]}).select(u(pkg.col("x")).alias("y")).to_pydict()
        return str(ei.value)

    ref, got = both(run)
    assert got == ref


def test_shutdown_all_tears_every_pool_down():
    from daft_tpu_torch import actor_pool

    u = daft_tpu_torch.udf(return_dtype=daft_tpu_torch.DataType.int64())(Doubler)
    daft_tpu_torch.from_pydict({"x": [1]}).select(
        u.with_concurrency(2)(daft_tpu_torch.col("x"))).to_pydict()
    assert actor_pool.pool_count() == 1
    names = {t.name for t in threading.enumerate() if t.name.startswith("daft-actor-Doubler")}
    assert len(names) == 2
    actor_pool.shutdown_all()
    assert actor_pool.pool_count() == 0
    assert not [t for t in threading.enumerate() if t.name in names and t.is_alive()]
    assert actor_pool.leaked_thread_count() == 0


# ---------------------------------------------------------------------------
# admission: tests/test_admission.py
# ---------------------------------------------------------------------------

def _accountant_cycle(pkg):
    """The accountant's check: requests that fit pass, and each that can
    never fit raises the same error as the reference's."""
    from importlib import import_module

    ex = import_module(f"{pkg.__name__}.execution")
    acc = ex.ResourceAccountant(cpus=4.0, gpus=1.0, memory_bytes=1000)
    for req in (ex.ResourceRequest(num_cpus=4.0), ex.ResourceRequest(num_gpus=1.0),
                ex.ResourceRequest(memory_bytes=1000)):
        acc.check(req)
    errors = []
    for req in (ex.ResourceRequest(num_cpus=5.0), ex.ResourceRequest(num_gpus=2.0),
                ex.ResourceRequest(memory_bytes=2000)):
        with pytest.raises(RuntimeError) as ei:
            acc.check(req)
        errors.append(str(ei.value))
    return errors


def test_accountant_as_the_reference():
    ref, got = both(_accountant_cycle)
    assert got == ref
    assert len(got) == 3


def _requests(pkg):
    """tests/test_admission.py TestRequestExtraction: the requests the
    physical ops carry."""
    from importlib import import_module

    ex = import_module(f"{pkg.__name__}.execution")
    opt = import_module(f"{pkg.__name__}.optimizer").optimize
    phys = import_module(f"{pkg.__name__}.physical")

    @pkg.udf(return_dtype=pkg.DataType.int64(), num_cpus=2, memory_bytes=123)
    def f(x):
        return x

    @pkg.udf(return_dtype=pkg.DataType.int64(), num_cpus=1)
    def g(x):
        return x

    @pkg.udf(return_dtype=pkg.DataType.int64(), memory_bytes=50)
    def h(x):
        return x

    cfg = pkg.get_context().execution_config
    out = []
    for df in (pkg.from_pydict({"x": [1, 2, 3]}).select(f(pkg.col("x"))),
               pkg.from_pydict({"x": [1]}).select(g(pkg.col("x")).alias("a"),
                                                  h(pkg.col("x")).alias("b"))):
        reqs = []

        def walk(op):
            reqs.append(ex.op_resource_request(op))
            for c in op.children:
                walk(c)

        walk(phys.translate(opt(df._plan), cfg))
        top = max(reqs, key=lambda r: (r.num_cpus, r.memory_bytes))
        out.append((top.num_cpus, top.num_gpus, top.memory_bytes))
    return out


def test_requests_reach_the_op_as_the_reference():
    ref, got = both(_requests)
    assert got == ref == [(2, 0, 123), (1, 0, 50)]


@pytest.mark.parametrize("case", ["cpus", "accelerator", "memory"])
def test_impossible_requests_raise_as_the_reference(case):
    """A request that can never fit raises before any partition runs. On
    the CPU host the reference counts no non-CPU jax device, and the port
    no card (its config asks for the CPU)."""
    def run(pkg):
        kw = {"cpus": {"num_cpus": 10_000}, "accelerator": {"num_gpus": 1},
              "memory": {"memory_bytes": 10 * 1024}}[case]

        @pkg.udf(return_dtype=pkg.DataType.int64(), **kw)
        def f(x):
            return x

        cfg = pkg.get_context().execution_config
        old = cfg.memory_budget_bytes
        cfg.memory_budget_bytes = 1024
        try:
            with pytest.raises(RuntimeError) as ei:
                pkg.from_pydict({"x": [1, 2]}).select(f(pkg.col("x"))).collect()
        finally:
            cfg.memory_budget_bytes = old
        return type(ei.value).__name__, str(ei.value).split(" but ")[0]

    ref, got = both(run)
    assert got == ref


def test_satisfiable_request_runs_as_the_reference():
    def run(pkg):
        @pkg.udf(return_dtype=pkg.DataType.int64(), num_cpus=1, memory_bytes=1024)
        def double(x):
            import pyarrow.compute as pc

            return pc.multiply(x.to_arrow(), 2)

        return pkg.from_pydict({"x": [1, 2, 3]}).select(double(pkg.col("x"))).to_pydict()

    ref, got = both(run)
    assert got == ref == {"x": [2, 4, 6]}


def test_cpu_request_admits_two_partitions_at_once(monkeypatch):
    """tests/test_admission.py::test_cpu_request_limits_task_concurrency in
    both packages: on 4 workers the op's partitions fan out to the pool, and
    a request of half the accountant's CPUs is admitted (each admission
    checks it; nothing checks it apart) for two of the 20 partitions at
    once, never more. The first call waits until the second admission is in (an
    event, not a duration), so the peak of 2 does not depend on timing."""
    import os

    def run(pkg):
        ex = pkg.execution
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
        per_task = float(max(cores, 4)) / 2
        lock = threading.Lock()
        checks, admits, inflight, peak = [0], [0], [0], [0]
        two_in = threading.Event()
        orig_check, orig_admit, orig_release = (ex.ResourceAccountant.check,
                                                ex.ResourceAccountant.admit,
                                                ex.ResourceAccountant.release)

        def check(self, req):
            with lock:
                checks[0] += 1
            orig_check(self, req)

        def admit(self, req):
            orig_admit(self, req)
            with lock:
                admits[0] += 1
                inflight[0] += 1
                peak[0] = max(peak[0], inflight[0])
                if inflight[0] == 2:
                    two_in.set()

        def release(self, req):
            with lock:
                inflight[0] -= 1
            orig_release(self, req)

        monkeypatch.setattr(ex.ResourceAccountant, "check", check)
        monkeypatch.setattr(ex.ResourceAccountant, "admit", admit)
        monkeypatch.setattr(ex.ResourceAccountant, "release", release)

        @pkg.udf(return_dtype=pkg.DataType.int64(), num_cpus=per_task, concurrency=4)
        class Track:
            def __call__(self, x):
                assert two_in.wait(30), "never two partitions admitted at once"
                return x

        cfg = pkg.get_context().execution_config
        old = cfg.executor_threads
        cfg.executor_threads = 4
        try:
            df = (pkg.from_pydict({"x": list(range(200))}).repartition(20)
                  .select(Track(pkg.col("x"))))
            got = sorted(df.to_pydict()["x"])
        finally:
            cfg.executor_threads = old
        return got, admits[0], peak[0], checks[0] - admits[0]

    ref, got = both(run)
    assert ref == got == (list(range(200)), 20, 2, 0)


def test_card_request_on_the_card_config_is_admitted(monkeypatch):
    """A ``num_gpus=1`` request fits where the config runs on the card and
    torch counts one; two do not (``_accelerator_count``)."""
    from daft_tpu_torch import execution
    from daft_tpu_torch.errors import DaftResourceError

    monkeypatch.setattr(execution.torch.cuda, "device_count", lambda: 1)
    cfg = daft_tpu_torch.ExecutionConfig(device="cuda", use_device_kernels=False)
    assert execution._accelerator_count(cfg) == 1
    assert execution._accelerator_count(daft_tpu_torch.ExecutionConfig(device="cpu")) == 0
    ctx = execution.ExecutionContext(cfg)
    ctx.accountant.check(execution.ResourceRequest(num_gpus=1))
    with pytest.raises(DaftResourceError, match="accelerator"):
        ctx.accountant.check(execution.ResourceRequest(num_gpus=2))


# ---------------------------------------------------------------------------
# fusion pins: tests/test_fuse.py TestUdfBarriers
# ---------------------------------------------------------------------------

def _tracked(pkg, calls, op):
    @pkg.udf(return_dtype=pkg.DataType.int64())
    def track(s):
        vals = s.to_pylist()
        calls.append(len(vals))
        return [op(v) for v in vals]

    return track


def _barrier_case(name, pkg, fusion: bool):
    from importlib import import_module

    cfg = pkg.get_context().execution_config
    saved = (cfg.expr_fusion, cfg.enable_result_cache)
    cfg.expr_fusion, cfg.enable_result_cache = fusion, False
    col = pkg.col
    calls = []
    try:
        if name == "evaluated_once_under_cse":
            t = _tracked(pkg, calls, lambda v: v * 10)
            q = (pkg.from_pydict({"v": list(range(16))})
                 .select(t(col("v")).alias("e"), col("v"))
                 .select((col("e") + 1).alias("a"), (col("e") * 2).alias("b"), col("v")))
        elif name == "not_reordered_across_filter":
            t = _tracked(pkg, calls, lambda v: v * 10)
            q = (pkg.from_pydict({"v": list(range(16))})
                 .select(t(col("v")).alias("e"), col("v"))
                 .where(col("e") > 50).select((col("e") + col("v")).alias("s")))
        elif name == "distinct_call_sites_not_merged":
            t = _tracked(pkg, calls, lambda v: v + 1)
            q = (pkg.from_pydict({"v": list(range(8))})
                 .select(t(col("v")).alias("e1"), col("v"))
                 .select(col("e1"), t(col("v")).alias("e2")))
        else:
            @pkg.udf(return_dtype=pkg.DataType.int64(), num_cpus=1)
            def f(s):
                return list(s.to_pylist())

            q = (pkg.from_pydict({"v": [1, 2, 3]}).select(f(col("v")).alias("e"), col("v"))
                 .select((col("e") + col("v")).alias("s")))
        opt = import_module(f"{pkg.__name__}.optimizer").optimize
        phys = import_module(f"{pkg.__name__}.physical").translate(opt(q._plan), cfg)

        def fused(op):
            return (type(op).__name__ == "FusedMapOp") + sum(fused(c) for c in op.children)

        return q.to_pydict(), calls, fused(phys)
    finally:
        cfg.expr_fusion, cfg.enable_result_cache = saved


@pytest.mark.parametrize("name", ["evaluated_once_under_cse", "not_reordered_across_filter",
                                  "distinct_call_sites_not_merged",
                                  "resource_request_declines_fusion"])
def test_udf_barrier_as_the_reference(name):
    for fusion in (True, False):
        ref, got = both(lambda pkg: _barrier_case(name, pkg, fusion))
        assert got == ref
    assert got[1] == {"evaluated_once_under_cse": [16], "not_reordered_across_filter": [16],
                      "distinct_call_sites_not_merged": [8, 8],
                      "resource_request_declines_fusion": []}[name]


@pytest.mark.parametrize("parts", [1, 3])
def test_pinned_udf_feeds_a_device_aggregate(parts):
    """A fused chain with a pinned UDF runs its UDF once per partition on the
    host (no device program), and the aggregate above takes its column on
    the card: the reference's rows and routing, and the same calls."""
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(0, 4, 600).tolist(), "v": rng.random(600).tolist(),
            "d": rng.random(600).tolist()}
    calls = {}

    def build(pkg):
        seen = calls.setdefault(pkg.__name__, [])

        @pkg.udf(return_dtype=pkg.DataType.float64())
        def disc(v, d):
            seen.append(len(v))
            return np.asarray(v.to_numpy()) * (1.0 - np.asarray(d.to_numpy()))

        col = pkg.col
        return (pkg.from_pydict(data).into_partitions(parts)
                .with_column("x", disc(col("v"), col("d")))
                .where(col("v") > 0.1)
                .groupby("k").agg(col("x").sum().alias("s"), col("x").count().alias("n"))
                .sort("k"))

    _ref, got = check(build, rtol=1e-6, ordered=True)
    # one call a partition, over the rows the pushed-down filter keeps
    assert calls["daft_tpu_torch"] == calls["daft_tpu"]
    assert len(calls["daft_tpu"]) == parts and sum(calls["daft_tpu"]) < 600
    c = got.stats.snapshot()["counters"]
    assert c.get("device_aggregations", 0) >= parts
    if parts == 1:  # the filter and the UDF fuse into one chain, run on the host
        assert c.get("fused_chains", 0) == 1 and c.get("host_fused_maps", 0) == 1


# ---------------------------------------------------------------------------
# cache refusals
# ---------------------------------------------------------------------------

def test_plan_caches_refuse_udf_plans():
    """No plan-cache hit and no whole-plan result hit for a plan with a UDF:
    the UDF runs again on every collect, in both packages."""
    def run(pkg):
        from importlib import import_module

        clear_adapt()
        key = import_module(f"{pkg.__name__}.runners").plan_cache_key
        cfg = pkg.get_context().execution_config
        saved = cfg.enable_result_cache
        cfg.enable_result_cache = True
        calls = []
        t = _tracked(pkg, calls, lambda v: v + 1)
        df = pkg.from_pydict({"v": [1, 2, 3]})
        try:
            hits, frames = [], []
            udf_key = key(df.select(t(pkg.col("v")).alias("w"))._plan)
            for _ in range(2):
                q = df.select(t(pkg.col("v")).alias("w")).collect()
                frames.append(q)  # the whole-plan result cache serves live frames only
                c = q.stats.snapshot()["counters"]
                hits.append((c.get("plan_cache_hits", 0), c.get("result_cache_hits", 0)))
            return udf_key, key(df.select(pkg.col("v"))._plan) is not None, hits, calls
        finally:
            cfg.enable_result_cache = saved
            clear_adapt()

    ref, got = both(run)
    assert got == ref
    assert got[0] is None and got[1] and got[2] == [(0, 0), (0, 0)] and got[3] == [3, 3]


def test_subplan_result_cache_declines_a_udf_prefix(tmp_path):
    """tests/test_adapt.py::test_udf_prefix_declines: a UDF projection over a
    scan is never kept, in both packages."""
    from daft_tpu.adapt import RESULT_CACHE as REF_RESULT_CACHE
    from daft_tpu_torch.adapt import RESULT_CACHE

    path = str(tmp_path / "t.parquet")
    papq.write_table(pa.table({"k": [i % 5 for i in range(2000)],
                               "v": [float(i) for i in range(2000)]}), path)

    def run(pkg):
        cache = REF_RESULT_CACHE if pkg is daft_tpu else RESULT_CACHE
        cache.clear()
        cfg = pkg.get_context().execution_config
        saved = cfg.enable_result_cache
        cfg.enable_result_cache = False
        try:
            @pkg.udf(return_dtype=pkg.DataType.float64())
            def plus1(s):
                return [v + 1 for v in s.to_pylist()]

            for _ in range(2):
                out = pkg.read_parquet(path).select(plus1(pkg.col("v")).alias("c")).to_pydict()
            return cache.snapshot()["inserts"], out["c"][:3]
        finally:
            cfg.enable_result_cache = saved
            cache.clear()

    ref, got = both(run)
    assert got == ref == (0, [1.0, 2.0, 3.0])


@pytest.mark.parametrize("parts,deep", sorted(UDF_Q1_ROUTES))
def test_udf_q1_routes_as_pinned(parts, deep):
    """chip_smoke.q1_udf (phase 15 (b)) at SF0.002 (seed 42), at
    ``device_min_rows=8``: the reference's rows and routing, the UDF called
    once a partition, and the K1 and K2 entries of ``UDF_Q1_ROUTES``, to
    which the card's launches are held."""
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    li = tpch.generate_lineitem_only(scale=0.002, seed=42)
    calls = {}

    def build(pkg):
        frame = pkg.from_arrow(li)
        return q1_udf(pkg, frame.into_partitions(parts) if parts > 1 else frame,
                      calls.setdefault(pkg.__name__, []))

    ss.ENTRIES = fes.ENTRIES = 0
    _ref, got = check(build, rtol=1e-6, ordered=True, knobs={"use_pallas_deep_fusion": deep})
    assert {"k1": ss.ENTRIES, "k2": fes.ENTRIES} == UDF_Q1_ROUTES[(parts, deep)]
    assert len(calls["daft_tpu_torch"]) == len(calls["daft_tpu"]) == parts
    c = got.stats.snapshot()["counters"]
    assert c.get("host_fused_maps", 0) == parts and c.get("device_agg_fallbacks", 0) == 0


def test_parallel_safety_gate_as_the_reference():
    """A function UDF (or a bare class UDF sharing one instance) makes its op
    unsafe to run on several partitions at once; a class UDF on an actor
    pool keeps it safe (the gate the pooled fan-out of scheduler.py will
    read)."""
    def run(pkg):
        from importlib import import_module

        opt = import_module(f"{pkg.__name__}.optimizer").optimize
        phys = import_module(f"{pkg.__name__}.physical")
        cfg = pkg.get_context().execution_config

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def f(x):
            return x

        pooled = pkg.udf(return_dtype=pkg.DataType.int64())(Doubler).with_concurrency(2)
        out = []
        for e in (pkg.col("x") + 1, f(pkg.col("x")), pooled(pkg.col("x"))):
            op = phys.translate(opt(pkg.from_pydict({"x": [1]}).select(e.alias("y"))._plan), cfg)
            while type(op).__name__ != "ProjectOp":
                op = op.children[0]
            out.append(op.parallel_safe())
        return out

    ref, got = both(run)
    assert got == ref == [True, False, True]
