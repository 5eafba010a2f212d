"""The fault registry, the DeviceHealth breaker, the fault sites and query
deadlines of the port (daft_tpu_torch/faults.py, execution.py) held
against daft_tpu on the CPU: the applicable cases of tests/test_faults.py,
the breaker legs and fuse.segment cases of tests/test_segment.py, the
fuse.compile case of tests/test_fuse.py and the join.filter cases of
tests/test_exchange.py.

A query case arms the same plan in both packages' registries (they are
separate modules), runs the same input through daft_tpu in its 32-bit
device mode (tests/device_mode.py) and through the port under the same
configuration with device="cpu", and compares the rows (floats at rtol
1e-6) and the breaker, fault and routing counters. The unit cases run the
reference's assertions against each package's own class.

The port adds rules the reference has no counterpart for: a device
attempt takes only the failures of the device layer
(``execution.DEVICE_FAILURES``: the staging's int32 range guard, an
injected fault, an out-of-memory error), each counted as
``device_attempt_failures``, which the reference does not count; any
other exception, above all a ``DaftKernelError`` (a kernel that does not
build, load or launch), reaches the caller. Left out with their modules: the scan,
IO, spill, collective and actor-pool sites.
"""

import dataclasses
import importlib
import time

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import faults as ref_faults
from daft_tpu_torch import faults
from daft_tpu_torch.errors import DaftError, DaftKernelError, DaftTimeoutError, DaftTransientError
from device_mode import real_tpu_mode_cfg
from test_torch_two_stage_agg import _assert_same

PKGS = {"reference": daft_tpu, "port": daft_tpu_torch}
REGISTRIES = {"reference": ref_faults, "port": faults}
BREAKER = ("device_breaker_trips", "device_breaker_probes", "device_breaker_recoveries",
           "device_breaker_reopens", "degraded_completions", "faults_injected")


def _module(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.fixture(autouse=True)
def _clean():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    faults.disarm()
    ref_faults.disarm()
    yield
    faults.disarm()
    ref_faults.disarm()
    ctx.execution_config = saved


def run_both(build, arm=None, min_rows: int = 8, **knobs):
    """``build(pkg)`` (a DataFrame) collected through both packages, with
    ``knobs`` set on the reference's config and mapped onto the port's, and
    ``arm`` ((site, mode, kwargs), or a list of them) armed in each
    package's registry just before its run, the reference on one executor
    thread. Returns ((reference dict,
    counters), (port dict, counters))."""
    plans = [] if arm is None else ([arm] if isinstance(arm[0], str) else list(arm))
    out = []
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        # one executor thread, as tests/test_faults.py runs its breaker
        # cases: the reference's pool would otherwise race its partitions'
        # attempts against the breaker
        knobs = {"enable_result_cache": False, "executor_threads": 1, **knobs}
        saved = {k: getattr(cfg, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cfg, k, v)
        try:
            for site, mode, kw in plans:
                ref_faults.arm(site, mode, **kw)
            ref = build(daft_tpu).collect()
            ref_faults.disarm()
            out.append((ref.to_pydict(), ref.stats.snapshot()["counters"]))
            d = dataclasses.asdict(cfg)
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    for site, mode, kw in plans:
        faults.arm(site, mode, **kw)
    got = build(daft_tpu_torch).collect()
    faults.disarm()
    out.append((got.to_pydict(), got.stats.snapshot()["counters"]))
    return out


def pick(c: dict, keys) -> dict:
    return {k: c.get(k, 0) for k in keys}


# ---------------------------------------------------------------------------
# plans and the registry: tests/test_faults.py TestFaultPlans
# ---------------------------------------------------------------------------

def test_sites_are_the_four_the_port_wires():
    # the name is from the eleventh slice's four sites; the thirteenth added
    # the spill and encode sites, the fourteenth the plan cache's and the
    # fifteenth the scan's and the sub-plan result cache's, the sixteenth the
    # scan readahead's, the eighteenth the batching coalesce's and the model
    # actors' load, the twenty-first the mesh exchange's, the twenty-second
    # the object store's read, the twenty-third the sketch merge's and the
    # mesh register merge's, the twenty-fourth the distributed runner's
    # (worker.*, transport.*, telemetry.fragment, peer.fetch), each wired as
    # the reference wires it
    assert set(faults.SITES) == {"io.get", "collective.exchange",
                                 "device.kernel", "fuse.compile", "fuse.segment", "join.filter",
                                 "spill.write", "spill.readback", "spill.corrupt",
                                 "exchange.encode", "plancache.lookup", "scan.read",
                                 "resultcache.lookup", "prefetch.fetch", "batch.coalesce",
                                 "actor.load", "sketch.merge", "collective.sketch",
                                 "worker.spawn", "worker.exec", "worker.heartbeat",
                                 "worker.task", "worker.drain", "transport.send",
                                 "transport.corrupt", "telemetry.fragment", "peer.fetch"}
    assert set(faults.SITES) <= set(ref_faults.SITES)


@pytest.mark.parametrize("mode,n,want", [("first_n", 2, [True, True, False, False]),
                                         ("nth", 3, [False, False, True, False]),
                                         ("always", 1, [True] * 4)])
def test_count_plans_fire_as_the_reference(mode, n, want):
    got = [faults.FaultPlan(mode, n=n).should_fire("s", i) for i in (1, 2, 3, 4)]
    assert got == want == [ref_faults.FaultPlan(mode, n=n).should_fire("s", i)
                           for i in (1, 2, 3, 4)]


def test_rate_is_seed_deterministic():
    a = faults.FaultPlan("rate", rate=0.5, seed=7)
    b = faults.FaultPlan("rate", rate=0.5, seed=7)
    seq_a = [a.should_fire("device.kernel", i) for i in range(1, 200)]
    assert seq_a == [b.should_fire("device.kernel", i) for i in range(1, 200)]
    assert any(seq_a) and not all(seq_a)
    c = faults.FaultPlan("rate", rate=0.5, seed=8)
    assert seq_a != [c.should_fire("device.kernel", i) for i in range(1, 200)]
    # the same seed gives the reference's sequence
    ref = ref_faults.FaultPlan("rate", rate=0.5, seed=7)
    assert seq_a == [ref.should_fire("device.kernel", i) for i in range(1, 200)]


def test_rate_zero_and_one():
    assert not any(faults.FaultPlan("rate", rate=0.0, seed=1).should_fire("s", i)
                   for i in range(1, 50))
    assert all(faults.FaultPlan("rate", rate=1.0, seed=1).should_fire("s", i)
               for i in range(1, 50))


def test_unknown_mode_is_a_value_error():
    with pytest.raises(ValueError, match="unknown fault mode"):
        faults.FaultPlan("sometimes")


@pytest.mark.parametrize("name", sorted(REGISTRIES))
def test_check_counts_and_raises(name):
    reg = REGISTRIES[name]
    reg.arm("x.site", "first_n", n=1)
    with pytest.raises(reg.InjectedFault):
        reg.check("x.site")
    reg.check("x.site")  # healed
    snap = reg.snapshot()
    assert snap["calls"]["x.site"] == 2
    assert snap["injected"]["x.site"] == 1


def test_injected_fault_is_transient_and_oserror():
    assert issubclass(faults.InjectedFault, DaftTransientError)
    assert issubclass(faults.InjectedFault, OSError)
    assert issubclass(faults.InjectedFault, DaftError)


def test_rearm_resets_counters():
    faults.arm("x.site", "always")
    with pytest.raises(faults.InjectedFault):
        faults.check("x.site")
    faults.arm("x.site", "first_n", n=1)
    snap = faults.snapshot()
    assert snap["calls"]["x.site"] == 0
    assert snap["injected"]["x.site"] == 0


def test_disarm_clears():
    faults.arm("x.site", "always")
    faults.disarm("x.site")
    faults.check("x.site")
    faults.arm("y.site", "always")
    assert faults.any_armed()
    faults.disarm()
    assert not faults.any_armed()
    faults.check("y.site")


def test_inject_context_manager():
    with faults.inject("z.site", "always"):
        with pytest.raises(faults.InjectedFault):
            faults.check("z.site")
    faults.check("z.site")


def test_delay_plan_slows_without_failing():
    from daft_tpu_torch.execution import RuntimeStats

    stats = RuntimeStats()
    faults.arm("x.site", "always", delay_s=0.01)
    t0 = time.perf_counter()
    faults.check("x.site", stats)
    assert time.perf_counter() - t0 >= 0.01
    assert stats.counters["faults_injected"] == 1


# ---------------------------------------------------------------------------
# the breaker: tests/test_faults.py TestDeviceHealthUnit, on each package
# ---------------------------------------------------------------------------

def _health(name: str, **kw):
    ex = _module(PKGS[name], "execution")
    return ex.DeviceHealth(**kw), ex.RuntimeStats()


@pytest.mark.parametrize("name", sorted(PKGS))
def test_trips_after_threshold_consecutive(name):
    h, stats = _health(name, threshold=3, cooldown_s=60.0)
    h.record_failure(stats)
    h.record_failure(stats)
    h.record_success(stats)  # a success resets the consecutive count
    h.record_failure(stats)
    h.record_failure(stats)
    assert h.state == h.CLOSED
    h.record_failure(stats)
    assert h.state == h.OPEN
    assert stats.counters["device_breaker_trips"] == 1
    assert not h.allow(stats)


@pytest.mark.parametrize("name", sorted(PKGS))
def test_cooldown_probe_recovers(name):
    h, stats = _health(name, threshold=1, cooldown_s=0.02)
    h.record_failure(stats)
    assert not h.allow(stats)
    time.sleep(0.03)
    assert h.allow(stats)          # the one probe
    assert not h.allow(stats)      # a second caller waits while it probes
    h.record_success(stats)
    assert h.state == h.CLOSED
    assert h.allow(stats)
    assert stats.counters["device_breaker_probes"] == 1
    assert stats.counters["device_breaker_recoveries"] == 1


@pytest.mark.parametrize("name", sorted(PKGS))
def test_failed_probe_reopens(name):
    h, stats = _health(name, threshold=1, cooldown_s=0.01)
    h.record_failure(stats)
    time.sleep(0.02)
    assert h.allow(stats)
    h.record_failure(stats)
    assert h.state == h.OPEN
    assert stats.counters["device_breaker_reopens"] == 1
    assert stats.counters["device_breaker_trips"] == 1  # a reopen is not a trip


@pytest.mark.parametrize("name", sorted(PKGS))
def test_stale_success_does_not_close_open_breaker(name):
    h, stats = _health(name, threshold=2, cooldown_s=60.0)
    h.record_failure(stats)
    h.record_failure(stats)
    assert h.state == h.OPEN
    h.record_success(stats)  # a resolver of an attempt launched before the trip
    assert h.state == h.OPEN
    assert stats.counters.get("device_breaker_recoveries", 0) == 0


@pytest.mark.parametrize("name", sorted(PKGS))
def test_abandoned_probe_reclaims_after_cooldown(name):
    h, _ = _health(name, threshold=1, cooldown_s=0.02)
    h.record_failure()
    time.sleep(0.03)
    assert h.allow()       # a probe admitted, then abandoned
    assert not h.allow()   # still held within the cooldown
    time.sleep(0.03)
    assert h.allow()       # the slot is reclaimed


@pytest.mark.parametrize("name", sorted(PKGS))
def test_declined_probe_releases_slot(name):
    h, _ = _health(name, threshold=1, cooldown_s=0.01)
    h.record_failure()
    time.sleep(0.02)
    assert h.allow()
    h.release_probe()  # the attempt declined: the slot is free again
    assert h.allow()


# ---------------------------------------------------------------------------
# the breaker in a query: tests/test_faults.py TestDeviceBreakerIntegration
# ---------------------------------------------------------------------------

def _device_query(pkg, parts=6, rows=30_000):
    return (pkg.from_pydict({"x": np.arange(rows, dtype=np.int64) % 997})
            .into_partitions(parts)
            .select((pkg.col("x") * 2 + 1).alias("y")))


WANT_Y = [int(x) % 997 * 2 + 1 for x in range(30_000)]
ROUTES = ("device_projections", "device_projection_dispatches", "host_projections",
          "device_projection_fallbacks")


def test_fail_always_trips_once_and_completes_on_host():
    (ref, rc), (got, gc) = run_both(
        _device_query, arm=("device.kernel", "always", {}), min_rows=1,
        device_breaker_threshold=2, device_breaker_cooldown_s=60.0)
    assert got["y"] == ref["y"] == WANT_Y
    assert pick(gc, BREAKER + ROUTES) == pick(rc, BREAKER + ROUTES)
    # one trip, not one failure per partition
    assert gc.get("device_breaker_trips") == 1 and gc.get("degraded_completions", 0) > 0, gc
    assert gc.get("device_projections", 0) == 0 and gc.get("faults_injected") == 2, gc
    assert gc.get("device_attempt_failures") == 2, gc


def test_fail_once_then_heal_recovers_after_cooldown():
    (ref, rc), (got, gc) = run_both(
        _device_query, arm=("device.kernel", "first_n", {"n": 1}), min_rows=1,
        device_breaker_threshold=1, device_breaker_cooldown_s=0.0)
    assert got["y"] == ref["y"] == WANT_Y
    assert pick(gc, BREAKER + ROUTES) == pick(rc, BREAKER + ROUTES)
    assert gc.get("device_breaker_trips") == 1 and gc.get("device_breaker_recoveries") == 1, gc
    assert gc.get("device_projections", 0) >= 1, gc  # later partitions ran on the card


def test_no_faults_no_breaker_activity():
    (ref, rc), (got, gc) = run_both(lambda pkg: _device_query(pkg, parts=2), min_rows=1)
    assert got["y"] == ref["y"]
    assert pick(gc, BREAKER) == pick(rc, BREAKER) == {k: 0 for k in BREAKER}


@pytest.mark.parametrize("nkeys", [5, 30])
def test_int64_staging_decline_trips_the_breaker_as_in_the_reference(nkeys):
    """An int64 column past int32 in the 32-bit mode: the staging's range
    guard raises in both packages, each device attempt of the aggregate
    counts as a failure and the third trips the breaker; the later
    device-eligible work of the query is degraded. Values, trips, degraded
    completions and device group codes equal the reference's."""
    rng = np.random.default_rng(0)
    t = pa.table({"k": rng.integers(0, nkeys, 300), "i": rng.integers(-2**40, 2**40, 300)})
    keys = ("device_breaker_trips", "degraded_completions", "device_group_codes",
            "device_aggregations", "host_aggregations", "device_agg_fallbacks")
    (ref, rc), (got, gc) = run_both(
        lambda pkg: pkg.from_arrow(t).into_partitions(3).groupby("k").agg(pkg.col("i").min()))
    assert sorted(zip(*got.values())) == sorted(zip(*ref.values()))
    assert pick(gc, keys) == pick(rc, keys)
    assert gc["device_breaker_trips"] == 1 and gc["device_group_codes"] == 3, gc
    assert gc["device_attempt_failures"] == 3, gc  # the three that trip it


# ---------------------------------------------------------------------------
# a failure of the port itself reaches the caller
# ---------------------------------------------------------------------------

def _raise_kernel_error(*a, **kw):
    raise DaftKernelError("kernel launch failed")


def _loader_build(*a, **kw):
    from daft_tpu_torch.kernels import segment_sums

    return segment_sums.build()  # no nvcc on the path: the loader raises


def _agg_frame(groups: int, rows: int = 8192):
    rng = np.random.RandomState(5)
    return daft_tpu_torch.from_pydict({"g": rng.randint(0, groups, rows),
                                       "v": rng.rand(rows), "w": rng.rand(rows)})


KERNEL_FAILURES = {
    # K1: the composed route's float sums over 16 groups
    "k1": ("kernels.segment_sums", "masked_segment_sums_plain", _raise_kernel_error, False, 16),
    # K2: the same aggregate with deep fusion on
    "k2": ("kernels.fused_expr_sums", "FusedExprSums.plain", _raise_kernel_error, True, 16),
    # the scatter kernel: float sums over more than 4096 groups
    "scatter": ("kernels.scatter_sums", "scatter_sum_kahan_plain", _raise_kernel_error, False,
                6000),
    # the nvcc loader, reached where K1 would build
    "nvcc": ("kernels.segment_sums", "masked_segment_sums_plain", _loader_build, False, 16),
}


@pytest.mark.parametrize("where", sorted(KERNEL_FAILURES))
def test_kernel_error_reaches_collect(monkeypatch, where):
    """A ``DaftKernelError`` where each wrapper would raise it (its launch
    failing; on the CPU in place of its plain version) or where the nvcc
    loader raises it is caught by no device attempt and no resolver: it
    reaches collect(), and the breaker counts nothing."""
    mod_name, attr, fn, deep, groups = KERNEL_FAILURES[where]
    # K2's module binds K1's plain version when it is first imported: import
    # it before the patch, so that the patch cannot outlive the test there
    _module(daft_tpu_torch, "kernels.fused_expr_sums")
    mod = _module(daft_tpu_torch, mod_name)
    if "." in attr:
        cls, meth = attr.split(".")
        monkeypatch.setattr(getattr(mod, cls), meth, fn)
    else:
        monkeypatch.setattr(mod, attr, fn)
    if where == "nvcc":
        from daft_tpu_torch.kernels import nvcc

        monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        use_deep_fusion_kernel=deep)
    col = daft_tpu_torch.col
    df = (_agg_frame(groups).where(col("w") > 0.1)
          .groupby("g").agg((col("v") * 2).sum().alias("s"), col("w").mean().alias("m")))
    with pytest.raises(DaftKernelError, match="nvcc not found" if where == "nvcc"
                       else "kernel launch failed"):
        df.collect()
    c = df.stats.snapshot()["counters"]
    assert c.get("device_breaker_trips", 0) == 0 and c.get("degraded_completions", 0) == 0, c


@pytest.mark.parametrize("exc,caught", [("OutOfMemoryError", True),
                                         ("AcceleratorError", False),
                                         ("RuntimeError", False)])
def test_cuda_errors_split_at_the_breaker(monkeypatch, exc, caught):
    """``torch.cuda.OutOfMemoryError`` is a failure of the device layer the
    breaker takes (the partitions complete on the host, the third trips
    it); ``torch.AcceleratorError``, a CUDA error, reaches collect(), and
    so does any other exception (a RuntimeError, as a torch op that rejects
    its inputs raises), which the reference's breaker would take."""
    import torch

    from daft_tpu_torch.kernels import device

    err = {"OutOfMemoryError": torch.cuda.OutOfMemoryError,
           "AcceleratorError": torch.AcceleratorError, "RuntimeError": RuntimeError}[exc]

    def broken(*a, **kw):
        raise err("device failure")

    monkeypatch.setattr(device, "eval_projection_device_async", broken)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    df = _device_query(daft_tpu_torch, parts=4, rows=400)
    if caught:
        assert df.collect().to_pydict()["y"] == WANT_Y[:400]
    else:
        with pytest.raises(err, match="device failure"):
            df.collect()
    c = df.stats.snapshot()["counters"]
    assert c.get("device_breaker_trips", 0) == int(caught), c
    assert c.get("device_attempt_failures", 0) == (3 if caught else 0), c


# ---------------------------------------------------------------------------
# deadlines: tests/test_faults.py TestDeadlines
# ---------------------------------------------------------------------------

def test_deadline_expiry_raises_with_partial_stats():
    for name, pkg in PKGS.items():
        with real_tpu_mode_cfg() as cfg:
            saved = cfg.execution_timeout_s, cfg.enable_result_cache
            cfg.execution_timeout_s, cfg.enable_result_cache = 1e-6, False
            try:
                if pkg is daft_tpu_torch:
                    daft_tpu_torch.set_execution_config(daft_tpu_torch.execution_config_from_dict(
                        dataclasses.asdict(cfg) | {"jax_enable_x64": False}, device="cpu"))
                df = _device_query(pkg, parts=4)
                with pytest.raises(pkg.errors.DaftTimeoutError if pkg is daft_tpu
                                   else DaftTimeoutError) as ei:
                    df.collect()
            finally:
                cfg.execution_timeout_s, cfg.enable_result_cache = saved
        err = ei.value
        assert isinstance(err, TimeoutError), name
        assert isinstance(err.stats, dict) and "counters" in err.stats, name
        assert err.stats["counters"].get("deadline_expired", 0) >= 1, name


def test_partial_stats_carry_completed_work():
    from daft_tpu_torch.execution import ExecutionContext, RuntimeStats

    stats = RuntimeStats()
    stats.bump("host_projections", 3)
    ctx = ExecutionContext(daft_tpu_torch.ExecutionConfig(device="cpu"), stats,
                           deadline=time.monotonic() - 1.0)
    with pytest.raises(DaftTimeoutError) as ei:
        ctx.check_deadline()
    assert ei.value.stats["counters"]["host_projections"] == 3
    assert ei.value.stats["counters"]["deadline_expired"] == 1


def test_generous_deadline_does_not_fire():
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1,
                                        execution_timeout_s=300.0)
    assert len(_device_query(daft_tpu_torch, parts=2).collect().to_pydict()["y"]) == 30_000


def test_no_deadline_by_default():
    from daft_tpu_torch.execution import ExecutionContext, RuntimeStats

    ctx = ExecutionContext(daft_tpu_torch.ExecutionConfig(device="cpu"), RuntimeStats())
    assert ctx.deadline is None
    ctx.check_deadline()


def test_zero_timeout_is_a_limit_not_disabled():
    from daft_tpu_torch.execution import ExecutionContext, RuntimeStats

    ctx = ExecutionContext(daft_tpu_torch.ExecutionConfig(device="cpu", execution_timeout_s=0.0),
                           RuntimeStats())
    assert ctx.deadline is not None
    time.sleep(0.01)
    with pytest.raises(DaftTimeoutError):
        ctx.check_deadline()


@pytest.mark.parametrize("query", ["sort", "hash_join", "broadcast_join", "aggregate"])
def test_pipeline_breakers_check_the_deadline(monkeypatch, query):
    """Each pipeline breaker checks the deadline before it buffers its
    input: with the per-pull check of ``_traced`` taken out, the query
    still ends with DaftTimeoutError."""
    from daft_tpu_torch import execution

    def untimed(op, stream, ctx):
        yield from stream

    monkeypatch.setattr(execution, "_traced", untimed)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        execution_timeout_s=0.0)
    col = daft_tpu_torch.col
    df = daft_tpu_torch.from_pydict({"k": list(range(64)), "v": [1.0] * 64}).into_partitions(2)
    other = daft_tpu_torch.from_pydict({"k": list(range(32)), "w": [2.0] * 32})
    q = {"sort": lambda: df.sort("k"),
         "hash_join": lambda: df.join(other.into_partitions(2), on="k", strategy="hash"),
         "broadcast_join": lambda: df.join(other, on="k", strategy="broadcast"),
         "aggregate": lambda: df.groupby("k").agg(col("v").sum())}[query]()
    time.sleep(0.001)
    with pytest.raises(DaftTimeoutError):
        q.collect()


# ---------------------------------------------------------------------------
# plan segments: tests/test_segment.py's breaker legs and fuse.segment cases
# ---------------------------------------------------------------------------

def _segment_data(nulls="some", n=200):
    if nulls == "none":
        v = list(range(n))
        f = [i * 0.25 for i in range(n)]
    elif nulls == "some":
        v = [i if i % 7 else None for i in range(n)]
        f = [i * 0.25 if i % 5 else None for i in range(n)]
    else:  # all: the aggregated columns carry no values at all
        v = [None] * n
        f = [None] * n
    return pa.table({
        "k": pa.array(["a", "b", "c", "d"] * (n // 4)),
        "u": pa.array(list(range(n)), type=pa.int64()),
        "v": pa.array(v, type=pa.int64()),
        "f": pa.array(f, type=pa.float64()),
        "b": pa.array([True, True, False, True] * (n // 4)),
    })


def _segment_query(pkg, nulls="some", nparts=2):
    col = pkg.col
    df = pkg.from_arrow(_segment_data(nulls)).into_partitions(nparts)
    return (df.select((col("v") * 2 + 1).alias("x"), (col("f") * 0.5).alias("g"),
                      (col("u") * 3).alias("w"), col("k"), col("b"))
            .where((col("w") > 30) & col("b"))
            .groupby("k")
            .agg(col("x").sum().alias("sx"), col("g").mean().alias("mg"),
                 col("g").max().alias("xg"), col("x").count().alias("c"),
                 col("w").sum().alias("sw"))
            .sort("k"))


SEGMENT = ("device_resident_segments", "device_handoffs_elided", "segment_fallbacks",
           "device_aggregations", "host_aggregations")


@pytest.mark.parametrize("nulls", ["none", "some", "all"])
@pytest.mark.parametrize("leg", ["device", "host", "breaker_tripped"])
def test_segment_legs(leg, nulls):
    """Residency on equals residency off, and both equal the reference,
    with the card, without it, and with every device attempt failing (the
    breaker trips on the first)."""
    knobs = {"device_residency": True}
    arm = None
    if leg == "host":
        knobs["use_device_kernels"] = False
    elif leg == "breaker_tripped":
        knobs.update(device_breaker_threshold=1, device_breaker_cooldown_s=600.0)
        arm = ("device.kernel", "always", {})
    build = lambda pkg: _segment_query(pkg, nulls)  # noqa: E731
    (ref, rc), (on, oc) = run_both(build, arm=arm, min_rows=1, **knobs)
    (_, _), (off, fc) = run_both(build, arm=arm, min_rows=1, **{**knobs,
                                                               "device_residency": False})
    assert on == off
    _assert_same(on, ref)
    assert pick(oc, SEGMENT + BREAKER) == pick(rc, SEGMENT + BREAKER)
    assert fc.get("device_resident_segments", 0) == 0
    if leg == "device":
        assert oc.get("device_resident_segments") == 1 and oc.get("device_handoffs_elided", 0) >= 1
    else:
        assert oc.get("device_resident_segments", 0) == 0, oc
        assert oc.get("device_handoffs_elided", 0) == 0, oc
    if leg == "breaker_tripped":
        assert oc.get("device_breaker_trips") == 1, oc


def _plan_and_run(pkg, build, arm_at: str, plan):
    """Translate ``build(pkg)`` (arming ``plan`` before the translate when
    ``arm_at`` is "compile", after it when "run"), run the physical plan
    and return (segments planned, rows, counters)."""
    from daft_tpu_torch.fuse.segment import DeviceSegmentOp as PortSegment

    reg = REGISTRIES["port" if pkg is daft_tpu_torch else "reference"]
    physical, optimizer, execution = (_module(pkg, m) for m in
                                      ("physical", "optimizer", "execution"))
    seg_cls = PortSegment if pkg is daft_tpu_torch else _module(pkg, "fuse").DeviceSegmentOp
    cfg = pkg.context.get_context().execution_config
    df = build(pkg)
    if arm_at == "compile":
        reg.arm(*plan[:2], **plan[2])
    phys = physical.translate(optimizer.optimize(df._plan), cfg)
    if arm_at == "compile":
        reg.disarm()
    else:
        reg.arm(*plan[:2], **plan[2])

    def walk(op):
        return int(isinstance(op, seg_cls)) + sum(walk(c) for c in op.children)

    stats = execution.RuntimeStats()
    rows = {}
    for p in execution.execute_plan(phys, execution.ExecutionContext(cfg, stats)):
        for k, vals in p.table().to_pydict().items():
            rows.setdefault(k, []).extend(vals)
    reg.disarm()
    return walk(phys), rows, stats.snapshot()["counters"]


@pytest.mark.parametrize("arm_at", ["compile", "run"])
def test_segment_fault_site(arm_at):
    """``fuse.segment`` armed first_n n=1 at the compile (the segment is not
    planned) or after it (the first resident handoff fails, counts against
    the breaker and takes the staged ops): the rows equal the unarmed
    query's, and the segments planned and the counters equal the
    reference's."""
    plan = ("fuse.segment", "first_n", {"n": 1})
    got = {}
    with real_tpu_mode_cfg(device_min_rows=1) as cfg:
        saved = cfg.enable_result_cache, cfg.device_residency
        cfg.enable_result_cache, cfg.device_residency = False, True
        try:
            got["reference"] = _plan_and_run(daft_tpu, _segment_query, arm_at, plan)
            want = _segment_query(daft_tpu).collect().to_pydict()
            d = dataclasses.asdict(cfg)
        finally:
            cfg.enable_result_cache, cfg.device_residency = saved
    daft_tpu_torch.set_execution_config(daft_tpu_torch.execution_config_from_dict(
        d | {"jax_enable_x64": False}, device="cpu"))
    got["port"] = _plan_and_run(daft_tpu_torch, _segment_query, arm_at, plan)
    (rseg, rrows, rc), (pseg, prows, pc) = got["reference"], got["port"]
    _assert_same(prows, want)
    _assert_same(rrows, want)
    assert pseg == rseg == (0 if arm_at == "compile" else 1)
    assert pick(pc, SEGMENT + BREAKER) == pick(rc, SEGMENT + BREAKER)
    if arm_at == "run":
        assert pc["faults_injected"] == 1 and pc["segment_fallbacks"] == 1, pc


@pytest.mark.parametrize("mode,kw", [("nth", {"n": 2}), ("always", {})])
def test_segment_fault_through_collect(mode, kw):
    """Armed before collect(): call 1 of ``fuse.segment`` is the compile,
    call 2 the first resident handoff. ``nth`` n=2 fails the first
    partition's handoff only, ``always`` keeps the segment out of the plan;
    neither fails the query, and both packages agree."""
    (ref, rc), (got, gc) = run_both(lambda pkg: _segment_query(pkg, nparts=3),
                                    arm=("fuse.segment", mode, kw), min_rows=1,
                                    device_residency=True)
    _assert_same(got, ref)
    assert pick(gc, SEGMENT + BREAKER) == pick(rc, SEGMENT + BREAKER)
    if mode == "nth":
        assert gc["segment_fallbacks"] == 1 and gc["device_resident_segments"] == 1, gc


def test_segment_site_registered():
    assert "fuse.segment" in faults.SITES


# ---------------------------------------------------------------------------
# fuse.compile: tests/test_fuse.py
# ---------------------------------------------------------------------------

def _select_chain(pkg):
    col = pkg.col
    q = pkg.from_pydict({"a": [1.0, 2.0, None, 4.0] * 25, "b": list(range(100))})
    q = q.select((col("a") + col("b")).alias("x"), col("b"))
    q = q.select((col("x") * 2).alias("y"), (col("x") + 1).alias("z"), col("b"))
    return q.select((col("y") + col("z")).alias("u"), (col("y") * col("z")).alias("v"))


def test_fuse_compile_fault_leaves_the_unfused_chain():
    from daft_tpu_torch.fuse.compile import FusedMapOp
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import ProjectOp, translate

    def ops(op, klass):
        return int(isinstance(op, klass)) + sum(ops(c, klass) for c in op.children)

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8, expr_fusion=True)
    cfg = daft_tpu_torch.get_context().execution_config
    want = _select_chain(daft_tpu_torch).to_pydict()
    with faults.inject("fuse.compile"):
        q = _select_chain(daft_tpu_torch)
        phys = translate(optimize(q._plan), cfg)
        assert ops(phys, FusedMapOp) == 0, phys.display_tree()
        assert ops(phys, ProjectOp) >= 2
        got = q.to_pydict()
        assert faults.snapshot()["injected"].get("fuse.compile", 0) >= 1
    assert got == want
    (ref, rc), (port, pc) = run_both(_select_chain, arm=("fuse.compile", "always", {}))
    _assert_same(port, ref)
    keys = ("fused_chains", "device_projections", "host_projections", "device_fused_maps")
    assert pick(pc, keys) == pick(rc, keys) and pc.get("fused_chains", 0) == 0


# ---------------------------------------------------------------------------
# join.filter: tests/test_exchange.py TestFaultDegradation
# ---------------------------------------------------------------------------

def _selective_join(pkg, n=5000, keys=2000, keep=60):
    rng = np.random.RandomState(11)
    build = pkg.from_pydict({"k": list(range(0, keep * 10, 10)),
                             "bv": list(range(keep))}).into_partitions(3)
    probe = pkg.from_pydict({"k": rng.randint(0, keys, n).tolist(),
                             "pv": rng.rand(n).tolist()}).into_partitions(3)
    return build.join(probe, on="k", how="inner", strategy="hash")


def _rows(d: dict) -> list:
    return sorted(zip(*d.values()))


JOIN_FILTER = ("join_filter_errors", "join_filter_built", "join_filter_rows_pruned",
               "join_filter_probe_rows", "join_filter_device_probes", "device_join_probes",
               "faults_injected")


@pytest.mark.parametrize("mode,kw,errors", [("always", {}, None), ("nth", {"n": 5}, 1)])
def test_join_filter_failure_degrades_to_unfiltered(mode, kw, errors):
    """``always``: every build feed fails, the filter is abandoned and
    nothing is pruned. ``nth`` n=5: the build feeds 3 partitions (3 checks),
    the seal checks nothing, so call 5 is the second probe partition's
    prune, which ships that partition unpruned. The rows equal those with
    the join filter off, and the counters the reference's."""
    (ref, rc), (got, gc) = run_both(_selective_join, arm=("join.filter", mode, kw))
    (_, _), (off, _) = run_both(_selective_join, runtime_join_filters=False)
    assert _rows(got) == _rows(ref) == _rows(off)
    assert pick(gc, JOIN_FILTER) == pick(rc, JOIN_FILTER)
    if errors is None:
        assert gc["join_filter_errors"] >= 1 and gc.get("join_filter_rows_pruned", 0) == 0, gc
    else:
        assert gc["join_filter_errors"] == errors and gc["join_filter_rows_pruned"] > 0, gc


def test_broadcast_join_filter_build_failure():
    """The broadcast join builds its filter over the collected small side
    in one attempt; with ``join.filter`` armed it fails open."""
    def build(pkg):
        rng = np.random.RandomState(11)
        small = pkg.from_pydict({"k": list(range(0, 600, 10)), "bv": list(range(60))})
        big = pkg.from_pydict({"k": rng.randint(0, 2000, 5000).tolist(),
                               "pv": rng.rand(5000).tolist()}).into_partitions(3)
        return big.join(small, on="k", how="inner", strategy="broadcast")

    (ref, rc), (got, gc) = run_both(build, arm=("join.filter", "always", {}))
    assert _rows(got) == _rows(ref)
    assert pick(gc, JOIN_FILTER) == pick(rc, JOIN_FILTER)
    assert gc["join_filter_errors"] == 1 and gc.get("join_filter_built", 0) == 0, gc


def test_join_filter_site_registered():
    assert "join.filter" in faults.SITES


# ---------------------------------------------------------------------------
# chip_smoke.py phase 8: the same plans over 4 partitions of small tables,
# in both packages; FAULT_PINS holds the numbers the card must show too
# ---------------------------------------------------------------------------

def _q1_with_columns(frame, col):
    import datetime

    return (frame
            .with_column("disc_price", col("l_extendedprice") * (1 - col("l_discount")))
            .with_column("charge", col("disc_price") * (1 + col("l_tax")))
            .where(col("l_shipdate") <= datetime.date(1998, 9, 2))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 col("disc_price").sum().alias("sum_disc_price"),
                 col("charge").sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


# the reference's versions of chip_smoke.fault_cases' queries
REF_FAULT_QUERIES = {
    "q1_kernel_always": lambda tpch, f: tpch.q1(f["lineitem_4"]),
    "q1_kernel_first": lambda tpch, f: tpch.q1(f["lineitem_4"]),
    "q1_segment_handoff": lambda tpch, f: _q1_with_columns(f["lineitem_4"], daft_tpu.col),
    "q3_join_filter": lambda tpch, f: tpch.q3(f["customer"], f["orders"], f["lineitem"]),
}


@pytest.fixture(scope="module")
def fault_tables():
    from benchmarks import tpch

    li = tpch.generate_lineitem_only(scale=20_000 / tpch.LINEITEM_ROWS_PER_SF, seed=7)
    return li, tpch.generate_tables(scale=0.005, seed=42)


@pytest.mark.parametrize("case", sorted(REF_FAULT_QUERIES))
def test_phase8_fault_cases_pin_both_packages(fault_tables, case):
    """Each armed case of chip_smoke.py's phase 8 (its query, config and
    fault plan, from ``fault_cases``) over 4 partitions: the rows equal the
    unarmed run's, and the counters FAULT_PINS names equal the reference's
    and the pins; the port's kernel entries (its launches on the card) equal
    the pins' K1 and K2 counts. Q1 keeps the default device_min_rows (5,000
    rows a partition take the card, stage 2's partials do not, as at SF1);
    Q3 runs at device_min_rows=8, where SF0.005's partitions probe on the
    card as SF1's do."""
    import chip_smoke
    from benchmarks import tpch
    from daft_tpu_torch.context import _FROM_REFERENCE
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    li, tables = fault_tables
    port_build, overrides, plan = chip_smoke.fault_cases()[case]
    to_ref = {ours: theirs for theirs, ours in _FROM_REFERENCE.items()}
    ref_knobs = {to_ref[k]: v for k, v in overrides.items()}
    step = -(-li.num_rows // chip_smoke.FAULT_PARTS)
    parts = [li.slice(i * step, step) for i in range(chip_smoke.FAULT_PARTS)]

    def frames(pkg):
        f = {"lineitem_4": pkg.from_arrow(parts)}
        for k in ("lineitem", "orders", "customer"):
            f[k] = pkg.from_arrow(tables[k]).into_partitions(chip_smoke.FAULT_PARTS)
        return f

    def build(pkg):
        if pkg is daft_tpu:
            return REF_FAULT_QUERIES[case](tpch, frames(pkg))
        return port_build(frames(pkg))

    min_rows = 8 if case == "q3_join_filter" else 4096
    (want_ref, _), (want, _) = run_both(build, min_rows=min_rows, **ref_knobs)
    entries = ss.ENTRIES, fes.ENTRIES
    (ref, rc), (got, gc) = run_both(build, arm=plan, min_rows=min_rows, **ref_knobs)
    launches = {"k1": ss.ENTRIES - entries[0], "k2": fes.ENTRIES - entries[1]}
    if case == "q3_join_filter":
        groups = chip_smoke.oracle_q3_groups(tables["customer"], tables["orders"],
                                             tables["lineitem"])
        assert chip_smoke.q3_parity(got, want, groups, chip_smoke.RTOL)
        assert chip_smoke.q3_parity(ref, want_ref, groups, chip_smoke.RTOL)
        assert gc["join_filter_errors"] > 0
    else:
        assert chip_smoke.parity(got, want, chip_smoke.RTOL)
        assert chip_smoke.parity(ref, want_ref, chip_smoke.RTOL)
    pins = chip_smoke.FAULT_PINS[case]
    counters = [k for k in pins if k not in launches]
    assert pick(gc, counters) == {k: pins[k] for k in counters}
    # the reference counts no device_attempt_failures
    shared = [k for k in counters if k != "device_attempt_failures"]
    assert pick(rc, shared) == {k: pins[k] for k in shared}
    assert pick(gc, BREAKER) == pick(rc, BREAKER)
    assert {k: launches[k] for k in pins if k in launches} == {
        k: v for k, v in pins.items() if k in launches}
