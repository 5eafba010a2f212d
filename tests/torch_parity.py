"""One query through daft_tpu and through daft_tpu_torch on the CPU under one
configuration, for the parity tests of the port's relational surface
(tests/test_torch_join_strategies.py, tests/test_torch_reshape.py).

The 32-bit mode is the reference's real-TPU recipe (tests/device_mode.py,
``device_min_rows=8`` unless a case says otherwise) with the port's config
mapped from it; the 64-bit mode is the reference's default x64 mode with
device kernels on, as tests/test_torch_x64.py runs it.
"""

import dataclasses

import pytest

import daft_tpu
import daft_tpu_torch
from device_mode import real_tpu_mode_cfg

# the routing and exchange counters each case holds equal in both packages
COUNTERS = ("device_filters", "host_filters", "device_projections", "host_projections",
            "device_fused_maps", "host_fused_maps", "device_aggregations", "host_aggregations",
            "device_agg_fallbacks", "device_sorts", "host_sorts", "device_group_codes",
            "device_join_probes", "host_joins", "broadcast_joins", "device_distincts",
            "host_distincts", "shuffles", "exchange_rows", "exchange_precombined_rows",
            "aligned_boundary_shuffles", "join_filter_built", "join_filter_rows_pruned",
            "device_breaker_trips", "degraded_completions")


# the spill and integrity counters the budgeted cases hold equal
# (tests/test_torch_spill.py, tests/test_torch_encoded_exchange.py)
SPILL_COUNTERS = ("spilled_partitions", "spill_write_failures", "unspill_readahead_submitted",
                  "corruption_detected", "lineage_truncated", "exchange_pieces_encoded",
                  "exchange_precombined_rows")

# the budgeted cases run the reference on one executor thread (its pool would
# otherwise charge parked task outputs against the budget in an order that
# depends on timing), and both packages with synchronous spill writes unless
# a case says otherwise: an async write changes its partition's size
# estimate from the memory bytes to the file bytes when it lands, and the
# readahead's budget throttle reads that estimate, so with async writes
# ``unspill_readahead_submitted`` follows the writer thread's timing
SPILL_BASE = {"executor_threads": 1, "async_spill_writes": False}


def actor_pools_down() -> None:
    """Both packages' UDF actor pools and pinned model actors shut down, so
    that no actor thread outlives the case that made it (the reference's
    serving tests count every live ``daft-actor-*`` thread as a leak)."""
    from daft_tpu.actor_pool import shutdown_all as ref_shutdown
    from daft_tpu_torch.actor_pool import shutdown_all

    ref_shutdown()
    shutdown_all()


def fresh_ledgers_and_faults() -> None:
    """Both packages' process-wide memory ledgers at 0, both fault
    registries disarmed, and both query logs and structured-log rings
    empty. A budgeted case's spill decisions read the ledger, which holds
    what earlier queries in the process left there: a reference query that
    fails under an injected fault can leave its buffers' bytes charged
    (tests/test_sketch_aggs.py's fault cases leave 15280), and the
    reference then spills more than the port over the same data. The
    observability cases read the query logs and the log rings."""
    from daft_tpu import faults as ref_faults
    from daft_tpu.obs import log as ref_log
    from daft_tpu.obs.querylog import QUERY_LOG as REF_QUERY_LOG
    from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
    from daft_tpu_torch import faults
    from daft_tpu_torch.obs import log as obs_log
    from daft_tpu_torch.obs.querylog import QUERY_LOG
    from daft_tpu_torch.spill import MEMORY_LEDGER

    for led in (REF_LEDGER, MEMORY_LEDGER):
        led.reset()
    ref_faults.disarm()
    faults.disarm()
    for qlog in (REF_QUERY_LOG, QUERY_LOG):
        qlog.clear()
    for ring in (ref_log, obs_log):
        ring.clear()


def spill_dirs() -> set:
    """The port's spill directories in the temp directory."""
    import glob
    import os
    import tempfile

    return set(glob.glob(os.path.join(tempfile.gettempdir(), "daft_tpu_torch_spill_*")))


def spill_counters(df) -> dict:
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS + SPILL_COUNTERS}


def run_both(build, min_rows: int = 8, x64: bool = False, knobs=None):
    """``build(pkg)`` (a DataFrame) through both packages, each collected;
    ``knobs`` (32-bit mode only) are set on the reference's config for its
    run and mapped onto the port's. Returns (reference frame, port frame)."""
    if x64:
        from daft_tpu.context import get_context

        cfg = get_context().execution_config
        knobs = dict(use_device_kernels=True, device_min_rows=min_rows,
                     enable_result_cache=False)
        saved = {k: getattr(cfg, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cfg, k, v)
        try:
            ref = build(daft_tpu).collect()
            d = dataclasses.asdict(cfg)
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)
    else:
        with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
            knobs = {"enable_result_cache": False, **(knobs or {})}
            saved = {k: getattr(cfg, k) for k in knobs}
            for k, v in knobs.items():
                setattr(cfg, k, v)
            try:
                ref = build(daft_tpu).collect()
                d = dataclasses.asdict(cfg)
            finally:
                for k, v in saved.items():
                    setattr(cfg, k, v)
    d["jax_enable_x64"] = x64
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    return ref, build(daft_tpu_torch).collect()


def under_both(fn, knobs: dict, min_rows: int = 8):
    """``fn(pkg)`` under the reference's 32-bit config with ``knobs`` set,
    then under the port's config mapped from it (``device="cpu"``); for
    cases that do more than collect one frame (a write, a late read, a
    failure). Returns (the reference's result, the port's)."""
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        saved = {k: getattr(cfg, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cfg, k, v)
        try:
            ref = fn(daft_tpu)
            d = dataclasses.asdict(cfg)
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    return ref, fn(daft_tpu_torch)


def counters(df) -> dict:
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def rows(d: dict) -> list:
    """The rows of a column dict as a sorted multiset."""
    return sorted(zip(*d.values()), key=lambda r: tuple((v is None, repr(v)) for v in r))


def assert_same_rows(got: dict, ref: dict, rtol: float = 0.0, ordered: bool = False):
    """Equal column names and rows (as multisets unless ``ordered``),
    floats within ``rtol``, everything else exactly."""
    assert list(got) == list(ref)
    g = list(zip(*got.values())) if ordered else rows(got)
    r = list(zip(*ref.values())) if ordered else rows(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert x == pytest.approx(y, rel=rtol, nan_ok=True), (a, b)
            else:
                assert x == y, (a, b)


def check(build, rtol: float = 0.0, ordered: bool = False, min_rows: int = 8,
          x64: bool = False, knobs=None):
    """The query through both packages: equal rows and equal counters.
    Returns (reference frame, port frame)."""
    ref, got = run_both(build, min_rows, x64, knobs)
    assert_same_rows(got.to_pydict(), ref.to_pydict(), rtol, ordered)
    assert counters(got) == counters(ref)
    return ref, got


@pytest.fixture(autouse=True)
def restore_port_config():
    """Gives the next case the port's config back as it found it."""
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


# ---------------------------------------------------------------------------
# planning for repeat-shaped traffic (tests/test_torch_adapt.py,
# tests/test_torch_adaptive.py)
# ---------------------------------------------------------------------------

# the plan cache's, feedback planning's, adaptive execution's and the result
# cache's counters, held equal in both packages beside COUNTERS
ADAPT_COUNTERS = ("plan_cache_hits", "plan_cache_misses", "plan_cache_errors",
                  "result_cache_hits", "fdo_join_flips", "fdo_shuffle_resizes",
                  "fdo_reduced_partitions", "fdo_mispredicts", "aqe_stages",
                  "aqe_shuffle_resizes")


def clear_adapt() -> None:
    """Both packages' plan caches, histories and result caches emptied (and
    the reference's sub-plan result cache)."""
    from daft_tpu.adapt import HISTORY as REF_HISTORY
    from daft_tpu.adapt import PLAN_CACHE as REF_PLAN_CACHE
    from daft_tpu.adapt import RESULT_CACHE as REF_RESULT_CACHE
    from daft_tpu.runners import partition_set_cache as ref_psets
    from daft_tpu_torch.adapt import HISTORY, PLAN_CACHE
    from daft_tpu_torch.runners import partition_set_cache

    for c in (REF_PLAN_CACHE, REF_HISTORY, REF_RESULT_CACHE, PLAN_CACHE, HISTORY,
              ref_psets(), partition_set_cache()):
        c.clear()


def adapt_counters(df) -> dict:
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS + ADAPT_COUNTERS}


def run_seq(seq, knobs=None, min_rows: int = 8):
    """``seq(pkg, set_knobs)`` through the reference, then through the port,
    each from emptied caches: the reference in the 32-bit device mode with
    ``knobs`` set on its config, the port under that config mapped
    (``device="cpu"``). ``set_knobs(**reference fields)`` changes the running
    package's config between the steps of a sequence. Returns [what the
    reference's seq returned, what the port's did]."""
    from daft_tpu_torch.context import _FROM_REFERENCE

    out = []
    clear_adapt()
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        saved = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        try:
            for k, v in (knobs or {}).items():
                setattr(cfg, k, v)
            d = dataclasses.asdict(cfg)

            def ref_set(**kw):
                for k, v in kw.items():
                    setattr(cfg, k, v)

            out.append(seq(daft_tpu, ref_set))
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))

    def port_set(**kw):
        daft_tpu_torch.set_execution_config(**{_FROM_REFERENCE[k]: v for k, v in kw.items()})

    clear_adapt()
    out.append(seq(daft_tpu_torch, port_set))
    clear_adapt()
    return out
