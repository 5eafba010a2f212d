"""Dynamic batching in the port (daft_tpu_torch/batch/, BatchedUdfOp) with
its device apply K13, held against daft_tpu on the CPU.

- tests/test_batch.py's non-streaming legs through both packages: the host
  and breaker-tripped legs at the three budgets (the same rows as with
  batching off, and as the reference's), the batch counts of each budget,
  device success, padded mode, the pinned actors (one instance shared by
  concurrent queries, warm across queries, unpinned by shutdown, LRU past
  ``model_cache_bytes``), the two fault sites (``batch.coalesce`` degrades
  to the same rows, ``actor.load`` raises the typed error and leaves no
  pool) and the ledger's settlement. Its streaming legs wait for the
  streaming executor (ROADMAP Queue 1 item 7) and its span and
  explain_analyze cases for the observability layer (item 6).
- K13 in the 32-bit mode: columns narrow as the reference's jitted apply
  narrows them with x64 off, so values float32 cannot hold (0.1, 1e8 + 1)
  come out with the reference's bits; in the 64-bit mode nothing narrows.
- The pinned difference: an exception raised by the model's
  ``apply_torch`` reaches the caller, where the reference's breaker takes
  any exception of ``apply_jax`` and applies the batch on the host.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import faults
from daft_tpu_torch.batch.actors import (model_pools_snapshot, pinned_model_count,
                                         shutdown_all_models)
from daft_tpu_torch.batch.coalesce import Coalescer
from daft_tpu_torch.batch.executor import BatchSettings, _next_bucket
from daft_tpu_torch.errors import DaftError, DaftResourceError
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.spill import MEMORY_LEDGER
from torch_parity import fresh_ledgers_and_faults, restore_port_config, under_both  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    from daft_tpu.batch.actors import shutdown_all_models as ref_shutdown_models

    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()
    ref_shutdown_models()
    shutdown_all_models()


# the reference's config for these cases (tests/test_batch.py's fixture and
# its non-streaming legs), in the 32-bit device mode; under_both maps it onto
# the port's (which has no streaming executor)
BASE = {"enable_result_cache": False, "dynamic_batching": True, "use_device_kernels": False,
        "streaming_execution": False}

_INIT_LOCK = threading.Lock()


class HostScorer:
    """A host-only model: no device apply, so the device path declines."""

    weight_bytes = 2048
    inits = 0

    def __init__(self):
        with _INIT_LOCK:
            HostScorer.inits += 1

    def __call__(self, v):
        return np.asarray(v.to_numpy(), dtype=np.float64) * 2.0 - 3.0


class DeviceScorer:
    """A device-capable model: ``apply_jax`` for the reference and
    ``apply_torch`` for the port mirror ``__call__``."""

    weight_bytes = 2048

    def __call__(self, v):
        return np.asarray(v.to_numpy(), dtype=np.float64) * 2.0 - 3.0

    @staticmethod
    def apply_jax(v):
        return v * 2.0 - 3.0

    @staticmethod
    def apply_torch(v):
        return v * 2.0 - 3.0


class BrokenScorer(DeviceScorer):
    """A device apply with a defect of the user's own."""

    @staticmethod
    def apply_jax(v):
        raise ValueError("bad model")

    @staticmethod
    def apply_torch(v):
        raise ValueError("bad model")


def _declare(pkg, cls, **kw):
    kw.setdefault("flush_ms", 10_000.0)  # no timer nondeterminism
    return pkg.batch_udf(return_dtype=pkg.DataType.float64(), **kw)(cls)


def _run(pkg, expr, n=4000, parts=4, values=None):
    vals = values if values is not None else [float(i) for i in range(n)]
    q = pkg.from_pydict({"v": vals}).into_partitions(parts).select(expr.alias("s")).collect()
    return q.to_pydict()["s"], q.stats.snapshot()["counters"]


def _set(pkg, **kw):
    """Change the running package's config."""
    if pkg is daft_tpu:
        cfg = daft_tpu.context.get_context().execution_config
        for k, v in kw.items():
            setattr(cfg, k, v)
    else:
        daft_tpu_torch.set_execution_config(**kw)


BATCH_COUNTERS = ("batches_formed", "batch_rows", "batch_capacity_rows", "batch_rows_padded",
                  "batch_flushes_budget", "batch_flushes_end", "batch_flushes_timer",
                  "batch_device_applies", "batch_device_fallbacks", "batch_coalesce_faults",
                  "device_breaker_trips", "faults_injected")


def _batch_counters(c: dict) -> dict:
    return {k: c.get(k, 0) for k in BATCH_COUNTERS}


def _arm(pkg, *args, **kw):
    (daft_tpu.faults if pkg is daft_tpu else faults).arm(*args, **kw)


def _disarm(pkg):
    (daft_tpu.faults if pkg is daft_tpu else faults).disarm()


# ---------------------------------------------------------------------------
# the byte-identity matrix, non-streaming
# ---------------------------------------------------------------------------

_BUDGETS = {"sub_partition": 100, "multi_partition": 600, "over_partition": 100_000}


@pytest.mark.parametrize("budget", sorted(_BUDGETS))
@pytest.mark.parametrize("leg", ["host", "breaker_tripped"])
def test_matrix_as_the_reference(budget, leg):
    knobs = dict(BASE)
    if leg == "breaker_tripped":
        # every device attempt fails: the breaker trips and every batch lands
        # on the pinned host instance
        knobs.update(use_device_kernels=True, device_breaker_threshold=1,
                     device_breaker_cooldown_s=600.0)

    def fn(pkg):
        scorer = (_declare(pkg, DeviceScorer, max_rows=_BUDGETS[budget], device=True)
                  if leg == "breaker_tripped"
                  else _declare(pkg, HostScorer, max_rows=_BUDGETS[budget]))
        if leg == "breaker_tripped":
            _arm(pkg, "device.kernel", "always")
        try:
            _set(pkg, dynamic_batching=False)
            off, c_off = _run(pkg, scorer(pkg.col("v")))
            _set(pkg, dynamic_batching=True)
            on, c_on = _run(pkg, scorer(pkg.col("v")))
        finally:
            _disarm(pkg)
        return off, on, _batch_counters(c_off), _batch_counters(c_on)

    ref, got = under_both(fn, knobs)
    assert got == ref
    off, on, c_off, c_on = got
    assert on == off == [float(i) * 2.0 - 3.0 for i in range(4000)]
    assert c_on["batches_formed"] > 0 and c_off["batches_formed"] == 0
    assert c_on["batch_device_applies"] == 0


def test_budget_shapes_batch_counts_as_the_reference():
    """Non-streaming, each partition of 1000 rows feeds the coalescer whole:
    a budget under a partition flushes each one alone, and a budget past
    the frame makes one end flush."""
    def fn(pkg):
        formed = {}
        for name, max_rows in sorted(_BUDGETS.items()):
            _, c = _run(pkg, _declare(pkg, HostScorer, max_rows=max_rows)(pkg.col("v")))
            formed[name] = (c.get("batches_formed", 0), c.get("batch_flushes_budget", 0),
                            c.get("batch_flushes_end", 0))
        return formed

    ref, got = under_both(fn, BASE)
    assert got == ref == {"multi_partition": (4, 4, 0), "over_partition": (1, 0, 1),
                          "sub_partition": (4, 4, 0)}


def test_device_success_as_the_reference():
    """The model's device apply runs every batch (K13 through the plain
    torch ops on the CPU here), with values float32 holds exactly, so the
    rows equal the host instance's."""
    def fn(pkg):
        scorer = _declare(pkg, DeviceScorer, max_rows=100_000, device=True)
        _set(pkg, dynamic_batching=False)
        off, _ = _run(pkg, scorer(pkg.col("v")))
        _set(pkg, dynamic_batching=True)
        on, c = _run(pkg, scorer(pkg.col("v")))
        return off, on, _batch_counters(c)

    ref, got = under_both(fn, {**BASE, "use_device_kernels": True})
    assert got == ref
    off, on, c = got
    assert on == off and c["batch_device_applies"] == c["batches_formed"] == 1
    assert c["batch_device_fallbacks"] == 0


def test_padded_mode_as_the_reference():
    def fn(pkg):
        scorer = _declare(pkg, HostScorer, max_rows=100_000, mode="padded")
        _set(pkg, dynamic_batching=False)
        off, _ = _run(pkg, scorer(pkg.col("v")), n=3000, parts=3)
        _set(pkg, dynamic_batching=True)
        on, c = _run(pkg, scorer(pkg.col("v")), n=3000, parts=3)
        return off == on, _batch_counters(c)

    ref, got = under_both(fn, BASE)
    assert got == ref
    # 3000 rows pad to the 4096 bucket: 1096 synthetic rows, sliced off
    assert got[0] and got[1]["batch_rows_padded"] == 1096
    assert got[1]["batch_capacity_rows"] == 4096


def test_declines_to_the_host_instance():
    """No apply_torch, device kernels off, or no execution context on the
    thread: the device path declines and the host instance applies."""
    from daft_tpu_torch.batch.actors import get_model_pool
    from daft_tpu_torch.batch.device import device_apply

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        enable_result_cache=False)
    s = daft_tpu_torch.Series.from_pylist([1.0, 2.0], "v")
    assert device_apply(get_model_pool(DeviceScorer, None), [s], 2) is None  # no context
    _, c = _run(daft_tpu_torch, _declare(daft_tpu_torch, HostScorer, device=True)(
        daft_tpu_torch.col("v")))
    assert c.get("batch_device_applies", 0) == 0 and c.get("batch_device_fallbacks", 0) == 0
    # streaming off: one executor for the whole query, as the reference's
    # tests/test_batch.py pins it (a stream gives each producer its own)
    daft_tpu_torch.set_execution_config(use_device_kernels=False, streaming_execution=False)
    _, c = _run(daft_tpu_torch, _declare(daft_tpu_torch, DeviceScorer, device=True)(
        daft_tpu_torch.col("v")))
    assert c.get("batch_device_applies", 0) == 0 and c.get("batches_formed", 0) == 1


# ---------------------------------------------------------------------------
# pinned model actors
# ---------------------------------------------------------------------------

def test_three_concurrent_queries_share_one_actor():
    daft_tpu_torch.set_execution_config(device="cpu", enable_result_cache=False,
                                        use_device_kernels=False)
    HostScorer.inits = 0
    scorer = _declare(daft_tpu_torch, HostScorer, max_rows=100_000)
    want = [float(i) * 2.0 - 3.0 for i in range(4000)]
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = _run(daft_tpu_torch, scorer(daft_tpu_torch.col("v")))[0]
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert all(results[i] == want for i in range(3))
    assert HostScorer.inits == 1 and pinned_model_count() == 1
    (pool,) = model_pools_snapshot()
    assert pool["applies"] >= 3 and pool["weight_bytes"] == HostScorer.weight_bytes


def test_model_warm_across_queries_and_shutdown_unpins_as_the_reference():
    def fn(pkg):
        from importlib import import_module

        actors = import_module(f"{pkg.__name__}.batch.actors")
        ledger = import_module(f"{pkg.__name__}.spill").MEMORY_LEDGER
        HostScorer.inits = 0
        scorer = _declare(pkg, HostScorer, max_rows=100_000)
        for _ in range(3):
            _run(pkg, scorer(pkg.col("v")), n=100, parts=1)
        pinned = (HostScorer.inits, actors.pinned_model_count(),
                  ledger.snapshot()["model_cache_bytes"])
        actors.shutdown_all_models()
        return pinned, (actors.pinned_model_count(), ledger.snapshot()["model_cache_bytes"])

    ref, got = under_both(fn, BASE)
    assert got == ref == ((1, 1, HostScorer.weight_bytes), (0, 0))


def test_lru_eviction_over_budget_as_the_reference():
    def fn(pkg):
        from importlib import import_module

        actors = import_module(f"{pkg.__name__}.batch.actors")
        actors.get_model_pool(HostScorer, None)
        first = actors.pinned_model_count()
        actors.get_model_pool(DeviceScorer, None)  # admits, evicts the LRU (Host)
        return first, [p["fingerprint"].split("|")[0].rsplit(".", 1)[1]
                       for p in actors.model_pools_snapshot()]

    ref, got = under_both(fn, {**BASE, "model_cache_bytes": 3000})
    assert got == ref == (1, ["DeviceScorer"])


# ---------------------------------------------------------------------------
# fault sites and the ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,n", [("always", None), ("first_n", 1)])
def test_coalesce_fault_degrades_as_the_reference(mode, n):
    def fn(pkg):
        from importlib import import_module

        ledger = import_module(f"{pkg.__name__}.spill").MEMORY_LEDGER
        scorer = _declare(pkg, HostScorer, max_rows=600)
        _set(pkg, dynamic_batching=False)
        want, _ = _run(pkg, scorer(pkg.col("v")))
        _set(pkg, dynamic_batching=True)
        _arm(pkg, "batch.coalesce", mode, **({"n": n} if n else {}))
        try:
            got, c = _run(pkg, scorer(pkg.col("v")))
        finally:
            _disarm(pkg)
        return got == want, _batch_counters(c), ledger.snapshot()["batch_inflight"]

    ref, got = under_both(fn, BASE)
    assert got == ref
    same, c, inflight = got
    assert same and inflight == 0 and c["batch_coalesce_faults"] == 1
    # the first fault degrades the op's one executor for the rest of the query
    assert c["batches_formed"] == 0


def test_actor_load_fault_is_typed_and_leaves_no_pool_as_the_reference():
    def fn(pkg):
        from importlib import import_module

        actors = import_module(f"{pkg.__name__}.batch.actors")
        ledger = import_module(f"{pkg.__name__}.spill").MEMORY_LEDGER
        errors = import_module(f"{pkg.__name__}.errors")
        scorer = _declare(pkg, HostScorer, max_rows=100_000)
        _arm(pkg, "actor.load", "always")
        try:
            with pytest.raises(errors.DaftError) as ei:
                _run(pkg, scorer(pkg.col("v")), n=100, parts=1)
        finally:
            _disarm(pkg)
        failed = (type(ei.value).__name__, "HostScorer" in str(ei.value),
                  actors.pinned_model_count(), ledger.snapshot()["batch_inflight"])
        healed, _ = _run(pkg, scorer(pkg.col("v")), n=100, parts=1)  # the site heals
        return failed, healed == [float(i) * 2.0 - 3.0 for i in range(100)], \
            actors.pinned_model_count()

    ref, got = under_both(fn, BASE)
    assert got == ref == (("DaftResourceError", True, 0, 0), True, 1)
    assert issubclass(DaftResourceError, DaftError)


def test_batched_query_settles_the_ledger():
    daft_tpu_torch.set_execution_config(device="cpu", enable_result_cache=False)
    _run(daft_tpu_torch, _declare(daft_tpu_torch, HostScorer, max_rows=100_000)(
        daft_tpu_torch.col("v")))
    snap = MEMORY_LEDGER.snapshot()
    assert snap["batch_inflight"] == 0
    assert snap["batch_inflight_high_water"] > 0  # the buffers really were charged


def test_coalescer_settles_through_the_ledger():
    co = Coalescer(max_rows=10, max_bytes=1 << 40, flush_ms=1e9, ledger=MEMORY_LEDGER)
    part = MicroPartition.from_pydict({"x": list(range(6))})
    assert not co.feed(part)  # buffered: the charge is outstanding
    assert MEMORY_LEDGER.snapshot()["batch_inflight"] > 0
    (f,) = co.feed(part)  # 12 rows >= 10: a budget flush
    assert f.reason == "budget" and f.rows == 12
    co.settle(f)
    assert MEMORY_LEDGER.snapshot()["batch_inflight"] == 0


def test_abandoned_query_settles_the_ledger():
    """A limit above the op closes its stream with partitions still
    buffered: ``abort`` settles their charge."""
    daft_tpu_torch.set_execution_config(device="cpu", enable_result_cache=False)
    scorer = _declare(daft_tpu_torch, HostScorer, max_rows=100_000)
    out = (daft_tpu_torch.from_pydict({"v": [float(i) for i in range(400)]}).into_partitions(4)
           .select(scorer(daft_tpu_torch.col("v")).alias("s")).limit(5).to_pydict())
    assert out["s"] == [float(i) * 2.0 - 3.0 for i in range(5)]
    assert MEMORY_LEDGER.snapshot()["batch_inflight"] == 0


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_next_bucket_power_of_two():
    from daft_tpu.batch.executor import _next_bucket as ref_next_bucket

    for n in (1, 8, 9, 3000, 4097):
        assert _next_bucket(n) == ref_next_bucket(n)
    assert [_next_bucket(n) for n in (1, 8, 9, 3000)] == [8, 8, 16, 4096]


def test_settings_declaration_overrides_config():
    cfg = daft_tpu_torch.ExecutionConfig(batch_max_rows=1111, batch_padding="ragged")
    s = BatchSettings.resolve({"max_rows": 7, "mode": "padded"}, cfg)
    assert (s.max_rows, s.mode, s.max_bytes) == (7, "padded", cfg.batch_max_bytes)
    d = BatchSettings.resolve(None, cfg)
    assert (d.max_rows, d.mode) == (1111, "ragged")


def test_timer_flush_with_injected_clock():
    now = [0.0]
    co = Coalescer(max_rows=10**9, max_bytes=1 << 40, flush_ms=25.0, clock=lambda: now[0])
    part = MicroPartition.from_pydict({"x": [1, 2]})
    assert co.feed(part) == []
    now[0] = 0.024  # under the deadline: still buffering
    assert co.feed(part) == []
    now[0] = 0.050  # the oldest is 50 ms old: the stale run flushes first
    (f,) = co.feed(part)
    assert f.reason == "timer" and f.rows == 4
    (tail,) = co.finish()
    assert tail.reason == "end" and tail.rows == 2


def test_batch_udf_rejects_bad_declarations_as_the_reference():
    for pkg in (daft_tpu, daft_tpu_torch):
        with pytest.raises(ValueError, match="batching mode"):
            pkg.batch_udf(return_dtype=pkg.DataType.float64(), mode="diagonal")(HostScorer)
        with pytest.raises(ValueError, match="unknown batching key"):
            pkg.udf(return_dtype=pkg.DataType.float64(), batching={"rows": 3})(HostScorer)


# ---------------------------------------------------------------------------
# K13: the narrowing and the failures
# ---------------------------------------------------------------------------

# values float32 cannot hold: their narrowed result differs from the host's
NARROW_VALUES = [0.1, 1e8 + 1, -2.5, 123456789.123, 1.0 / 3.0, 7.0]


@pytest.mark.parametrize("x64", [False, True])
def test_k13_narrows_as_the_reference(x64):
    """The device apply's output bits equal the reference's jitted apply's:
    narrowed to float32 in the 32-bit mode, at full width in x64 (where it
    equals the host instance)."""
    import struct

    from torch_parity import run_both

    def build(pkg):
        scorer = _declare(pkg, DeviceScorer, max_rows=100_000, device=True)
        return pkg.from_pydict({"v": NARROW_VALUES}).select(scorer(pkg.col("v")).alias("s"))

    knobs = None if x64 else {"dynamic_batching": True}
    ref, got = run_both(build, min_rows=8, x64=x64, knobs=knobs)

    def bits(vals):
        return [struct.pack("<d", v) for v in vals]

    host = [v * 2.0 - 3.0 for v in NARROW_VALUES]
    g, r = got.to_pydict()["s"], ref.to_pydict()["s"]
    assert bits(g) == bits(r)
    c = got.stats.snapshot()["counters"]
    assert c.get("batch_device_applies", 0) == 1
    if x64:
        assert bits(g) == bits(host)
    else:
        narrowed = (np.asarray(NARROW_VALUES, np.float32) * np.float32(2.0)
                    - np.float32(3.0)).astype(np.float64)
        assert bits(g) == bits(narrowed.tolist()) and bits(g) != bits(host)


# columns whose staged numpy dtype is not their kind's: an int64 column with
# nulls stages as float64 with NaN (to float32), a uint64 one as uint64 (to
# uint32, wrapping 2**32 + 7); 16777217 and 2**31 + 5 float32 cannot hold
NARROW_STAGED = {
    "nullable_int64": pa.array([1, None, 2**31 + 5, 16777217, -7], pa.int64()),
    "uint64": pa.array([0, 1, 2**32 - 1, 2**31 + 3, 16777217, 2**32 + 7], pa.uint64()),
}


@pytest.mark.parametrize("case", sorted(NARROW_STAGED))
def test_k13_narrows_by_the_staged_dtype(case):
    """In the 32-bit mode K13 narrows each column as jax narrows the array
    it is handed, by its numpy dtype, so the output has the reference's
    bits (nulls where the reference has them)."""
    import struct

    from torch_parity import run_both

    def build(pkg):
        scorer = _declare(pkg, DeviceScorer, max_rows=100_000, device=True)
        frame = pkg.from_arrow(pa.table({"v": NARROW_STAGED[case]}))
        return frame.select(scorer(pkg.col("v")).alias("s"))

    ref, got = run_both(build, min_rows=8, knobs={"dynamic_batching": True})

    def bits(vals):
        return [None if v is None else struct.pack("<d", v) for v in vals]

    g, r = got.to_pydict()["s"], ref.to_pydict()["s"]
    assert bits(g) == bits(r)
    assert got.stats.snapshot()["counters"].get("batch_device_applies", 0) == 1


def test_user_apply_error_reaches_the_caller_where_the_reference_applies_on_the_host():
    """The pinned difference: the port's device attempt takes only
    execution.DEVICE_FAILURES; the user's own error is not one, so it
    reaches the caller. The reference takes any exception of apply_jax and
    applies the batch on the host instance (one ``batch_device_fallbacks``)."""
    def fn(pkg):
        scorer = _declare(pkg, BrokenScorer, max_rows=100_000, device=True)
        try:
            out, c = _run(pkg, scorer(pkg.col("v")), n=100, parts=1)
        except ValueError as e:
            return "raised", str(e)
        return out == [float(i) * 2.0 - 3.0 for i in range(100)], \
            c.get("batch_device_fallbacks", 0)

    ref, got = under_both(fn, {**BASE, "use_device_kernels": True})
    assert ref == (True, 1)
    assert got == ("raised", "bad model")


def test_injected_device_fault_applies_on_the_host():
    """A DEVICE_FAILURES member (the injected ``device.kernel`` fault) sends
    the batch to the host instance, counted, as in the reference."""
    def fn(pkg):
        scorer = _declare(pkg, DeviceScorer, max_rows=100_000, device=True)
        _arm(pkg, "device.kernel", "first_n", n=1)
        try:
            out, c = _run(pkg, scorer(pkg.col("v")), n=100, parts=1)
        finally:
            _disarm(pkg)
        return out == [float(i) * 2.0 - 3.0 for i in range(100)], _batch_counters(c)

    ref, got = under_both(fn, {**BASE, "use_device_kernels": True})
    assert got == ref
    assert got[0] and got[1]["batch_device_fallbacks"] == 1 and got[1]["faults_injected"] == 1
