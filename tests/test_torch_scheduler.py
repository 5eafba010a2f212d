"""The port's partition scheduler (daft_tpu_torch/scheduler.py) against the
reference's (daft_tpu/scheduler.py, tests/test_scheduler.py).

Each case drives both packages' ``dispatch`` through the same scenario and
holds the same outcome: results in task order, the window bound, the
backlog's pulls, cancellation, an error's propagation, the admission
returned on an early close, the parked outputs' ``exec_inflight`` charge
and its settling, and the budget's backpressure. The scenarios order their
tasks with events and ledger conditions instead of sleeps, so no outcome
depends on timing.

The port-only cases hold the thread safety of the kernel layer under the
pool: ``nvcc.start``/``finish`` and ``fused_expr_sums.program``/``build``
driven by threads against a stand-in nvcc (one build for one source), the
launch counters under concurrent wrapper calls, and a ``DaftKernelError``
raised inside a pool worker reaching the caller.
"""

import copy
import threading
import time
import types

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from torch_parity import fresh_ledgers_and_faults, restore_port_config  # noqa: F401

PKGS = ("ref", "port")


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


class Pkg:
    """One package's scheduler, execution, table and ledger modules."""

    def __init__(self, which):
        if which == "ref":
            from daft_tpu import execution, scheduler
            from daft_tpu.micropartition import MicroPartition
            from daft_tpu.spill import MEMORY_LEDGER
            from daft_tpu.table import Table

            self.base_cfg = lambda: copy.copy(daft_tpu.context.get_context().execution_config)
        else:
            from daft_tpu_torch import execution, scheduler
            from daft_tpu_torch.micropartition import MicroPartition
            from daft_tpu_torch.spill import MEMORY_LEDGER
            from daft_tpu_torch.table import Table

            self.base_cfg = lambda: daft_tpu_torch.ExecutionConfig(device="cpu")
        self.execution, self.scheduler = execution, scheduler
        self.MicroPartition, self.Table, self.ledger = MicroPartition, Table, MEMORY_LEDGER

    def ctx(self, threads=4, backlog=-1, budget=None):
        c = self.base_cfg()
        c.executor_threads = threads
        c.max_task_backlog = backlog
        c.memory_budget_bytes = budget
        return self.execution.ExecutionContext(c, self.execution.RuntimeStats())

    def mp(self, i):
        return self.MicroPartition.from_table(self.Table.from_pydict({"x": [i]}))

    def mp_big(self, i, rows=4000):
        return self.MicroPartition.from_table(self.Table.from_pydict(
            {"x": list(range(rows)), "s": [f"pad-{i}-{j:06d}" * 4 for j in range(rows)]}))

    def task(self, part, fn, i, req=None):
        return self.scheduler.PartitionTask(part, fn, req, "t", i)


def _wait_for(cond, what: str) -> None:
    """Block until ``cond()`` holds (a condition, not a duration: the
    bound only turns a hang into a failure)."""
    end = time.monotonic() + 30.0
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"never reached: {what}")
        time.sleep(0.001)


def _x(p):
    return p.to_pydict()["x"][0]


@pytest.mark.parametrize("which", PKGS)
def test_results_in_task_order(which):
    # task 0 finishes only after task 3 has: the results still come in order
    k = Pkg(which)
    ctx = k.ctx()
    third_done = threading.Event()

    def fn(part):
        i = _x(part)
        if i == 0:
            assert third_done.wait(30)
        if i == 3:
            third_done.set()
        return part

    out = [_x(p) for p in k.scheduler.dispatch(
        (k.task(k.mp(i), fn, i) for i in range(12)), ctx)]
    ctx.shutdown_pool()
    assert out == list(range(12))


@pytest.mark.parametrize("which", PKGS)
def test_window_bounds_in_flight(which):
    # window = threads + backlog = 3; at most `threads` tasks run at once
    k = Pkg(which)
    ctx = k.ctx(threads=2, backlog=1)
    live, peak = [0], [0]
    lock = threading.Lock()

    def fn(part):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        with lock:
            live[0] -= 1
        return part

    out = list(k.scheduler.dispatch((k.task(k.mp(i), fn, i) for i in range(20)), ctx))
    ctx.shutdown_pool()
    assert len(out) == 20 and 1 <= peak[0] <= 2


@pytest.mark.parametrize("which", PKGS)
def test_backlog_limits_task_pulls(which):
    # window 2: the dispatcher never drains the source into its queue
    k = Pkg(which)
    ctx = k.ctx(threads=1, backlog=1)
    pulled = []

    def src():
        for i in range(10):
            pulled.append(i)
            yield k.task(k.mp(i), lambda p: p, i)

    g = k.scheduler.dispatch(src(), ctx)
    next(g)
    held = len(pulled)
    rest = [_x(p) for p in g]
    ctx.shutdown_pool()
    assert held <= 3 and rest == list(range(1, 10))


@pytest.mark.parametrize("which", PKGS)
def test_cancellation_raises(which):
    k = Pkg(which)
    ctx = k.ctx(threads=2)
    ctx.stats.cancel()
    with pytest.raises(k.execution.QueryCancelledError):
        list(k.scheduler.dispatch((k.task(k.mp(i), lambda p: p, i) for i in range(4)), ctx))
    ctx.shutdown_pool()
    assert k.scheduler.inflight_tasks() == 0


@pytest.mark.parametrize("which", PKGS)
def test_error_propagates_in_order(which):
    k = Pkg(which)
    ctx = k.ctx(threads=2, backlog=0)

    def fn(part):
        if _x(part) == 3:
            raise ValueError("boom")
        return part

    got = []
    with pytest.raises(ValueError, match="boom"):
        for p in k.scheduler.dispatch((k.task(k.mp(i), fn, i) for i in range(8)), ctx):
            got.append(_x(p))
    ctx.shutdown_pool()
    assert got == [0, 1, 2]


@pytest.mark.parametrize("which", PKGS)
def test_admission_returned_on_early_close(which):
    # each task asks for every CPU: a reservation leaked by the early close
    # would block the probe's admit
    k = Pkg(which)
    ctx = k.ctx(threads=1, backlog=2)
    req = k.execution.ResourceRequest(num_cpus=float(ctx.accountant.total_cpus))
    g = k.scheduler.dispatch((k.task(k.mp(i), lambda p: p, i, req) for i in range(10)), ctx)
    next(g)
    g.close()
    done = threading.Event()

    def probe():
        ctx.accountant.admit(req)
        ctx.accountant.release(req)
        done.set()

    threading.Thread(target=probe, daemon=True).start()
    assert done.wait(30), "an early close leaked an admission"
    ctx.shutdown_pool()


@pytest.mark.parametrize("which", PKGS)
def test_parked_output_charges_and_settles_on_pull(which):
    # the fast task's output waits behind the head: charged to exec_inflight
    # while parked, settled when the consumer pulls it
    k = Pkg(which)
    ctx = k.ctx(threads=2)

    def head(part):
        _wait_for(lambda: k.ledger.exec_inflight > 0, "the parked output's charge")
        return part

    g = k.scheduler.dispatch(iter([k.task(k.mp_big(0), head, 0),
                                   k.task(k.mp_big(1), lambda p: p, 1)]), ctx)
    next(g)
    parked = k.ledger.exec_inflight
    next(g)
    after = k.ledger.exec_inflight
    with pytest.raises(StopIteration):
        next(g)
    ctx.shutdown_pool()
    assert parked > 0 and after == 0 and k.ledger.exec_inflight_high_water > 0


@pytest.mark.parametrize("which", PKGS)
def test_parked_output_charge_settles_on_early_close(which):
    k = Pkg(which)
    ctx = k.ctx(threads=2)

    def head(part):
        _wait_for(lambda: k.ledger.exec_inflight > 0, "the parked output's charge")
        return part

    g = k.scheduler.dispatch(iter([k.task(k.mp_big(0), head, 0),
                                   k.task(k.mp_big(1), lambda p: p, 1)]), ctx)
    next(g)
    assert k.ledger.exec_inflight > 0
    g.close()  # the parked output is never pulled
    ctx.shutdown_pool()
    assert k.ledger.exec_inflight == 0


@pytest.mark.parametrize("which", PKGS)
def test_budget_backpressure_throttles_window(which):
    # budget 64 KiB: the exec cap (16 KiB) is below one output, so once an
    # output is parked the next submit drains the head instead
    k = Pkg(which)
    ctx = k.ctx(threads=4, budget=64 * 1024)
    got = [_x(p) for p in k.scheduler.dispatch(_stepped_tasks(k, 8), ctx)]
    stalls = ctx.stats.snapshot()["counters"].get("dispatch_backpressure_stalls", 0)
    ctx.shutdown_pool()
    assert got == [0] * 8 and stalls == 7 and k.ledger.exec_inflight == 0


def _stepped_tasks(k, n):
    """n tasks of one 2000-row output each, stepped: task i runs only once
    the source moves on to task i+1, and the source yields task i+1 only
    once task i's output is parked. Each submit after the first then finds
    one parked output above the exec cap: one stall per task after the
    first, in either package."""
    gates = [threading.Event() for _ in range(n)]

    def gated(i):
        def fn(part):
            assert gates[i].wait(30)
            return part
        return fn

    for i in range(n):
        if i:
            gates[i - 1].set()
            _wait_for(lambda: k.ledger.exec_inflight > 0, "a parked output")
        yield k.task(k.mp_big(i, rows=2000), gated(i), i)
    gates[n - 1].set()


def test_stall_counts_equal_in_both_packages():
    # the deterministic scenario above gives one stall per task after the
    # first in both packages
    counts = []
    for which in PKGS:
        k = Pkg(which)
        ctx = k.ctx(threads=4, budget=64 * 1024)
        list(k.scheduler.dispatch(_stepped_tasks(k, 6), ctx))
        counts.append(ctx.stats.snapshot()["counters"].get("dispatch_backpressure_stalls", 0))
        ctx.shutdown_pool()
        k.ledger.reset()
    assert counts[0] == counts[1] == 5


@pytest.mark.parametrize("which", PKGS)
def test_transient_error_retries_the_task(which):
    # a task that raises a transient error twice re-runs (task_retries 2)
    k = Pkg(which)
    ctx = k.ctx(threads=2)
    ctx.cfg.task_retry_backoff_s = 0.0
    err = (daft_tpu.errors if which == "ref" else daft_tpu_torch.errors).DaftTransientError
    tries = {}

    def fn(part):
        i = _x(part)
        tries[i] = tries.get(i, 0) + 1
        if i == 1 and tries[i] <= 2:
            raise err("flaky")
        return part

    out = [_x(p) for p in k.scheduler.dispatch((k.task(k.mp(i), fn, i) for i in range(3)),
                                               ctx)]
    ctx.shutdown_pool()
    assert out == [0, 1, 2] and tries[1] == 3
    assert ctx.stats.snapshot()["counters"]["task_retries"] == 2


# ---------------------------------------------------------------------------
# port only: the kernel layer under concurrent first use
# ---------------------------------------------------------------------------

def _stand_in_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc that appends each run to a file and writes an empty
    library (the tests replace ``nvcc.load``)."""
    from daft_tpu_torch.kernels import nvcc

    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    runs = tmp_path / "runs.txt"
    fake = bindir / "nvcc"
    fake.write_text('#!/bin/bash\n[ "$1" = --version ] && { echo stand-in; exit 0; }\n'
                    'out=""\nwhile [ $# -gt 0 ]; do case "$1" in\n'
                    '  -o) out="$2"; shift 2;;\n  *) shift;;\nesac; done\n'
                    f'echo run >> "{runs}"\n: > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    return runs


def _in_threads(fn, n=8):
    """``fn()`` on ``n`` threads released together; their results."""
    barrier = threading.Barrier(n)
    out, errs = [None] * n, []

    def run(i):
        barrier.wait()
        try:
            out[i] = fn()
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return out


def test_nvcc_one_build_for_one_source_across_threads(tmp_path, monkeypatch):
    from daft_tpu_torch.kernels import nvcc

    runs = _stand_in_nvcc(tmp_path, monkeypatch)
    sos = _in_threads(lambda: nvcc.finish(nvcc.start("// one source\n", "race")))
    assert len(set(sos)) == 1 and sos[0].exists()
    assert runs.read_text().count("run") == 1
    assert not nvcc._RUNNING
    # no temporary or log file is left beside the library
    assert sorted(p.suffix for p in (tmp_path / "build").iterdir()) == [".cu", ".so"]


def test_nvcc_failed_build_raises_on_every_thread(tmp_path, monkeypatch):
    from daft_tpu_torch.errors import DaftKernelError
    from daft_tpu_torch.kernels import nvcc

    _stand_in_nvcc(tmp_path, monkeypatch)
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.write_text('#!/bin/bash\n[ "$1" = --version ] && { echo stand-in; exit 0; }\n'
                    'echo "error: no"; exit 2\n')
    pending = nvcc.start("// broken\n", "race")

    def finish():
        with pytest.raises(DaftKernelError, match="nvcc failed"):
            nvcc.finish(pending)
        return True

    assert all(_in_threads(finish, n=6))


def test_fused_expr_sums_program_and_build_once_across_threads(tmp_path, monkeypatch):
    # threads asking for one new deep-kernel program at once get one program
    # object, one nvcc run and one library load
    import torch

    from daft_tpu_torch.expressions import col
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import nvcc
    from daft_tpu_torch.schema import Schema
    from daft_tpu_torch.table import Table

    runs = _stand_in_nvcc(tmp_path, monkeypatch)
    loads = []

    def fake_load(so):
        loads.append(so)
        return types.SimpleNamespace(fused_expr_sums_f32=types.SimpleNamespace(),
                                     fused_expr_sums_error_string=types.SimpleNamespace())

    monkeypatch.setattr(nvcc, "load", fake_load)
    schema = Table.from_pydict({"a": [1.5], "b": [2.5]}).schema
    assert isinstance(schema, Schema)
    pred = (col("a") > 0.73125)._node
    child = (col("a") * col("b") + 0.61875)._node
    dtypes = {"a": torch.float32, "b": torch.float32}
    before = len(fes.programs())
    progs = _in_threads(lambda: fes.program(pred, [child], schema, dtypes))
    assert len({id(p) for p in progs}) == 1
    assert len(fes.programs()) == before + 1
    libs = _in_threads(progs[0].build)
    assert len({id(lib) for lib in libs}) == 1
    assert len(loads) == 1 and runs.read_text().count("run") == 1


@pytest.mark.parametrize("kernel", ["segment_sums", "scatter_sums"])
def test_library_builds_once_across_threads(kernel, tmp_path, monkeypatch):
    from daft_tpu_torch.kernels import nvcc, scatter_sums, segment_sums

    mod = segment_sums if kernel == "segment_sums" else scatter_sums
    runs = _stand_in_nvcc(tmp_path, monkeypatch)
    loads = []

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    def fake_load(so):
        loads.append(so)
        return Lib()

    monkeypatch.setattr(nvcc, "load", fake_load)
    monkeypatch.setattr(mod, "_LIB", None)
    libs = _in_threads(mod.build)
    assert len({id(lib) for lib in libs}) == 1
    assert len(loads) == 1 and runs.read_text().count("run") == 1


def test_wrapper_counts_exact_under_threads():
    # ENTRIES is a counter of wrapper calls: 8 threads x 25 calls each
    import torch

    from daft_tpu_torch.kernels import scatter_sums, segment_sums

    codes = torch.zeros(1024, dtype=torch.int32)
    mask = torch.ones(1024, dtype=torch.float32)
    vals = torch.ones((1024, 2), dtype=torch.float32)
    fvals = torch.ones(1024, dtype=torch.float32)
    codes2, mask2 = codes[:, None], mask[:, None]
    e1, e2 = segment_sums.ENTRIES, scatter_sums.ENTRIES

    def work():
        for _ in range(25):
            segment_sums.masked_segment_sums_padded(codes2, mask2, vals, 4)
            scatter_sums.scatter_sum_kahan(fvals, codes, 4)
        return True

    _in_threads(work)
    assert segment_sums.ENTRIES - e1 == 200
    assert scatter_sums.ENTRIES - e2 == 200


def test_kernel_error_on_a_pool_worker_reaches_the_caller(monkeypatch):
    # K1 fails as a kernel that does not build would, inside the partitions
    # the pool runs (the first partition declines, so the rest fan out):
    # the error reaches collect, nothing finishes on the host
    from daft_tpu_torch.errors import DaftKernelError
    from daft_tpu_torch.kernels import segment_sums

    seen = []

    def broken(*a, **k):
        seen.append(threading.current_thread().name)
        raise DaftKernelError("K1 did not build")

    monkeypatch.setattr(segment_sums, "masked_segment_sums_padded", broken)
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
        device="cpu", device_min_rows=64, executor_threads=4, enable_result_cache=False))
    rng = np.random.default_rng(5)
    import pyarrow as pa

    tabs = [pa.table({"k": rng.integers(0, 4, n), "v": rng.random(n)})
            for n in [10] + [300] * 5]
    df = daft_tpu_torch.from_arrow(tabs).groupby("k").agg(
        daft_tpu_torch.col("v").sum().alias("s"))
    with pytest.raises(DaftKernelError, match="did not build"):
        df.collect()
    assert seen and all(n.startswith("daft-torch-exec") for n in seen)
    from daft_tpu_torch.scheduler import inflight_tasks

    assert inflight_tasks() == 0
