"""Deterministic, seeded fault injection for resilience testing (the port's
copy of daft_tpu/faults.py).

The recovery paths of the engine (the device path's fallback to the host,
the DeviceHealth breaker, the fusion compilers' declines, the join filter's
fail-open) guard real behaviour, yet none of them runs under healthy tests.
This registry makes them run on demand: code at a fault *site* calls
``check(site)``, and a test arms a plan that decides, per call, whether to
raise.

``SITES`` lists the sites the port wires; each has a ``check()`` caller in
the port (a registered site with no caller is dead surface). Arbitrary
names stay legal at run time: tests arm synthetic sites to exercise the
plans.

Plans are deterministic: ``always`` / ``first_n`` / ``nth`` fire by call
count; ``rate`` hashes (seed, site, call#), so one seed gives one failure
sequence on every run.

``arm_from_env`` arms the plans a parent process put in
``DAFT_TPU_TORCH_DIST_FAULT_SPEC``, in a distributed worker at its start.

A fired fault counts as ``faults_injected`` on the query's stats, records a
``fault_injected`` event in a profiled query and a ``fault:<site>`` instant
in an armed chrome trace.

The disarmed path is one module-global boolean test, so the engine pays
nothing when no plan is armed.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager
from typing import Dict, Optional

from .errors import DaftTransientError, DaftValueError

SITES = {
    "io.get": "each object-store read attempt (io/object_store.py IOClient.get, "
              "inside the retry loop: a failure retries under the client's "
              "RetryPolicy and counts in IO_STATS.retries)",
    "scan.read": "each scan-task read attempt (io/scan.py, inside the retry "
                 "loop: a failure retries up to scan_retry_attempts, then the "
                 "reader's error reaches the caller)",
    "collective.exchange": "each mesh all_to_all shuffle attempt "
                           "(parallel/mesh_exec.py; a failure counts against the "
                           "collective breaker and the shuffle takes the host path)",
    "device.kernel": "each device attempt (ExecutionContext._device_attempt: the "
                     "synchronous ones and each asynchronous launch); a failure "
                     "counts against the DeviceHealth breaker and the partition "
                     "takes the host path",
    "fuse.compile": "each map-chain fusion compile (fuse/compile.py; a failure "
                    "leaves the unfused op chain, never a query failure)",
    "fuse.segment": "each plan-segment compile and each resident handoff "
                    "(fuse/segment.py; either failure degrades to the staged "
                    "ops, never a query failure)",
    "join.filter": "each runtime-join-filter build feed and probe prune "
                   "(physical.py, exchange/joinfilter.py; a failure ships the "
                   "exchange unfiltered, never a query failure)",
    "spill.write": "each partition spill write (spill.py, synchronous or on the "
                   "async writer thread; a failure holds the partition in "
                   "memory)",
    "spill.readback": "each spilled-partition re-materialization (spill.py, a "
                      "consumer-thread read or an unspill readahead; errors "
                      "propagate to the drain consumer)",
    "spill.corrupt": "each landed spill IPC write (spill.py, synchronous or on "
                     "the async writer thread; an injected fault flips a real "
                     "bit in the written file after its checksum was recorded, "
                     "the disk-corruption hook behind detection and lineage "
                     "recompute)",
    "exchange.encode": "each exchange-payload encode attempt (exchange/encode.py; "
                       "a failure ships the piece raw, never a query failure)",
    "plancache.lookup": "each plan-cache consult (adapt/plancache.py; a failure "
                        "degrades to uncached planning: the warm path fails open, "
                        "never a query failure)",
    "prefetch.fetch": "each background scan-prefetch fetch (io/prefetch.py; "
                      "the error re-raises from the partition's read on the "
                      "consumer's thread, never retried: the scan's retry "
                      "policy runs inside the read, below this site)",
    "resultcache.lookup": "each sub-plan result-cache consult "
                          "(adapt/resultcache.py; a failure runs the prefix "
                          "plainly: fails open, never a query failure)",
    "batch.coalesce": "each dynamic-batching coalesce step (batch/executor.py; "
                      "a failure settles the buffered charge and degrades the "
                      "op to the per-partition UDF path, the same rows, never "
                      "a query failure)",
    "sketch.merge": "each stage-2 sketch merge (the HLL register max or the "
                    "quantile samples' concat, sketch/hll.py and "
                    "sketch/quantile.py; the error reaches the caller)",
    "collective.sketch": "each mesh register-merge collective (the max over the "
                         "slots, parallel/mesh_exec.py; a failure counts against "
                         "the collective breaker and the host merge takes over)",
    "actor.load": "each pinned-model actor-pool construction (batch/actors.py; "
                  "a failed model load surfaces as a DaftResourceError naming "
                  "the model, with no half-initialized pool left)",
    "worker.spawn": "each distributed-worker process spawn attempt "
                    "(dist/supervisor.py; a failure consumes restart budget "
                    "and the pool degrades, never hangs)",
    "worker.exec": "each task dispatch to a distributed worker "
                   "(dist/supervisor.py; an injected fault SIGKILLs the target "
                   "worker, the deterministic kill-a-worker-mid-query hook, and "
                   "the task re-dispatches to a surviving worker)",
    "worker.heartbeat": "each supervision-loop heartbeat check of one worker "
                        "(dist/supervisor.py; an injected fault reads as a "
                        "missed deadline: the worker is declared dead and its "
                        "in-flight tasks re-dispatch)",
    "worker.task": "each task execution on a distributed worker "
                   "(dist/worker.py; armable per worker through "
                   "DAFT_TPU_TORCH_DIST_FAULT_SPEC: a delay_s plan slows the "
                   "worker instead of failing it, the straggler hook behind "
                   "speculative execution)",
    "worker.drain": "each graceful worker drain request (dist/supervisor.py; "
                    "an injected fault degrades the drain to the SIGKILL and "
                    "re-dispatch path, never a hung quiesce)",
    "transport.send": "each framed send on the worker transport "
                      "(dist/transport.py; a failed send marks the connection "
                      "dead and the supervision layer re-dispatches)",
    "transport.corrupt": "each checksummed transport frame send "
                         "(dist/transport.py; an injected fault flips a real "
                         "bit in the payload after its crc was computed: the "
                         "receiver's verify raises DaftCorruptionError and the "
                         "supervision layer re-dispatches)",
    "telemetry.fragment": "each worker telemetry-fragment merge in the driver "
                          "(obs/cluster.py; an injected fault drops the "
                          "fragment: telemetry_dropped counts it, the task's "
                          "result is untouched and nothing re-dispatches)",
    "peer.fetch": "each peer-shuffle piece fetch at the read site "
                  "(dist/peerplane.py; an injected fault reads as a dead peer: "
                  "the fetcher recomputes the lost piece from its lineage "
                  "recipe, peer_refetches)",
}


class InjectedFault(DaftTransientError):
    """Raised by an armed fault plan. A transient engine error (an OSError),
    so the device path's catches treat it as a real transient failure."""


class FaultPlan:
    """Decides, per call, whether an armed site fires.

    Modes:
      - ``always``:  every call fails
      - ``first_n``: calls 1..n fail, then the site heals (n=1 is
                     fail-once-then-heal)
      - ``nth``:     exactly call #n fails (1-based)
      - ``rate``:    each call fails with probability ``rate``, decided by
                     sha256(seed, site, call#), deterministically
    """

    __slots__ = ("mode", "n", "rate", "seed", "exc", "message", "delay_s")

    def __init__(self, mode: str = "always", n: int = 1, rate: float = 0.0,
                 seed: int = 0, exc: type = InjectedFault,
                 message: str = "", delay_s: float = 0.0):
        if mode not in ("always", "first_n", "nth", "rate"):
            # a misconfigured plan is a caller bug, never a retryable fault
            raise DaftValueError(f"unknown fault mode {mode!r}")
        self.mode = mode
        self.n = n
        self.rate = rate
        self.seed = seed
        self.exc = exc
        self.message = message
        # a delay plan slows the site instead of failing it: a firing call
        # sleeps delay_s and returns
        self.delay_s = float(delay_s)

    def should_fire(self, site: str, call_no: int) -> bool:
        """call_no is 1-based: the first check() at an armed site is #1."""
        if self.mode == "always":
            return True
        if self.mode == "first_n":
            return call_no <= self.n
        if self.mode == "nth":
            return call_no == self.n
        digest = hashlib.sha256(f"{self.seed}:{site}:{call_no}".encode()).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64) < self.rate

    def __repr__(self) -> str:
        return f"FaultPlan({self.mode}, n={self.n}, rate={self.rate}, seed={self.seed})"


_lock = threading.Lock()
_plans: Dict[str, FaultPlan] = {}
_calls: Dict[str, int] = {}
_injected: Dict[str, int] = {}
# check() returns at once when nothing is armed
_armed = False


def arm(site: str, mode: str = "always", **kwargs) -> FaultPlan:
    """Arm a plan at a site, replacing any plan there and resetting the
    site's call and injection counts. Returns the plan."""
    global _armed
    plan = FaultPlan(mode, **kwargs)
    with _lock:
        _plans[site] = plan
        _calls[site] = 0
        _injected[site] = 0
        _armed = True
    return plan


def any_armed() -> bool:
    """True while any fault plan is armed."""
    return _armed


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site, or every site (and clear all counts) when None."""
    global _armed
    with _lock:
        if site is None:
            _plans.clear()
            _calls.clear()
            _injected.clear()
        else:
            _plans.pop(site, None)
        _armed = bool(_plans)


@contextmanager
def inject(site: str, mode: str = "always", **kwargs):
    """Scoped arming: ``with faults.inject("device.kernel", "first_n", n=2): ...``"""
    arm(site, mode, **kwargs)
    try:
        yield
    finally:
        disarm(site)


def check(site: str, stats=None) -> None:
    """Call at a fault site. Raises the armed plan's exception when the plan
    decides this call fails, else does nothing. ``stats`` (a RuntimeStats)
    gets a ``faults_injected`` bump per fired fault; a site without a
    per-query stats handle passes None and is still counted in
    ``snapshot()['injected']``."""
    if not _armed:
        return
    with _lock:
        plan = _plans.get(site)
        if plan is None:
            return
        _calls[site] = call_no = _calls.get(site, 0) + 1
        fire = plan.should_fire(site, call_no)
        if fire:
            _injected[site] = _injected.get(site, 0) + 1
    if not fire:
        return
    if stats is not None:
        stats.bump("faults_injected")
        if stats.profiler.armed:
            stats.profiler.event("fault_injected", site=site, call=call_no)
    from . import tracing

    tracing.add_instant(f"fault:{site}", {"call": call_no})
    if plan.delay_s > 0:
        import time

        time.sleep(plan.delay_s)
        return
    raise plan.exc(plan.message or f"injected fault at {site} (call #{call_no})")


# set by a parent process before it spawns workers, so that fault plans
# cross the process boundary (module-global plans do not): a JSON object, or
# a list of them, with site/mode/n/rate/seed/delay_s and an optional
# worker_id that scopes the plan to one worker slot
ENV_FAULT_SPEC = "DAFT_TPU_TORCH_DIST_FAULT_SPEC"


def arm_from_env(worker_id: Optional[int] = None) -> int:
    """Arm the plans of :data:`ENV_FAULT_SPEC` (the distributed worker's
    entry point calls this at startup). Returns how many were armed; a
    malformed spec arms nothing, so that a spec never crashes a worker."""
    import json
    import os

    raw = os.environ.get(ENV_FAULT_SPEC)
    if not raw:
        return 0
    try:
        specs = json.loads(raw)
    except ValueError:
        return 0
    if isinstance(specs, dict):
        specs = [specs]
    armed = 0
    for spec in specs:
        if not isinstance(spec, dict) or "site" not in spec:
            continue
        target = spec.get("worker_id")
        if target is not None and worker_id is not None and int(target) != int(worker_id):
            continue
        try:
            arm(spec["site"], spec.get("mode", "always"),
                n=int(spec.get("n", 1)), rate=float(spec.get("rate", 0.0)),
                seed=int(spec.get("seed", 0)),
                delay_s=float(spec.get("delay_s", 0.0)))
            armed += 1
        except Exception:
            continue
    return armed


def snapshot() -> dict:
    """The armed plans and each site's call and injection counts."""
    with _lock:
        return {
            "armed": {site: repr(p) for site, p in _plans.items()},
            "calls": dict(_calls),
            "injected": dict(_injected),
        }
