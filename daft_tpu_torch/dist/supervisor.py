"""Worker supervision: spawn, heartbeat, re-dispatch, bounded respawn (the
port's copy of daft_tpu/dist/supervisor.py).

The WorkerPool owns N spawned worker processes and is the driver side of
the dispatch-backend abstraction (scheduler.DispatchBackend): map-class
partition tasks route here, execute on a worker, and return — while the
pool treats worker death as a first-class event:

- **heartbeats with a deadline**: the supervision thread pings every
  worker each ``worker_heartbeat_interval_s``; no pong within
  ``worker_heartbeat_timeout_s`` (or a dead process, a severed socket, an
  injected ``worker.heartbeat`` fault) declares the worker dead.
- **WorkerHealth breaker per worker** (the DeviceHealth trip/cooldown/
  probe shape of execution.py): a slot that keeps dying trips its breaker and
  stops being respawned until the cooldown probe lets one attempt through.
- **bounded respawn**: respawns (never the initial spawns) consume the
  pool-wide ``worker_restart_budget``; an exhausted budget degrades the
  pool to local in-process execution instead of cycling forever.
- **task re-dispatch with exactly-once results**: each task carries an
  attempt count and an excluded-worker set. A worker death re-dispatches
  only tasks still in flight — results already acked into the driver-side
  ledger are never re-run. A poison task that kills every worker it
  touches fails its QUERY with a DaftError naming the task once it
  exhausts ``dist_task_max_attempts`` or has excluded every slot.

Each worker is ``python -m daft_tpu_torch.dist.worker`` under the driver's
config with a carved share of the memory budget (``_worker_cfg``); it runs
its tasks on the config's ``device``, so on the card every worker holds its
own CUDA context and launches the kernels itself.

Fault sites: ``worker.spawn``
fails a spawn attempt, ``worker.exec`` SIGKILLs the target worker at
dispatch (a REAL mid-query worker loss, deterministically placed),
``worker.heartbeat`` reads as a missed deadline, ``transport.send``
severs a link.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import pickle
import secrets
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..errors import DaftError, DaftTransientError
from ..execution import DeviceHealth
from ..obs.log import get_logger
from ..scheduler import DispatchBackend
from .transport import PROTOCOL_VERSION, TransportClosed, recv_msg, send_msg

logger = get_logger("dist")

# worker-side op-cache keys: process-wide monotonic, never reused (id()
# would alias across GC)
_OP_SEQ = itertools.count(1)

# speculative execution: completed-wall samples kept per op name (the
# running distribution the p75 straggler threshold is computed from), and
# the minimum sample count before speculation may trigger at all — with
# fewer completions the p75 is noise, and duplicating tasks on a cold
# pool would be pure added load
_WALL_HISTORY = 64
_SPECULATION_MIN_SAMPLES = 4


class WorkerHealth(DeviceHealth):
    """Per-worker circuit breaker: consecutive deaths trip it open (no
    respawn), the cooldown probe admits one respawn attempt, and a worker
    that comes back healthy re-closes it — the DeviceHealth contract
    applied to process supervision."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0):
        super().__init__(threshold, cooldown_s, kind="worker")


class _LocalFallback(Exception):
    """Internal: the pool cannot serve this task (degraded/closed) — the
    caller runs it in-process instead. Never escapes the backend."""


class _TaskEntry:
    """Driver-side ledger row for one dispatched task."""

    __slots__ = ("task_id", "op_name", "seq", "ctx", "attempts", "excluded",
                 "status", "result", "error", "event", "charged", "wid",
                 "active_wids", "spec_wid", "dispatched_at", "frag",
                 "frag_wid", "submit_pc", "sent_pc", "reply_pc", "extra",
                 "prefer", "result_wid")

    def __init__(self, task_id: int, op_name: str, seq: int, ctx):
        self.task_id = task_id
        self.op_name = op_name
        self.seq = seq
        self.ctx = ctx
        self.attempts = 0
        self.excluded: set = set()
        # inflight -> done | error | lost (lost = worker died; re-dispatch)
        self.status = "idle"
        self.result: Optional[Tuple] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.charged = 0
        self.wid: Optional[int] = None
        # worker slots currently executing this entry (>1 while a
        # speculative duplicate is in flight); the entry only reads as
        # LOST when the set empties — one of two runners dying is not a
        # loss, it is exactly what speculation pays for
        self.active_wids: set = set()
        # the duplicate's worker slot while one is in flight (None
        # otherwise); invariant: the pool-wide _spec_inflight counter
        # counts entries whose spec_wid is set
        self.spec_wid: Optional[int] = None
        # when the current primary dispatch left the driver — the clock
        # the straggler threshold compares against
        self.dispatched_at = 0.0
        # telemetry fragment from the settling reply (obs/cluster.py) and
        # the worker slot it came from; merged by _execute on the query
        # thread, where the dist.remote span is open
        self.frag = None
        self.frag_wid: Optional[int] = None
        # driver-side perf_counter stamps for the dist.remote phase split:
        # submit (dispatch entered) -> sent (frame on the wire) -> reply
        # (reply frame processed) — visible even when the fragment is lost
        self.submit_pc = 0
        self.sent_pc = 0
        self.reply_pc = 0
        # envelope extras merged into the task message (a peer-shuffle
        # fanout carries its split spec here instead of a map op)
        self.extra: Optional[dict] = None
        # peer-locality preference: worker slots already hosting this
        # task's input pieces (dispatch picks among these when one is
        # free, turning remote piece fetches into local store reads)
        self.prefer: Optional[set] = None
        # the slot whose RESULT settled the entry (the piece-hosting
        # worker for a fanout — survives speculation; wid does not)
        self.result_wid: Optional[int] = None


class _WorkerHandle:
    """One supervised worker slot (the slot identity survives respawns)."""

    __slots__ = ("wid", "proc", "sock", "state", "last_pong", "inflight",
                 "restarts", "deaths", "breaker", "send_lock", "ops_sent",
                 "rx_thread", "ledger_report", "pid", "tasks_done",
                 "telemetry_rx", "telemetry_dropped", "peer_addr",
                 "peer_report", "launches", "cfg_sent", "draining",
                 "drained")

    def __init__(self, wid: int, breaker: WorkerHealth):
        self.wid = wid
        self.proc: Optional[subprocess.Popen] = None
        self.sock: Optional[socket.socket] = None
        self.state = "dead"  # ready | dead | spawning (elastic growth)
        self.last_pong = 0.0
        self.inflight: Dict[int, _TaskEntry] = {}
        self.restarts = 0
        self.deaths = 0
        self.breaker = breaker
        # serializes frames onto this worker's socket — held across
        # the send by design (interleaved frames would desync rx)
        self.send_lock = threading.Lock()
        self.ops_sent: dict = {}  # insertion-ordered op-key window
        # the config this incarnation last received: a task of a query
        # under another config carries its own (the device path's knobs,
        # deep fusion, the 64-bit mode, device_min_rows, decide what the
        # worker launches)
        self.cfg_sent = None
        self.rx_thread: Optional[threading.Thread] = None
        self.ledger_report = {"current": 0, "high_water": 0}
        self.pid: Optional[int] = None
        self.tasks_done = 0
        # telemetry accounting for THIS incarnation (reset on respawn):
        # fragments received on replies vs the worker's pong-echoed tseq —
        # a positive gap is a fragment lost in flight (telemetry_dropped)
        self.telemetry_rx = 0
        self.telemetry_dropped = 0
        # peer-shuffle piece-server endpoint from the hello, and the
        # worker's pong-piggybacked piece-store snapshot (peerplane.py)
        self.peer_addr: Optional[Tuple[str, int]] = None
        self.peer_report: dict = {}
        # the worker's CUDA kernel launches, from its last pong
        # (worker.kernel_launches)
        self.launches: dict = {}
        # draining: quiescing on request (no new tasks; pieces still
        # served through the grace window); drained: the quiesce finished
        # — this slot's exit is NOT a worker loss
        self.draining = False
        self.drained = False


def _repo_root() -> str:
    from .. import __file__ as pkg_init

    return os.path.dirname(os.path.dirname(os.path.abspath(pkg_init)))


class WorkerPool(DispatchBackend):
    """Supervised pool of worker processes behind the scheduler's dispatch
    backend protocol (``capacity`` / ``try_execute``, and the peer-shuffle
    extension)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n = max(1, int(cfg.distributed_workers))
        # elastic bounds: with BOTH set the supervision loop scales the
        # live worker count inside [n_min, n_max] (admission-queue depth +
        # dispatch waiters push up, sustained idleness drains down);
        # unset keeps the fixed-size pool semantics exactly
        wmin = getattr(cfg, "distributed_workers_min", None)
        wmax = getattr(cfg, "distributed_workers_max", None)
        self._elastic = wmin is not None and wmax is not None
        self.n_min = max(1, int(wmin)) if self._elastic else self.n
        self.n_max = max(self.n_min, int(wmax)) if self._elastic else self.n
        if self._elastic:
            self.n = min(max(self.n, self.n_min), self.n_max)
        # the knob values this pool was built for (get_worker_pool's
        # rebuild predicate — self.n drifts under elasticity)
        self._cfg_key = (cfg.distributed_workers, wmin, wmax,
                         cfg.memory_budget_bytes)
        self._cond = threading.Condition()
        self._closed = False
        self._token = secrets.token_hex(16)
        self._task_seq = itertools.count(1)
        # handshakes are serialized: concurrent spawns would steal each
        # other's hello candidates off the shared listener. A stolen but
        # VALID hello for another slot is parked (wid -> (conn, hello))
        # for that slot's spawner rather than closed — closing it would
        # kill the sibling's worker mid-handshake
        self._spawn_lock = threading.Lock()
        self._parked: Dict[int, tuple] = {}
        # pool-wide counters (the cluster health / gauge surface)
        self.worker_losses_total = 0
        self.task_redispatches_total = 0
        self.tasks_dispatched_total = 0
        self.tasks_completed_total = 0
        self.local_fallbacks_total = 0
        self.restarts_used = 0
        self.restart_budget = max(0, int(cfg.worker_restart_budget))
        # telemetry fragments lost pool-wide: pong-gap detections, lost
        # in-flight replies at worker death (driver-side merge drops are
        # per-query RuntimeStats counters, not pool state)
        self.telemetry_dropped_total = 0
        # peer-shuffle plane: live shuffle ids (dropped at query finish),
        # and every payload byte the DRIVER shipped or received over the
        # task channel — the star-vs-p2p flatness gate's numerator
        self._shuffle_seq = itertools.count(1)
        self._live_shuffles: set = set()
        self.driver_payload_bytes_total = 0
        # elastic controller state: wids never reuse (a recycled wid
        # would alias a fresh worker into old tasks' excluded sets)
        self._next_wid = itertools.count(self.n)
        self.workers_drained_total = 0
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.last_scale_decision = "init"
        self._last_scale_at = 0.0
        self._idle_since = time.monotonic()
        self._acquire_waiters = 0
        self._scaling = False
        # speculative straggler mitigation: completed-wall history per op
        # (feeds the p75 threshold), the bounded count of duplicates in
        # flight, and the speculated/won totals
        self._op_walls: Dict[str, deque] = {}
        self._spec_inflight = 0
        self.tasks_speculated_total = 0
        self.speculation_wins_total = 0
        # transport frame checksums follow the integrity knob
        self._checksum = bool(getattr(cfg, "partition_integrity", True))
        # the listener the spawned workers dial back into
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.n_max + 4)
        self._port = self._listener.getsockname()[1]
        self._bthresh = max(1, int(cfg.device_breaker_threshold))
        self._bcool = float(cfg.device_breaker_cooldown_s)
        self.workers: List[_WorkerHandle] = [
            _WorkerHandle(i, WorkerHealth(self._bthresh, self._bcool))
            for i in range(self.n)]
        # the initial spawns run at once (each worker pays its interpreter's
        # import alone; the handshakes park for each other, see _spawn)
        def _initial(w):
            try:
                self._spawn(w, initial=True)
            except Exception as e:
                logger.warning("worker_initial_spawn_failed", worker=w.wid,
                               error=repr(e))

        spawners = [threading.Thread(target=_initial, args=(w,),
                                     name=f"daft-torch-dist-spawn-{w.wid}",
                                     daemon=True)
                    for w in self.workers]
        for t in spawners:
            t.start()
        for t in spawners:
            t.join()
        self._supervisor = threading.Thread(
            target=self._supervise_loop, name="daft-torch-dist-supervisor",
            daemon=True)
        self._supervisor.start()
        from ..obs.health import register_cluster

        register_cluster(self)

    # ------------------------------------------------------------- spawning
    def _worker_cfg(self, cfg=None):
        """The cfg a worker runs under (``cfg``, the pool's by default):
        never nested-distributed, one executor thread (one task at a
        time), no deadline of its own (the driver owns the query's), and a
        carved CHILD share of the global memory budget — the driver keeps
        one share, so all workers plus the driver together can never
        exceed it."""
        cfg = self.cfg if cfg is None else cfg
        share = None
        if self.cfg.memory_budget_bytes is not None:
            # carve by the elastic CEILING so the budget invariant holds
            # at any scale without respawning the fleet on a resize
            share = max(1, self.cfg.memory_budget_bytes // (self.n_max + 1))
        return dataclasses.replace(
            cfg, distributed_workers=0, memory_budget_bytes=share,
            executor_threads=1, enable_query_log=False,
            enable_profiling=False, diagnostics_dir=None,
            slow_query_threshold_s=None, execution_timeout_s=None)

    def _spawn(self, w: _WorkerHandle, initial: bool = False) -> None:
        """Spawn slot ``w``'s process and complete the handshake. Raises on
        failure (caller accounts budget/breaker); the ``worker.spawn``
        fault site fires per attempt."""
        from .. import faults

        with self._cond:
            if self._closed:
                raise DaftTransientError("worker pool is shut down")
        faults.check("worker.spawn")
        env = dict(os.environ)
        root = _repo_root()
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        # the worker readies the card before its hello (worker.ready_device)
        env["DAFT_TPU_TORCH_WORKER_DEVICE"] = str(self.cfg.device)
        proc = subprocess.Popen(
            [sys.executable, "-m", "daft_tpu_torch.dist.worker",
             "127.0.0.1", str(self._port), str(w.wid), self._token],
            env=env, cwd=root, stdout=subprocess.DEVNULL)
        deadline = time.monotonic() + float(self.cfg.worker_spawn_timeout_s)
        sock = None
        try:
            while True:
                # _spawn_lock guards ONLY the parked-handshake dict (held
                # for dict ops, never across IO): concurrent spawners may
                # all block in accept() on the shared listener — the OS
                # hands each connection to exactly one of them, and a
                # spawner that accepts a sibling's worker parks it below
                with self._spawn_lock:
                    parked = self._parked.pop(w.wid, None)
                if parked is not None:
                    # a sibling spawner already accepted and validated our
                    # worker's hello off the shared listener
                    cand, hello = parked
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise DaftTransientError(
                            f"worker {w.wid} spawn timed out")
                    # short accept timeout: a handshake parked for us by a
                    # sibling must be discovered within a second
                    self._listener.settimeout(min(remaining, 1.0))
                    try:
                        cand, _ = self._listener.accept()
                    except socket.timeout:
                        if proc.poll() is not None:
                            raise DaftTransientError(
                                f"worker {w.wid} exited rc={proc.returncode}"
                                " before handshake")
                        continue
                    except OSError:
                        # listener closed under us: shutdown raced in
                        raise DaftTransientError(
                            "worker pool shut down during spawn")
                    # the handshake read gets its own deadline: a client
                    # that connects and never speaks must time out instead
                    # of wedging every subsequent spawn
                    cand.settimeout(
                        min(max(deadline - time.monotonic(), 0.1), 5.0))
                    try:
                        hello = recv_msg(cand)
                    except Exception:
                        cand.close()
                        continue
                    if (hello.get("type") == "hello"
                            and hello.get("proto") != PROTOCOL_VERSION):
                        # old-frame peer (pre-checksum protocol) or a
                        # version skew: reject at the handshake — mixed-
                        # version frames would desync, and unverified
                        # payloads defeat the end-to-end integrity contract
                        logger.warning("worker_proto_rejected", worker=w.wid,
                                       got=hello.get("proto"),
                                       want=PROTOCOL_VERSION)
                        cand.close()
                        continue
                if (hello.get("type") == "hello"
                        and hello.get("token") == self._token
                        and hello.get("worker_id") == w.wid):
                    sock = cand
                    break
                other = hello.get("worker_id") if (
                    hello.get("type") == "hello"
                    and hello.get("token") == self._token) else None
                if isinstance(other, int) and other != w.wid:
                    # a concurrent spawn's worker dialed in while we held
                    # the listener: park its handshake for that spawner
                    with self._spawn_lock:
                        stale = self._parked.pop(other, None)
                        self._parked[other] = (cand, hello)
                    if stale is not None:
                        try:
                            stale[0].close()
                        except OSError:
                            pass
                    continue
                cand.close()  # stale/foreign connection: not ours
            # back to a blocking socket before init/rx handoff: the
            # handshake deadline must not apply to task traffic
            sock.settimeout(None)
            init_cfg = self._worker_cfg()
            send_msg(sock, {"type": "init", "cfg": init_cfg},
                     checksum=self._checksum)
        except BaseException:
            if sock is not None:
                sock.close()
            try:
                proc.kill()
                proc.wait(timeout=5)
            except Exception:
                pass
            raise
        with self._cond:
            if self._closed:
                # shutdown raced this spawn: shutdown() iterated the slots
                # before this worker existed, so nothing else will ever
                # reap it — kill it HERE or the zero-leak guarantee breaks
                closed = True
            else:
                closed = False
                w.proc = proc
                w.sock = sock
                w.pid = hello.get("pid")
                w.state = "ready"
                w.last_pong = time.monotonic()
                w.ops_sent = {}
                w.cfg_sent = init_cfg
                # a fresh incarnation's tseq starts at 0: reset the
                # per-incarnation telemetry accounting with it
                w.telemetry_rx = 0
                w.telemetry_dropped = 0
                peer_port = hello.get("peer_port")
                w.peer_addr = (("127.0.0.1", int(peer_port))
                               if peer_port else None)
                w.peer_report = {}
                w.launches = {}
                w.draining = False
                w.drained = False
                if not initial:
                    w.restarts += 1
                w.rx_thread = threading.Thread(
                    target=self._rx_loop, args=(w, sock),
                    name=f"daft-torch-dist-rx-{w.wid}", daemon=True)
                w.rx_thread.start()
                self._cond.notify_all()
        if closed:
            try:
                sock.close()
            except OSError:
                pass
            try:
                proc.kill()
                proc.wait(timeout=5)
            except Exception:
                pass
            raise DaftTransientError("worker pool shut down during spawn")
        w.breaker.record_success()
        logger.info("worker_ready", worker=w.wid, pid=w.pid,
                    respawn=not initial)

    # ------------------------------------------------------------- receive
    def _rx_loop(self, w: _WorkerHandle, sock: socket.socket) -> None:
        try:
            while True:
                msg = recv_msg(sock)
                kind = msg.get("type")
                if kind == "pong":
                    with self._cond:
                        if w.sock is sock:
                            w.last_pong = time.monotonic()
                            w.ledger_report = msg.get("ledger",
                                                      w.ledger_report)
                            peer = msg.get("peer")
                            if isinstance(peer, dict):
                                w.peer_report = peer
                            launches = msg.get("launches")
                            if isinstance(launches, dict):
                                w.launches = launches
                            tseq = msg.get("tseq")
                            if isinstance(tseq, int):
                                # the worker attached tseq fragments ever;
                                # any it sent that never arrived (and were
                                # not already counted) were dropped in
                                # flight — fail-open means we COUNT them,
                                # never chase them
                                gap = (tseq - w.telemetry_rx
                                       - w.telemetry_dropped)
                                if gap > 0:
                                    w.telemetry_dropped += gap
                                    self.telemetry_dropped_total += gap
                elif kind == "draining":
                    # SIGTERM landed on the worker itself (spot
                    # preemption): it finishes its current task, keeps
                    # serving pieces through the grace window, then
                    # exits — from here on it takes no new work and its
                    # exit reads as a drain, not a loss
                    with self._cond:
                        if w.sock is sock and w.state == "ready":
                            w.draining = True
                            self._cond.notify_all()
                    logger.info("worker_draining", worker=w.wid,
                                reason="sigterm")
                elif kind in ("result", "task_error", "task_skipped"):
                    self._on_task_reply(w, sock, msg)
        except TransportClosed:
            self._on_worker_death(w, sock, "connection closed")
        except Exception as e:
            # includes DaftCorruptionError from a checksum-failed frame:
            # a corrupt link is a dead link — re-dispatch owns recovery
            self._on_worker_death(w, sock, f"receiver failed: {e!r}")

    def _on_task_reply(self, w: _WorkerHandle, sock, msg: dict) -> None:
        cancel_targets: List[_WorkerHandle] = []
        reply_pc = time.perf_counter_ns()
        with self._cond:
            if w.sock is not sock:
                return  # a dead incarnation's straggler frame
            frag = msg.get("telemetry")
            if frag is not None:
                # counted on ARRIVAL (even a discarded speculative loser's
                # fragment arrived fine) so the pong-gap math only ever
                # flags frames that truly never made it
                w.telemetry_rx += 1
            entry = w.inflight.pop(msg["task_id"], None)
            if entry is None:
                return
            entry.active_wids.discard(w.wid)
            if msg["type"] == "task_skipped" or entry.status != "inflight":
                # a cancelled speculative loser (skipped before it started,
                # or its late result after the winner settled): the pop
                # above frees the slot; exactly-once — never re-applied
                self._cond.notify_all()
                return
            if msg["type"] == "result":
                entry.status = "done"
                entry.result = (msg["part"], msg["rows"], msg["wall_ns"])
                entry.result_wid = w.wid
                entry.frag = frag
                entry.frag_wid = w.wid
                entry.reply_pc = reply_pc
                w.tasks_done += 1
                self.tasks_completed_total += 1
                # feed the straggler threshold's running distribution
                self._op_walls.setdefault(
                    entry.op_name, deque(maxlen=_WALL_HISTORY)).append(
                    msg["wall_ns"] / 1e9)
            else:
                if entry.active_wids:
                    # another runner of this entry is still executing
                    # (speculation): DROP the failed runner instead of
                    # settling — "first result wins" means first RESULT,
                    # not first reply, and an erroring duplicate must
                    # never cancel healthy in-flight work (nor count as
                    # a speculation win)
                    if entry.spec_wid == w.wid:
                        entry.spec_wid = None
                        self._spec_inflight -= 1
                    elif entry.spec_wid is not None:
                        # the primary failed: the duplicate is now the
                        # worker of record
                        entry.wid = entry.spec_wid
                        entry.spec_wid = None
                        self._spec_inflight -= 1
                    self._cond.notify_all()
                    return
                err = None
                if msg.get("error") is not None:
                    try:
                        err = pickle.loads(msg["error"])
                    except Exception:
                        err = None
                if not isinstance(err, BaseException):
                    err = DaftError(
                        f"worker task failed: {msg.get('error_type')}: "
                        f"{msg.get('error_message')}")
                entry.status = "error"
                entry.error = err
                entry.frag = frag
                entry.frag_wid = w.wid
                entry.reply_pc = reply_pc
            spec_win = False
            if entry.spec_wid is not None:
                # a speculated entry settled: first result wins, the
                # still-running dispatch is the loser — cancel it (frees
                # its worker's queue slot if the task never started; a
                # mid-execution loser finishes and its result is dropped
                # by the exactly-once guard above)
                spec_win = (w.wid == entry.spec_wid)
                entry.spec_wid = None
                self._spec_inflight -= 1
                if spec_win:
                    self.speculation_wins_total += 1
                cancel_targets = [ow for ow in self.workers
                                  if ow.wid in entry.active_wids
                                  and ow.sock is not None]
            if entry.charged:
                entry.ctx.ledger.dist_done(entry.charged)
                entry.charged = 0
            self._cond.notify_all()
        if entry.status == "done":
            w.breaker.record_success()
        if spec_win:
            entry.ctx.stats.bump("speculation_wins")
            logger.warning("speculation_win", op=entry.op_name,
                           seq=entry.seq, worker=w.wid)
        for ow in cancel_targets:
            try:
                with ow.send_lock:
                    send_msg(ow.sock, {"type": "cancel",
                                       "task_id": entry.task_id},
                             checksum=self._checksum)
            except Exception:
                pass  # a dead loser settles through the death path
        entry.event.set()

    # ------------------------------------------------------------ death
    def _kill_worker(self, w: _WorkerHandle, reason: str) -> None:
        """SIGKILL the slot's process (the injected ``worker.exec`` chaos
        hook and the shutdown straggler path), then run the death flow."""
        with self._cond:
            proc, sock = w.proc, w.sock
        if proc is not None and proc.poll() is None:
            try:
                os.kill(proc.pid, signal.SIGKILL)
            except OSError:
                pass
        self._on_worker_death(w, sock, reason)

    def _on_worker_death(self, w: _WorkerHandle, sock, reason: str) -> None:
        """Declare slot ``w`` dead: reap the process, mark in-flight tasks
        lost (their waiters re-dispatch), inform the breaker and the
        per-query counters. Idempotent per incarnation."""
        with self._cond:
            if w.state != "ready" or (sock is not None and w.sock is not sock):
                # a stale incarnation's death (the slot already moved on):
                # still close ITS socket, or the rx thread that reported the
                # death stays blocked in recv() forever
                if sock is not None and sock is not w.sock:
                    try:
                        sock.close()
                    except OSError:
                        pass
                return
            if self._closed:
                # drain-mode shutdown: the worker exiting on request is not
                # a loss (no breaker failure, no counters, no warning)
                w.state = "dead"
                w.sock = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                return
            w.state = "dead"
            drained = w.draining
            if drained:
                # a graceful quiesce completing (drain_worker / SIGTERM):
                # no new tasks landed since the draining mark, peers had
                # the grace window to finish fetching, and its remaining
                # pieces re-source through lineage at the read site —
                # this exit is paid-for, not a failure (no breaker hit,
                # no worker_losses)
                w.draining = False
                w.drained = True
                self.workers_drained_total += 1
            else:
                w.deaths += 1
            dead_sock, proc = w.sock, w.proc
            w.sock = None
            entries = []
            for e in w.inflight.values():
                if e.status != "inflight":
                    continue  # a settled speculative loser parked here
                e.active_wids.discard(w.wid)
                if e.active_wids:
                    # a speculative duplicate (or the primary) of this
                    # entry is still running on another worker: the entry
                    # SURVIVES this death — exactly what the duplicate
                    # was dispatched to buy
                    if e.spec_wid == w.wid:
                        e.spec_wid = None
                        self._spec_inflight -= 1
                    elif e.spec_wid is not None:
                        # the primary died: the duplicate is now the
                        # worker of record (exclusion on a later loss)
                        e.wid = e.spec_wid
                        e.spec_wid = None
                        self._spec_inflight -= 1
                    continue
                if e.spec_wid is not None:
                    e.spec_wid = None
                    self._spec_inflight -= 1
                entries.append(e)
            w.inflight.clear()
            if not drained:
                self.worker_losses_total += 1
            affected = {}
            for e in entries:
                e.status = "lost"
                if e.charged:
                    e.ctx.ledger.dist_done(e.charged)
                    e.charged = 0
                affected[id(e.ctx)] = e.ctx
                if getattr(e.ctx.cfg, "cluster_telemetry", True):
                    # the in-flight task's would-be fragment died with the
                    # worker: counted, never chased — and the driver-side
                    # span around the remote wait still closes, so a lost
                    # fragment can never orphan a driver span
                    self.telemetry_dropped_total += 1
            self._cond.notify_all()
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass
        if proc is not None:
            try:
                proc.wait(timeout=5)
            except Exception:
                pass
        if dead_sock is not None:
            try:
                dead_sock.close()
            except OSError:
                pass
        if drained:
            # every query that lived through the drain records it (the
            # QueryRecord workers_drained event counter)
            from ..obs.cluster import active_query_stats

            for st in active_query_stats():
                st.bump("workers_drained")
            for e in entries:
                e.event.set()
            logger.info("worker_drained", worker=w.wid, reason=reason,
                        raced_inflight=len(entries))
            return
        w.breaker.record_failure()
        for ctx in affected.values():
            ctx.stats.bump("worker_losses")
        for e in entries:
            if getattr(e.ctx.cfg, "cluster_telemetry", True):
                e.ctx.stats.bump("telemetry_dropped")
        for e in entries:
            e.event.set()
        logger.warning("worker_lost", worker=w.wid, reason=reason,
                       inflight=len(entries))

    # ------------------------------------------------------- supervision
    def _supervise_loop(self) -> None:
        from .. import faults

        interval = max(0.05, float(self.cfg.worker_heartbeat_interval_s))
        timeout = max(float(self.cfg.worker_heartbeat_timeout_s),
                      2 * interval)
        while True:
            with self._cond:
                if self._closed:
                    return
            time.sleep(interval)
            self._elastic_step()
            with self._cond:
                fleet = list(self.workers)
            for w in fleet:
                with self._cond:
                    if self._closed:
                        return
                    state, sock, proc = w.state, w.sock, w.proc
                    stale = (state == "ready"
                             and time.monotonic() - w.last_pong > timeout)
                    if state == "dead" and w.drained:
                        continue  # a drained slot is retired, not sick
                if state == "ready":
                    if proc is not None and proc.poll() is not None:
                        self._on_worker_death(
                            w, sock, f"process exited rc={proc.returncode}")
                        continue
                    try:
                        faults.check("worker.heartbeat")
                    except DaftTransientError:
                        # injected missed-deadline: the supervision layer
                        # must behave exactly as if the worker went silent
                        self._kill_worker(w, "heartbeat fault injected")
                        continue
                    if stale:
                        self._kill_worker(w, "heartbeat deadline missed")
                        continue
                    try:
                        with w.send_lock:
                            send_msg(sock, {"type": "ping"},
                                     checksum=self._checksum)
                    except Exception as e:
                        self._on_worker_death(w, sock, f"ping failed: {e!r}")
                elif state == "dead":
                    self._maybe_respawn(w)

    def _maybe_respawn(self, w: _WorkerHandle) -> None:
        """Respawn a dead slot on a thread of its own: a spawn takes the new
        interpreter's import of the port and its device's readying (seconds
        on the card), and the supervise loop must go on pinging the live
        workers meanwhile, or their heartbeat deadlines pass. The slot reads
        ``spawning`` until the handshake settles it."""
        with self._cond:
            if self._closed or self.restarts_used >= self.restart_budget:
                return
            if w.state != "dead" or not w.breaker.allow():
                return  # tripped: wait out the cooldown probe
            self.restarts_used += 1  # the attempt consumes budget, not success
            w.state = "spawning"

        def _respawn():
            try:
                self._spawn(w)
            except Exception as e:
                with self._cond:
                    if w.state == "spawning":
                        w.state = "dead"
                w.breaker.record_failure()
                logger.warning("worker_respawn_failed", worker=w.wid,
                               error=repr(e),
                               budget_remaining=self.budget_remaining())
                if self.budget_remaining() <= 0:
                    logger.error("worker_pool_degraded",
                                 reason="restart budget exhausted",
                                 losses=self.worker_losses_total)

        threading.Thread(target=_respawn, name=f"daft-torch-dist-respawn-{w.wid}",
                         daemon=True).start()

    def budget_remaining(self) -> int:
        with self._cond:
            return max(0, self.restart_budget - self.restarts_used)

    # ----------------------------------------------------------- elastic
    def _elastic_step(self) -> None:
        """One scale decision per ``elastic_scale_interval_s``: demand =
        admission-queue depth + busy workers + dispatch waiters. Pressure
        grows the fleet toward ``n_max`` (a WARM FDO history — this
        process has completed queries before, so the traffic shape is
        known — jumps straight to max; a cold pool steps by one);
        fleet-wide idleness past ``elastic_idle_scale_down_s`` gracefully
        DRAINS one worker down toward ``n_min``. Drained/retired slots
        are pruned; fresh slots get never-reused wids."""
        if not self._elastic:
            return
        now = time.monotonic()
        interval = max(0.05, float(getattr(
            self.cfg, "elastic_scale_interval_s", 0.5)))
        if now - self._last_scale_at < interval:
            return
        self._last_scale_at = now
        try:
            from ..obs.health import admission_state

            queued = int((admission_state() or {}).get(
                "queued_queries", 0) or 0)
        except Exception:
            queued = 0
        with self._cond:
            if self._closed or self._scaling:
                return
            retired = [w for w in self.workers
                       if w.drained and w.state == "dead"]
            for w in retired:
                self.workers.remove(w)
            if retired:
                self.n = len(self.workers)
            live = [w for w in self.workers if not w.draining
                    and not w.drained]
            busy = sum(1 for w in live if w.inflight)
            demand = queued + busy + self._acquire_waiters
            n_live = len(live)
            grow = min(self.n_max - n_live,
                       max(demand - n_live, self.n_min - n_live))
            if grow > 0:
                if grow > 1 or demand > n_live:
                    # scaling UP under real pressure: with warm FDO
                    # history the traffic shape is a known repeat — jump;
                    # cold, step by one and let the next tick re-decide
                    try:
                        from ..adapt.history import HISTORY

                        warm = HISTORY.snapshot().get("queries", 0) > 0
                    except Exception:
                        warm = False
                    if not warm:
                        grow = min(grow, max(1, self.n_min - n_live))
                new = []
                for _ in range(grow):
                    w = _WorkerHandle(next(self._next_wid),
                                      WorkerHealth(self._bthresh,
                                                   self._bcool))
                    # "spawning", not the default "dead": the supervise
                    # loop would otherwise race a budgeted respawn of this
                    # slot against the scale-up thread's spawn — two
                    # processes for one wid, the loser's socket orphaned
                    w.state = "spawning"
                    self.workers.append(w)
                    new.append(w)
                self.n = len(self.workers)
                self.scale_ups_total += 1
                self.last_scale_decision = (
                    f"up+{len(new)} (queued={queued} busy={busy} "
                    f"waiters={self._acquire_waiters})")
                self._idle_since = now
                self._scaling = True
            elif (demand == 0 and n_live > self.n_min
                    and now - self._idle_since > float(getattr(
                        self.cfg, "elastic_idle_scale_down_s", 10.0))):
                # sustained idleness: gracefully retire ONE worker per
                # decision (prefer the emptiest piece store — its drain
                # strands the least to re-source)
                idle = [w for w in live if w.state == "ready"]
                if not idle:
                    return
                victim = min(idle, key=lambda h: (
                    h.peer_report.get("pieces_hosted", 0), h.tasks_done))
                self.scale_downs_total += 1
                self.last_scale_decision = f"down-1 (drain w{victim.wid})"
                self._idle_since = now
                self._scaling = True
                new = None
            else:
                if demand > 0:
                    self._idle_since = now
                return
        if new:
            def _grow_fleet(handles=new):
                try:
                    for w in handles:
                        try:
                            # fleet growth is capacity we asked for, not
                            # failure recovery: initial=True keeps it off
                            # the restart budget
                            self._spawn(w, initial=True)
                        except Exception as e:
                            with self._cond:
                                if w.state == "spawning":
                                    # hand the slot to the supervise
                                    # loop's budgeted respawn path
                                    w.state = "dead"
                            logger.warning("elastic_spawn_failed",
                                           worker=w.wid, error=repr(e))
                finally:
                    with self._cond:
                        self._scaling = False

            threading.Thread(target=_grow_fleet, daemon=True,
                             name="daft-torch-dist-scale-up").start()
            logger.info("elastic_scale_up", count=len(new),
                        queued=queued, busy=busy)
        else:
            def _shrink_fleet(wid=victim.wid):
                try:
                    self.drain_worker(wid)
                finally:
                    with self._cond:
                        self._scaling = False

            threading.Thread(target=_shrink_fleet, daemon=True,
                             name="daft-torch-dist-scale-down").start()
            logger.info("elastic_scale_down", worker=victim.wid)

    def drain_worker(self, wid: int) -> bool:
        """Gracefully quiesce one worker: stop routing tasks to it, wait
        out its in-flight work, then ask it to exit after the piece-serve
        grace window — a preemption that costs bounded recompute, never a
        failed query. The ``worker.drain`` fault site fires here; an
        injected fault (and a drain that times out) degrades to the
        SIGKILL/redispatch path, which the loss machinery already owns.
        Returns True when the worker exited as a drain."""
        from .. import faults

        with self._cond:
            w = next((x for x in self.workers if x.wid == wid), None)
            if w is None or w.state != "ready" or w.draining:
                return False
            w.draining = True
            self._cond.notify_all()
        logger.info("worker_drain_requested", worker=wid)
        try:
            faults.check("worker.drain")
        except DaftTransientError:
            with self._cond:
                w.draining = False
            self._kill_worker(w, "worker.drain fault injected")
            return False
        deadline = time.monotonic() + float(getattr(
            self.cfg, "worker_drain_timeout_s", 10.0))
        with self._cond:
            while (w.inflight and w.state == "ready"
                    and time.monotonic() < deadline):
                self._cond.wait(0.05)
            still_busy = bool(w.inflight) and w.state == "ready"
            sock, alive = w.sock, w.state == "ready"
        if still_busy:
            # its in-flight task outlived the drain window: this is the
            # bounded part of "bounded recompute" — kill and re-dispatch
            with self._cond:
                w.draining = False
            self._kill_worker(w, "drain timed out with task in flight")
            return False
        if not alive:
            return bool(w.drained)  # died mid-drain; death flow decided
        try:
            with w.send_lock:
                send_msg(sock, {"type": "drain"},
                         checksum=self._checksum)
        except Exception:
            pass  # a dead link settles through the death path
        grace = float(getattr(self.cfg, "worker_drain_grace_s", 2.0))
        exit_deadline = time.monotonic() + grace + max(
            5.0, float(getattr(self.cfg, "worker_drain_timeout_s", 10.0)))
        with self._cond:
            while w.state == "ready" and time.monotonic() < exit_deadline:
                self._cond.wait(0.1)
            alive = w.state == "ready"
        if alive:
            with self._cond:
                w.draining = False
            self._kill_worker(w, "drain grace expired without exit")
            return False
        return bool(w.drained)

    # --------------------------------------------------- dispatch backend
    def capacity(self) -> int:
        return self.n

    def _usable_locked(self) -> bool:
        if self._closed:
            return False
        if any(w.state == "ready" for w in self.workers):
            return True
        return self.restarts_used < self.restart_budget

    def _op_payload(self, op) -> Optional[Tuple[int, bytes]]:
        """(op_key, pickled map op with children stripped), cached on the
        op; None when the op cannot cross a process boundary (UDF closures
        and the like) — the task runs in-process instead. The key comes
        from a process-wide counter, NOT id(op): address reuse after GC
        would alias a new op to a dead op's worker-side cache entry."""
        cached = getattr(op, "_dist_payload", False)
        if cached is not False:
            return cached
        import copy

        try:
            clone = copy.copy(op)
            clone.children = []
            payload = (next(_OP_SEQ), pickle.dumps(
                clone, protocol=pickle.HIGHEST_PROTOCOL))
        except Exception:
            payload = None
        try:
            op._dist_payload = payload
        except Exception:
            pass
        return payload

    @staticmethod
    def _part_eligible(part) -> bool:
        # deferred op chains are driver-side closures; loaded tables and
        # plain scan tasks ship fine (the worker reads the file itself)
        return not getattr(part, "_pending", None)

    def try_execute(self, op, part, ctx, op_name: str, seq: int):
        """Execute one map task on a worker, blocking until a terminal
        result. Returns ``(out_partition, rows, wall_ns)`` or None when the
        task is ineligible / the pool is degraded (caller runs it
        in-process). Raises the task's real error, the poison-task
        DaftError, or the query's cancellation/timeout."""
        if getattr(op, "map_partition", None) is None:
            return None
        payload = self._op_payload(op)
        if payload is None or not self._part_eligible(part):
            return None
        with self._cond:
            if not self._usable_locked():
                self.local_fallbacks_total += 1
                ctx.stats.bump("dist_local_fallbacks")
                return None
        try:
            # serialize ONCE, up front: an unshippable partition (driver-
            # local prefetch state, exotic scan factories) is a decline,
            # never a worker death — and re-dispatches reuse the bytes
            part_bytes = pickle.dumps(part,
                                      protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            return None
        from .peerplane import peer_preference

        try:
            return self._execute(payload, part_bytes, ctx, op_name, seq,
                                 prefer=peer_preference(part))
        except _LocalFallback:
            with self._cond:
                self.local_fallbacks_total += 1
            ctx.stats.bump("dist_local_fallbacks")
            return None

    def execute_fanout(self, part, spec: dict, ctx, op_name: str,
                       seq: int):
        """Dispatch one peer-shuffle FANOUT task: the worker splits the
        source partition and parks the pieces in its local store
        (peerplane.execute_fanout); only piece metadata comes back.
        Returns ``(wid, (host, port), metas)`` naming the hosting slot,
        or None when the pool declines (the caller splits driver-side).
        Rides the whole _execute machinery, so re-dispatch, speculation,
        and exactly-once settle compose: a worker dying mid-fanout just
        re-stores the same deterministic pieces elsewhere."""
        if not self._part_eligible(part):
            return None
        with self._cond:
            if not self._usable_locked():
                self.local_fallbacks_total += 1
                ctx.stats.bump("dist_local_fallbacks")
                return None
        try:
            part_bytes = pickle.dumps(part,
                                      protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            return None
        from .peerplane import peer_preference

        try:
            metas, _rows, _wall = self._execute(
                None, part_bytes, ctx, op_name, seq,
                extra={"shuffle": spec}, prefer=peer_preference(part))
        except _LocalFallback:
            with self._cond:
                self.local_fallbacks_total += 1
            ctx.stats.bump("dist_local_fallbacks")
            return None
        return metas

    def _execute(self, payload, part_bytes, ctx, op_name: str, seq: int,
                 extra: Optional[dict] = None,
                 prefer: Optional[set] = None):
        entry = _TaskEntry(next(self._task_seq), op_name, seq, ctx)
        entry.extra = extra
        entry.prefer = prefer
        max_attempts = max(1, int(self.cfg.dist_task_max_attempts))
        while True:
            self._check_query(ctx)
            w = self._acquire_worker(entry, ctx)
            self._dispatch(entry, w, payload, part_bytes)
            self._wait(entry, ctx, payload, part_bytes)
            if entry.status == "done":
                out, rows, wall_ns = entry.result
                self._finish_telemetry(entry, ctx)
                ctx.stats.bump("dist_tasks")
                if extra is not None and "shuffle" in extra:
                    # resolve the hosting slot's piece-server endpoint:
                    # the pieces live on whichever worker's result
                    # settled the entry (speculation-proof)
                    with self._cond:
                        host = next((h for h in self.workers
                                     if h.wid == entry.result_wid), None)
                        addr = host.peer_addr if host is not None else None
                    if addr is None:
                        return None, rows, wall_ns
                    return (entry.result_wid, addr, out), rows, wall_ns
                rbytes = 0
                try:
                    rbytes = out.size_bytes() or 0
                except Exception:
                    rbytes = 0
                if rbytes:
                    # the reply payload transited the driver too: the
                    # other half of the star topology's O(cluster) bill
                    with self._cond:
                        self.driver_payload_bytes_total += rbytes
                    ctx.stats.bump("dist_driver_bytes", rbytes)
                return out, rows, wall_ns
            if entry.status == "error":
                # task_error replies piggyback telemetry too — the failing
                # task's counters/spans/logs are exactly the ones worth
                # having when queries get hard to debug
                self._finish_telemetry(entry, ctx)
                raise entry.error
            # lost: the worker died with this task in flight
            if entry.wid is not None:
                entry.excluded.add(entry.wid)
            with self._cond:
                live = {w.wid for w in self.workers if not w.drained}
            if ((live and entry.excluded >= live)
                    or entry.attempts >= max_attempts):
                # terminal: no further dispatch happens, so this loss is
                # NOT a re-dispatch — counting it here would over-report
                raise DaftError(
                    f"poison task {op_name}#{seq}: lost "
                    f"{entry.attempts} worker(s) "
                    f"(excluded slots {sorted(entry.excluded)}) — "
                    "refusing further re-dispatch")
            ctx.stats.bump("task_redispatches")
            with self._cond:
                self.task_redispatches_total += 1
            logger.warning("task_redispatch", op=op_name, seq=seq,
                           attempts=entry.attempts,
                           excluded=sorted(entry.excluded))

    def _finish_telemetry(self, entry: _TaskEntry, ctx) -> None:
        """Terminal-reply observability, on the query thread while the
        ``dist.remote`` span run_map_task opened is still this thread's
        innermost: stamp the driver-side phase split (submit -> sent ->
        reply — visible even when the worker's fragment was lost) and
        merge the piggybacked telemetry fragment (obs/cluster.py;
        strictly fail-open)."""
        prof = ctx.stats.profiler
        if prof.armed:
            sp = prof.current()
            if sp is not None:
                if entry.sent_pc and entry.submit_pc:
                    sp.add_phase("submit",
                                 max(0, entry.sent_pc - entry.submit_pc))
                if entry.reply_pc and entry.sent_pc:
                    sp.add_phase("remote_wait",
                                 max(0, entry.reply_pc - entry.sent_pc))
                sp.set_attr("worker", entry.frag_wid
                            if entry.frag_wid is not None else entry.wid)
                sp.set_attr("attempts", entry.attempts)
        if entry.frag is not None:
            from ..obs.cluster import merge_fragment

            frag, entry.frag = entry.frag, None
            merge_fragment(ctx, frag, entry.frag_wid
                           if entry.frag_wid is not None else -1)

    def _check_query(self, ctx) -> None:
        from ..execution import QueryCancelledError

        if ctx.stats.is_cancelled():
            raise QueryCancelledError(
                "query cancelled (distributed task)")
        ctx.check_deadline()

    def _acquire_worker(self, entry: _TaskEntry, ctx) -> _WorkerHandle:
        """Reserve a ready worker slot outside the task's excluded set
        (capacity one task per worker). Blocks until one frees up; raises
        _LocalFallback when the pool can no longer serve, and detects
        poison-by-exclusion without waiting."""
        while True:
            with self._cond:
                live = {w.wid for w in self.workers if not w.drained}
                if live and entry.excluded >= live:
                    raise DaftError(
                        f"poison task {entry.op_name}#{entry.seq}: lost "
                        f"{entry.attempts} worker(s) (every slot excluded)"
                        " — refusing further re-dispatch")
                if not self._usable_locked():
                    raise _LocalFallback
                ready = [w for w in self.workers
                         if w.state == "ready"
                         and not w.draining
                         and w.wid not in entry.excluded
                         and not w.inflight]
                if ready:
                    if entry.prefer:
                        # peer locality: a free slot already hosting this
                        # task's input pieces wins (fetches become local
                        # store reads); otherwise any free slot serves
                        hosts = [w for w in ready
                                 if w.wid in entry.prefer]
                        if hosts:
                            ready = hosts
                    w = min(ready, key=lambda h: h.tasks_done)
                    entry.status = "inflight"
                    entry.event.clear()
                    entry.wid = w.wid
                    entry.active_wids = {w.wid}
                    entry.spec_wid = None
                    w.inflight[entry.task_id] = entry
                    return w
                # nothing to wait FOR: no candidate slot is serving (ready
                # or finishing a task) and none can come back soon — every
                # dead candidate is budget-blocked or breaker-tripped
                # (waiting out a 30s cooldown would stall the query while
                # in-process execution is available). An elastic pool
                # below its ceiling is worth waiting on: the waiter count
                # below IS the scale-up controller's demand signal.
                candidates = [w for w in self.workers
                              if w.wid not in entry.excluded
                              and not w.draining and not w.drained]
                revivable = (self.restarts_used < self.restart_budget)
                respawn_pending = any(w.state == "spawning" for w in candidates) or (
                    revivable and any(w.state == "dead" and w.breaker.state != "open"
                                      for w in candidates))
                headroom = self._elastic and len(
                    [w for w in self.workers
                     if not w.draining and not w.drained]) < self.n_max
                if (not any(w.state == "ready" or w.inflight
                            for w in candidates)
                        and not respawn_pending and not headroom):
                    raise _LocalFallback
                self._acquire_waiters += 1
                try:
                    self._cond.wait(0.05)
                finally:
                    self._acquire_waiters -= 1
            self._check_query(ctx)

    def _dispatch(self, entry: _TaskEntry, w: _WorkerHandle, payload,
                  part_bytes: bytes, speculative: bool = False) -> None:
        from .. import faults

        # payload None = a peer-shuffle fanout (no map op crosses the
        # wire; entry.extra carries the split spec instead)
        op_key, op_bytes = payload if payload is not None else (None, b"")
        if not speculative:
            # a speculative duplicate is added capacity for the SAME
            # attempt: it must not consume the poison-task budget, and the
            # straggler clock keeps timing the original dispatch
            entry.attempts += 1
            entry.dispatched_at = time.monotonic()
            entry.submit_pc = time.perf_counter_ns()
        with self._cond:
            self.tasks_dispatched_total += 1
        try:
            faults.check("worker.exec", entry.ctx.stats)
        except DaftTransientError:
            # the chaos contract: an injected worker.exec fault IS a worker
            # loss — SIGKILL the process for real and let the re-dispatch
            # machinery (the thing under test) pick up the pieces
            self._kill_worker(w, "worker.exec fault injected")
            return
        with self._cond:
            # the worker may have died between acquire and here: its death
            # handler already marked the entry lost and settled any charge
            # — charging after that point would leak ledger bytes
            if entry.status != "inflight" or w.sock is None:
                if speculative:
                    # the entry settled (or this worker died) before the
                    # duplicate's frame ever left: unwind the reservation,
                    # or the slot would wait forever for a reply that can
                    # never come
                    w.inflight.pop(entry.task_id, None)
                    entry.active_wids.discard(w.wid)
                    if entry.spec_wid == w.wid:
                        entry.spec_wid = None
                        self._spec_inflight -= 1
                return
            sock = w.sock
            size = len(part_bytes)
            if size and not entry.charged:
                # charged once per entry, not per duplicate: the driver
                # ships the same payload twice but holds it once
                entry.charged = size
                entry.ctx.ledger.dist_started(size)
        msg = {"type": "task", "task_id": entry.task_id,
               "part": part_bytes}
        wcfg = self._worker_cfg(entry.ctx.cfg)
        if wcfg != w.cfg_sent:
            msg["cfg"] = wcfg
        if payload is not None:
            msg["op_key"] = op_key
        if entry.extra:
            msg.update(entry.extra)
        if getattr(entry.ctx.cfg, "cluster_telemetry", True):
            # the span-context propagation half of the telemetry plane:
            # the task envelope carries the query id (log attribution),
            # the dispatching op's identity (the splice anchor names it),
            # and whether the driver's query is profiled (the worker arms
            # a local profiler only then — unprofiled queries piggyback
            # counters + log tail only)
            from ..obs.log import current_query_id

            msg["telemetry"] = True
            msg["query_id"] = current_query_id()
            msg["op_name"] = entry.op_name
            msg["seq"] = entry.seq
            msg["profile"] = bool(entry.ctx.stats.profiler.armed)
        wire = len(part_bytes)
        if payload is not None and op_key not in w.ops_sent:
            msg["op"] = op_bytes
            wire += len(op_bytes)
        try:
            with w.send_lock:
                send_msg(sock, msg, checksum=self._checksum)
            if "cfg" in msg:
                w.cfg_sent = wcfg
            if not speculative:
                entry.sent_pc = time.perf_counter_ns()
            with self._cond:
                self.driver_payload_bytes_total += wire
            entry.ctx.stats.bump("dist_driver_bytes", wire)
            if payload is not None:
                # insertion-ordered window, capped BELOW the worker's op
                # cache so a key we omit op bytes for is always still
                # cached there
                w.ops_sent[op_key] = True
                while len(w.ops_sent) > 96:
                    w.ops_sent.pop(next(iter(w.ops_sent)))
        except Exception as e:
            self._on_worker_death(w, sock, f"task send failed: {e!r}")

    def _wait(self, entry: _TaskEntry, ctx, payload,
              part_bytes: bytes) -> None:
        """Block until the entry is terminal, keeping the query's
        cancellation/deadline semantics live while the work is remote —
        and watching for straggling: an entry past the speculation
        threshold gets a duplicate dispatched to a different worker. A
        query that dies here disowns the entry; a late result (or the
        worker's death) settles it without a waiter, exactly once."""
        while not entry.event.wait(0.05):
            self._check_query(ctx)
            self._maybe_speculate(entry, ctx, payload, part_bytes)

    def _maybe_speculate(self, entry: _TaskEntry, ctx, payload,
                         part_bytes: bytes) -> None:
        """Speculative straggler mitigation: when this entry has been
        running longer than ``speculation_quantile_factor`` x the op's
        running p75 completed wall (floor ``speculation_min_s``), dispatch
        a duplicate to a different idle worker. First result wins through
        the exactly-once ack ledger, the loser is cancelled, and
        pool-wide duplicates are bounded by ``speculation_max_inflight``
        so a sick fleet cannot double its own load."""
        # speculation knobs are PER-QUERY semantics: read the query's own
        # config, not the pool's spawn-time snapshot
        cfg = ctx.cfg
        if not getattr(cfg, "speculative_execution", True):
            return
        with self._cond:
            if (self._closed or entry.status != "inflight"
                    or entry.spec_wid is not None):
                return
            hist = self._op_walls.get(entry.op_name)
            if hist is None or len(hist) < _SPECULATION_MIN_SAMPLES:
                return
            walls = sorted(hist)
            p75 = walls[min(len(walls) - 1, (3 * len(walls)) // 4)]
            threshold = max(
                float(getattr(cfg, "speculation_min_s", 1.0)),
                float(getattr(cfg, "speculation_quantile_factor", 3.0))
                * p75)
            if time.monotonic() - entry.dispatched_at < threshold:
                return
            if self._spec_inflight >= max(
                    0, int(getattr(cfg, "speculation_max_inflight", 2))):
                return
            cands = [w for w in self.workers
                     if w.state == "ready" and not w.inflight
                     and w.wid not in entry.active_wids
                     and w.wid not in entry.excluded]
            if not cands:
                return
            w = min(cands, key=lambda h: h.tasks_done)
            entry.spec_wid = w.wid
            entry.active_wids.add(w.wid)
            w.inflight[entry.task_id] = entry
            self._spec_inflight += 1
            self.tasks_speculated_total += 1
        ctx.stats.bump("tasks_speculated")
        logger.warning("task_speculated", op=entry.op_name, seq=entry.seq,
                       worker=w.wid, threshold_s=round(threshold, 3))
        self._dispatch(entry, w, payload, part_bytes, speculative=True)

    # ------------------------------------------------------- peer plane
    def new_shuffle_id(self) -> int:
        """A fresh pool-unique shuffle id; registered live until its
        query's finish broadcasts the drop."""
        sid = next(self._shuffle_seq)
        with self._cond:
            self._live_shuffles.add(sid)
        return sid

    def peer_token(self) -> str:
        return self._token

    def peer_ready(self) -> bool:
        """Any ready worker with a piece-server endpoint? (The p2p branch
        stands down to the star path otherwise.)"""
        with self._cond:
            return any(w.state == "ready" and not w.draining
                       and w.peer_addr is not None
                       for w in self.workers)

    def drop_shuffles(self, sids) -> None:
        """Broadcast end-of-life for the given shuffle ids: every worker
        (and the driver's own store) frees the hosted pieces. Fire-and-
        forget — a worker that misses the drop frees at process exit."""
        sids = [s for s in sids]
        if not sids:
            return
        from .peerplane import plane

        plane().drop_shuffles(sids)
        with self._cond:
            for s in sids:
                self._live_shuffles.discard(s)
            targets = [w for w in self.workers
                       if w.state == "ready" and w.sock is not None]
        for w in targets:
            try:
                with w.send_lock:
                    send_msg(w.sock, {"type": "drop_shuffles",
                                      "ids": sids},
                             checksum=self._checksum)
            except Exception:
                pass  # a dead worker's pieces died with it

    # ------------------------------------------------------------ health
    def snapshot(self) -> dict:
        """The health() ``cluster`` section (mirrored as
        ``daft_tpu_cluster_*`` gauges)."""
        from .peerplane import plane

        peer = plane().snapshot()
        with self._cond:
            alive = sum(1 for w in self.workers if w.state == "ready")
            tripped = sum(1 for w in self.workers
                          if w.breaker.state == "open")
            inflight = sum(len(w.inflight) for w in self.workers)
            draining = sum(1 for w in self.workers if w.draining)
            # aggregate the workers' pong-piggybacked piece-store
            # snapshots over the driver's own (ensure_local pulls)
            for w in self.workers:
                for k, v in (w.peer_report or {}).items():
                    if k in peer and isinstance(v, int):
                        peer[k] += v
            peer["shuffles_active"] = len(self._live_shuffles)
            elastic = {
                "enabled": int(self._elastic),
                "workers_target": self.n,
                "workers_min": self.n_min,
                "workers_max": self.n_max,
                "draining": draining,
                "workers_drained_total": self.workers_drained_total,
                "scale_ups_total": self.scale_ups_total,
                "scale_downs_total": self.scale_downs_total,
                "last_scale_decision": self.last_scale_decision,
            }
            workers = {
                str(w.wid): {
                    "state": w.state,
                    "breaker": w.breaker.state,
                    "pid": w.pid,
                    "restarts": w.restarts,
                    "deaths": w.deaths,
                    "inflight": len(w.inflight),
                    "tasks_done": w.tasks_done,
                    "ledger_current": w.ledger_report.get("current", 0),
                    "ledger_high_water": w.ledger_report.get(
                        "high_water", 0),
                    "telemetry_rx": w.telemetry_rx,
                    "telemetry_dropped": w.telemetry_dropped,
                }
                for w in self.workers}
            return {
                "workers": self.n,
                "workers_alive": alive,
                "workers_restarting": self.n - alive - sum(
                    1 for w in self.workers
                    if w.state == "dead"
                    and self.restarts_used >= self.restart_budget),
                "workers_tripped": tripped,
                "tasks_inflight": inflight,
                "tasks_dispatched_total": self.tasks_dispatched_total,
                "tasks_completed_total": self.tasks_completed_total,
                "task_redispatches_total": self.task_redispatches_total,
                "worker_losses_total": self.worker_losses_total,
                "tasks_speculated_total": self.tasks_speculated_total,
                "speculation_wins_total": self.speculation_wins_total,
                "speculation_inflight": self._spec_inflight,
                "telemetry_dropped_total": self.telemetry_dropped_total,
                "driver_payload_bytes_total":
                    self.driver_payload_bytes_total,
                "workers_drained_total": self.workers_drained_total,
                "peer_plane": peer,
                "elastic": elastic,
                "local_fallbacks_total": self.local_fallbacks_total,
                "restarts_used": self.restarts_used,
                "restart_budget": self.restart_budget,
                "restart_budget_remaining": max(
                    0, self.restart_budget - self.restarts_used),
                "degraded": not self._usable_locked(),
                "worker_detail": workers,
            }

    def kernel_launches(self, wait_s: float = 5.0) -> Dict[int, dict]:
        """slot -> the CUDA launches of K1, K2 and the scatter kernel its
        current process reported, read from pongs that arrived after this
        call (waiting up to ``wait_s`` for every ready worker's next one)."""
        t0 = time.monotonic()
        deadline = t0 + wait_s
        with self._cond:
            while (any(w.state == "ready" and w.last_pong <= t0 for w in self.workers)
                    and time.monotonic() < deadline):
                self._cond.wait(0.05)
            return {w.wid: dict(w.launches) for w in self.workers if w.state == "ready"}

    def worker_pids(self) -> Dict[int, int]:
        """slot -> live pid (the kill-a-worker tests' target list)."""
        with self._cond:
            return {w.wid: w.pid for w in self.workers
                    if w.state == "ready" and w.pid is not None}

    def live_worker_processes(self) -> int:
        """Spawned worker processes still alive (0 after shutdown — the
        zero-leak assertion surface)."""
        with self._cond:
            procs = [w.proc for w in self.workers if w.proc is not None]
        return sum(1 for p in procs if p.poll() is None)

    # ---------------------------------------------------------- shutdown
    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Stop supervision, ask every worker to exit, SIGKILL stragglers,
        and fail over any still-waiting tasks to local execution."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            entries = [e for w in self.workers
                       for e in w.inflight.values()
                       if e.status == "inflight"]
            for w in self.workers:
                for e in list(w.inflight.values()):
                    if e.status == "inflight":
                        e.status = "lost"
                        if e.spec_wid is not None:
                            e.spec_wid = None
                            self._spec_inflight -= 1
                        if e.charged:
                            e.ctx.ledger.dist_done(e.charged)
                            e.charged = 0
                w.inflight.clear()
            self._cond.notify_all()
        for e in entries:
            e.event.set()
        deadline = time.monotonic() + timeout_s
        for w in self.workers:
            with self._cond:
                sock, proc = w.sock, w.proc
            if sock is not None:
                try:
                    with w.send_lock:
                        send_msg(sock, {"type": "shutdown"},
                                 checksum=self._checksum)
                except Exception:
                    pass
        for w in self.workers:
            with self._cond:
                proc = w.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                try:
                    proc.kill()
                    proc.wait(timeout=5)
                except Exception:
                    pass
        for w in self.workers:
            with self._cond:
                sock, w.sock, w.state = w.sock, None, "dead"
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        try:
            self._listener.close()
        except OSError:
            pass
        # _spawn_lock only guards the parked dict (held for dict ops, never
        # across IO), so shutdown can take it: the swap can't interleave
        # with a racing spawner's park, whose socket would otherwise leak
        # into the dropped dict
        with self._spawn_lock:
            parked, self._parked = self._parked, {}
        for cand, _hello in parked.values():
            try:
                cand.close()
            except OSError:
                pass
        if self._supervisor.is_alive():
            self._supervisor.join(timeout=max(
                0.1, deadline - time.monotonic()))
        for w in self.workers:
            if w.rx_thread is not None and w.rx_thread.is_alive():
                w.rx_thread.join(timeout=max(
                    0.05, deadline - time.monotonic()))
        logger.info("worker_pool_shutdown",
                    losses=self.worker_losses_total,
                    redispatches=self.task_redispatches_total,
                    restarts_used=self.restarts_used)


# ---------------------------------------------------------------------------
# process-wide pool lifecycle (one pool, rebuilt when the knobs change)
# ---------------------------------------------------------------------------

_POOL: Optional[WorkerPool] = None
_POOL_LOCK = threading.Lock()


def get_worker_pool(cfg) -> Optional[WorkerPool]:
    """The process's WorkerPool for ``cfg`` (spawned on first use; rebuilt
    when worker count or budget changes). None when distribution is off."""
    global _POOL
    if cfg.distributed_workers <= 0:
        return None
    with _POOL_LOCK:
        pool = _POOL
        if pool is not None and not pool._closed and (
                pool._cfg_key == (cfg.distributed_workers,
                                  getattr(cfg, "distributed_workers_min",
                                          None),
                                  getattr(cfg, "distributed_workers_max",
                                          None),
                                  cfg.memory_budget_bytes)):
            # adopt the caller's config for the tunables that need no
            # respawn (speculation knobs, driver-side frame checksums) —
            # worker-resident settings keep their spawn-time values
            pool.cfg = cfg
            pool._checksum = bool(getattr(cfg, "partition_integrity", True))
            return pool
        if pool is not None:
            pool.shutdown()
        _POOL = WorkerPool(cfg)
        return _POOL


def shutdown_worker_pool(timeout_s: float = 10.0) -> None:
    """Tear the process pool down. A worker whose driver exits without it
    reads the closed socket and exits on its own."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(timeout_s=timeout_s)


def worker_pool_snapshot() -> Optional[dict]:
    """The live pool's cluster snapshot, or None (idle): the health() hook,
    which never spawns a pool."""
    with _POOL_LOCK:
        pool = _POOL
    if pool is None or pool._closed:
        return None
    return pool.snapshot()


def live_worker_process_count() -> int:
    with _POOL_LOCK:
        pool = _POOL
    return 0 if pool is None else pool.live_worker_processes()
