"""The distributed worker's entry point: ``python -m daft_tpu_torch.dist.worker``
(the port's copy of daft_tpu/dist/worker.py).

One worker is one process the supervisor spawned. It readies the card
first, when the supervisor says it runs on one (``DAFT_TPU_TORCH_WORKER_DEVICE``:
the CUDA context and the K1 and scatter-sum libraries, so that none of it
lands inside the heartbeat window), then connects back to the driver's
listener, authenticates with the spawn token, receives its ExecutionConfig
(with a carved share of the memory budget) and serves tasks until told to
stop:

- a **reader thread** drains the socket: ``ping`` is answered at once (a
  busy worker still heartbeats), ``task`` queues for the main loop,
  ``cancel`` marks a queued task skippable (the losing side of a
  speculative duplicate), ``drop_shuffles`` frees a finished query's
  hosted pieces, ``drain`` quiesces, ``shutdown`` (or EOF) ends the
  process;
- the **main loop** runs one task at a time: unpickle the map op (cached
  per op key), run ``op.map_partition`` against a local ExecutionContext
  and ship the result or the error back. The ``worker.task`` fault site
  fires per execution and is armable from the parent's environment
  (``faults.ENV_FAULT_SPEC``).

The worker runs its tasks under the config's ``device``: on the card it
holds its own CUDA context and launches K1, K2 and the scatter kernel
itself; with ``device="cpu"`` (the tests) their plain versions run. A TPU
admits one process at a time, so the reference's workers compute on the
host; an H100 takes several processes' contexts at once.

Telemetry (obs/cluster.py): when the task envelope asks for it, the task
runs inside a :class:`TelemetryCollector` scope (a local Profiler when the
driver's query is profiled, a counter snapshot, a log capture) and the
bounded fragment it builds rides the ``result``/``task_error`` reply.
Fragments carry a sequence number (``tseq``) that pongs echo, so the
supervisor counts fragments lost in flight as ``telemetry_dropped``.
Building a fragment fails open: a defect ships the reply without one.

The worker decides no policy: retries, re-dispatch, deadlines and poison
detection live in the driver (supervisor.py). A worker that dies mid-task
stops answering, and the supervisor reads the silence as the failure.
"""

from __future__ import annotations

import os
import pickle
import queue
import signal
import socket
import sys
import threading
import time


# the kernel wrappers whose CUDA launches a pong reports (module, count)
_LAUNCH_COUNTS = {"k1": ("daft_tpu_torch.kernels.segment_sums", "LAUNCHES"),
                  "k2": ("daft_tpu_torch.kernels.fused_expr_sums", "LAUNCHES"),
                  "scatter": ("daft_tpu_torch.kernels.scatter_sums", "LAUNCHES"),
                  "scatter_f64": ("daft_tpu_torch.kernels.scatter_sums", "LAUNCHES_F64")}


def kernel_launches() -> dict:
    """This process's CUDA launches of K1, K2 and the scatter kernel so far
    (each wrapper's own count; 0 for a module never imported). Pongs carry
    them, so that the driver sees the kernels run inside its workers."""
    out = {}
    for key, (mod, attr) in _LAUNCH_COUNTS.items():
        m = sys.modules.get(mod)
        out[key] = int(getattr(m, attr, 0)) if m is not None else 0
    return out


def _execute_task(op, part, exec_ctx, msg: dict):
    """Run one map task against the worker-local ExecutionContext, inside
    a task-scope span when the task's telemetry collector armed a local
    profiler — the span is the root the driver splices the worker subtree
    under. The ``worker.task`` fault site fires per execution (the
    straggler and failure hook)."""
    from .. import faults
    from ..obs.log import get_logger

    prof = exec_ctx.stats.profiler
    sp = None
    if prof.armed:
        sp = prof.begin("worker.task", op=msg.get("op_name"),
                        part=msg.get("seq"), kind="bg")
    try:
        faults.check("worker.task")
        return op.map_partition(part, exec_ctx)
    except BaseException as e:
        # the worker's view of the failure, emitted INSIDE the telemetry
        # scope so the fragment's log tail relays it to the driver's ring
        get_logger("dist.worker").warning(
            "worker_task_failed", op=msg.get("op_name"),
            seq=msg.get("seq"), error=repr(e))
        raise
    finally:
        if sp is not None:
            prof.end(sp)


def _serve(sock: socket.socket, worker_id: int, token: str) -> int:
    # late imports: the module must be importable for argv parsing before
    # the (expensive) engine import decides the process's fate
    from .. import faults
    from ..context import get_context
    from ..obs.log import get_logger
    from .peerplane import PieceServer, execute_fanout, plane
    from .transport import _FLAG_CRC, PROTOCOL_VERSION, TransportClosed, \
        recv_msg, send_msg

    log = get_logger("dist.worker")
    # held across each framed reply by design: one socket, one frame
    # at a time (interleaved frames would desync the driver's reader)
    send_lock = threading.Lock()
    # the peer-shuffle piece server binds BEFORE the hello carries its
    # port: no dispatched reduce task can ever hold an unbound address
    peer_server = PieceServer(token)
    peer_server.start()
    # frame checksums MIRROR the driver's: every received frame's flag
    # byte updates this, so a driver-side cfg.partition_integrity toggle
    # flips both directions of traffic without a respawn. The hello
    # itself is always checksummed (both sides speak v2 or the handshake
    # rejects).
    checksum = [True]
    # fragments attached to replies, ever (the telemetry sequence number):
    # read and bumped ONLY under send_lock, so a pong echoing it can never
    # overtake the reply frame that carried the counted fragment — socket
    # FIFO then guarantees the driver sees the fragment before the seq
    tel_seq = [0]

    def reply(msg: dict, frag=None) -> None:
        with send_lock:
            if frag is not None:
                tel_seq[0] += 1
                msg["telemetry"] = frag
                msg["tseq"] = tel_seq[0]
            send_msg(sock, msg, checksum=checksum[0])

    reply({"type": "hello", "worker_id": worker_id, "pid": os.getpid(),
           "token": token, "proto": PROTOCOL_VERSION,
           "peer_port": peer_server.port})
    init = recv_msg(sock)
    if init.get("type") != "init":
        raise RuntimeError(f"expected init, got {init.get('type')!r}")
    cfg = init["cfg"]
    checksum[0] = bool(getattr(cfg, "partition_integrity", True))
    peer_server.checksum = checksum[0]
    ctx = get_context()
    ctx.execution_config = cfg
    # fault plans armed by the PARENT process via the environment (chaos
    # tooling's cross-process hook — e.g. a worker.task delay plan that
    # slows exactly this worker into a straggler)
    faults.arm_from_env(worker_id)

    from ..execution import ExecutionContext

    exec_ctx = ExecutionContext(cfg)
    # peer-plane identity + stats hook: fetch/refetch counters bumped
    # during piece pulls land on the worker's RuntimeStats and ride the
    # telemetry fragments back into the driver's per-query rollup
    plane().configure(worker_id, exec_ctx.stats)
    tasks: "queue.Queue" = queue.Queue()
    inflight = [0]
    op_cache: dict = {}
    # task ids cancelled by the driver (the losing side of a speculative
    # duplicate): queued-but-unstarted tasks are skipped with an explicit
    # task_skipped ack; a task already executing cannot be preempted —
    # the driver discards its late result through the exactly-once ledger
    cancelled: set = set()

    def ledger_report() -> dict:
        try:
            from ..spill import MEMORY_LEDGER

            snap = MEMORY_LEDGER.snapshot()
            return {"current": snap["current"],
                    "high_water": snap["high_water"]}
        except Exception:
            return {"current": 0, "high_water": 0}

    def read_loop() -> None:
        try:
            while True:
                msg, flags = recv_msg(sock, with_flags=True)
                checksum[0] = bool(flags & _FLAG_CRC)
                kind = msg.get("type")
                if kind == "ping":
                    with send_lock:
                        seq = tel_seq[0]
                    pong = {"type": "pong", "worker_id": worker_id,
                            "inflight": inflight[0],
                            "tseq": seq,
                            "ledger": ledger_report(),
                            "peer": plane().snapshot(),
                            "launches": kernel_launches()}
                    reply(pong)
                elif kind == "task":
                    inflight[0] += 1
                    tasks.put(msg)
                elif kind == "cancel":
                    # ids never reuse, so stale entries are harmless —
                    # but bound the set anyway (a cleared stale id at
                    # worst skips a skip: the task runs and the driver
                    # drops its result through the exactly-once ledger)
                    if len(cancelled) > 4096:
                        cancelled.clear()
                    cancelled.add(msg.get("task_id"))
                elif kind == "drop_shuffles":
                    # end-of-life broadcast for a query's shuffle pieces
                    plane().drop_shuffles(msg.get("ids", []))
                elif kind == "drain":
                    # graceful quiesce: queued AFTER any in-flight task,
                    # so current work finishes and replies first
                    tasks.put({"_drain": True})
                elif kind == "shutdown":
                    tasks.put(None)
                    return
        except TransportClosed:
            tasks.put(None)  # driver went away: exit cleanly
        except Exception as e:
            log.error("worker_reader_failed", error=repr(e))
            tasks.put(None)

    reader = threading.Thread(target=read_loop, name="daft-torch-dist-reader",
                              daemon=True)
    reader.start()

    # SIGTERM = spot preemption notice: tell the driver we are draining
    # (it stops routing tasks here), finish the current task, keep
    # serving hosted pieces through the grace window, then exit 0. The
    # handler only spawns a thread — the main thread may hold send_lock
    # when the signal lands, and a direct reply() would self-deadlock.
    def _on_sigterm(signum, frame):
        def _announce():
            try:
                reply({"type": "draining", "worker_id": worker_id})
            except Exception:
                pass
            tasks.put({"_drain": True})

        threading.Thread(target=_announce, name="daft-torch-dist-announce",
                         daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass  # non-main thread / exotic platform: drain stays driver-led

    while True:
        msg = tasks.get()
        if msg is None:
            break
        if msg.get("_drain"):
            # quiesce: no new tasks will arrive (the driver marked this
            # slot draining); hold the piece server open for the grace
            # window so peers finish their fetches, then leave — pieces
            # lost with us re-source from lineage at the read site
            log.info("worker_draining", worker=worker_id,
                     pieces=plane().snapshot()["pieces_hosted"])
            time.sleep(float(getattr(cfg, "worker_drain_grace_s", 2.0)))
            peer_server.close()
            break
        task_id = msg["task_id"]
        if task_id in cancelled:
            # speculative loser cancelled before this task ever started:
            # ack the skip so the driver frees the slot deterministically
            cancelled.discard(task_id)
            inflight[0] -= 1
            reply({"type": "task_skipped", "task_id": task_id})
            continue
        collector = None
        try:
            if "cfg" in msg:
                # a query under another config than the last one: the device
                # path's knobs decide what this worker launches
                cfg = msg["cfg"]
                ctx.execution_config = cfg
                exec_ctx = ExecutionContext(cfg)
                plane().configure(worker_id, exec_ctx.stats)
            spec = msg.get("shuffle")
            op = None
            if spec is None:
                op_key = msg["op_key"]
                if "op" in msg:
                    # (re-)insert at the end so eviction order tracks the
                    # driver's send order (its ops_sent window is smaller
                    # than this cache, so a key it omits is always still
                    # here)
                    op_cache.pop(op_key, None)
                    op_cache[op_key] = pickle.loads(msg["op"])
                    while len(op_cache) > 128:  # bounded across queries
                        op_cache.pop(next(iter(op_cache)))
                op = op_cache[op_key]
            part = msg["part"]
            if isinstance(part, (bytes, bytearray)):
                # the driver pre-serializes partitions once (re-dispatches
                # reuse the bytes); decode here
                part = pickle.loads(part)
            if msg.get("telemetry"):
                # per-task telemetry scope (obs/cluster.py): counter
                # snapshot + log capture always, a bounded local profiler
                # when the driver's query is profiled. Failing to BUILD
                # the scope must not fail the task (fail-open).
                try:
                    from ..obs.cluster import TelemetryCollector

                    collector = TelemetryCollector(
                        msg.get("query_id"), msg.get("op_name", "task"),
                        msg.get("seq", 0), exec_ctx.stats,
                        profile=bool(msg.get("profile")))
                except Exception:
                    collector = None
            def _run_map(op=op, part=part, msg=msg):
                return _execute_task(op, part, exec_ctx, msg)

            t0 = time.perf_counter_ns()
            # _execute_task fires the worker.task chaos hook: an armed
            # delay plan slows this worker (counted into the reported
            # wall), a failure plan becomes a task_error the driver's
            # retry machinery owns
            if collector is not None:
                with collector:
                    out = (execute_fanout(part, spec, exec_ctx)
                           if spec is not None else _run_map())
            else:
                out = (execute_fanout(part, spec, exec_ctx)
                       if spec is not None else _run_map())
            wall_ns = time.perf_counter_ns() - t0
            if spec is not None:
                # a fanout's reply is piece METADATA only — the payload
                # bytes stay parked in this process's piece store
                n = sum(m[1] for m in out)
            else:
                n = out.num_rows_or_none()
            reply({"type": "result", "task_id": task_id, "part": out,
                   "rows": n if n is not None else 0, "wall_ns": wall_ns},
                  frag=collector.fragment() if collector else None)
        except BaseException as e:  # a task failure must not kill the worker
            try:
                err_pickle = pickle.dumps(e)
            except Exception:
                err_pickle = None
            try:
                frag = collector.fragment() if collector else None
            except Exception:
                frag = None
            reply({"type": "task_error", "task_id": task_id,
                   "error": err_pickle, "error_type": type(e).__name__,
                   "error_message": str(e)[:2000]}, frag=frag)
        finally:
            inflight[0] -= 1
            # a cancel that raced an already-executing task left its id
            # parked in the set; the id is spent now — drop it
            cancelled.discard(task_id)
    return 0


# set by the supervisor: the device of the driver's config
DEVICE_ENV = "DAFT_TPU_TORCH_WORKER_DEVICE"


def ready_device(device: str) -> None:
    """Make the CUDA context and load K1's and the scatter kernel's
    libraries (built by nvcc where they are not on disk yet) before the
    hello: none of it may stall the reader thread inside the heartbeat
    window. The CPU needs nothing."""
    import torch

    if torch.device(device).type != "cuda":
        return
    torch.empty(1, device=device)
    from ..kernels import scatter_sums, segment_sums

    segment_sums.build()
    scatter_sums.build()


def main(argv) -> int:
    host, port, worker_id, token = (
        argv[0], int(argv[1]), int(argv[2]), argv[3])
    ready_device(os.environ.get(DEVICE_ENV, "cpu"))
    sock = socket.create_connection((host, port), timeout=30)
    sock.settimeout(None)
    try:
        return _serve(sock, worker_id, token)
    finally:
        try:
            sock.close()
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
