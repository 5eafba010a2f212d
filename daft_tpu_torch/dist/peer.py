"""Host allgather between the processes of a torch.distributed cluster
(the port's copy of daft_tpu/dist/peer.py).

The mesh's exchange between processes rides ``all_to_all_single`` over the
process group (``nccl`` on the card, ``gloo`` on the CPU). When that
collective fails (or the collective breaker is open), the engine still needs
a data plane: this module gives the N processes of one cluster a host-side
allgather over TCP, so that the shuffle can move rows between processes
without the collective backend (``mesh_exec._transport_shuffle``).

Topology: a star. Process 0 hosts the hub (bound on the coordinator's port
plus one, or DAFT_TPU_TORCH_PEER_PORT); every other process dials in once
and keeps the connection. One ``allgather(payload)`` round: each process
sends its bytes, the hub collects all N contributions (its own included)
and broadcasts the list in rank order. Every process issues the same rounds
in the same order, the contract the collective exchange already has, and
round ids are checked so that a desync fails loudly. Frames are those of
transport.py (checksummed).
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time
from typing import List, Optional

from ..errors import DaftTransientError
from ..obs.log import get_logger
from .transport import TransportClosed, recv_msg, send_msg

logger = get_logger("dist.peer")

# how long one allgather round may wait on the slowest peer before the
# caller's breaker/fallback machinery takes over
ROUND_TIMEOUT_S = 300.0


class PeerGroup:
    """One process's handle on the cluster-wide allgather plane."""

    def __init__(self, host: str, port: int, nproc: int, pid: int):
        self.host = host
        self.port = port
        self.nproc = nproc
        self.pid = pid
        self._round = 0
        # serializes collective rounds end-to-end: held across the
        # round's socket traffic by design (rounds must not interleave)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._hub: Optional["_Hub"] = None
        self._local_q: Optional[queue.Queue] = None
        if pid == 0:
            self._hub = _Hub(host, port, nproc)
            self._local_q = self._hub.local_q

    def allgather(self, payload: bytes,
                  timeout_s: float = ROUND_TIMEOUT_S) -> List[bytes]:
        """All processes' payloads for this round, pid-ordered. Raises
        DaftTransientError when a peer goes away / times out — callers
        degrade exactly like a failed collective."""
        with self._lock:
            rnd = self._round
            self._round += 1
            if self.pid == 0:
                self._hub.ensure_started(timeout_s)
                reply: "queue.Queue" = queue.Queue()
                self._local_q.put((rnd, payload, reply))
                try:
                    out = reply.get(timeout=timeout_s)
                except queue.Empty:
                    raise DaftTransientError(
                        f"peer allgather round {rnd} timed out on the hub")
                if isinstance(out, BaseException):
                    raise out
                return out
            sock = self._connect(timeout_s)
            try:
                send_msg(sock, {"type": "ag", "round": rnd, "pid": self.pid,
                                "data": payload})
                msg = recv_msg(sock)
            except (TransportClosed, OSError) as e:
                self._drop_socket()
                raise DaftTransientError(
                    f"peer allgather failed: {e!r}") from e
            if msg.get("type") != "agr" or msg.get("round") != rnd:
                self._drop_socket()
                raise DaftTransientError(
                    f"peer allgather desync: expected round {rnd}, got "
                    f"{msg.get('type')}/{msg.get('round')}")
            return msg["datas"]

    def _connect(self, timeout_s: float) -> socket.socket:
        if self._sock is not None:
            return self._sock
        deadline = time.monotonic() + min(timeout_s, 60.0)
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=5.0)
                s.settimeout(timeout_s)
                send_msg(s, {"type": "join", "pid": self.pid})
                self._sock = s
                return s
            except OSError as e:
                last = e
                time.sleep(0.2)
        raise DaftTransientError(
            f"could not reach peer hub {self.host}:{self.port}: {last!r}")

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class _Hub:
    """Process 0's collector/broadcaster (lazy: binds on first round)."""

    def __init__(self, host: str, port: int, nproc: int):
        self.host = host
        self.port = port
        self.nproc = nproc
        self.local_q: "queue.Queue" = queue.Queue()
        self._started = False
        self._start_lock = threading.Lock()
        self._peers: dict = {}
        self._error: Optional[Exception] = None

    def ensure_started(self, timeout_s: float) -> None:
        with self._start_lock:
            if self._started:
                if self._error is not None:
                    raise DaftTransientError(
                        f"peer hub failed: {self._error!r}")
                return
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((self.host, self.port))
            listener.listen(self.nproc + 2)
            self._listener = listener
            t = threading.Thread(target=self._serve,
                                 name="daft-torch-dist-peer-hub", daemon=True)
            t.start()
            self._started = True

    def _serve(self) -> None:
        try:
            self._listener.settimeout(ROUND_TIMEOUT_S)
            while len(self._peers) < self.nproc - 1:
                sock, _ = self._listener.accept()
                sock.settimeout(ROUND_TIMEOUT_S)
                join = recv_msg(sock)
                if join.get("type") != "join":
                    sock.close()
                    continue
                self._peers[join["pid"]] = sock
            while True:
                # one round: the local contribution names the round id;
                # every peer socket then delivers exactly one "ag" frame
                rnd, local_data, reply = self.local_q.get()
                try:
                    datas: List[Optional[bytes]] = [None] * self.nproc
                    datas[0] = local_data
                    for pid, sock in self._peers.items():
                        msg = recv_msg(sock)
                        if msg.get("type") != "ag" or msg.get("round") != rnd:
                            raise DaftTransientError(
                                f"hub desync from pid {pid}: "
                                f"{msg.get('type')}/{msg.get('round')} != "
                                f"ag/{rnd}")
                        datas[msg["pid"]] = msg["data"]
                    out = {"type": "agr", "round": rnd, "datas": datas}
                    for sock in self._peers.values():
                        send_msg(sock, out)
                    reply.put(datas)
                except BaseException as e:
                    reply.put(e if isinstance(e, Exception)
                              else DaftTransientError(repr(e)))
                    raise
        except BaseException as e:
            self._error = e if isinstance(e, Exception) else Exception(repr(e))
            logger.warning("peer_hub_failed", error=repr(e))
            for sock in self._peers.values():
                try:
                    sock.close()
                except OSError:
                    pass


_GROUP: Optional[PeerGroup] = None
_GROUP_LOCK = threading.Lock()


def get_peer_group() -> Optional[PeerGroup]:
    """This process's PeerGroup, from the cluster that
    ``multihost.init_distributed`` joined; None outside a multi-process
    cluster (or when no coordinator address is known)."""
    global _GROUP
    with _GROUP_LOCK:
        if _GROUP is not None:
            return _GROUP
        from ..parallel.multihost import cluster_info

        info = cluster_info()
        if info is None:
            return None
        coordinator, nproc, pid = info
        if nproc is None or pid is None or nproc <= 1:
            return None
        host = coordinator.rsplit(":", 1)[0] if coordinator else "127.0.0.1"
        env_port = os.environ.get("DAFT_TPU_TORCH_PEER_PORT")
        if env_port is not None:
            port = int(env_port)
        elif coordinator and ":" in coordinator:
            # the rendezvous beside the coordinator's port: every process
            # derives the same address without further coordination
            port = int(coordinator.rsplit(":", 1)[1]) + 1
        else:
            return None
        _GROUP = PeerGroup(host, port, nproc, pid)
        return _GROUP


def reset_peer_group() -> None:
    """Forget this process's PeerGroup (``shutdown_distributed``): the next
    cluster derives its own."""
    global _GROUP
    with _GROUP_LOCK:
        g, _GROUP = _GROUP, None
    if g is not None:
        g._drop_socket()
