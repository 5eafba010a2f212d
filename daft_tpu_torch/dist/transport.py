"""Length-prefixed message transport between the driver and its workers
(the port's copy of daft_tpu/dist/transport.py).

One frame is a 13-byte header (8-byte big-endian payload length, 1 flag
byte, 4-byte crc32 of the payload) and a pickled message dict. Pickle is
the wire format because the payloads are engine objects (tables, scan
tasks, physical map ops) and the endpoints are same-host processes the
driver spawned itself: the token handshake in worker.py keeps strangers off
the socket. This is an IPC plane, not a network service.

Integrity (protocol v2): the sender records the payload's crc32 in the
header (flag bit 0) and the receiver verifies it before unpickling, so a
frame damaged in flight raises :class:`~..errors.DaftCorruptionError`
instead of feeding pickle garbage; the supervision layer then treats the
connection as dead and re-dispatches. Frames up to ``_FULL_CRC_MAX`` are
covered in full; bulk frames (shipped partitions) are covered in stripes
(flag bit 1): the first and last 64 KiB blocks and every 64th one between
them. ``checksum=False`` (``partition_integrity`` off) sends flag-0 frames
that the receiver passes through unverified. A peer of the older 8-byte
header is rejected at the handshake by ``PROTOCOL_VERSION``.

Failure contract: a partial read or an EOF raises :class:`TransportClosed`
(a DaftTransientError), every send passes the ``transport.send`` fault site
(a severed link) and ``transport.corrupt`` flips a real payload bit after
the crc was computed (integrity/checksum.py ``flip_payload_bits``).

No tensor crosses this transport: the partitions that ship hold arrow
tables or scan tasks (``MicroPartition.__getstate__`` drops the columns
staged on the card), and a map op ships without its cached programs.
"""

from __future__ import annotations

import pickle
import socket
import struct

from ..errors import DaftCorruptionError, DaftTransientError
from ..integrity.checksum import crc32_bytes

# carried in the worker's hello: 2 since frames carry the flag and crc fields
PROTOCOL_VERSION = 2
# 8-byte big-endian payload length, 1 flag byte, 4-byte crc32
_HDR = struct.Struct(">QBI")
_FLAG_CRC = 1
_FLAG_STRIPED = 2
# frames up to this size crc in full (pings, acks, task envelopes, small
# results); larger ones stripe
_FULL_CRC_MAX = 256 * 1024
# striped coverage: first, last and every _STRIPE_EVERY'th 64 KiB block
_STRIPE = 64 * 1024
_STRIPE_EVERY = 64
# a longer frame is a protocol desync, not a payload
MAX_FRAME_BYTES = 1 << 40


def _payload_crc(data: bytes) -> "tuple[int, int]":
    """(crc, flags) for a frame payload: the full crc32 up to
    ``_FULL_CRC_MAX`` bytes, striped above (both sides derive the same
    stripes from the length)."""
    n = len(data)
    if n <= _FULL_CRC_MAX:
        return crc32_bytes(data), _FLAG_CRC
    m = memoryview(data)
    crc = crc32_bytes(n.to_bytes(8, "big"))
    for off in range(0, n, _STRIPE * _STRIPE_EVERY):
        crc = crc32_bytes(m[off:off + _STRIPE], crc)
    crc = crc32_bytes(m[n - _STRIPE:], crc)
    return crc, _FLAG_CRC | _FLAG_STRIPED


class TransportClosed(DaftTransientError):
    """The peer went away mid-frame (EOF, reset, severed link)."""


def dial(host: str, port: int, timeout: float = 30.0) -> socket.socket:
    """One framed connection to a peer endpoint (the workers' piece servers
    dial each other with it). The connect and every later round trip are
    bounded by ``timeout``, so a dead peer reads as TransportClosed rather
    than a hang; the caller closes the socket."""
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except OSError as e:
        raise TransportClosed(f"transport dial {host}:{port} failed: {e!r}") from e
    sock.settimeout(timeout)
    return sock


def send_msg(sock: socket.socket, msg: dict, checksum: bool = True) -> None:
    """Pickle, frame and send one message. ``checksum`` stamps the payload's
    crc32 into the header. Raises TransportClosed on a dead connection; the
    ``transport.send`` and ``transport.corrupt`` fault sites fire here."""
    from .. import faults

    data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    crc, flags = _payload_crc(data) if checksum else (0, 0)
    try:
        faults.check("transport.send")
        try:
            faults.check("transport.corrupt")
        except DaftTransientError:
            # the crc above describes the clean payload: the receiver's
            # verify must catch this
            from ..integrity.checksum import flip_payload_bits

            data = flip_payload_bits(data)
        sock.sendall(_HDR.pack(len(data), flags, crc) + data)
    except DaftTransientError:
        raise
    except OSError as e:
        raise TransportClosed(f"transport send failed: {e!r}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except OSError as e:
            raise TransportClosed(f"transport recv failed: {e!r}") from e
        if not chunk:
            raise TransportClosed(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket, with_flags: bool = False):
    """Receive one framed message (blocking). Raises TransportClosed on
    EOF or reset, DaftCorruptionError on a payload that fails its crc and
    DaftTransientError on a desynced frame. ``with_flags`` also returns the
    frame's flag byte: the worker mirrors the driver's checksum setting from
    it, so toggling ``partition_integrity`` in the driver flips both
    directions without a respawn."""
    (length, flags, crc) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > MAX_FRAME_BYTES:
        raise DaftTransientError(
            f"transport frame length {length} exceeds {MAX_FRAME_BYTES} (protocol desync)")
    data = _recv_exact(sock, length)
    if flags & _FLAG_CRC:
        got, _ = _payload_crc(data)
        if got != crc:
            raise DaftCorruptionError(
                f"transport frame failed its integrity check (crc {got:#010x} != "
                f"{crc:#010x}, {length} bytes{', striped' if flags & _FLAG_STRIPED else ''})")
    msg = pickle.loads(data)
    return (msg, flags) if with_flags else msg
