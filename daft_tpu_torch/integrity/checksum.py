"""Fast payload checksums shared by every integrity call site (the port's
copy of daft_tpu/integrity/checksum.py).

zlib.crc32 is the engine's one checksum: cheap on the host, and strong
enough to detect the bit-level damage the data plane sees (a flipped
sector, a torn write). It is not a cryptographic MAC.

Three surfaces, one algorithm:

- :func:`crc32_bytes`: raw payload bytes;
- :func:`crc32_table`: an arrow table's buffer bytes (encoded exchange
  pieces verified in memory, where no serialization normalizes them);
- :func:`crc32_file`: a written artifact's bytes (spill IPC files: the
  checksum describes exactly what the disk must hand back, so IPC padding
  can never read as corruption).

:func:`flip_file_bits` and :func:`flip_payload_bits` are the deterministic
damage injectors: the first is the effect of the ``spill.corrupt`` fault
site, which flips a real bit of the landed file, so detection and the
recovery behind it are testable end to end; the second is kept for the
transport frames of dist/."""

from __future__ import annotations

import os
import zlib

# chunked file reads: spill files are page-cache warm right after the
# write, so the verify pass streams at memcpy speed without a big buffer
_FILE_CHUNK = 1 << 20


def crc32_bytes(data, crc: int = 0) -> int:
    """crc32 of a bytes-like payload (optionally chained via ``crc``)."""
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def _crc32_array(arr, crc: int) -> int:
    for buf in arr.buffers():
        if buf is None:
            crc = zlib.crc32(b"\x00", crc)
        else:
            crc = zlib.crc32(memoryview(buf), crc)
    # DictionaryArray.buffers() covers only validity+indices: the
    # dictionary VALUES — the actual column data for encoded exchange
    # pieces — live on a separate child array and must fold in too
    dictionary = getattr(arr, "dictionary", None)
    if dictionary is not None:
        crc = _crc32_array(dictionary, crc)
    return crc


def crc32_table(atbl) -> int:
    """crc32 over an arrow table's buffer bytes, column by column, chunk
    by chunk — including dictionary value buffers (None buffers — absent
    validity bitmaps — fold as a length-0 marker so presence changes are
    detected too)."""
    crc = 0
    for col in atbl.columns:
        chunks = col.chunks if hasattr(col, "chunks") else [col]
        for chunk in chunks:
            crc = _crc32_array(chunk, crc)
    return crc & 0xFFFFFFFF


def crc32_file(path: str) -> int:
    """crc32 of a file's bytes (the spill write/read verification pair)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_FILE_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def flip_file_bits(path: str) -> None:
    """Deterministically flip one byte in the middle of ``path`` (the
    ``spill.corrupt`` fault-site effect). A zero-length file is left
    alone — there is nothing to corrupt."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size <= 0:
        return
    off = size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        if not b:
            return
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def flip_payload_bits(data: bytes) -> bytes:
    """A copy of ``data`` with one byte flipped (the ``transport.corrupt``
    fault-site effect). The flip lands within the frame's FIRST 4 KiB so
    it falls inside the transport's always-covered leading stripe —
    detection stays deterministic even for bulk frames whose body is
    striped-sampled."""
    if not data:
        return data
    off = min(len(data) // 2, 4096)
    out = bytearray(data)
    out[off] ^= 0xFF
    return bytes(out)
