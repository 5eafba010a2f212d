"""A minimal Apache Avro Object Container File codec, reading and writing
(the port's copy of daft_tpu/io/avro.py).

Iceberg manifests and manifest lists are Avro OCF files, and no avro
library is a dependency, so the subset of the spec they need is here:
records, unions, arrays, maps, strings, bytes, fixed, enums, every
primitive type, and the null and deflate block codecs. Schema resolution
uses the writer's schema only (no reader-schema evolution), which is what
a manifest replay needs. The bytes equal the reference's for the same
records and sync marker, so a manifest either package writes decodes in
the other.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_utf8(self) -> str:
        return self.read_bytes().decode("utf-8")


def _decode(r: _Reader, schema) -> Any:
    """Decode one value of `schema` (parsed JSON form) from r."""
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            return r.read(1) == b"\x01"
        if t in ("int", "long"):
            return r.read_long()
        if t == "float":
            return struct.unpack("<f", r.read(4))[0]
        if t == "double":
            return struct.unpack("<d", r.read(8))[0]
        if t == "bytes":
            return r.read_bytes()
        if t == "string":
            return r.read_utf8()
        raise ValueError(f"unknown avro type {t!r}")
    if isinstance(schema, list):  # union
        idx = r.read_long()
        return _decode(r, schema[idx])
    t = schema["type"]
    if t == "record":
        return {f["name"]: _decode(r, f["type"]) for f in schema["fields"]}
    if t == "array":
        out = []
        while True:
            cnt = r.read_long()
            if cnt == 0:
                break
            if cnt < 0:
                cnt = -cnt
                r.read_long()  # block byte size, unused
            for _ in range(cnt):
                out.append(_decode(r, schema["items"]))
        return out
    if t == "map":
        out = {}
        while True:
            cnt = r.read_long()
            if cnt == 0:
                break
            if cnt < 0:
                cnt = -cnt
                r.read_long()
            for _ in range(cnt):
                k = r.read_utf8()  # NB: must read key BEFORE value (python
                out[k] = _decode(r, schema["values"])  # evaluates RHS first)
        return out
    if t == "fixed":
        return r.read(schema["size"])
    if t == "enum":
        return schema["symbols"][r.read_long()]
    # logical types / named references wrap the underlying type string
    return _decode(r, t)


def read_avro_file(path: str) -> Tuple[dict, List[dict]]:
    """-> (writer schema JSON, list of decoded records)."""
    with open(path, "rb") as f:
        data = f.read()
    return read_avro_bytes(data)


def read_avro_bytes(data: bytes) -> Tuple[dict, List[dict]]:
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError("not an avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        cnt = r.read_long()
        if cnt == 0:
            break
        if cnt < 0:
            cnt = -cnt
            r.read_long()
        for _ in range(cnt):
            k = r.read_utf8()
            meta[k] = r.read_bytes()
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    records: List[dict] = []
    while r.pos < len(r.buf):
        n_items = r.read_long()
        size = r.read_long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        if r.read(16) != sync:
            raise ValueError("avro sync marker mismatch")
        br = _Reader(block)
        for _ in range(n_items):
            records.append(_decode(br, schema))
    return schema, records


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

class _Writer:
    __slots__ = ("out",)

    def __init__(self):
        self.out = io.BytesIO()

    def write(self, b: bytes) -> None:
        self.out.write(b)

    def write_long(self, v: int) -> None:
        # zigzag then varint; python's arithmetic >> keeps this exact for the
        # full 64-bit range
        u = ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF
        while True:
            b = u & 0x7F
            u >>= 7
            if u:
                self.out.write(bytes([b | 0x80]))
            else:
                self.out.write(bytes([b]))
                break

    def write_bytes(self, b: bytes) -> None:
        self.write_long(len(b))
        self.out.write(b)

    def write_utf8(self, s: str) -> None:
        self.write_bytes(s.encode("utf-8"))


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _encode(w: _Writer, schema, value) -> None:
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return
        if t == "boolean":
            w.write(b"\x01" if value else b"\x00")
            return
        if t in ("int", "long"):
            w.write_long(int(value))
            return
        if t == "float":
            w.write(struct.pack("<f", float(value)))
            return
        if t == "double":
            w.write(struct.pack("<d", float(value)))
            return
        if t == "bytes":
            w.write_bytes(bytes(value))
            return
        if t == "string":
            w.write_utf8(value)
            return
        raise ValueError(f"unknown avro type {t!r}")
    if isinstance(schema, list):  # union: pick the first matching branch
        for i, branch in enumerate(schema):
            if _matches(branch, value):
                w.write_long(i)
                _encode(w, branch, value)
                return
        raise ValueError(f"no union branch of {schema} matches {value!r}")
    t = schema["type"]
    if t == "record":
        for f in schema["fields"]:
            _encode(w, f["type"], (value or {}).get(f["name"]))
        return
    if t == "array":
        items = list(value or [])
        if items:
            w.write_long(len(items))
            for it in items:
                _encode(w, schema["items"], it)
        w.write_long(0)
        return
    if t == "map":
        entries = dict(value or {})
        if entries:
            w.write_long(len(entries))
            for k, v in entries.items():
                w.write_utf8(k)
                _encode(w, schema["values"], v)
        w.write_long(0)
        return
    if t == "fixed":
        b = bytes(value)
        if len(b) != schema["size"]:
            raise ValueError("fixed size mismatch")
        w.write(b)
        return
    if t == "enum":
        w.write_long(schema["symbols"].index(value))
        return
    _encode(w, t, value)


def _matches(branch, value) -> bool:
    if branch == "null" or branch is None:
        return value is None
    if value is None:
        return False
    if isinstance(branch, str):
        return {
            "boolean": lambda v: isinstance(v, bool),
            "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
            "long": lambda v: isinstance(v, int) and not isinstance(v, bool),
            "float": lambda v: isinstance(v, float),
            "double": lambda v: isinstance(v, float),
            "bytes": lambda v: isinstance(v, (bytes, bytearray)),
            "string": lambda v: isinstance(v, str),
        }.get(branch, lambda v: True)(value)
    t = branch.get("type")
    if t == "record":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, (list, tuple))
    if t == "map":
        return isinstance(value, dict)
    if t in ("fixed",):
        return isinstance(value, (bytes, bytearray))
    if t == "enum":
        return isinstance(value, str)
    return True


def encode_avro_bytes(schema: dict, records: List[dict],
                      meta: Optional[Dict[str, bytes]] = None) -> bytes:
    """Records as one null-codec OCF block (plenty for manifests)."""
    w = _Writer()
    w.write(MAGIC)
    m = {"avro.schema": json.dumps(schema).encode(), "avro.codec": b"null"}
    m.update(meta or {})
    w.write_long(len(m))
    for k, v in m.items():
        w.write_utf8(k)
        w.write_bytes(v)
    w.write_long(0)
    sync = os.urandom(16)
    w.write(sync)
    body = _Writer()
    for rec in records:
        _encode(body, schema, rec)
    data = body.out.getvalue()
    w.write_long(len(records))
    w.write_long(len(data))
    w.write(data)
    w.write(sync)
    return w.out.getvalue()


def write_avro_file(path: str, schema: dict, records: List[dict],
                    meta: Optional[Dict[str, bytes]] = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_avro_bytes(schema, records, meta))
