"""Encoded exchange payloads (the port's copy of daft_tpu/exchange/encode.py):
dictionary-encode the low-cardinality columns of the shuffle's pieces before
they enter the spillable bucket buffers.

A bucket holds pieces of many source partitions until the reduce side merges
them; those pieces are what the memory ledger charges and what spills under
a budget. Low-cardinality columns (flags, dates, status strings, keys of
small dimensions) dictionary-encode to a fraction of their raw width, so the
held bytes and the spilled IPC bytes shrink: arrow IPC writes dictionary
arrays natively, so a spilled encoded piece stays encoded on disk (the spill
writer takes the payload through the ``encoded_payload`` task hook).

A prefix sample's distinct count must stay under SAMPLE_MAX_RATIO of the
sample, and the encoded column must be smaller than the raw one, or the
column ships raw. A piece where no column wins ships raw (``None`` from
:func:`encode_exchange_partition`).

Decode happens once, at the reduce-side merge: the encoded piece is an
UNLOADED MicroPartition whose task decodes on read, to the piece's engine
schema exactly, the lazy contract spilled partitions follow. The caller
(``ShuffleOp``) ships the raw piece when the encode fails with the injected
``exchange.encode`` fault or an arrow error; results equal those with
``exchange_payload_encoding`` off, since dictionary round trips are exact.
"""

from __future__ import annotations

from typing import List, Optional

import pyarrow as pa

from .. import faults
from ..micropartition import MicroPartition

# pieces below this many rows are not worth the encode pass
ENCODE_MIN_ROWS = 64
# cardinality sampling: prefix sample size and the distinct/sample ratio
# above which a column is hostile (near-unique) and ships raw
SAMPLE_ROWS = 1024
SAMPLE_MAX_RATIO = 0.5

# what an encode may fail with and still ship the piece raw
ENCODE_FAILURES = (faults.InjectedFault, pa.ArrowException)


class EncodedExchangeTask:
    """Scan-task-shaped holder of one encoded piece: an arrow table whose
    low-cardinality columns are dictionary-encoded, and the engine schema to
    decode back into. ``read()`` decodes (at the reduce-side merge or an
    unspill); ``encoded_payload()`` is the spill writer's hook for writing
    the encoded form to disk as it is."""

    def __init__(self, atbl, schema, raw_bytes: int, crc: Optional[int] = None,
                 stats=None):
        self._atbl = atbl
        self.schema = schema
        self.raw_bytes = raw_bytes
        # crc32 over the encoded table's buffers, recorded at encode and
        # verified at decode (None: checksums off); a spill round trip is
        # covered by the spill file's own checksum
        self.crc = crc
        self._rt_stats = stats

    @property
    def materialized_schema(self):
        return self.schema

    def num_rows(self) -> Optional[int]:
        return self._atbl.num_rows

    def size_bytes(self) -> Optional[int]:
        return self._atbl.nbytes

    def read(self):
        """Decode to an engine Table of the original dtypes, verifying the
        encode-time checksum first, so that a damaged payload raises
        DaftCorruptionError instead of decoding garbage."""
        from ..series import Series
        from ..table import Table

        if self.crc is not None:
            from ..errors import DaftCorruptionError
            from ..integrity.checksum import crc32_table

            got = crc32_table(self._atbl)
            if got != self.crc:
                if self._rt_stats is not None:
                    self._rt_stats.bump("corruption_detected")
                raise DaftCorruptionError(
                    f"encoded exchange piece failed its integrity check "
                    f"(crc {got:#010x} != {self.crc:#010x}, rows={self._atbl.num_rows})")
        cols = []
        for f, name in zip(self.schema, self._atbl.column_names):
            arr = self._atbl.column(name)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            if pa.types.is_dictionary(arr.type):
                arr = arr.dictionary_decode()
            cols.append(Series.from_arrow(arr, f.name, f.dtype))
        return Table(self.schema, cols)

    def encoded_payload(self) -> List:
        """The encoded arrow tables for the spill writer."""
        return [self._atbl]

    def __repr__(self) -> str:
        return (f"EncodedExchangeTask(rows={self._atbl.num_rows}, "
                f"bytes={self._atbl.nbytes}/{self.raw_bytes})")


def _encode_column(arr):
    """Dictionary-encode one arrow array when sampling says it pays; the
    encoded array or None (ship raw)."""
    import pyarrow.compute as pc

    t = arr.type
    if pa.types.is_dictionary(t) or pa.types.is_nested(t) or pa.types.is_null(t):
        return None
    n = len(arr)
    sample = arr.slice(0, min(n, SAMPLE_ROWS))
    try:
        distinct = pc.count_distinct(sample).as_py() or 0
    except pa.ArrowException:
        return None  # a dtype without a distinct kernel ships raw
    if distinct > max(16, int(len(sample) * SAMPLE_MAX_RATIO)):
        return None
    enc = arr.dictionary_encode()
    if enc.nbytes >= arr.nbytes:
        return None  # the tail was hostile: keep raw
    return enc


def encode_exchange_partition(part: MicroPartition, stats=None,
                              integrity: bool = True) -> Optional[MicroPartition]:
    """Encode one shuffle piece: the encoded (unloaded, lazily decoding)
    MicroPartition, or None when the piece is too small, no column wins, or
    it holds python objects. The ``exchange.encode`` site fires here; the
    caller ships the raw piece on ``ENCODE_FAILURES``."""
    n = part.num_rows_or_none() or 0
    if n < ENCODE_MIN_ROWS:
        return None
    faults.check("exchange.encode", stats)
    tbl = part.table()
    if any(f.dtype.is_python() for f in tbl.schema):
        return None  # no arrow representation: the piece ships raw
    arrays = []
    won = False
    for arr in tbl.to_arrow().columns:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        enc = _encode_column(arr)
        won = won or enc is not None
        arrays.append(arr if enc is None else enc)
    if not won:
        return None
    atbl = pa.Table.from_arrays(arrays, names=[f.name for f in tbl.schema])
    raw = tbl.size_bytes()
    if atbl.nbytes >= raw:
        return None
    crc = None
    if integrity:
        from ..integrity.checksum import crc32_table

        crc = crc32_table(atbl)
    out = MicroPartition.from_scan_task(
        EncodedExchangeTask(atbl, part.schema, raw, crc=crc, stats=stats)).derived_from(part)
    # the encoded piece decodes to exactly the raw piece, so the raw
    # piece's recipe (if any) re-derives it too
    out.lineage_recipe = part.lineage_recipe
    return out
