"""Morsels: the unit of streaming execution.

A morsel is a loaded :class:`MicroPartition` over a ``Table.slice`` of one
of its source partition's reader chunks, zero-copy where arrow allows (the
slice shares the chunk's buffers). A morsel never spans two chunks, so a
scan partition of several chunks is never concatenated whole.
"""

from __future__ import annotations

from typing import Iterator

from ..micropartition import MicroPartition

__all__ = ["iter_morsels"]


def iter_morsels(part: MicroPartition, rows: int) -> Iterator[MicroPartition]:
    """Slice ``part`` into loaded morsels of at most ``rows`` rows each.

    An unloaded partition reads through ``iter_chunk_tables()`` (parquet one
    row group at a time, behind the scan's retries and its ``scan.read``
    fault site), so the first morsel flows after one chunk's decode. An
    empty partition yields exactly one empty morsel: the driver's re-chunk
    rebuilds the source partitions one for one, empty ones included."""
    rows = max(1, int(rows))
    emitted = False
    for t in part.iter_chunk_tables():
        n = len(t)
        for s in range(0, n, rows):
            emitted = True
            yield MicroPartition.from_table(t.slice(s, min(s + rows, n))).derived_from(part)
    if not emitted:
        yield MicroPartition.empty(part.schema).derived_from(part)
