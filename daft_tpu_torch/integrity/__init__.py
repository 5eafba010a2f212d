"""End-to-end partition integrity (the port's copy of daft_tpu/integrity/,
without the transport frames, which come with dist/).

Payloads that leave compute and come back, spill IPC files and encoded
exchange pieces, carry a crc32 computed when the payload is produced and
verified when it re-enters compute (:mod:`.checksum`), so silent corruption
surfaces as a typed ``DaftCorruptionError`` instead of a garbled table. A
bounded per-query :class:`.lineage.LineageLog` records how spilled
partitions were produced, so a corrupted or missing spill file is recomputed
from its source instead of failing the query."""

from .checksum import crc32_bytes, crc32_file, crc32_table, flip_file_bits
from .lineage import LineageLog

__all__ = ["crc32_bytes", "crc32_file", "crc32_table", "flip_file_bits",
           "LineageLog"]
