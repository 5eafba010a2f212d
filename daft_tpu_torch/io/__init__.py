"""Input and output (the port's copy of the part of daft_tpu/io/ this slice
runs): scan tasks and their pushdowns, the parquet, CSV, JSON and arrow IPC
readers over local paths, the scan readahead (prefetch.py), the parquet,
CSV and JSON writers to local paths (writer.py), and the IO counters. The
decoded arrow tables are what the device layer stages. Left out: the
object-store client, catalogs and the lake formats."""

from .readers import read_csv_table, read_json_table, read_parquet_table
from .scan import IO_STATS, FileFormat, IOStats, Pushdowns, ScanTask, glob_paths

__all__ = ["FileFormat", "IOStats", "IO_STATS", "Pushdowns", "ScanTask", "glob_paths",
           "read_csv_table", "read_json_table", "read_parquet_table"]
