"""Input and output (the port's copy of daft_tpu/io/): scan tasks and
their pushdowns, the parquet, CSV, JSON and arrow IPC readers, the scan
readahead (prefetch.py), the parquet, CSV and JSON writers (writer.py), the
object-store client with its S3, GCS, Azure, Hugging Face and HTTP sources
(object_store.py), the lake formats and SQL scans (catalogs.py, over the
avro codec of avro.py), the Unity Catalog client (unity.py), user-defined
scan sources (pyscan.py), and the IO counters. The decoded arrow tables are
what the device layer stages."""

from .readers import read_csv_table, read_json_table, read_parquet_table
from .scan import IO_STATS, FileFormat, IOStats, Pushdowns, ScanTask, glob_paths
from .writer import write_tabular

__all__ = ["FileFormat", "IOStats", "IO_STATS", "Pushdowns", "ScanTask", "glob_paths",
           "read_csv_table", "read_json_table", "read_parquet_table", "write_tabular"]
