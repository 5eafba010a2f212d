"""daft_tpu_torch: the PyTorch/CUDA port of daft_tpu for an NVIDIA H100.

It grows beside daft_tpu (the JAX reference, which stays as it is), one slice
at a time, and imports neither jax nor daft_tpu. This slice runs TPC-H Q1/Q6:
in-memory partitions, filter, grouped sum/mean/count/min/max and sort, with
the aggregation on the card in the 32-bit device mode. Its float sums go
through a hand-written CUDA kernel (kernels/segment_sums.py,
csrc/masked_segment_sums.cu).

``read_parquet``, ``read_csv`` and ``read_json`` scan local files: the
optimizer pushes columns, filters and limits into the scan tasks, and each
partition is read when the first operator needs it, with the reads of the
next ``scan_prefetch_depth`` partitions running ahead in the background.
``write_parquet``, ``write_csv`` and ``write_json`` write a frame's
partitions as files and return the manifest of the written paths.

Entry points run on the card (``ExecutionConfig.device == "cuda"``) unless
the caller asks for the CPU with ``set_execution_config(device="cpu")``.
"""

from .api import (from_arrow, from_glob_path, from_pandas, from_pydict, from_pylist, read_csv,
                  read_json, read_parquet)
from .context import ExecutionConfig, execution_config_from_dict, get_context, set_execution_config
from .dataframe import DataFrame
from .datatypes import DataType
from .expressions import Expression, col, interval, lit
from .schema import Field, Schema
from .series import Series
from .table import Table

__all__ = [
    "DataFrame", "DataType", "ExecutionConfig", "Expression", "Field", "Schema",
    "Series", "Table", "col", "execution_config_from_dict", "from_arrow",
    "from_glob_path", "from_pandas", "from_pydict", "from_pylist", "get_context",
    "interval", "lit", "read_csv",
    "read_json", "read_parquet", "set_execution_config",
]
