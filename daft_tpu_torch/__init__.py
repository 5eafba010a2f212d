"""daft_tpu_torch: the PyTorch/CUDA port of daft_tpu for an NVIDIA H100.

It grows beside daft_tpu (the JAX reference, which stays as it is), one slice
at a time, and imports neither jax nor daft_tpu. This slice runs TPC-H Q1/Q6:
in-memory partitions, filter, grouped sum/mean/count/min/max and sort, with
the aggregation on the card in the 32-bit device mode. Its float sums go
through a hand-written CUDA kernel (kernels/segment_sums.py,
csrc/masked_segment_sums.cu).

``read_parquet``, ``read_csv`` and ``read_json`` scan local files and
object stores (``s3://``, ``gs://``, ``az://``, ``hf://``, ``http(s)://``;
io/object_store.py): the optimizer pushes columns, filters and limits into
the scan tasks, and each partition is read when the first operator needs
it, with the reads of the next ``scan_prefetch_depth`` partitions running
ahead in the background. ``read_deltalake``, ``read_iceberg``,
``read_hudi``, ``read_lance``, ``read_sql`` and ``from_scan_operator``
read lake tables, databases and user-defined sources (io/catalogs.py,
io/unity.py, io/pyscan.py). ``write_parquet``, ``write_csv`` and
``write_json`` write a frame's partitions as files, local or remote, and
return the manifest of the written paths; ``write_deltalake`` and
``write_iceberg`` commit them to a lake table. ``col(...).url.download()``
and ``.url.upload(...)`` move bytes between rows and objects.

``approx_count_distinct`` and ``approx_percentiles`` aggregate through
mergeable sketches (sketch/): over several partitions the exchange ships
serialized sketches, and the HLL registers build on the card (K9).
``col(...).image`` decodes, encodes, crops, converts and resizes images
(multimodal.py; the resize of a fixed-shape column runs on the card, K11),
and ``col(...).embedding.cosine_distance`` compares embeddings.

``sql`` plans a SQL text onto the DataFrame API; ``udf`` and ``batch_udf``
make python UDFs, and a batch-declared model class with ``apply_torch``
runs its batches on the card.

``collect(profile=True)``, ``explain_analyze()``, ``tracing.chrome_trace``
(or DAFT_TPU_TORCH_CHROME_TRACE), ``query_log()``, ``health()``,
``metrics_text()`` and ``engine_log_tail()`` say where a query spent its
time and how the engine is doing (profile/, obs/, tracing.py).

``set_runner_mesh()`` (or ``runners.MeshRunner(parallel.default_mesh(8))``)
runs the shuffles over a mesh of slots (parallel/); ``parallel.init_distributed``
and ``parallel.global_mesh`` span processes over torch.distributed.
``set_execution_config(distributed_workers=N)`` runs the map tasks on N
supervised worker processes (dist/, ``DistributedRunner``), each on the
config's device.

Entry points run on the card (``ExecutionConfig.device == "cuda"``) unless
the caller asks for the CPU with ``set_execution_config(device="cpu")``.
"""

from .api import (UDF, batch_udf, engine_log_tail, from_arrow, from_dask_dataframe,
                  from_glob_path, from_pandas, from_pydict, from_pylist, from_ray_dataset,
                  from_scan_operator, health, last_profile, metrics_text, query_log,
                  query_progress, read_csv, read_deltalake, read_hudi, read_iceberg, read_json,
                  read_lance, read_parquet, read_sql, sql_expr, udf)
from .context import (ExecutionConfig, execution_config_from_dict, get_context,
                      set_execution_config, set_runner, set_runner_mesh, set_runner_native)
from .dataframe import DataFrame
from .datatypes import DataType
from .expressions import Expression, col, interval, lit
from .schema import Field, Schema
from .series import Series
from .table import Table

__all__ = [
    "DataFrame", "DataType", "ExecutionConfig", "Expression", "Field", "Schema",
    "Series", "Table", "UDF", "batch_udf", "col", "engine_log_tail",
    "execution_config_from_dict", "from_arrow", "from_dask_dataframe", "from_glob_path",
    "from_pandas", "from_pydict", "from_pylist", "from_ray_dataset", "from_scan_operator",
    "get_context", "health", "interval", "last_profile", "lit", "metrics_text",
    "query_log", "query_progress", "read_csv", "read_deltalake", "read_hudi", "read_iceberg",
    "read_json", "read_lance", "read_parquet", "read_sql", "set_execution_config", "set_runner", "set_runner_mesh", "set_runner_native", "sql",
    "sql_expr", "udf",
]

# The sql SUBMODULE shares its name with the sql() entry point: the first
# real import of the submodule would rebind the package attribute to the
# module, so a second daft_tpu_torch.sql("SELECT ...") would raise
# TypeError. `from . import sql` cannot force that import here (the package
# already has a `sql` attribute, so the from-list machinery skips the
# submodule); importlib imports it for real, and pinning the function
# afterwards keeps the attribute stable, since later imports of the
# submodule find it in sys.modules and never set the attribute again.
import importlib as _importlib  # noqa: E402

# registers url.download and url.upload, which SQL and Function callers name
# before any expression namespace is touched
from . import multimodal  # noqa: E402,F401

_importlib.import_module(f"{__name__}.sql")
from .api import sql  # noqa: E402,F401
