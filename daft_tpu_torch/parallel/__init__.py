"""Mesh execution: a shuffle's fan-out and reduce as one exchange over a mesh
of slots (the port's copy of daft_tpu/parallel/).

A slot is a (process rank, torch.device) pair. Between the slots of one
process the exchange is a tensor copy; between processes it is
``torch.distributed.all_to_all_single`` (``nccl`` on the card, ``gloo`` on
the CPU). The host keeps the control plane: bucket assignment, capacity
agreement and re-chunking partitions onto the slots.
"""

from .collectives import Mesh, build_exchange, exchange_capacity
from .mesh_exec import MeshExecutionContext, default_mesh
from .multihost import global_mesh, init_distributed, process_local_slots

__all__ = [
    "Mesh",
    "build_exchange",
    "exchange_capacity",
    "MeshExecutionContext",
    "default_mesh",
    "global_mesh",
    "init_distributed",
    "process_local_slots",
]
