"""Multi-process clusters over torch.distributed (the port's copy of
daft_tpu/parallel/multihost.py).

Every process calls ``init_distributed`` (or sets
DAFT_TPU_TORCH_COORDINATOR / DAFT_TPU_TORCH_NUM_PROCESSES /
DAFT_TPU_TORCH_PROCESS_ID, picked up when the arguments are left out), then
builds ``global_mesh()`` and hands it to ``MeshRunner``. The coordinator is
a ``host:port`` the rank-0 process listens on (``tcp://`` rendezvous). The
group's backend follows the execution config's device: ``nccl`` for CUDA
slots, ``gloo`` for CPU slots. With no coordinator configured, a launcher's
``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT`` bootstrap the
group where they are set; a failed bootstrap is warned about once and then
cached, and the process runs alone.

Topology contract, as the reference's: the slots of every process, ordered
by rank, form one mesh; a process stages only its own slots' shards, and the
control plane (bucket assignment, capacity agreement) runs on every process
from the same host-side inputs (SPMD).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from .collectives import Mesh, my_rank

_INITIALIZED = [False]
_BOOTSTRAP_FAILED = [False]
# (coordinator, num_processes, process_id) of the connected cluster
_CLUSTER = [None]


def cluster_info():
    """(coordinator, num_processes, process_id) once ``init_distributed``
    connected this process, else None."""
    return _CLUSTER[0]


def _backend() -> str:
    from ..context import get_context

    dev = torch.device(get_context().execution_config.device)
    return "nccl" if dev.type == "cuda" else "gloo"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join this process to the cluster's process group (idempotent).
    Returns True when the group is (now) up, False when no coordinator is
    configured or the zero-config bootstrap failed."""
    import torch.distributed as dist

    if _INITIALIZED[0] or (dist.is_available() and dist.is_initialized()):
        _INITIALIZED[0] = True
        return True
    coordinator = coordinator or os.environ.get("DAFT_TPU_TORCH_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("DAFT_TPU_TORCH_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("DAFT_TPU_TORCH_PROCESS_ID")
    backend = _backend()
    if coordinator is None and num_processes is None:
        # zero-config: a launcher's environment (torchrun and the like). A
        # failed attempt is warned about and cached: degrading silently, or
        # blocking on the rendezvous again every call, would be worse
        if _BOOTSTRAP_FAILED[0]:
            return False
        try:
            if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
                raise RuntimeError("no launcher environment (WORLD_SIZE, RANK, MASTER_ADDR, "
                                   "MASTER_PORT)")
            dist.init_process_group(backend, init_method="env://")
        except Exception as e:
            from ..obs.log import get_logger

            _BOOTSTRAP_FAILED[0] = True
            get_logger("multihost").warning(
                "distributed_bootstrap_failed", error=repr(e),
                note="proceeding single-process: pass coordinator/num_processes/"
                     "process_id for a multi-process cluster")
            return False
        _INITIALIZED[0] = True
        _CLUSTER[0] = (None, dist.get_world_size(), dist.get_rank())
        return True
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id with a "
                         "coordinator")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _INITIALIZED[0] = True
    _CLUSTER[0] = (coordinator, num_processes, process_id)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group this module made (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED[0] = False
    _CLUSTER[0] = None
    from ..dist.peer import reset_peer_group

    reset_peer_group()


def local_devices() -> List[torch.device]:
    """This process's devices of the config's kind: every visible card for
    ``cuda``, one CPU slot for ``cpu``."""
    from ..context import get_context

    dev = torch.device(get_context().execution_config.device)
    if dev.type == "cuda":
        from ..kernels.device import resolve_device

        resolve_device(get_context().execution_config)  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_mesh(slots_per_process: Optional[int] = None) -> Mesh:
    """One mesh over the slots of every process, ordered by rank: each
    process contributes one slot per local device, or ``slots_per_process``
    slots wrapped over its devices (slot i on device i % count). Every
    process must pass the same count."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    devs = local_devices()
    k = len(devs) if slots_per_process is None else int(slots_per_process)
    # every process's device kinds agree (one config); its indices are its own
    slots = [(r, devs[i % len(devs)]) for r in range(world) for i in range(k)]
    return Mesh(slots)


def process_local_slots(mesh: Mesh) -> List[int]:
    """The mesh slots this process stages (its own rank's)."""
    return mesh.local_indices(my_rank())
