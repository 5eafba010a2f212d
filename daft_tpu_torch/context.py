"""Global context + execution config (the port's copy of the part of
daft_tpu/context.py this slice reads).

The port runs its device path on the card by default: ``use_device_kernels``
is on and ``device`` is ``"cuda"``. A caller that wants the CPU says so with
``device="cpu"`` (the tests do); asking for ``cuda`` where there is none
raises instead of running on the CPU.

Left out of this slice: the planning config (beyond expression fusion and
device residency), the scan/shuffle/spill/serving knobs and runner selection
(the port has one runner, NativeRunner).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class ExecutionConfig:
    """Knobs consulted at physical planning / execution time."""

    # route eligible aggregations through the torch device layer
    # (kernels/device_agg.py); host pyarrow path otherwise
    use_device_kernels: bool = True
    # partitions smaller than this stay on the host path (a decline)
    device_min_rows: int = 4096
    # the torch device the device layer stages onto: "cuda" (the card) or
    # "cpu" (the kernels' plain versions, for tests)
    device: str = "cuda"
    # the counterpart of jax_enable_x64 in daft_tpu: False is the 32-bit
    # device mode a TPU runs (int64 narrows to int32 when it fits, float64
    # always computes as float32). Only the 32-bit mode is ported so far.
    device_x64: bool = False
    # batch every float sum of a fused aggregation through the masked
    # segment-sums kernel (kernels/segment_sums.py)
    use_segment_sums_kernel: bool = True
    # evaluate the filter and the derived float-sum columns inside the
    # segment-sums kernel: the deep-fused kernel K2
    # (kernels/fused_expr_sums.py), opt-in as in daft_tpu
    use_deep_fusion_kernel: bool = False
    # collapse Project/Filter chains into one fused map op (fuse/compile.py)
    expr_fusion: bool = True
    # compile project -> filter -> agg segments into device-resident
    # DeviceSegmentOps (fuse/segment.py); needs use_device_kernels
    device_residency: bool = True

    def __post_init__(self):
        if self.device_x64:
            raise NotImplementedError(
                "the 64-bit device mode is not ported yet; use device_x64=False")


# daft_tpu ExecutionConfig field (or "jax_enable_x64") -> port field
_FROM_REFERENCE = {
    "use_device_kernels": "use_device_kernels",
    "device_min_rows": "device_min_rows",
    "use_pallas_segment_sums": "use_segment_sums_kernel",
    "use_pallas_deep_fusion": "use_deep_fusion_kernel",
    "expr_fusion": "expr_fusion",
    "device_residency": "device_residency",
    "jax_enable_x64": "device_x64",
}


def execution_config_from_dict(d: dict, **overrides) -> ExecutionConfig:
    """Map ``dataclasses.asdict`` of a daft_tpu ExecutionConfig, plus its
    ``jax_enable_x64`` flag, onto the port's config, so both packages run one
    query under one configuration. Knobs of subsystems the port does not have
    yet are ignored; ``overrides`` (for example ``device="cpu"``) win.

    The 32-bit device mode always computes float64 as float32, so a reference
    config that turns ``device_reduced_precision`` off has no counterpart."""
    if d.get("device_reduced_precision") is False:
        raise NotImplementedError(
            "float64 without reduced precision needs the 64-bit device mode, "
            "which is not ported yet")
    kw = {ours: d[theirs] for theirs, ours in _FROM_REFERENCE.items() if theirs in d}
    kw.update(overrides)
    return ExecutionConfig(**kw)


class DaftContext:
    """Process-global context: the execution config and the runner."""

    _instance: Optional["DaftContext"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.execution_config = ExecutionConfig()
        self._runner = None

    @classmethod
    def get(cls) -> "DaftContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DaftContext()
            return cls._instance

    def runner(self):
        if self._runner is None:
            from .runners import NativeRunner

            self._runner = NativeRunner()
        return self._runner


def get_context() -> DaftContext:
    return DaftContext.get()


def set_execution_config(config: Optional[ExecutionConfig] = None, **kwargs) -> DaftContext:
    """Install ``config`` (or the current config with ``kwargs`` replaced)."""
    ctx = get_context()
    base = config if config is not None else ctx.execution_config
    ctx.execution_config = dataclasses.replace(base, **kwargs)
    return ctx
