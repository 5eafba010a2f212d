"""K13: the device apply of batch-declared UDFs, behind the breaker (the
port's counterpart of daft_tpu/batch/device.py, which runs a model's
``jax.jit(apply_jax)``).

A model opts in by defining ``apply_torch``: a staticmethod or classmethod
taking the same columns as ``__call__``, as torch tensors on the card
(``cfg.device``), and returning a tensor (or an array) of one value per row.
A batch then runs ``apply_torch`` under ``torch.inference_mode()`` through
the query's ``ExecutionContext._device_attempt``: the ``device.kernel``
fault site, the breaker, and only ``execution.DEVICE_FAILURES`` (the
injected fault, a staging decline, ``torch.cuda.OutOfMemoryError``) taken
as a failure that sends the batch to the host instance. Any other
exception, the user's own among them, reaches the caller (the reference
takes every exception of ``apply_jax`` and applies on the host).

In the 32-bit device mode the columns narrow as the reference's jitted
apply narrows them with x64 off: by the dtype of the numpy array staged
(float64 to float32, int64 to int32, uint64 to uint32), not by the
column's kind, since an int64 column with nulls stages as float64 with
NaN. So the result has the reference's bits; in the 64-bit mode nothing
narrows. ``_coerce_result`` casts the result back
to the UDF's return type.

Without ``apply_torch``, with device kernels off, or without an execution
context on this thread, the path declines (returns None) and the pinned
host instance applies: the reference's contract, not a fallback.

The execution context rides a thread-local that the batching executor and
BatchedUdfOp set while UDF expressions evaluate (``exec_ctx_scope``).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

import numpy as np

_tl = threading.local()

# jax's canonical dtypes with x64 off: each 64-bit array narrows to 32 bits
_NARROW_STAGED = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
                  np.dtype(np.uint64): np.uint32}


class exec_ctx_scope:
    """``with exec_ctx_scope(ctx): ...`` publishes the ExecutionContext to
    UDF evaluation on this thread (re-entrant: restores the prior one)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tl, "ctx", None)
        _tl.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tl.ctx = self._prev
        return False


def current_exec_ctx():
    return getattr(_tl, "ctx", None)


def apply_torch(fn, args: List[Any], device, x64: bool) -> np.ndarray:
    """``fn`` under inference mode over the batch's columns as tensors on
    ``device`` (each through ``to_numpy``, narrowed as jax narrows it with
    x64 off unless ``x64``), fetched to numpy."""
    import torch

    staged = []
    for a in args:
        arr = np.asarray(a.to_numpy())
        if not x64 and arr.dtype in _NARROW_STAGED:
            arr = arr.astype(_NARROW_STAGED[arr.dtype])
        staged.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    with torch.inference_mode():
        out = fn(*staged)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def device_apply(pool, args: List[Any], n: int) -> Optional[Any]:
    """One breaker-gated device attempt for a batch. None: the host instance
    applies (a decline, an open breaker, or one of DEVICE_FAILURES)."""
    ctx = current_exec_ctx()
    if ctx is None or not ctx.cfg.use_device_kernels:
        return None
    fn = pool.torch_callable()
    if fn is None:
        return None
    if not ctx.device_health.allow(ctx.stats):
        ctx.stats.bump("batch_device_fallbacks")
        return None
    device = ctx._device()
    out = ctx._device_attempt(lambda: apply_torch(fn, args, device, ctx.cfg.device_x64))
    if out is None:
        ctx.stats.bump("batch_device_fallbacks")
    else:
        ctx.stats.bump("batch_device_applies")
    return out
