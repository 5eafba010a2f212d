"""Engine error hierarchy (the port's copy of daft_tpu/errors.py; reference:
DaftError, src/common/error/error.rs).

Every class dual-inherits the builtin exception users would naturally catch,
so `except ValueError` keeps working while `except DaftError` catches all
engine-raised failures. Raise sites adopt these types incrementally; the
public contract is the hierarchy itself."""

from __future__ import annotations

import torch


class DaftError(Exception):
    """Base of every engine-raised error (reference: DaftError enum)."""


class DaftTypeError(DaftError, TypeError):
    """Expression/kernel type mismatch (reference: DaftError::TypeError)."""


class DaftValueError(DaftError, ValueError):
    """Invalid argument or value (reference: DaftError::ValueError)."""


class DaftSchemaError(DaftError, ValueError):
    """Schema resolution failure: unknown column, incompatible field
    (reference: DaftError::SchemaMismatch / FieldNotFound)."""


class DaftNotFoundError(DaftError, FileNotFoundError):
    """Missing file/table/catalog object (reference: DaftError::FileNotFound)."""


class DaftIOError(DaftError, IOError):
    """IO failure after retries (reference: DaftError::External on IO)."""


class DaftResourceError(DaftError, RuntimeError):
    """Unsatisfiable resource request (reference: admission failure in
    pyrunner.py:352-370)."""


class DaftOverloadedError(DaftError, RuntimeError):
    """The serving runtime shed this query: the admission queue was full,
    the queue wait exceeded its timeout, or the engine was draining for
    shutdown. Deliberate load shedding, never an engine bug — callers
    back off and retry against a less loaded instance."""


class DaftInternalError(DaftError, RuntimeError):
    """An engine invariant was violated — always a bug in the engine itself,
    never a user or environment error (reference: DaftError::InternalError).
    Raised loudly so defects surface instead of corrupting results."""


class DaftTransientError(DaftError, IOError):
    """Transient, retryable failure (timeouts, 5xx, connection resets, and
    injected faults). Retry policies key on this type: anything else is
    treated as permanent and propagates immediately."""


class DaftCorruptionError(DaftTransientError):
    """A payload failed its end-to-end integrity check — a spill IPC file,
    a transport frame, or an encoded exchange piece came back with bytes
    that do not match the checksum recorded when the payload was produced
    (or the artifact is missing/unparseable at re-entry). Raised INSTEAD of
    surfacing a garbled table or a deep arrow decode error. Classified
    transient: the lineage-recompute and task-retry/re-dispatch layers own
    recovery, and only when both are exhausted does the query fail."""


class DaftStagingError(DaftValueError):
    """The device layer cannot stage a column it was given: the 32-bit
    mode's int32 range guard on an int64 column. A device attempt counts it
    as a DeviceHealth breaker failure and the partition completes on the
    host, as the reference's staging ``ValueError`` does."""


class DaftTimeoutError(DaftError, TimeoutError):
    """Query exceeded ExecutionConfig.execution_timeout_s. Carries the
    partial RuntimeStats snapshot accumulated before the deadline so
    callers can see how far the query got."""

    def __init__(self, message: str, stats: "dict | None" = None):
        super().__init__(message)
        self.stats = stats or {}


class DaftKernelError(DaftInternalError):
    """A hand-written kernel or the card it runs on is unavailable: nvcc is
    missing or fails on a source, a built library does not load, a launch
    returns an error, or the config asks for the card where torch sees
    none. The device path never catches it (nor ``torch.AcceleratorError``,
    a CUDA error): the DeviceHealth breaker takes failures of the device
    layer, and a broken port is not one of them."""


# failures of the port itself: the broader catches around the device path
# (the fuse compile, the join filter's fail-open) re-raise them first
PORT_FAILURES = (DaftKernelError, torch.AcceleratorError)
