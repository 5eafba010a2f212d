"""Python UDFs: the batch trampoline and the @udf decorator (the port's copy
of daft_tpu/udf.py).

UDFs receive Series (or scalars broadcast from literal arguments) in
batches and return a Series, list, numpy array or arrow array;
``batch_size`` splits long columns. Class UDFs (stateful) are instantiated
once per process and reused; with ``concurrency`` > 1 they run on an actor
pool (actor_pool.py), one instance per worker thread.

Batch-declared UDFs (``batch_udf`` or ``udf(..., batching=...)``) opt in to
dynamic batching (batch/): the declaration is the user's contract that the
fn is row-local, so the engine may coalesce partitions into batches and
re-split the output. Class targets of such UDFs route through
ModelActorPool (batch/actors.py), so weights load once per process and stay
resident across queries; with ``device=True`` a batch runs the model's
``apply_torch`` on the card (batch/device.py) before the host instance.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, List, Optional

import numpy as np

from .datatypes import DataType
from .series import Series

_STATEFUL_INSTANCES: dict = {}

_BATCHING_KEYS = ("max_rows", "max_bytes", "flush_ms", "mode", "device")


def _normalize_batching(batching: Any) -> Optional[dict]:
    """Validate a batching declaration into a plain dict (or None).

    True means "batch with config defaults"; a dict may override any of
    max_rows / max_bytes / flush_ms / mode ("ragged"|"padded") / device."""
    if batching is None or batching is False:
        return None
    if batching is True:
        return {}
    if not isinstance(batching, dict):
        raise ValueError(
            f"batching must be True/False or a dict, got {type(batching).__name__}")
    bad = [k for k in batching if k not in _BATCHING_KEYS]
    if bad:
        raise ValueError(f"unknown batching key(s) {bad!r}; valid keys: {list(_BATCHING_KEYS)}")
    mode = batching.get("mode")
    if mode is not None and mode not in ("ragged", "padded"):
        raise ValueError(f'batching mode must be "ragged" or "padded", got {mode!r}')
    return dict(batching)


def _coerce_result(out: Any, name: str, dtype: DataType, n: int) -> Series:
    """A UDF's output as a Series of ``n`` rows and ``dtype`` (cast when the
    function returned another type: a float32 device result of a float64
    UDF is cast back, as the reference casts its jitted float32 output)."""
    if isinstance(out, Series):
        s = out
    elif isinstance(out, np.ndarray):
        s = Series.from_numpy(out, name)
    elif isinstance(out, (list, tuple)):
        s = Series.from_pylist(list(out), name, dtype)
    else:
        import pyarrow as pa

        if not isinstance(out, (pa.Array, pa.ChunkedArray)):
            raise ValueError(
                f"UDF must return Series/list/numpy/arrow, got {type(out).__name__}")
        s = Series.from_arrow(out, name)
    if len(s) != n:
        raise ValueError(f"UDF returned {len(s)} rows, expected {n}")
    if s.dtype != dtype:
        s = s.cast(dtype)
    return s


def run_udf(fn: Callable, args: List[Series], return_dtype: DataType, n: int,
            batch_size: Optional[int] = None, init_args: Optional[tuple] = None,
            concurrency: Optional[int] = None,
            batching: Optional[dict] = None) -> Series:
    """Evaluate a UDF over column batches.

    Stateful (class) UDFs with concurrency > 1 run on a persistent actor pool
    (actor_pool.py): one instance per worker, batches dispatched across them,
    results re-assembled in order. Batch-declared class UDFs instead pin one
    instance per process through ModelActorPool (weights resident across
    queries, LRU-evicted under the ledger's model_cache_bytes account)."""
    from .series import _broadcast_to

    name = args[0].name if args else "udf"
    args = [_broadcast_to(a, n) if len(a) != n else a for a in args]

    if batching is not None and inspect.isclass(fn):
        from .batch.actors import get_model_pool

        pool = get_model_pool(fn, init_args)
        out = None
        if batching.get("device"):
            from .batch.device import device_apply

            out = device_apply(pool, args, n)  # None: the host instance applies
        if out is None:
            out = pool.apply(args, n)
        return _coerce_result(out, name, return_dtype, n)

    if inspect.isclass(fn) and concurrency and concurrency > 1:
        from .actor_pool import get_pool

        pool = get_pool(fn, init_args, concurrency)
        bs = batch_size or max(1, -(-n // concurrency))  # ceil-split across actors
        bounds = [(s, min(s + bs, n)) for s in range(0, n, bs)] or [(0, 0)]
        batches = [tuple(a.slice(s, e) for a in args) for s, e in bounds]
        outs = pool.map_batches(batches)
        coerced = [_coerce_result(o, name, return_dtype, e - s)
                   for o, (s, e) in zip(outs, bounds)]
        return Series.concat(coerced) if len(coerced) > 1 else coerced[0]

    if inspect.isclass(fn):
        key = (fn, repr(init_args))
        if key not in _STATEFUL_INSTANCES:
            a, kw = (init_args or ((), {}))
            _STATEFUL_INSTANCES[key] = fn(*a, **kw)
        fn = _STATEFUL_INSTANCES[key].__call__

    if not batch_size or n <= batch_size:
        return _coerce_result(fn(*args), name, return_dtype, n)
    outs = []
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        chunk = [a.slice(start, end) for a in args]
        outs.append(_coerce_result(fn(*chunk), name, return_dtype, end - start))
    return Series.concat(outs)


class UDF:
    """A wrapped user function callable over expressions."""

    def __init__(self, fn: Callable, return_dtype: DataType,
                 batch_size: Optional[int] = None, concurrency: Optional[int] = None,
                 init_args: Optional[tuple] = None, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None, memory_bytes: Optional[int] = None,
                 batching: Optional[dict] = None):
        self.fn = fn
        self.return_dtype = return_dtype
        self.batch_size = batch_size
        self.concurrency = concurrency
        self.init_args = init_args
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus
        self.memory_bytes = memory_bytes
        self.batching = batching
        self.__name__ = getattr(fn, "__name__", "udf")

    def __call__(self, *exprs):
        from .expressions import Expression, PyUdf, _as_expr_node

        nodes = [_as_expr_node(e) for e in exprs]
        rr = None
        if self.num_cpus or self.num_gpus or self.memory_bytes:
            rr = (self.num_cpus, self.num_gpus, self.memory_bytes)
        return Expression(PyUdf(self.fn, self.return_dtype, nodes, fn_name=self.__name__,
                                batch_size=self.batch_size, concurrency=self.concurrency,
                                init_args=self.init_args, resource_request=rr,
                                batching=self.batching))

    def with_init_args(self, *args, **kwargs) -> "UDF":
        return UDF(self.fn, self.return_dtype, self.batch_size, self.concurrency,
                   (args, kwargs), self.num_cpus, self.num_gpus, self.memory_bytes,
                   self.batching)

    def with_concurrency(self, concurrency: int) -> "UDF":
        return UDF(self.fn, self.return_dtype, self.batch_size, concurrency,
                   self.init_args, self.num_cpus, self.num_gpus, self.memory_bytes,
                   self.batching)

    def override_options(self, *, num_cpus=None, num_gpus=None, memory_bytes=None) -> "UDF":
        return UDF(self.fn, self.return_dtype, self.batch_size, self.concurrency,
                   self.init_args, num_cpus or self.num_cpus, num_gpus or self.num_gpus,
                   memory_bytes or self.memory_bytes, self.batching)


def udf(return_dtype: DataType, num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None, memory_bytes: Optional[int] = None,
        batch_size: Optional[int] = None, concurrency: Optional[int] = None,
        batching: Any = None):
    """Decorator creating a UDF (``return_dtype`` positional or by name, as
    the reference's api takes it). def and class targets both work; class
    targets are stateful (one instance per process, or per worker of an
    actor pool with ``concurrency``). ``batching=True`` (or a dict of
    overrides) opts into dynamic batching, as ``batch_udf`` does."""

    def wrap(fn):
        return UDF(fn, return_dtype, batch_size, concurrency,
                   num_cpus=num_cpus, num_gpus=num_gpus, memory_bytes=memory_bytes,
                   batching=_normalize_batching(batching))

    return wrap


def batch_udf(*, return_dtype: DataType, max_rows: Optional[int] = None,
              max_bytes: Optional[int] = None, flush_ms: Optional[float] = None,
              mode: Optional[str] = None, device: bool = False,
              concurrency: Optional[int] = None,
              num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
              memory_bytes: Optional[int] = None):
    """Declare a dynamically-batched UDF (batch/).

    The declaration is a contract that the fn is ROW-LOCAL: output row i
    depends only on input row i. Under that contract the engine coalesces
    partitions into batches under a byte/row budget with a max-latency
    flush timer, then re-splits results to exact source boundaries, so the
    outputs equal the unbatched path's.

    Class targets become pinned model actors: __init__ runs once per process,
    the instance stays resident across queries keyed by its fingerprint, and
    eviction is LRU under the ``model_cache_bytes`` budget. ``device=True``
    runs each batch through the model's ``apply_torch`` on the card, behind
    the device breaker (batch/device.py)."""
    batching = {}
    if max_rows is not None:
        batching["max_rows"] = max_rows
    if max_bytes is not None:
        batching["max_bytes"] = max_bytes
    if flush_ms is not None:
        batching["flush_ms"] = flush_ms
    if mode is not None:
        batching["mode"] = mode
    if device:
        batching["device"] = True

    def wrap(fn):
        return UDF(fn, return_dtype, None, concurrency,
                   num_cpus=num_cpus, num_gpus=num_gpus, memory_bytes=memory_bytes,
                   batching=_normalize_batching(batching or True))

    return wrap
