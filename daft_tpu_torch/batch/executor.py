"""BatchingExecutor: coalesce, (pad), apply, re-split (the port's copy of
daft_tpu/batch/executor.py).

The engine behind BatchedUdfOp: source partitions are fed in order and
OUTPUT partitions come back re-split to exactly the source boundaries, so
every consumer above sees the piece boundaries of the unbatched path,
which is what keeps batching invisible in the results.

A fault at ``batch.coalesce`` degrades THIS executor for good to the
per-piece UDF path (each source piece evaluated alone: still correct, just
unbatched), after settling the buffered ledger charge; it never fails the
query; it logs ``batch_coalesce_degraded``. A model-load failure surfaces
from the apply as the typed error of batch/actors.py.

A flush records a ``batch.coalesce`` phase span (the concat and padding)
and an ``actor.apply`` phase span (the apply, K13 on the card among it)
under the op, and bumps the process-wide flush counts that
``health()["batching"]`` reads (``process_counters``).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from ..micropartition import MicroPartition
from ..series import Series
from .coalesce import Coalescer, Flush
from .device import exec_ctx_scope

# the process-wide flush counts of health()["batching"] (the per-query
# counts live on RuntimeStats)
_proc_lock = threading.Lock()
_proc_counts = {"batches_formed": 0, "flushes_budget": 0, "flushes_timer": 0,
                "flushes_end": 0, "coalesce_faults": 0}


def _proc_bump(key: str, n: int = 1) -> None:
    with _proc_lock:
        _proc_counts[key] += n


def process_counters() -> dict:
    with _proc_lock:
        return dict(_proc_counts)


def _next_bucket(n: int, floor: int = 8) -> int:
    """The next power-of-two batch bucket >= n (at least ``floor``): few
    distinct shapes for a device apply."""
    b = floor
    while b < n:
        b <<= 1
    return b


class BatchSettings:
    """Effective knobs: the declaration's overrides over ExecutionConfig."""

    __slots__ = ("max_rows", "max_bytes", "flush_ms", "mode")

    def __init__(self, max_rows: int, max_bytes: int, flush_ms: float, mode: str):
        self.max_rows = max(1, int(max_rows))
        self.max_bytes = max(1, int(max_bytes))
        self.flush_ms = float(flush_ms)
        self.mode = mode

    @classmethod
    def resolve(cls, declaration: Optional[dict], cfg) -> "BatchSettings":
        d = declaration or {}
        return cls(d.get("max_rows", cfg.batch_max_rows),
                   d.get("max_bytes", cfg.batch_max_bytes),
                   d.get("flush_ms", cfg.batch_flush_ms),
                   d.get("mode", cfg.batch_padding))


class BatchingExecutor:
    """One per op execute call. Feed source pieces in order; outputs come
    back re-split to those boundaries, possibly several per feed (timer and
    budget both firing) or none (still buffering); ``finish()`` drains the
    tail."""

    def __init__(self, op_name: str, exprs, ctx, settings: Optional[BatchSettings] = None,
                 clock=time.monotonic):
        self.op_name = op_name
        self.exprs = exprs
        self.ctx = ctx
        self.settings = settings or BatchSettings.resolve(None, ctx.cfg)
        self._coalescer = Coalescer(self.settings.max_rows, self.settings.max_bytes,
                                    self.settings.flush_ms, ledger=ctx.ledger, clock=clock)
        self._degraded = False

    def _apply_one(self, part: MicroPartition) -> MicroPartition:
        """The per-piece UDF path (the degrade target): the projection on one
        source piece alone."""
        with exec_ctx_scope(self.ctx):
            return part.eval_expression_list(self.exprs)

    def _pad(self, part: MicroPartition, rows: int):
        """Pad to the next power-of-two bucket by repeating the last row (any
        real row works: the padding is sliced off after the apply)."""
        pad_n = _next_bucket(rows) - rows
        if pad_n <= 0 or rows == 0:
            return part, 0
        idx = np.concatenate([np.arange(rows, dtype=np.int64),
                              np.full(pad_n, rows - 1, dtype=np.int64)])
        return part.take(Series.from_numpy(idx, "idx")), pad_n

    def _run_flush(self, f: Flush) -> List[MicroPartition]:
        from .. import faults

        stats = self.ctx.stats
        prof = stats.profiler
        try:
            with prof.span("batch.coalesce", op=self.op_name, kind="phase",
                           rows=f.rows, pieces=len(f.parts)):
                faults.check("batch.coalesce", stats)
                batch = f.parts[0] if len(f.parts) == 1 else MicroPartition.concat(f.parts)
                pad_n = 0
                capacity = max(self.settings.max_rows, f.rows)
                if self.settings.mode == "padded" and f.rows:
                    batch, pad_n = self._pad(batch, f.rows)
                    capacity = f.rows + pad_n
        except Exception as e:
            # the coalesce failed (injected or real): this executor degrades
            # to the per-piece UDF path, the same rows, never a query failure
            stats.bump("batch_coalesce_faults")
            _proc_bump("coalesce_faults")
            self._degraded = True
            self._coalescer.settle(f)
            from ..obs.log import get_logger

            get_logger("batch").warning("batch_coalesce_degraded", op=self.op_name,
                                        error=repr(e))
            return [self._apply_one(p) for p in f.parts]

        stats.bump("batches_formed")
        stats.bump("batch_rows", f.rows)
        stats.bump("batch_capacity_rows", capacity)
        if pad_n:
            stats.bump("batch_rows_padded", pad_n)
        stats.bump(f"batch_flushes_{f.reason}")
        _proc_bump("batches_formed")
        _proc_bump(f"flushes_{f.reason}")

        try:
            with prof.span("actor.apply", op=self.op_name, kind="phase", rows=f.rows):
                with exec_ctx_scope(self.ctx):
                    out = batch.eval_expression_list(self.exprs)
            if pad_n:
                out = out.slice(0, f.rows)
            # re-split to the EXACT source boundaries (prefix sums in feed order)
            pieces: List[MicroPartition] = []
            off = 0
            for p in f.parts:
                n = len(p)
                pieces.append(out.slice(off, off + n))
                off += n
            return pieces
        finally:
            # settle even when the apply raises (a typed model-load failure):
            # the error may fail the query, but no charge stays outstanding
            self._coalescer.settle(f)

    def feed(self, part: MicroPartition) -> List[MicroPartition]:
        if self._degraded:
            return [self._apply_one(part)]
        outs: List[MicroPartition] = []
        for f in self._coalescer.feed(part):
            outs.extend(self._run_flush(f))
        return outs

    def finish(self) -> List[MicroPartition]:
        outs: List[MicroPartition] = []
        for f in self._coalescer.finish():
            outs.extend(self._run_flush(f))
        return outs

    def abort(self) -> None:
        """Teardown without apply: settle any still-buffered ledger charge
        (idempotent; a clean finish leaves nothing buffered)."""
        for f in self._coalescer.finish():
            self._coalescer.settle(f)
