"""The hierarchical exchange: the stage-2 merge applied before the
exchange (the port's copy of daft_tpu/exchange/combine.py).

A two-stage aggregation ships one stage-1 partial row per (source partition
x group) through the hash exchange, so every bucket holds P pieces that
stage 2 merges. Folding the pieces bound for one bucket with the stage-2
merge as they arrive shrinks what the exchange holds and merges from
P x groups rows to about groups rows per bucket.

The fold keeps ONE running partial per bucket and always re-aggregates
``[running_partial, new pieces...]`` with the partial's rows first, so the
groups keep their first-occurrence order: the results equal those with
``hierarchical_exchange_combine`` off. Only merges that are exact under any
regrouping fold: integer and count sums, min, max, the order-keeping
concat of list partials and the sketch merges (the HLL register max; the
quantile merge, whose compression keys on the values alone). A float sum
declines, since folding early changes its order of additions.

The staged pieces live outside the spillable bucket buffers, so they are
charged to the query's MemoryLedger while staged, and under a byte budget the
combiner abandons once they pass half the budget (the rest of the budget
belongs to the buffers, which can spill).

A fold raises what its aggregate raises: a transient merge failure (the
``sketch.merge`` fault site) reaches the caller, as the same merge after
the exchange would, and the staged pieces' charge leaves the ledger first
(the reference's combiner keeps it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..micropartition import MicroPartition

# pieces staged per bucket before a re-aggregation pass (the running partial
# always rides first, so the cadence trades fold work against staged pieces
# and cannot change results)
FOLD_EVERY = 16

# stage-2 kinds the fold may apply early: order-insensitive exact merges
# (min, max, the sketch register max), exact accumulations (integer sums;
# float sums are gated by dtype in combine_spec_applicable) and
# order-keeping concatenations (concat). any_value declines: which value it
# picks depends on the shape of its input, so a fold could change the value
# that survives.
COMBINABLE_KINDS = {"sum", "min", "max", "concat", "merge_sketch_hll", "merge_sketch_quantile"}

# a fold that keeps more than this share of its input rows is not reducing
# (near-unique keys): the combiner abandons and hands every piece on raw
ABANDON_MIN_SHRINK = 0.75


def combine_spec_applicable(stage2, key_cols, exchanged_schema) -> bool:
    """Translate-time gate: True when folding ``stage2`` early over pieces
    of ``exchanged_schema`` is closed (its output schema is its input
    schema) and every aggregation kind is a merge that is exact under
    regrouping (a float sum declines)."""
    from ..expressions import AggExpr, Alias
    from ..physical import _stage_schema

    for e in stage2:
        node = e._node
        while isinstance(node, Alias):
            node = node.child
        if not (isinstance(node, AggExpr) and node.kind in COMBINABLE_KINDS):
            return False
        if node.kind == "sum":
            try:
                dt = node.to_field(exchanged_schema).dtype
            except (ValueError, KeyError):
                return False
            if not dt.is_integer():
                return False
    try:
        out_schema = _stage_schema(exchanged_schema, stage2, key_cols)
    except (ValueError, KeyError):
        return False
    return out_schema == exchanged_schema


class BucketCombiner:
    """Per-bucket running partials for one shuffle's fanout.

    ``add(bucket, piece)`` stages a piece; every FOLD_EVERY staged pieces
    the bucket re-aggregates ``[partial] + staged`` into one new partial.
    ``finish()`` folds the remainders and yields ``(bucket, partial)`` for
    every touched bucket: the only rows that enter the exchange. A fold
    that does not shrink past ABANDON_MIN_SHRINK abandons the combiner for
    the whole shuffle: every staged piece (the partials among them, which
    are valid partial aggregates of their inputs) is handed back unfolded,
    and stage 2 merges partials of any granularity. So does passing half of
    ``budget`` in staged bytes; the staged bytes are charged to ``ledger``
    while staged."""

    def __init__(self, aggs, keys, stats=None, ledger=None, budget=None):
        self.aggs = list(aggs)
        self.keys = list(keys)
        self.stats = stats
        self.ledger = ledger
        self.budget = budget
        self._staged: Dict[int, List[MicroPartition]] = {}
        self._staged_bytes: Dict[int, int] = {}
        self._held = 0
        self._failed = False

    @property
    def failed(self) -> bool:
        return self._failed

    def _charge(self, bucket: int, piece: MicroPartition) -> None:
        b = piece.size_bytes() or 0
        if b:
            self._staged_bytes[bucket] = self._staged_bytes.get(bucket, 0) + b
            self._held += b
            if self.ledger is not None:
                self.ledger.add(b)

    def _release(self, bucket: int) -> None:
        b = self._staged_bytes.pop(bucket, 0)
        if b:
            self._held -= b
            if self.ledger is not None:
                self.ledger.sub(b)

    def _abandon(self) -> List[Tuple[int, MicroPartition]]:
        self._failed = True
        out = [(b, p) for b in sorted(self._staged) for p in self._staged[b]]
        self._staged = {}
        for b in list(self._staged_bytes):
            self._release(b)
        return out

    def add(self, bucket: int, piece: MicroPartition
            ) -> Optional[List[Tuple[int, MicroPartition]]]:
        """Stage one fanout piece. Returns None, or, when a fold declines or
        the staged bytes pass half the budget, every staged ``(bucket,
        partition)`` for the caller to append raw (the combiner then stops)."""
        staged = self._staged.setdefault(bucket, [])
        staged.append(piece)
        self._charge(bucket, piece)
        if len(staged) >= FOLD_EVERY + 1:
            folded = self._fold_or_release(staged)
            if folded is None:
                return self._abandon()
            self._release(bucket)
            self._staged[bucket] = [folded]
            self._charge(bucket, folded)
        if self.budget is not None and self._held > self.budget // 2:
            # staged partials cannot spill: past half the budget they go to
            # the spillable buffers instead
            return self._abandon()
        return None

    def finish(self):
        """Fold the remainders; yields (bucket, partial) in bucket order."""
        for b in sorted(self._staged):
            staged = self._staged[b]
            self._release(b)
            if len(staged) == 1:
                yield b, staged[0]
                continue
            folded = self._fold_or_release(staged)
            if folded is None:
                for p in staged:
                    yield b, p
                continue
            yield b, folded
        self._staged = {}

    def _fold_or_release(self, staged: List[MicroPartition]) -> Optional[MicroPartition]:
        """``_fold``; when it raises (a transient merge failure, the
        ``sketch.merge`` site), every staged piece's charge leaves the
        ledger before the error reaches the caller."""
        try:
            return self._fold(staged)
        except BaseException:
            self._abandon()
            raise

    def _fold(self, staged: List[MicroPartition]) -> Optional[MicroPartition]:
        """One host aggregate of the staged pieces, or None when it is not
        schema-closed or barely shrinks."""
        in_rows = sum(len(p) for p in staged)
        merged = MicroPartition.concat(staged) if len(staged) > 1 else staged[0]
        out = merged.agg(self.aggs, self.keys)
        if out.schema != merged.schema:
            return None  # not schema-closed at run time
        if len(out) > ABANDON_MIN_SHRINK * in_rows:
            return None  # near-unique keys: the partial would hold the whole bucket
        if self.stats is not None:
            self.stats.bump("exchange_precombined_rows", max(0, in_rows - len(out)))
        return out
