"""Lineage-based recomputation for spilled partitions (the port's copy of
daft_tpu/integrity/lineage.py).

Restarting a whole query because one spill file rotted is the
coarse-grained failure mode operator frameworks avoid by recovering
individual operator outputs from lineage (HPTMT, PAPERS.md). Here the
unit is a spilled partition: when it enters the spill layer, a RECIPE —
a zero-arg closure that re-derives the partition's exact logical tables
from stable storage — is recorded in the query's bounded
:class:`LineageLog`; when the spill read-back detects corruption (or the
file is simply gone), the slot task recomputes through the recipe and
serves the recomputed table, counted as ``partitions_recomputed``,
instead of failing the query.

Recipes must never pin partition memory (that would defeat the spill),
so only partitions re-derivable from stable sources get one:

- a spilled partition still backed by a re-readable scan task (the file
  is the source of truth: re-read it);
- a piece of a hash, random or range shuffle whose source partition was an
  unloaded scan partition (``fanout_piece_recipe``, ``range_piece_recipe``:
  re-read the source and split it again, deterministically), and the
  buffered input of a range shuffle, which its key sampling loaded
  (``task_recipe`` of the task captured before the sampling).

Everything else — loaded in-memory sources, pruned/combined exchange
pieces — is *truncated* lineage: corruption there raises
``DaftCorruptionError`` (a ``DaftError``) to the caller and counts
``lineage_truncated``, never a garbled result. The log itself is bounded
(``cfg.lineage_log_depth``); evicting a recipe is also truncation,
counted so tests can pin the degradation path."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional

Recipe = Callable[[], List]  # zero-arg -> the partition's chunk Tables


class LineageLog:
    """Bounded per-query recipe registry (key -> recompute closure).

    ``record`` returns an opaque key the spill slot task stores; ``get``
    returns the recipe or None when it was evicted (bounded log) — the
    caller treats None as truncated lineage and degrades."""

    def __init__(self, depth: int = 4096):
        self._lock = threading.Lock()
        self._depth = max(0, int(depth))
        self._recipes: "OrderedDict[int, Recipe]" = OrderedDict()
        self._seq = 0
        self.recorded = 0
        self.evicted = 0

    def record(self, recipe: Recipe) -> Optional[int]:
        """Register a recipe; returns its key, or None when the log is
        configured away (depth 0 — every spill is truncated lineage)."""
        if self._depth <= 0:
            return None
        with self._lock:
            self._seq += 1
            key = self._seq
            self._recipes[key] = recipe
            self.recorded += 1
            while len(self._recipes) > self._depth:
                self._recipes.popitem(last=False)
                self.evicted += 1
            return key

    def get(self, key: Optional[int]) -> Optional[Recipe]:
        if key is None:
            return None
        with self._lock:
            return self._recipes.get(key)

    def forget(self, key: Optional[int]) -> None:
        """Drop a recipe whose spill slot was consumed/recycled (keeps the
        bounded log dense with recipes that can still be needed)."""
        if key is None:
            return
        with self._lock:
            self._recipes.pop(key, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {"depth": self._depth, "live": len(self._recipes),
                    "recorded": self.recorded, "evicted": self.evicted}


def rereadable_task(task) -> bool:
    """Is ``task`` a stable-storage scan task a recipe may capture?

    Spill slots re-read the (possibly corrupt) spill file itself and
    encoded exchange tasks hold their payload in memory — capturing
    either would be circular or would pin the bytes the spill exists to
    release. Anything shaped like a real scan task (reads from source
    storage on demand) qualifies."""
    if task is None:
        return False
    from ..exchange.encode import EncodedExchangeTask
    from ..spill import _SpillSlotTask, _SpillSlotView

    return not isinstance(task, (_SpillSlotTask, _SpillSlotView,
                                 EncodedExchangeTask))


def unwrap_source_task(part):
    """The re-readable scan task behind an UNLOADED partition, or None.

    A readahead wrapper (io/prefetch.py) holds its query's fetch state, so
    the recipe captures the task it wraps: a recompute re-reads the file,
    never a consumed fetch."""
    task = part.scan_task()
    task = getattr(task, "_task", task)
    return task if rereadable_task(task) else None


def task_recipe(task) -> Recipe:
    """Recipe for a partition that IS a scan task's output: re-read it."""

    def recompute() -> List:
        if hasattr(task, "read_chunks"):
            return list(task.read_chunks())
        return [task.read()]

    return recompute


def range_piece_recipe(src_task, by, boundaries, descending, nulls_first,
                       idx: int) -> Recipe:
    """Recipe for one range-shuffle piece: re-read the SOURCE partition
    and re-run the deterministic boundary split (the boundaries are a few
    sampled key rows, cheap to capture), keeping piece ``idx``."""

    def recompute() -> List:
        from ..micropartition import MicroPartition

        mp = MicroPartition.from_scan_task(src_task)
        pieces = mp.partition_by_range(by, boundaries, descending, nulls_first)
        return [pieces[idx].table()]

    return recompute


def fanout_piece_recipe(src_task, by, scheme: str, num: int, seed: int,
                        idx: int) -> Recipe:
    """Recipe for one shuffle fan-out piece: re-read the SOURCE partition
    and re-run the deterministic split (hash bucketing or the seeded random
    split), keeping bucket ``idx``."""

    def recompute() -> List:
        from ..micropartition import MicroPartition

        mp = MicroPartition.from_scan_task(src_task)
        if scheme == "hash":
            pieces = mp.partition_by_hash(by, num)
        else:
            pieces = mp.partition_by_random(num, seed=seed)
        return [pieces[idx].table()]

    return recompute
