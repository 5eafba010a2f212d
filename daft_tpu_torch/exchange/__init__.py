"""The exchange between partitions (the port's copy of the part of
daft_tpu/exchange/ this slice runs): two legs of the reference's exchange,
each behind its own ``ExecutionConfig`` knob (default on), each leaving the
results as they are with the knob off.

- :mod:`joinfilter`: runtime join filters. A Bloom + min-max filter built
  from the join build side's keys prunes probe-side rows before they are
  bucketed (``runtime_join_filters``); its Bloom probe runs on the card
  (K10) when the partition clears ``device_min_rows``.
- :mod:`combine`: the hierarchical combine. A two-stage aggregate's stage-1
  pieces bound for one bucket fold through the stage-2 merge as they arrive
  (``hierarchical_exchange_combine``).

Left out: the reference's third leg, the dictionary-encoded payload
(``exchange/encode.py``), which engages only under a memory budget, and the
port has no memory ledger.
"""

from .combine import BucketCombiner, combine_spec_applicable
from .joinfilter import JoinFilterBuilder, JoinFilterSlot, RuntimeJoinFilter

__all__ = [
    "BucketCombiner",
    "combine_spec_applicable",
    "JoinFilterBuilder",
    "JoinFilterSlot",
    "RuntimeJoinFilter",
]
