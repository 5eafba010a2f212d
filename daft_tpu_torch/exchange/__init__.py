"""The exchange between partitions (the port's copy of the part of
daft_tpu/exchange/ this slice runs): the three legs of the reference's exchange,
each behind its own ``ExecutionConfig`` knob (default on), each leaving the
results as they are with the knob off.

- :mod:`joinfilter`: runtime join filters. A Bloom + min-max filter built
  from the join build side's keys prunes probe-side rows before they are
  bucketed (``runtime_join_filters``); its Bloom probe runs on the card
  (K10) when the partition clears ``device_min_rows``.
- :mod:`combine`: the hierarchical combine. A two-stage aggregate's stage-1
  pieces bound for one bucket fold through the stage-2 merge as they arrive
  (``hierarchical_exchange_combine``); under a memory budget it charges
  the ledger and abandons past half the budget.
- :mod:`encode`: the dictionary-encoded payload. Under a memory budget the
  shuffle's pieces encode their low-cardinality columns before they enter
  the spillable buckets (``exchange_payload_encoding``).
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
