"""Morsel-driven streaming execution (the port's copy of daft_tpu/stream/).

A streamable chain (a Scan or InMemory source, Project/Filter/FusedMap/
BatchedUdf maps, an optional Limit above them) pulls morsels of
``cfg.morsel_size_rows`` rows through bounded channels instead of
materializing whole partitions between its steps. The ops above the chain
see whole partitions again behind the driver's re-chunk, so results equal
those with ``cfg.streaming_execution`` off.

- :mod:`daft_tpu_torch.stream.morsel`: zero-copy slices of a partition's
  reader chunks;
- :mod:`daft_tpu_torch.stream.channel`: the bounded channel, charged to the
  ledger's ``stream_inflight``, with close and error propagation;
- :mod:`daft_tpu_torch.stream.pipeline`: the segment extraction and the
  producer/consumer driver over the query's worker pool.
"""

from .channel import BoundedChannel, ChannelClosed, channels_snapshot
from .morsel import iter_morsels
from .pipeline import try_stream

__all__ = ["BoundedChannel", "ChannelClosed", "channels_snapshot", "iter_morsels",
           "try_stream"]
