"""Input and output (the port's copy of the part of daft_tpu/io/ this slice
reads): the scan pushdowns alone, which the lazy partitions of the spill
layer narrow through. The readers and scan tasks come with the scan slice."""
