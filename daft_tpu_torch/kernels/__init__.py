"""Device layer of the port: staging, the expression compiler, segment
reductions, the fused aggregation and the hand-written kernels."""
