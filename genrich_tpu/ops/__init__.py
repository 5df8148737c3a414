"""Device kernels: the numeric pipeline as jittable JAX array programs.

These mirror the algorithms in :mod:`genrich_tpu.engine` but with
static shapes, masked padding, and data-parallel primitives
(lax.sort, cumulative sums, segment reductions) so the whole
events -> pileup -> p-value -> peaks pipeline runs as one fused XLA
computation per genome tile, and shards over tiles via
:mod:`genrich_tpu.parallel`.
"""
