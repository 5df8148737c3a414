"""Numeric engine: pileups, statistics, q-values, peak calling.

Two implementations share the same algorithms:

- this package (numpy, float64/float32 with C-exact semantics) backs the
  default CLI path and matches the reference byte-for-byte;
- :mod:`genrich_tpu.ops` holds the jittable JAX versions of the same
  kernels for device execution and sharding.
"""
