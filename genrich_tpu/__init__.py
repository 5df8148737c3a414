"""genrich-tpu: a JAX peak-calling engine for genomic enrichment assays.

A from-scratch reimplementation of the capabilities of Genrich v0.6.2
(reference: Genrich.c) designed for an accelerator (an NVIDIA GPU):

- host-side ingest turns SAM/BAM alignments into flat fragment-interval
  event arrays (``genrich_tpu.ingest``),
- the genome-scale numeric pipeline (pileups, p-values, q-values, peak
  masks) runs as vectorized integer/float32 array programs in JAX that
  shard over genome tiles (``genrich_tpu.engine``, ``genrich_tpu.ops``,
  ``genrich_tpu.parallel``),
- bit-exact float64 ports of the statistical kernels back the default
  output path so results match the reference byte-for-byte
  (``genrich_tpu.engine.pvalue``, ``genrich_tpu.engine.chisq``).
"""

__version__ = "0.1.0"

# Keep genome-scale numpy temporaries on the persistent heap instead
# of per-allocation mmap/munmap (see utils/malloc_tuning.py: ~30%
# end-to-end on allocation-heavy phases, byte-identical results).
# Early, so it covers every allocation the analysis makes.
import os as _os

if _os.environ.get("GENRICH_MALLOC_TUNING", "1") != "0":
    from .utils.malloc_tuning import tune_malloc as _tune_malloc

    _tune_malloc()

GENRICH_COMPAT_VERSION = "0.6.2"  # reference Genrich.h:9
