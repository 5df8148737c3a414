"""Persistent XLA compilation cache.

Compiled programs are kept on disk so that later processes (serve
restarts, CLI runs, benches) load them instead of compiling again.
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here names a directory.  Otherwise the cache is the fixed
``<checkout>/.jax_cache`` (gitignored): the directory is part of what
makes a later run find an entry, so it never moves with the host or
the backend.
"""

from __future__ import annotations

import os
import sys

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> None:
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(CACHE_DIR, exist_ok=True)
        except OSError as exc:
            print(f"genrich_tpu: compile cache off: {exc}",
                  file=sys.stderr)
            return
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache every program: the small per-chromosome programs are the
    # ones a serve restart or a CLI run would otherwise recompile
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
