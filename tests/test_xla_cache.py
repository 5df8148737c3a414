"""Where compiled programs persist (utils/xla_cache.py)."""

from __future__ import annotations

import os
import subprocess
import sys
import uuid

import pytest

from genrich_tpu.utils import xla_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import jax, jax.numpy as jnp
from genrich_tpu.utils import xla_cache
xla_cache.enable_compile_cache()
print(jax.config.jax_compilation_cache_dir)
def f(x):
    return x * 3.25 + 1
f.__name__ = "{name}"
jax.jit(f)(jnp.arange(7.0)).block_until_ready()
"""


@pytest.mark.parametrize("from_env", [True, False],
                         ids=["JAX_COMPILATION_CACHE_DIR", "checkout"])
def test_compile_cache_location(tmp_path, from_env):
    """With JAX_COMPILATION_CACHE_DIR set, entries land there and the
    program names no directory of its own; without it, in the fixed
    <checkout>/.jax_cache."""
    name = f"cache_probe_{uuid.uuid4().hex[:12]}"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    assert xla_cache.CACHE_DIR == want
    if from_env:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c", PROBE.format(name=name)],
                       env=env, capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.strip().splitlines()[0] == want

    def entries(d):
        return [f for f in os.listdir(d) if name in f] \
            if os.path.isdir(d) else []

    assert entries(want), os.listdir(want)
    other = xla_cache.CACHE_DIR if from_env else str(tmp_path / "cc")
    assert not entries(other)
