"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Tests run on the CPU (fast local compiles, 8 virtual devices for the
sharded engine's mesh).  Checks that need an NVIDIA card carry the
``gpu`` marker and take the ``gpu_card`` fixture, which skips them
when no card answers; run them on a machine with one through
``python -m pytest tests -m gpu``.
"""

import os
import subprocess
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except ImportError:  # pragma: no cover
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips without one)")


@pytest.fixture(scope="session")
def gpu_card():
    """Skip unless JAX, held to CUDA, finds a GPU (checked in a child
    process: this one is pinned to the CPU)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=env, timeout=300)
    if r.returncode != 0 or r.stdout.strip() != "gpu":
        pytest.skip("no NVIDIA card visible to JAX")


@pytest.fixture(scope="session")
def native_lib():
    """Skip unless the native ingest library builds and loads."""
    from genrich_tpu.ingest import native
    if not native.available():
        pytest.skip("native ingest library unavailable")
