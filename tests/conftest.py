"""Test harness.

The default suite runs on JAX's CPU backend with 8 virtual devices, so the
sharding paths run without accelerators (as `dryrun_multichip` does).
Tests marked `gpu` need an NVIDIA GPU; their `gpu` fixture skips them
anywhere else.  Run that lane on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

The platform is pinned with jax.config (before any backend starts) unless
JAX_PLATFORMS names CUDA.
"""

import os

import pytest

GPU_LANE = "cuda" in os.environ.get("JAX_PLATFORMS", "")

if not GPU_LANE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not GPU_LANE:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The default device, which must be a GPU; skips the test elsewhere."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX's default backend is "
                    f"{jax.default_backend()})")
    return jax.devices()[0]
