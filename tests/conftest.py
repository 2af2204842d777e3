"""Test harness: run the tests on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without accelerators via
``--xla_force_host_platform_device_count``.  Must run before the first
``import jax``.  ``JAX_PLATFORMS`` defaults to ``cpu``; the ``gpu``-marked
tests run on a card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`` and skip elsewhere.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pose algebra correctness tests use float64 oracles; enabling x64 makes jnp
# honor input dtypes (the pipeline itself still runs float32/bfloat16).
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.  Decided
    here, at run time, so every worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return jax.devices()[0]
