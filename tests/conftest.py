"""Test configuration: the suite runs on the CPU with 8 virtual devices.

The CPU client is created lazily, so setting XLA_FLAGS here still yields 8
virtual devices for the sharding tests, and the Pallas heads run in the
interpreter. The persistent compile cache is off, so no CPU executable is
written into the checkout's cache directory.

Tests marked `gpu` need the card: they skip here (the `gpu` fixture decides
at run time), and run on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

which is the one case where this file leaves the platform alone.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import cmtci  # noqa: E402,F401  (x64 + its compile-cache setup, undone below)

if os.environ.get("JAX_PLATFORMS") != "cuda":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", None)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is the GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
