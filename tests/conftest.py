"""Test harness bootstrap.

Tests run on the local CPU with 8 virtual devices, so the mesh and
collective tests need no accelerator (SURVEY.md §4). JAX may already be
imported when this file runs, but its backend client is created lazily,
so setting ``jax_platforms`` here still wins; XLA_FLAGS is also read
lazily, at CPU-client creation. The persistent compilation cache is the
package's own (utils/cachedir.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import direct_lidar_odometry_tpu  # noqa: E402,F401  (configures the cache)

import numpy as np
import pytest

assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
