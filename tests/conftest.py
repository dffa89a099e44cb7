"""Test env: force CPU backend with 8 virtual devices BEFORE jax import.

This is the fake-backend analog the SURVEY §4c test plan calls for: all
sharding/collective logic runs on an 8-device CPU mesh in one process.
What needs the GPU runs in `chip_smoke.py` instead.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force, even if the env preselects GPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# A sitecustomize may import jax before conftest runs, so the env var
# alone can be too late — override the already-captured config value too.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
