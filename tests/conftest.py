"""Test configuration: run JAX on 8 virtual CPU devices.

The tier-1 command sets ``JAX_PLATFORMS=cpu``; sharding tests use the
standard mesh-on-CPU trick (XLA_FLAGS=--xla_force_host_platform_device_count=8).
Tests marked ``chip`` need a GPU and skip without one (see the ``gpu``
fixture); run them on the card with ``python -m pytest -m chip tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# `lrcn`'s start-up turns on the persistent compilation cache; tests call
# it in-process, and parallel test workers must not share cache files.
jax.config.update("jax_enable_compilation_cache", False)

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def reference_eval_dir():
    """Path to the reference repo's committed eval artifacts (golden data)."""
    path = os.path.join(REFERENCE_DIR, "eval")
    if not os.path.isdir(path):
        pytest.skip("reference eval artifacts not available")
    return path


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {device.platform}")
    return device
