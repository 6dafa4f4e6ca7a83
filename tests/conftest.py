"""Test configuration.

The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise, on a
virtual 8-device CPU mesh so sharding paths are exercised without several
accelerators. Tests that need a GPU carry the ``gpu`` marker and the ``gpu``
fixture, which skips them where JAX finds none; ``python chip_smoke.py``
runs them on the card.
"""
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

REFERENCE_EXAMPLE_DATA = Path("/root/reference/examples/example_data")


def pytest_configure(config):
    config.addinivalue_line("markers", "perf: heavy quality/benchmark runs")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, not at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled E-step kernel has no CPU form")
