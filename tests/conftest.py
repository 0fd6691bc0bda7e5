"""Test configuration: pin JAX to a virtual 8-device CPU mesh so tests
are hermetic and sharding tests exercise real multi-device compilation.

Tests marked ``gpu`` need an NVIDIA GPU; they skip with a reason
everywhere else (decided in the ``gpu_device`` fixture, never at
import).  On the GPU machine, ``THERMITE_TEST_GPU=1 pytest -m gpu
tests/`` runs them on the card (``chip_smoke.py`` does so in process).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if os.environ.get("THERMITE_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere with a reason)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip(
            "needs an NVIDIA GPU: run THERMITE_TEST_GPU=1 pytest -m gpu "
            "on the card (chip_smoke.py does)"
        )
    return devs[0]
