"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, so the sharding
tests see a mesh without a card.  ``JAX_PLATFORMS`` is only defaulted to
``cpu``: the tests marked ``gpu`` run on a machine with an NVIDIA card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

and skip elsewhere.  Whether a card is present is decided inside the ``gpu``
fixture, never while modules are collected.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled Triton kernels)"
    )


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; the CPU run covers the kernel in "
                    "interpret mode")
