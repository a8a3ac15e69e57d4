"""Shared test fixtures.  NOTE: no XLA_FLAGS here — unit tests run on the
single real CPU device; multi-device tests spawn subprocesses that set
--xla_force_host_platform_device_count themselves."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA / Triton kernels); skipped elsewhere",
    )
