"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the single real
CPU device (the 512-device flag is exclusively dryrun.py's)."""

import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running statistical test")
    config.addinivalue_line(
        "markers",
        "requires_cuda: runs a repro_torch CUDA kernel; skips without a GPU")
