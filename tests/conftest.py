"""Test config: run everything on a virtual 8-device CPU mesh.

The XLA host-device-count flag must be set before jax initializes its
backends; the platform is forced to the CPU via jax.config as well as
JAX_PLATFORMS, so the suite never touches an accelerator.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-process / long-running tests (run explicitly with "
        "-m slow or by file)",
    )


@pytest.fixture
def rng():
    return np.random.default_rng(20141119)


FIXTURE_ML = os.path.join(os.path.dirname(__file__), "data", "sample_movielens.txt")


@pytest.fixture(scope="session")
def movielens_path():
    return FIXTURE_ML
