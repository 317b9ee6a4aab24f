"""Test harness config.

Tests run on CPU with 8 virtual devices (the multi-host simulation the
reference cannot do — SURVEY.md §4: ``XLA_FLAGS=--xla_force_host_platform_
device_count=N``).  Tests marked ``gpu`` need a card: they skip on the
CPU and run on one with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

from inplacemsdradixsort.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; otherwise the test skips."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {d.platform}")
    return d
