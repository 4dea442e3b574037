"""Test configuration: a virtual 8-device CPU mesh with x64 enabled.

Mirrors the reference's `make test` harness role (reference lib Makefile:16-17)
but with NumPy/SciPy oracles and multi-device sharding tests, per SURVEY.md §4.

The tests run on the CPU unless ``JAX_PLATFORMS`` names another platform.
Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless
JAX's default device is a GPU; on the card they run with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0``.
"""

import os

import pytest

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# The XLA:CPU AOT cache loader logs a cosmetic machine-feature mismatch once
# per cache hit; silence C++ logs in test processes.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Under pytest-xdist every worker creates 8 virtual devices, each with its
# own intra-op thread pool — on a small host the workers thrash (measured:
# sys time > user time).  One compute thread per virtual device is faster
# in aggregate.
if os.environ.get("PYTEST_XDIST_WORKER"):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# The persistent compilation cache stays off: for hundreds of small CPU
# programs, lookup and deserialization cost about as much as compiling.


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided per test, never
    at import time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card with "
                    "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0")
    return jax.devices()[0]
