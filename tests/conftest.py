"""Test harness configuration.

All tests run on a virtual 8-device CPU mesh with Pallas kernels in
interpreter mode — the analog of the reference's generic no-SIMD fallback
path that lets its tests run on any machine (SURVEY.md §4). Set
LASER_TEST_BACKEND=tpu to run the same suite compiled on real hardware.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("LASER_TEST_BACKEND", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "devices(n): skip unless at least n jax devices are visible "
        "(multi-device tests run on the 8-device virtual CPU mesh in CI; "
        "on single-chip hardware they skip)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (laser_tpu_torch kernels); "
        "skips without one")


def pytest_runtest_setup(item):
    for mark in item.iter_markers("devices"):
        if jax.device_count() < mark.args[0]:
            pytest.skip(f"needs {mark.args[0]} devices, "
                        f"have {jax.device_count()}")


@pytest.fixture
def rng():
    # Seed mirrors the reference's randomize(0xDEADBEEF)
    # (tests/test_x86_reductions.nim:10).
    return np.random.RandomState(0xDEADBEEF)
