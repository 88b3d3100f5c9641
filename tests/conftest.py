"""Test harness config: CPU backend with 8 virtual devices.

The test story (SURVEY.md §4): pure-JAX unit tests run on the CPU backend,
the Triton kernels in the Pallas interpreter, and multi-card logic on a
forced 8-device host mesh. ``JAX_PLATFORMS`` defaults to ``cpu``; tests
marked ``gpu`` take the ``gpu`` fixture and skip where JAX sees no GPU. On
a machine with a card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

and chip_smoke.py runs the full-size on-card checks.
"""

import os

import pytest

_FLAG = "--xla_force_host_platform_device_count=8"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " " + _FLAG
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """The first GPU device; the test skips where JAX sees none (decided
    here, at run time, never while a test module is imported)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs on the card)")
    return devices[0]
