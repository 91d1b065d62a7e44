"""Test harness: run everything on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without a GPU (SURVEY.md §4).
JAX_PLATFORMS and XLA_FLAGS must be set before jax initializes its
backends.

Tests marked `card` need the GPU. They take the `card` fixture, which
skips them (with the reason) wherever the default device is not a GPU.
chip_smoke.py runs them on the card inside its own process, which has
already opened the GPU: it sets CCVE_CARD_TESTS=1 so this file leaves
the platform alone.
"""

import os

import pytest

CARD_RUN = os.environ.get("CCVE_CARD_TESTS") == "1"

if not CARD_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not CARD_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_sessionstart(session):
    if CARD_RUN:
        return
    n = len(jax.devices())
    assert jax.devices()[0].platform == "cpu", (
        f"tests must run on CPU, got {jax.devices()[0]}"
    )
    assert n == 8, f"expected 8 virtual CPU devices, got {n}"


@pytest.fixture
def card():
    """The GPU device, or a skip where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs the GPU (default device here: {dev.platform}); "
            "run on the card with `python chip_smoke.py`"
        )
    return dev
