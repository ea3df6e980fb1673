"""Test configuration: run everything on CPU with 8 virtual devices.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``, forced here as well):
the clock kernel in Pallas interpret mode, everything else as plain XLA,
and the sharded paths on a virtual CPU mesh, the same way the reference
fakes hardware with mocks (SURVEY.md §4).  Tests that need the GPU carry
the ``gpu`` marker and skip here; run them on a GPU with
``python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import jax
import pytest


def pytest_configure(config):
    # every run stays on the CPU except one selecting the GPU tests
    # (``-m gpu``), which must see the card; whether a card is there is
    # decided per test by the ``gpu`` fixture
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


REFERENCE_DIR = pathlib.Path(os.environ.get("SDRM_REFERENCE_DIR", "/root/reference"))
FIXTURES_DIR = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="session")
def reference_dir() -> pathlib.Path:
    """The upstream C checkout — only for tests that cross-validate the
    VENDORED fixtures/tables against the original sources; everything
    else runs from tests/fixtures and needs no checkout."""
    if not REFERENCE_DIR.exists():
        pytest.skip("reference checkout not available")
    return REFERENCE_DIR


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES_DIR


@pytest.fixture(scope="session")
def resources_dir() -> pathlib.Path:
    """Golden fixture directory: the vendored copy (tests/fixtures),
    byte-identical to the reference's test/resources (asserted by
    test_vendored_fixtures_match_reference when the checkout exists)."""
    return FIXTURES_DIR


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (tests marked ``gpu``)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run python -m pytest -m gpu tests/ on one")
    return jax.devices()[0]
