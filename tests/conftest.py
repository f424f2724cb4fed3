"""Test configuration: force CPU with 8 simulated devices, enable x64.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4 item 4) so sharded
training can be validated without accelerator hardware, and with x64
enabled so the float64 golden-parity harness matches the reference's
Theano float64 math.  Tests that need a GPU carry the ``gpu`` marker and
take the ``gpu`` fixture, which skips them here.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute e2e/ensemble/multihost tests. Quick tier: "
        "python -m pytest tests/ -q -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA GPU (skipped on the CPU; run on the card with "
        "python chip_smoke.py)")


@pytest.fixture
def gpu():
    """The first GPU device, or a skip where there is none.  Decided here,
    at run time, never while test modules are imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the CPU suite forces JAX_PLATFORMS=cpu")
