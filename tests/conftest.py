"""Test config.

The backend is whatever JAX picks: ``JAX_PLATFORMS=cpu`` for the regular
suite (with 8 virtual host devices for the sharding tests), the GPU on a
machine that has one.  Tests that need the GPU carry ``@pytest.mark.gpu``
and are skipped elsewhere by the ``_gpu_only`` fixture below; run them
with ``python -m pytest -m gpu tests/``.  Whether a card is present is
decided inside fixtures and tests, never while a module is imported, so
every xdist worker collects the same tests.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest


def on_gpu() -> bool:
    """True when the default JAX backend is an NVIDIA GPU.  Call it
    inside a test or fixture, never at import."""
    import jax
    return jax.devices()[0].platform == "gpu"


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests when JAX finds no GPU."""
    if request.node.get_closest_marker("gpu") and not on_gpu():
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/")


@pytest.fixture(autouse=True)
def _restore_precision_policy():
    """Tests default to the 'parity' policy; anything that switches policy
    (directly or via entry points) must not leak into later tests."""
    from dsp_stuff_tpu.utils import precision
    prev = precision.get_policy()
    yield
    precision.set_policy(prev)
