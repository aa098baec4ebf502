"""Test harness: an 8-virtual-device CPU platform unless told otherwise.

XLA's host platform is split into 8 virtual devices before jax imports, so
Mesh / NamedSharding / collective tests run anywhere, deterministically.
``JAX_PLATFORMS`` picks the backend (CPU by default); tests marked ``gpu``
need a GPU and skip without one (the ``gpu`` fixture decides at run time).
Run them on a GPU machine with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# keep f32 default; some oracle comparisons opt into x64 locally
os.environ.setdefault("JAX_ENABLE_X64", "0")
# the entry points point JAX's persistent compile cache at the checkout;
# tests compile in many worker processes and keep no cache
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu``-marked test when JAX's first device is not a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found the {platform!r} backend")
