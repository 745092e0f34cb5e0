"""Test configuration: the CPU backend with an 8-device virtual mesh.

Numeric semantics tests must be fast and deterministic; multi-device
sharding tests need >= 8 devices, which the virtual CPU platform provides
(`--xla_force_host_platform_device_count`).  Run the suite with
`JAX_PLATFORMS=cpu`.  Tests that need a CUDA GPU carry the `gpu` marker
and skip elsewhere; on the card, run them with
`python -m pytest -m gpu tests/` and no JAX_PLATFORMS.

The compilation cache follows the package rule (ray_tracying.compile_cache):
JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache` in the checkout.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

from ray_tracying import compile_cache  # noqa: E402

compile_cache.setup()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` skip unless JAX's default backend is a CUDA GPU.
    Decided when the test runs, never at import or collection."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: the Triton kernels compile only there")
