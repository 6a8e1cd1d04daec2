import os
import sys

import pytest

# Tests run on the CPU with a virtual 8-device mesh, so multi-device
# sharding paths are exercised without a card.  A run on the GPU sets
# JAX_PLATFORMS itself (see README.md) and selects the `gpu` tests.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# the repo root holds `benchmarks.fixtures`, which rebuilds test inputs
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU; decided here, never at import."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]
