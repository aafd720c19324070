import os

import pytest

# The tests run on the CPU unless the caller names a platform
# (`JAX_PLATFORMS=cuda pytest -m gpu` runs the card's tests).  Eight
# virtual CPU devices back the sharding tests.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# Protocol e2e tests use the exact host engine (fast, no compiles); the JAX
# engine has dedicated parity tests in test_ops_*.py.
os.environ.setdefault("BPPP_ENGINE", "host")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is an NVIDIA GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on the card")
