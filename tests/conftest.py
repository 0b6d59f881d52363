"""Test configuration.

The tests run on the CPU backend with 8 virtual devices, so the mesh tests
have devices to shard over, unless JAX_PLATFORMS is set. Tests that need an
NVIDIA GPU take the `gpu` fixture and carry the `gpu` marker; elsewhere the
fixture skips them. On a machine with a card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

# tests compile many small programs; keep them out of the persistent cache
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX's default device is not one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; the default device is "
                    f"{dev.platform}")
    return dev
