"""Test configuration.

By default the tests run on the CPU backend in float64, so numeric
oracles match the reference's double-precision semantics, with an
8-device virtual platform for the sharding tests.  Tests marked ``gpu``
need an NVIDIA GPU and run in the card's float32 configuration:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Whether a card is present is decided by the ``gpu`` fixture at run time.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the suite is compile-dominated: keep its own persistent compile cache
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                 ".jax_test_cache"))
_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
if _CPU:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ["RB_X64"] = "1"

import jax  # noqa: E402

if _CPU:
    jax.config.update("jax_enable_x64", True)
    # XLA:CPU executables compiled on another host's CPU features reload
    # with a loud error per entry: cache the compiled programs only
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is an NVIDIA GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (found {dev.platform}); run "
                    f"JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev
