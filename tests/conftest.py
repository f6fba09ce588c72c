"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding logic is validated on XLA's host platform with 8 virtual
devices.  Must run before any `import jax` in test modules.

The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise.
Tests marked ``gpu`` need an NVIDIA GPU; they run with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`` and skip
elsewhere (the ``gpu`` fixture decides, at run time).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bwt_tpu.utils import compile_cache  # noqa: E402

# persistent compile cache (one fixed directory per checkout and
# platform): repeated suite runs skip recompilation of the jitted
# search/build programs
compile_cache.enable()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def gpu():
    """JAX's first device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests/ -m gpu)")
    return dev
