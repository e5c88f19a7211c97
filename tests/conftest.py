import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
# exercised without GPUs. The platform is pinned through jax.config as well
# as JAX_PLATFORMS, before any backend is initialized.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_state():
    """Drop JAX's in-process executable caches after each test module.

    Long single-process suite runs accumulate hundreds of live XLA:CPU
    executables; past ~100 tests the CPU backend segfaulted inside
    compile/deserialize (observed at the same suite position across
    runs, while the same tests pass standalone or in halves). Bounding
    the live JIT state per module avoids the crash; recompiles are
    cheap on CPU and served by the persistent on-disk cache.
    """
    yield
    jax.clear_caches()
