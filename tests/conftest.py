"""Test configuration: CPU backend with an 8-device virtual mesh, f64 enabled.

Mirrors the strategy in SURVEY.md §4's "implication for the build": the dense jnp
oracle replaces gaussians.py's pure-torch twins as the correctness reference,
``jax.test_util.check_grads`` (f64) replaces ``torch.autograd.gradcheck``, and
multi-device sharding tests run on a virtual CPU mesh.

The suite runs on the CPU: the fused kernels run through the Pallas interpreter
there.  Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; run them on
a GPU machine with ``python chip_smoke.py`` (phase 6), or alone with
``PIGS_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ON_GPU = bool(os.environ.get("PIGS_TESTS_ON_GPU"))

if not ON_GPU:
    # Must be set before the first backend is initialized.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    # The config route applies as long as no backend has been initialized.
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except AttributeError:
        pass  # older jax: the XLA_FLAGS path above covers it

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: XLA-CPU compiles dominate test wall-clock on small
# hosts; caching them across runs makes the suite fast after the first pass.
from pigs_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; see conftest)")


@pytest.fixture
def gpu():
    """The first device, which must be a GPU; the test skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {dev.platform!r})")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live executables between test modules.

    With ~150 accumulated compilations in one process, jaxlib 0.9.0's XLA:CPU
    executable (de)serialization for the persistent cache crashes
    (SIGSEGV/SIGABRT in ``executable.serialize()`` — reproduced only past
    ~100 prior tests; any subset passes).  Clearing jit caches per module
    keeps the live-executable count bounded and avoids the crash; the
    persistent on-disk cache makes the re-tracing cheap.
    """
    yield
    jax.clear_caches()
