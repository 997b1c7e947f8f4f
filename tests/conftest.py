"""Test env: force CPU with 8 virtual devices so sharding tests run
anywhere (SURVEY.md §4 'Distributed tests without a cluster').

jax.config.update is used as well as the environment, because it is
honored as long as no backend has been initialized, even if jax was
imported before this file ran. Tests that need a GPU carry the `gpu`
marker and decide inside the `gpu_device` fixture whether one is
present."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # older jax: the XLA_FLAGS path above covers it


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none (decided
    here, at run time, never while the test module is imported)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return gpus[0]
