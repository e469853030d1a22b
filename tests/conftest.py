"""Test harness config: force an 8-device virtual CPU mesh (SURVEY.md §4d).

Must run before jax is imported anywhere: tests exercise the sharded code
paths without several cards, per the standard
``xla_force_host_platform_device_count`` trick.
"""
import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# The suite runs on the CPU backend. TERRA_TEST_PLATFORM=gpu leaves JAX's
# default platform alone so that the ``gpu``-marked tests
# (tests/test_gpu_smoke.py) run on the card; they skip anywhere else.
_platform = os.environ.get("TERRA_TEST_PLATFORM", "cpu")

import jax  # noqa: E402

if _platform == "cpu":
    os.environ["JAX_PLATFORMS"] = _platform
    jax.config.update("jax_platforms", _platform)
jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run with TERRA_TEST_PLATFORM=gpu); "
        "skips elsewhere")


def _twin_impl(packed, o, d, t_init, any_hit, watertight):
    """gpu_traverse ``impl`` that runs the kernel's NumPy twin on the host
    (the CUDA kernel itself needs a card)."""
    import jax.numpy as jnp

    from terra_tpu.testing import traverse_twin

    def run(nodes, leaves, tris, o, d, t_init):
        return traverse_twin.traverse(nodes, leaves, tris, o, d, t_init,
                                      packed.root, any_hit, watertight)

    n = o.shape[0]
    return jax.pure_callback(
        run, (jax.ShapeDtypeStruct((n,), jnp.float32),
              jax.ShapeDtypeStruct((n,), jnp.int32)),
        packed.nodes, packed.leaves, packed.tris, o, d, t_init)


@pytest.fixture
def twin_impl():
    return _twin_impl
