"""Test environment: CPU backend with 8 virtual devices.

Multi-device code paths (``parallel/``) are exercised on a fake 8-device CPU
mesh — the same ``shard_map`` code that runs across GPUs (SURVEY.md §4c).
Must run before JAX initializes its backends.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a machine
with one, run them with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu on a GPU machine)")
