"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding tests run without GPUs, and kernels run in the Pallas
interpreter.

On a machine with a GPU, ``PARTICLE_SIM_TEST_GPU=1 python -m pytest tests/
-m gpu`` leaves JAX on the GPU and runs the tests marked ``gpu``, which
compile the kernels for the card; without a card they skip."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

# The config API (post-import, pre-backend-init) pins the CPU even where the
# environment selects another platform.
if os.environ.get("PARTICLE_SIM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
# Parallel test workers must not share one on-disk compile cache (the CLI
# configures it); tests always compile fresh.
jax.config.update("jax_enable_compilation_cache", False)

import pytest

from particle_simulation_tpu import cross_section


@pytest.fixture(scope="session")
def sine_table():
    return cross_section.load_table()


@pytest.fixture(scope="session")
def const_table():
    return cross_section.load_table(cross_section.bundled_paths()[1])
