"""Test harness: the CPU backend with 8 virtual devices, so multi-device
sharding paths compile and run without accelerators (SURVEY.md section 4).

Tests marked ``gpu`` need a GPU and skip elsewhere; on a machine with one,
run them with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (  # noqa: E402
    EngineConfig,
)


@pytest.fixture(scope="session")
def cfg() -> EngineConfig:
    return EngineConfig()


@pytest.fixture(scope="session")
def problem(cfg):
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
        TrifocalProblem,
    )

    return TrifocalProblem.load(cfg)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; JAX runs on " + jax.default_backend())
