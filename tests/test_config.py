"""Config-tier tests: the reference YAML keys and the compile-cache rule."""

import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import runtime


def test_num_of_cores_yaml_key(tmp_path):
    """Num_Of_Cores (gpuhc_settings.yaml:34) is parsed and recorded; the
    CPU oracle's parallelism itself is the XLA CPU runtime's thread pool
    (the OpenMP pool it replaces: CPU_HC_Solver.cpp:232-239)."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        load_problem_yaml,
    )

    p = tmp_path / "gpuhc_settings.yaml"
    p.write_text("%YAML:1.0\nNum_Of_Cores: 12\n")
    cfg = load_problem_yaml(str(p))
    assert cfg.num_cpu_cores == 12
    p.write_text("%YAML:1.0\nNum_Of_Vars: 30\n")
    assert load_problem_yaml(str(p)).num_cpu_cores is None


@pytest.mark.parametrize("environ, expected", [
    ({}, runtime.DEFAULT_CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, runtime.DEFAULT_CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
])
def test_compile_cache_dir_rule(environ, expected):
    """A set JAX_COMPILATION_CACHE_DIR wins and the code sets no other
    path; otherwise the cache sits at one fixed path in the checkout."""
    assert runtime.compile_cache_dir(environ) == expected


def test_default_cache_dir_is_fixed_inside_checkout():
    import os

    assert runtime.DEFAULT_CACHE_DIR == os.path.join(runtime.REPO_ROOT,
                                                     ".jax_cache")


def test_enable_compile_cache_keeps_env_dir(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    runtime.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before
