"""Monodromy start-system generation (D4 equivalent) on the CPU oracle."""

import dataclasses

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    monodromy,
    system,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import tracker


def test_refiner_polishes_shipped_roots(problem, cfg):
    """Newton polish (complex128) pulls perturbed committed roots back onto
    the roots, which is what lets monodromy landings deduplicate."""
    x = np.asarray(problem.start_sols, np.complex128)[:16]
    rng = np.random.default_rng(0)
    noisy = x + 1e-6 * np.abs(x).max(axis=1, keepdims=True) * (
        rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    xr, res = system.newton_polish(problem.hx_table, problem.ht_table, noisy,
                                   np.asarray(problem.start_params))
    assert res.max() < monodromy.RESIDUAL_TOL
    np.testing.assert_allclose(xr, x, rtol=1e-6, atol=1e-8)


def test_write_start_system_roundtrip(problem, tmp_path):
    res = monodromy.MonodromyResult(
        params=np.asarray(problem.start_params),
        solutions=np.asarray(problem.start_sols)[:5],
        loops_run=0,
        history=[],
    )
    pp = tmp_path / "start_params.txt"
    ps = tmp_path / "start_sols.txt"
    monodromy.write_start_system(str(pp), str(ps), res)
    raw = np.loadtxt(ps)
    sols = (raw[:, 0] + 1j * raw[:, 1]).reshape(5, 30)
    np.testing.assert_allclose(
        sols, np.asarray(problem.start_sols)[:5], rtol=1e-6, atol=1e-7
    )
    raw_p = np.loadtxt(pp)
    np.testing.assert_allclose(
        raw_p[:, 0] + 1j * raw_p[:, 1],
        np.asarray(problem.start_params)[:-1],
        rtol=1e-6,
    )


@pytest.mark.slow
def test_monodromy_discovers_new_roots(problem, cfg):
    hc = dataclasses.replace(cfg.hc, truncate_paths=False, max_steps=200)
    track = tracker.make_track_fn(problem, hc, dynamic_start=True)
    seed = np.asarray(problem.start_sols)[:24]
    res = monodromy.monodromy_solve(
        problem, track, seed, target_count=30, max_loops=3,
        patience=3, rng_seed=2, leg_batch=32,
    )
    assert res.solutions.shape[0] > 24, res.history
    # Every discovered root must be a true root of the shipped start set.
    ship = np.asarray(problem.start_sols)
    for s in res.solutions:
        assert np.min(np.max(np.abs(ship - s[None]), axis=1)) < 1e-2
