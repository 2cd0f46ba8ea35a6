"""Property tests for the HC path tracker (SURVEY.md section 4 test plan)."""

import numpy as np
import jax.numpy as jnp

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import system
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac, tracker
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io


def _one_hypothesis_targets(cfg, problem, n_paths):
    view = data_io.load_view(cfg, 0)
    samples = ransac.sample_edgel_triplets(7, view.edge_locations.shape[0], 1)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents, samples)
    tgt_b = np.repeat(tgt, n_paths, axis=0)
    return tgt_b, tgt_b - np.asarray(problem.start_params)


def test_converged_paths_satisfy_target_system(cfg, problem):
    n = 64  # subset of the 312 paths to keep CPU runtime small
    tgt_b, diff_b = _one_hypothesis_targets(cfg, problem, n)
    x0 = np.asarray(problem.start_sols)[:n]
    track = tracker.make_track_fn(problem, cfg.hc)
    res = track(x0, tgt_b, diff_b)

    assert res.converged.any(), "no path converged on a real hypothesis"
    # H(x, t=1) = 0 for converged paths: t=1 means p(t) = target params.
    xc = res.x[res.converged]
    p1 = tgt_b[: xc.shape[0]]
    h = np.asarray(ev.eval_H_direct(problem, jnp.asarray(xc), jnp.asarray(p1)))
    # Scale-aware (backward error): each residual against the sum of its
    # equation's term magnitudes, so a converged path of large norm (a
    # root near infinity) is judged at its own scale.
    ht_abs = np.array(problem.ht_table)
    ht_abs[:, 0, :] = np.abs(ht_abs[:, 0, :])
    terms, _ = system.evaluate_np(np.abs(problem.hx_table), ht_abs,
                                  np.abs(xc).astype(np.float64),
                                  np.abs(p1).astype(np.float64))
    assert (np.abs(h) / terms).max() < 1e-4
    # Flags are mutually consistent.
    assert not (res.converged & res.pruned).any()


def test_tracker_deterministic(cfg, problem):
    n = 16
    tgt_b, diff_b = _one_hypothesis_targets(cfg, problem, n)
    x0 = np.asarray(problem.start_sols)[:n]
    track = tracker.make_track_fn(problem, cfg.hc)
    r1 = track(x0, tgt_b, diff_b)
    r2 = track(x0, tgt_b, diff_b)
    np.testing.assert_array_equal(r1.x, r2.x)
    np.testing.assert_array_equal(r1.converged, r2.converged)


def test_nan_solve_is_rejected(cfg, problem, monkeypatch):
    """The LU gives inf/NaN for a singular Jacobian: such a step fails the
    corrector test, the path rolls back with a halved dt, and no other
    path sees it."""
    import jax

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import linalg

    tgt_b, diff_b = _one_hypothesis_targets(cfg, problem, 2)
    x0 = jnp.asarray(np.asarray(problem.start_sols)[:2])
    s0 = tracker.init_state(x0, cfg.hc)
    args = (jnp.asarray(tgt_b), jnp.asarray(diff_b))
    clean = jax.jit(tracker.make_step_fn(problem, cfg.hc))(s0, *args)

    solve = linalg.solve
    monkeypatch.setattr(linalg, "solve",
                        lambda a, b: solve(a, b).at[1].set(jnp.nan))
    s1 = jax.jit(tracker.make_step_fn(problem, cfg.hc))(s0, *args)
    np.testing.assert_array_equal(np.asarray(s1.x[0]), np.asarray(clean.x[0]))
    assert float(s1.t[0]) == float(clean.t[0]) > 0
    np.testing.assert_array_equal(np.asarray(s1.x[1]), np.asarray(x0[1]))
    assert float(s1.t[1]) == 0.0
    assert s1.dt[1] == np.float32(cfg.hc.init_delta_t) * np.float32(0.5)
    assert not bool(s1.inf_fail[1])
