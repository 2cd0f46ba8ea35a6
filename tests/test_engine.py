"""Engine-level smoke tests on the CPU backend (the production segmented
path, the same program the GPU runs)."""

import dataclasses

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
    TrifocalPoseEngine,
)


@pytest.fixture(scope="module")
def engine(cfg):
    # Keep CPU cost small: few steps are enough to exercise the whole
    # pipeline (tracking, gating, scoring, selection); convergence is not
    # required for the plumbing to work.
    small = dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, max_steps=25)
    )
    return TrifocalPoseEngine(small)


def test_run_round_pipeline(engine):
    view = engine.load_view(0)
    rr = engine.run_round(view, seed=0, num_hypotheses=2)
    assert rr.num_edgels == view.edge_locations.shape[0]
    assert rr.stats.num_paths == 2 * engine.problem.num_tracks
    assert rr.track_ms > 0
    assert rr.num_steps.shape == (2 * engine.problem.num_tracks,)


def test_run_stream_matches_run_round(engine):
    view = engine.load_view(0)
    rr = engine.run_round(view, seed=0, num_hypotheses=2)
    results, vps = engine.run_stream([0, 1], num_hypotheses=2)
    assert len(results) == 2 and vps > 0
    # View 0 streamed with the same seed reproduces the serial round.
    assert results[0].stats.num_converged == rr.stats.num_converged
    assert results[0].num_candidates == rr.num_candidates
    assert results[0].best_support21 == rr.best_support21


@pytest.mark.slow
def test_stream_abort_matches_round_abort(cfg):
    """Chunked abort stream (engine._run_stream_abort) vs run_round abort.

    Part A: a step budget too small for any hit, so both modes
    dispatch EVERY chunk -- the stream's per-chunk device-select sums must
    equal the round pipeline's whole-batch statistics.  Part B: relaxed
    candidate gates (ratio 0 + huge imag tol, the test_parallel abort
    trick) so a mid-stream chunk hits -- the scheduler must report the
    found pose and skip the view's remaining chunks.
    """
    # Part A: no hit possible in 16 steps; full chunk sweep both modes.
    ecfg = dataclasses.replace(
        cfg,
        hc=dataclasses.replace(cfg.hc, max_steps=16),
        ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                                   abort_chunk=2, stream_abort_chunk=2),
    )
    eng = TrifocalPoseEngine(ecfg)
    view = eng.load_view(0)
    rr = eng.run_round(view, seed=0, num_hypotheses=4)
    results, vps = eng.run_stream([0], num_hypotheses=4)
    sr = results[0]
    assert vps > 0 and len(results) == 1
    assert sr.stats.num_paths == rr.stats.num_paths
    assert sr.stats.num_converged == rr.stats.num_converged
    assert sr.stats.num_infinity == rr.stats.num_infinity
    assert sr.num_candidates == rr.num_candidates
    assert sr.best_support21 == rr.best_support21
    assert sr.found_pose == rr.found_pose is False

    # Part A-ragged: H=5 with chunk 2 -> chunks of 2/2/1; both modes pad
    # the tail chunk by duplicating its first hypotheses and must slice
    # the duplicates away before counting (engine real_h / the round
    # path's done[:H*T] slice), so the statistics still agree exactly.
    rr5 = eng.run_round(view, seed=0, num_hypotheses=5)
    results5, _ = eng.run_stream([0], num_hypotheses=5)
    sr5 = results5[0]
    assert sr5.stats.num_paths == rr5.stats.num_paths == 5 * eng.problem.num_tracks
    assert sr5.stats.num_converged == rr5.stats.num_converged
    assert sr5.stats.num_infinity == rr5.stats.num_infinity
    assert sr5.num_candidates == rr5.num_candidates
    assert sr5.best_support21 == rr5.best_support21

    # Part B: 30 steps + relaxed gates -> a candidate converges (probed:
    # 1 candidate at H=4 seed 0) and any candidate is a hit.
    ecfg_b = dataclasses.replace(
        cfg,
        hc=dataclasses.replace(cfg.hc, max_steps=30),
        ransac=dataclasses.replace(
            cfg.ransac, abort_by_good_sol=True, abort_chunk=2,
            stream_abort_chunk=2, imag_part_tol=1e9,
            pass_inlier_support_ratio=0.0,
        ),
    )
    eng_b = TrifocalPoseEngine(ecfg_b)
    results_b, _ = eng_b.run_stream([0], num_hypotheses=4)
    sb = results_b[0]
    assert sb.found_pose
    assert sb.best_pose is not None and sb.pose_errors is not None
    assert sb.num_candidates >= 1
    assert sb.actual_sol_steps.shape == (1,)


def test_ef_matrix_utilities(cfg):
    """Skew/essential/fundamental builders (util.hpp:155-228): the GT pose's
    F satisfies the epipolar constraint on the view's correspondences."""
    import jax.numpy as jnp

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
        trifocal as tfm,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        data_io,
        evaluation as evl,
    )

    t = np.array([1.0, -2.0, 3.0])
    sk = np.asarray(tfm.skew_symmetric(jnp.asarray(t)))
    v = np.array([0.5, 0.25, -1.0])
    np.testing.assert_allclose(sk @ v, np.cross(t, v), atol=1e-6)

    view = data_io.load_view(cfg, 0)
    k = data_io.load_intrinsics(cfg)
    r21, t21 = evl.decompose_gt_pose(view.gt_pose21)
    f = np.asarray(
        tfm.fundamental_matrix(jnp.asarray(r21), jnp.asarray(t21),
                               jnp.asarray(k))
    )
    # Epipolar residuals of the GT correspondences in pixel coordinates.
    g1 = view.edge_locations[:64, 0:2]
    g2 = view.edge_locations[:64, 2:4]
    p1 = np.concatenate([g1, np.ones((64, 1))], axis=1) @ k.T
    p2 = np.concatenate([g2, np.ones((64, 1))], axis=1) @ k.T
    resid = np.abs(np.einsum("ni,ij,nj->n", p2, f, p1))
    scale = np.abs(np.einsum("ni,ij,nj->n", p2, f, p1 * 0 + 1)).mean() + 1.0
    assert np.median(resid) / scale < 1e-3


def test_device_scoring_matches_host_scoring(cfg):
    """The on-device scoring path (default) and the host path
    (collect_solutions=True) produce identical statistics and supports."""
    import dataclasses

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )

    base = dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, max_steps=25)
    )
    eng = TrifocalPoseEngine(base)
    view = eng.load_view(0)
    rd = eng.run_round(view, seed=0, num_hypotheses=2)
    rh = eng.run_round(view, seed=0, num_hypotheses=2,
                       collect_solutions=True)
    assert rd.stats.num_converged == rh.stats.num_converged
    assert rd.stats.num_infinity == rh.stats.num_infinity
    assert rd.stats.num_real == rh.stats.num_real
    assert rd.num_candidates == rh.num_candidates
    assert rd.best_support21 == rh.best_support21
    assert rd.best_support31 == rh.best_support31
    assert rd.found_pose == rh.found_pose
    np.testing.assert_array_equal(
        np.sort(rd.actual_sol_steps), np.sort(rh.actual_sol_steps)
    )
