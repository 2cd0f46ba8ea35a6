"""The production segmented tracker (ops/segmented.py) against the plain
oracle (ops/tracker.py), and its on-device abort scoring."""

import dataclasses

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac,
    segmented,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io

H, T = 2, 48
# A (view, seed) whose first hypotheses reach the ground-truth pose.
ABORT_VIEW, ABORT_SEED, ABORT_H = 0, 0, 2


def _workload(cfg, problem, view_index, seed, h, t):
    view = data_io.load_view(cfg, view_index)
    s = ransac.sample_edgel_triplets(seed, view.edge_locations.shape[0], h)
    tgt = np.repeat(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s), t, axis=0)
    x0 = np.tile(np.asarray(problem.start_sols)[:t], (h, 1))
    return view, x0, tgt, tgt - np.asarray(problem.start_params)


@pytest.fixture(scope="module")
def workload(cfg, problem):
    return _workload(cfg, problem, 0, 5, H, T)


@pytest.fixture(scope="module")
def oracle(cfg, problem, workload):
    _, x0, tgt, diff = workload
    return tracker.make_track_fn(problem, cfg.hc)(x0, tgt, diff)


@pytest.mark.parametrize("segment_steps, compact", [
    (1, True), (8, True), (81, True), (8, False),
])
def test_segment_step_matches_oracle(cfg, problem, workload, oracle,
                                     segment_steps, compact):
    """Segments of 1, 8 and 81 steps, with and without compaction, give
    the oracle's flags and step counts path for path and its endpoints."""
    _, x0, tgt, diff = workload
    hc = dataclasses.replace(cfg.hc, segment_steps=segment_steps,
                             compact_survivors=compact)
    res = segmented.make_segmented_track_fn(problem, hc)(x0, tgt, diff)
    r = res.track
    np.testing.assert_array_equal(r.converged, oracle.converged)
    np.testing.assert_array_equal(r.inf_fail, oracle.inf_fail)
    np.testing.assert_array_equal(r.pruned, oracle.pruned)
    np.testing.assert_array_equal(r.num_steps, oracle.num_steps)
    assert oracle.converged.any()
    c = oracle.converged
    scale = np.maximum(1.0, np.abs(oracle.x[c]).max(axis=1))
    err = np.abs(r.x[c] - oracle.x[c]).max(axis=1) / scale
    assert err.max() <= 1e-6
    assert not res.found and res.found_path == -1  # abort is off


def test_abort_scoring_finds_pose(cfg, problem):
    """With abort on, on-device scoring flags a path whose pose has >= 90%
    support, and that pose is the ground truth."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        evaluation as evl,
    )

    view, x0, tgt, diff = _workload(cfg, problem, ABORT_VIEW, ABORT_SEED,
                                    ABORT_H, problem.num_tracks)
    rc = dataclasses.replace(cfg.ransac, abort_by_good_sol=True)
    track = segmented.make_segmented_track_fn(problem, cfg.hc, rc)
    n = view.edge_locations.shape[0]
    res = track(x0, tgt, diff, edgels=view.edge_locations,
                intrinsics=data_io.load_intrinsics(cfg), n_edgels=n)
    assert res.found
    assert res.best_support >= 0.9 * n
    x = res.track.x[res.found_path].real
    assert res.track.converged[res.found_path]
    r21, r31, t21, t31 = (np.asarray(a) for a in
                          trifocal.solution_to_pose(x.astype(np.float32)))
    pe = evl.measure_pose_error(r21, r31, t21, t31, view.gt_pose21,
                                view.gt_pose31)
    assert pe.within(rc)
    # The batch stopped early: some paths never used their step budget.
    assert res.track.num_steps.min() < cfg.hc.max_steps
