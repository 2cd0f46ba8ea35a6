"""Evaluations-layer parity tests: uncapped candidate scoring, the exact
reference Find_Unique_Sols semantics, and min-residuals-over-all-sols
(Evaluations.cpp:184-233, :545-583)."""

import dataclasses

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
    TrifocalPoseEngine,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import system
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import tracker
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
    evaluation as evl,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
    RansacConfig,
)


@pytest.fixture(scope="module")
def engine(cfg):
    small = dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, max_steps=5)
    )
    return TrifocalPoseEngine(small)


def test_score_round_uncapped_candidates(engine):
    """> _CANDIDATE_CAP candidates must ALL be scored: plant the GT pose as
    candidate 600 among 700 junk candidates and require selection to find
    it (the old 512 cap silently dropped it)."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu import engine as eng_mod

    view = engine.load_view(0)
    B = eng_mod._CANDIDATE_CAP + 188  # 700: two scoring chunks
    gt_i = eng_mod._CANDIDATE_CAP + 88  # index 600, beyond the old cap
    rng = np.random.default_rng(0)
    x = np.zeros((B, 30), np.complex64)
    x[:, 0:8] = 1.0  # positive depths: pass the candidate gate
    # Junk poses: random cayley + translation -> near-zero inlier support.
    x[:, 18:30] += rng.normal(0.5, 0.5, (B, 12)).astype(np.float32)
    # Candidate gt_i carries the GT pose (support ~ all edgels, README).
    r21, t21u = evl.decompose_gt_pose(view.gt_pose21)
    r31, t31u = evl.decompose_gt_pose(view.gt_pose31)
    x[gt_i, 18:21] = view.gt_pose21[:, 3]
    x[gt_i, 21:24] = view.gt_pose31[:, 3]
    x[gt_i, 24:27] = system.rotation_to_cayley(r21)
    x[gt_i, 27:30] = system.rotation_to_cayley(r31)
    res = tracker.TrackResult(
        x=x,
        converged=np.ones(B, bool),
        inf_fail=np.zeros(B, bool),
        pruned=np.zeros(B, bool),
        num_steps=np.arange(B, dtype=np.int32),
    )
    (stats, n_cand, best21, best31, found, best_pose, pose_errors,
     actual_steps, f21s, f31s, min_res, any_gt) = engine._score_round(
        view, res
    )
    n_edgels = view.edge_locations.shape[0]
    assert n_cand == B
    # Every candidate got a fundamental matrix (scored), not just 512.
    assert f21s.shape == (B, 3, 3) and f31s.shape == (B, 3, 3)
    # The planted GT pose (beyond the old cap) wins selection.
    assert found
    assert best21 >= 0.9 * n_edgels and best31 >= 0.9 * n_edgels
    assert pose_errors is not None and pose_errors.within(
        engine.cfg.ransac
    )
    assert gt_i in actual_steps  # num_steps = arange, so steps == index
    # Min-over-all-sols residuals include the GT-pose candidate.
    assert min_res is not None and any_gt
    assert min_res.rot21 < 1e-2 and min_res.transl21 < 1e-2


def test_find_unique_solutions_reference_semantics():
    """Crafted batch pinning BOTH dedup modes (Evaluations.cpp:184-233):
    the reference's skip-set replacement and iteration-0-only scan differ
    from the whole-batch mode by design."""
    num_tracks = 4
    a = np.full(30, 1.0 + 0.0j)
    b = np.full(30, 2.0 + 0.0j)
    c = np.full(30, 3.0 + 0.0j)
    # Iteration 0: [A, A, B, A]; iteration 1: [C, ...] converged.
    x = np.stack([a, a, b, a, c, c, c, c]).astype(np.complex64)
    conv = np.array([1, 1, 1, 1, 1, 0, 0, 0], bool)

    ref = evl.find_unique_solutions_reference(x, conv, num_tracks, tol=1e-4)
    # bs=0: dups {1,3} -> skip; bs=1 skipped; bs=2 (B) unique;
    # bs=3 skipped; iteration 1 never scanned.
    np.testing.assert_array_equal(ref, [2])

    batch = evl.find_unique_solutions(x, conv, tol=1e-4)
    # Whole batch: A (idx 0), B (idx 2), C (idx 4).
    np.testing.assert_array_equal(batch, [0, 2, 4])

    # Skip-set REPLACEMENT quirk: [A, B, A, B] -- bs=0 dups {2} -> skip;
    # bs=1 dups {3} -> skip REPLACED (2 forgotten); bs=2 (A again) now
    # scans ds=3 only, no dup -> counted unique despite duplicating bs=0.
    x2 = np.stack([a, b, a, b]).astype(np.complex64)
    conv2 = np.ones(4, bool)
    ref2 = evl.find_unique_solutions_reference(x2, conv2, 4, tol=1e-4)
    np.testing.assert_array_equal(ref2, [2])


def test_min_residuals_over_sols():
    rc = RansacConfig()
    gt21 = np.concatenate([np.eye(3), [[1.0], [0.0], [0.0]]], axis=1)
    gt31 = np.concatenate([np.eye(3), [[0.0], [1.0], [0.0]]], axis=1)

    def rot_z(th):
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)

    # Pose 0: perfect on 21, bad on 31. Pose 1: bad on 21, perfect on 31.
    r21s = np.stack([np.eye(3), rot_z(0.5)])
    r31s = np.stack([rot_z(0.5), np.eye(3)])
    t21s = np.array([[2.0, 0.0, 0.0], [0.0, 0.0, 2.0]])
    t31s = np.array([[0.0, 0.0, 2.0], [0.0, 3.0, 0.0]])
    pe, ok = evl.min_residuals_over_sols(
        r21s, r31s, t21s, t31s, gt21, gt31, rc
    )
    # Component-wise minima come from DIFFERENT poses; no single pose is
    # within tolerance on all four -> success flag false.
    assert pe.rot21 < 1e-6 and pe.rot31 < 1e-6
    assert pe.transl21 < 1e-6 and pe.transl31 < 1e-6
    assert not ok
    # Add the exact pose: flag flips true.
    pe2, ok2 = evl.min_residuals_over_sols(
        np.concatenate([r21s, [np.eye(3)]]),
        np.concatenate([r31s, [np.eye(3)]]),
        np.concatenate([t21s, [[5.0, 0.0, 0.0]]]),
        np.concatenate([t31s, [[0.0, 5.0, 0.0]]]),
        gt21, gt31, rc,
    )
    assert ok2
    # Empty candidate set keeps the 100.0 init (Evaluations.cpp:41-44).
    pe3, ok3 = evl.min_residuals_over_sols(
        np.zeros((0, 3, 3)), np.zeros((0, 3, 3)), np.zeros((0, 3)),
        np.zeros((0, 3)), gt21, gt31, rc,
    )
    assert pe3.rot21 == 100.0 and not ok3


def test_format_gt_deviation_identity_pose():
    """format_gt_deviation (Check_Deviations_of_Veridical_Sol_from_GT,
    Evaluations.cpp:267-296): exact pose -> zero residuals, and the report
    carries GT + solution translations side by side."""
    r = np.eye(3, dtype=np.float32)
    t = np.array([3.0, 0.0, 4.0], np.float32)
    gt = np.concatenate([r, t[:, None]], axis=1)
    rep = evl.format_gt_deviation(r, r, t, 2 * t, gt, gt)
    assert "GT translation_21 = (0.6, 0, 0.8)" in rep
    assert "Sol translation_21 = (0.6, 0, 0.8)" in rep
    assert "(R21) 0 (R31) 0" in rep
    assert "(t21) 0 (t31) 0" in rep
