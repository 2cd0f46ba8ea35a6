"""Reproduction of the reference's sampling, and golden tracker statistics.

The reference's CPU solver (no TrunPaths, plain LAPACK f32) is the
semantics oracle for its own committed sample run; tools/reconcile_stats.py
compares against those outputs on the reference's data tree.  These tests
pin (a) the bit-exact glibc srand(0) sampling reproduction and (b) the
oracle tracker's convergence statistics on that sampling over the committed
start system and the generated dataset (view 0), so a semantics regression
shows as a moved count.
"""

import dataclasses

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac, tracker
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
    data_io,
    evaluation as evl,
)


def test_glibc_rand_bit_exact():
    """GlibcRand == glibc rand() (golden values from a compiled C run)."""
    g = ransac.GlibcRand(0)
    assert [g.rand() for _ in range(12)] == [
        1804289383, 846930886, 1681692777, 1714636915, 1957747793,
        424238335, 719885386, 1649760492, 596516649, 1189641421,
        1025202362, 1350490027,
    ]


def test_reference_sampling_bit_exact():
    """Reproduces GPU_HC_Solver.cpp:268-271 including its duplicate-check
    quirk (indices 0 and 2 are never compared); golden values from a
    compiled C reimplementation of that exact loop with N=5117."""
    s = ransac.sample_edgel_triplets_reference(0, 5117, 5)
    assert s.tolist() == [
        [4481, 865, 961], [1853, 4061, 3216], [241, 3873, 2374],
        [325, 1178, 1153], [2043, 1005, 1287],
    ]


@pytest.mark.slow
def test_convergence_statistics_golden(cfg, problem):
    """Tracker statistics on the reference's exact srand(0) sampling, H=1.

    Golden values from this framework's oracle tracker on the generated
    data (pins regressions).
    """
    view = data_io.load_view(cfg, 0)
    samples = ransac.sample_edgel_triplets_reference(
        0, view.edge_locations.shape[0], 1
    )
    tgt = ransac.build_target_params(
        view.edge_locations, view.edge_tangents, samples
    )
    T = problem.num_tracks
    tgt_b = np.repeat(tgt, T, axis=0)
    diff_b = tgt_b - np.asarray(problem.start_params)
    x0 = np.tile(np.asarray(problem.start_sols), (1, 1))
    # The reference CPU solver has NO TrunPaths (CPUHC_Generic_Solver_
    # Eval_by_Indx.cpp contains no depth check), so compare truncation-off.
    hc = dataclasses.replace(cfg.hc, truncate_paths=False)
    res = tracker.make_track_fn(problem, hc)(x0, tgt_b, diff_b)
    st = evl.collect_stats(res.x, res.converged, res.inf_fail, cfg.ransac)
    # A 1-2 path drift across XLA device configs is threshold-level float
    # noise (reduction reassociation); a real semantics regression moves
    # these counts by tens.
    assert abs(st.num_converged - 90) <= 3
    assert abs(st.num_infinity - 35) <= 3
    assert int(res.pruned.sum()) == 0


@pytest.mark.slow
def test_f32_oracle_real_count_h2(cfg, problem):
    """The f32 oracle's H=2 real count at the 1e-4 cliff (measured 24 of
    244 converged on the generated data).  A collapse toward 0 would mean
    an absolute-error floor crept into the evaluation (a defect an earlier
    pair-product basis had: ~1e-4 imaginary residue on every root)."""
    view = data_io.load_view(cfg, 0)
    samples = ransac.sample_edgel_triplets_reference(
        0, view.edge_locations.shape[0], 2
    )
    tgt = ransac.build_target_params(
        view.edge_locations, view.edge_tangents, samples
    )
    T = problem.num_tracks
    tgt_b = np.repeat(tgt, T, axis=0)
    diff_b = tgt_b - np.asarray(problem.start_params)
    x0 = np.tile(np.asarray(problem.start_sols), (2, 1))
    hc = dataclasses.replace(cfg.hc, truncate_paths=False)
    res = tracker.make_track_fn(problem, hc)(x0, tgt_b, diff_b)
    mi = np.abs(res.x.imag).max(axis=-1)
    n_real = int((res.converged & (mi <= 1e-4)).sum())
    # Threshold-level drift of a couple of paths is float noise; a floor
    # defect zeroes it.
    assert n_real >= 10
