"""Multi-device sharding tests on the 8-device virtual CPU mesh.

These exercise the production segmented path per shard and the cross-device
TrunRANSAC collectives, against the plain single-device oracle.
"""

import dataclasses

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.parallel import mesh as pmesh
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io


def _workload(cfg, problem, H, T, seed=3):
    view = data_io.load_view(cfg, 0)
    samples = ransac.sample_edgel_triplets(seed, view.edge_locations.shape[0], H)
    tgt = ransac.build_target_params(
        view.edge_locations, view.edge_tangents, samples
    )
    tgt_b = np.repeat(tgt, T, axis=0)
    diff_b = tgt_b - np.asarray(problem.start_params)
    x0 = np.tile(np.asarray(problem.start_sols)[:T], (H, 1))
    return x0, tgt_b, diff_b, view


def test_sharded_track_matches_single_device(cfg, problem):
    import jax

    assert len(jax.devices()) == 8
    # predictor_handoff off: its condition is granularity-dependent
    # (batch-wide oracle vs per-shard), so sharded-vs-single parity
    # only holds without it.
    hc = dataclasses.replace(cfg.hc, max_steps=12,
                             predictor_handoff=False)
    x0, tgt_b, diff_b, _ = _workload(cfg, problem, H=8, T=16)

    single = tracker.make_track_fn(problem, hc)
    r_single = single(x0, tgt_b, diff_b)

    # The production path per shard: only the sharding and the
    # segmenting differ from the oracle.
    m = pmesh.make_mesh(8)
    sharded = pmesh.make_sharded_track_fn(problem, hc, m)
    r_shard = sharded(x0, tgt_b, diff_b).track

    # Hypothesis sharding is communication-free: flags agree exactly;
    # solutions agree up to f32 reassociation noise (different program
    # partitioning reorders reductions). Non-converged paths hold garbage
    # (diverged/rolled-back state), so compare converged ones only.
    np.testing.assert_array_equal(r_single.converged, r_shard.converged)
    np.testing.assert_array_equal(r_single.pruned, r_shard.pruned)
    np.testing.assert_array_equal(r_single.num_steps, r_shard.num_steps)
    conv = r_single.converged
    np.testing.assert_allclose(
        r_single.x[conv], r_shard.x[conv], rtol=5e-3, atol=5e-4
    )


@pytest.mark.slow
def test_cross_chip_abort_stops_other_devices(cfg, problem):
    """One device's TrunRANSAC hit stops every device at a segment boundary.

    Device 0 gets a trivial homotopy (diff = 0, so its paths converge in a
    few steps); devices 1-7 get a real RANSAC target that cannot converge
    within the step budget.  With the found-flag all-reduce, the global
    abort must stop devices 1-7 mid-tracking.
    """
    H, T = 8, 8
    # truncate_paths off: device 0's trivial paths would otherwise be
    # depth-sign pruned at t>0.95 (start solutions have mixed-sign depths).
    hc = dataclasses.replace(
        cfg.hc, max_steps=16, segment_steps=2, init_delta_t=0.5,
        truncate_paths=False,
    )
    # Accept any converged candidate: ratio 0 + huge imag tolerance turns
    # the first convergence into a hit, isolating the abort plumbing.
    rc = dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True,
        pass_inlier_support_ratio=0.0, imag_part_tol=1e9,
    )
    x0, tgt_b, diff_b, view = _workload(cfg, problem, H=H, T=T)
    # Device 0 (hypothesis 0): target == start => immediate convergence.
    sp = np.asarray(problem.start_params)
    tgt_b[:T] = sp
    diff_b[:T] = 0.0

    m = pmesh.make_mesh(8)
    sharded = pmesh.make_sharded_track_fn(problem, hc, m, ransac_cfg=rc)
    edgels = view.edge_locations.astype(np.float32)[:64]
    res = sharded(
        x0, tgt_b, diff_b, edgels=edgels,
        intrinsics=np.eye(3, dtype=np.float32), n_edgels=64,
    )
    assert res.found
    assert 0 <= res.found_path < T          # a device-0 path, global index
    assert res.best_support >= 0
    # Devices 1-7 were stopped early by the cross-device flag: none of
    # their paths reached the full step budget or converged.
    other_steps = res.track.num_steps[T:]
    assert (~res.track.converged[T:]).all()
    assert other_steps.max() < hc.max_steps


@pytest.mark.slow
def test_engine_multidevice_round(cfg, problem):
    """Engine-level hypothesis sharding: same statistics as single-device."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )

    base = dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, max_steps=12,
                                    predictor_handoff=False)  # see above
    )
    e1 = TrifocalPoseEngine(base)
    view = e1.load_view(0)
    r1 = e1.run_round(view, seed=0, num_hypotheses=4)

    e8 = TrifocalPoseEngine(dataclasses.replace(base, num_devices=4))
    r8 = e8.run_round(view, seed=0, num_hypotheses=4)
    assert r8.stats.num_converged == r1.stats.num_converged
    assert r8.stats.num_infinity == r1.stats.num_infinity
    assert r8.best_support21 == r1.best_support21
    assert r8.best_support31 == r1.best_support31
