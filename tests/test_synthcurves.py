"""The seeded synthetic curve-edgel dataset."""

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import synthcurves


def _support(view):
    g = [(p[:, :3][None], p[:, 3][None]) for p in (view.gt_pose21,
                                                   view.gt_pose31)]
    n21, n31 = ransac.count_inlier_support(
        g[0][0], g[1][0], g[0][1], g[1][1], view.edge_locations,
        synthcurves.intrinsics(),
    )
    return int(n21[0]), int(n31[0])


def test_generator_is_deterministic():
    a = synthcurves.generate_view(3)
    b = synthcurves.generate_view(3)
    c = synthcurves.generate_view(4)
    np.testing.assert_array_equal(a.edge_locations, b.edge_locations)
    np.testing.assert_array_equal(a.edge_tangents, b.edge_tangents)
    np.testing.assert_array_equal(a.gt_pose21, b.gt_pose21)
    assert not np.array_equal(a.edge_locations, c.edge_locations)


@pytest.mark.parametrize("view_index", [0, 1, 50, 99])
def test_ground_truth_support_at_least_90_percent(view_index):
    view = synthcurves.generate_view(view_index)
    n = view.edge_locations.shape[0]
    assert n == synthcurves.NUM_EDGELS
    n21, n31 = _support(view)
    assert n21 >= 0.9 * n and n31 >= 0.9 * n
    # The outliers are really outliers.
    assert n21 <= n - 0.8 * 0.05 * n and n31 <= n - 0.8 * 0.05 * n


def test_view_shapes_and_units():
    view = synthcurves.generate_view(0)
    assert view.edge_locations.shape == (synthcurves.NUM_EDGELS, 6)
    assert view.edge_locations.dtype == np.float32
    # Metric coordinates inside the image; unit tangents.
    half = np.array(synthcurves.IMAGE_SIZE) / 2 / synthcurves.FOCAL_PX
    assert (np.abs(view.edge_locations.reshape(-1, 3, 2)) <= half).all()
    norms = np.linalg.norm(view.edge_tangents.reshape(-1, 3, 2), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    for p in (view.gt_pose21, view.gt_pose31):
        np.testing.assert_allclose(p[:, :3] @ p[:, :3].T, np.eye(3),
                                   atol=1e-5)


def test_noise_and_outlier_parameters():
    clean = synthcurves.generate_view(2, outlier_ratio=0.0)
    n = clean.edge_locations.shape[0]
    assert _support(clean) == (n, n)
    noisy = synthcurves.generate_view(2, outlier_ratio=0.0, noise_px=0.5)
    d = np.abs(noisy.edge_locations - clean.edge_locations) * \
        synthcurves.FOCAL_PX
    assert 0.1 < d.mean() < 1.0
