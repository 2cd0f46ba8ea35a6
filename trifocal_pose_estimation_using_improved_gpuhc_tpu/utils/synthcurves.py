"""Seeded synthetic curve-edgel dataset: view triplets of 3D curves.

Stands in for the synthcurves RANSAC dataset when no reference-layout data
tree is given (utils/config.EngineConfig.data_root).  Each view triplet is
built in memory from ``(seed, view_index)``:

* random smooth closed 3D curves (low-order Fourier series) around a point
  in front of camera 1, whose frame is the world frame;
* cameras 2 and 3 placed 8-25 degrees off camera 1's axis, looking at the
  scene centre, with ground-truth poses view_j = R_j1 view_1 + t_j1;
* points and unit tangents sampled on the curves and projected into all
  three views in metric (calibrated) coordinates, keeping only edgels that
  land inside every image and whose image tangent is well defined;
* optional Gaussian location noise (``noise_px``, in pixels) and a share
  of outliers (``outlier_ratio``) whose view 2 and view 3 edgels belong to
  another, random edgel.

The defaults keep every inlier exact, so the ground-truth pose has
1 - outlier_ratio = 95 % support on both view pairs (the engine accepts a
pose at 90 %).
"""

from __future__ import annotations

import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.data_io import (
    RansacView,
)

NUM_VIEWS = 100
NUM_EDGELS = 5117
IMAGE_SIZE = (640, 480)  # width, height in pixels
FOCAL_PX = 2585.0


def intrinsics() -> np.ndarray:
    """The cameras' shared intrinsic matrix, (3, 3) float32."""
    w, h = IMAGE_SIZE
    return np.array([[FOCAL_PX, 0.0, w / 2], [0.0, FOCAL_PX, h / 2],
                     [0.0, 0.0, 1.0]], np.float32)


def _look_at(pos: np.ndarray, target: np.ndarray, roll: float) -> np.ndarray:
    """World->camera rotation of a camera at pos looking at target."""
    z = target - pos
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c, s = np.cos(roll), np.sin(roll)
    x, y = c * x + s * y, -s * x + c * y
    return np.stack([x, y, z])


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    k = axis / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def _cameras(rng: np.random.Generator, centre: np.ndarray):
    """Ground-truth poses (R, t) of cameras 2 and 3 relative to camera 1."""
    poses = []
    for _ in range(2):
        phi = rng.uniform(0, 2 * np.pi)
        axis = np.array([np.cos(phi), np.sin(phi), 0.0])
        angle = np.deg2rad(rng.uniform(8.0, 25.0))
        dist = np.linalg.norm(centre) * rng.uniform(0.9, 1.1)
        pos = centre - dist * (_axis_angle(axis, angle) @ np.array([0, 0, 1.0]))
        r = _look_at(pos, centre, rng.uniform(-0.2, 0.2))
        poses.append((r, -r @ pos))
    return poses


def _curve_samples(rng: np.random.Generator, centre: np.ndarray, n: int):
    """n points and unit 3D tangents on random closed Fourier curves."""
    n_curves = 24
    per = -(-n // n_curves)
    pts, tans = [], []
    for _ in range(n_curves):
        origin = centre + rng.uniform(-0.18, 0.18, 3)
        a = rng.normal(0, 0.08, (3, 3))
        b = rng.normal(0, 0.08, (3, 3))
        s = rng.uniform(0, 2 * np.pi, per)
        k = np.arange(1, 4)[:, None]                       # (3, 1)
        cos, sin = np.cos(k * s), np.sin(k * s)            # (3, per)
        pts.append(origin + ((a / k.T) @ cos + (b / k.T) @ sin).T)
        tans.append((-a @ sin + b @ cos).T)
    pts = np.concatenate(pts)[:n]
    tans = np.concatenate(tans)[:n]
    return pts, tans / np.linalg.norm(tans, axis=1, keepdims=True)


def _project(pts, tans):
    """Metric image locations (N, 2) and unit image tangents (N, 2)."""
    z = pts[:, 2:3]
    loc = pts[:, :2] / z
    d = (tans[:, :2] - loc * tans[:, 2:3]) / z
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    return loc, d / np.maximum(norm, 1e-30), norm[:, 0] * z[:, 0]


def generate_view(view_index: int, seed: int = 0,
                  num_edgels: int = NUM_EDGELS, noise_px: float = 0.0,
                  outlier_ratio: float = 0.05) -> RansacView:
    """One view triplet, deterministic in (seed, view_index)."""
    rng = np.random.default_rng([seed, view_index])
    centre = np.array([0.0, 0.0, rng.uniform(2.5, 3.5)])
    poses = _cameras(rng, centre)
    w, h = IMAGE_SIZE
    half = np.array([w / 2, h / 2]) / FOCAL_PX * 0.97
    locs = tans2d = None
    pool = 2 * num_edgels
    for _ in range(8):
        pts, tans = _curve_samples(rng, centre, pool)
        views = [_project(pts, tans)]
        for r, t in poses:
            views.append(_project(pts @ r.T + t, tans @ r.T))
        ok = np.ones(pool, bool)
        for (loc, _, dnorm), (cam_pts) in zip(
                views, [pts] + [pts @ r.T + t for r, t in poses]):
            ok &= (cam_pts[:, 2] > 0) & (np.abs(loc) < half).all(axis=1)
            # The image tangent vanishes where the curve runs along the
            # viewing ray; such edgels have no usable orientation.
            ok &= dnorm > 0.2
        if ok.sum() >= num_edgels:
            idx = rng.choice(np.nonzero(ok)[0], num_edgels, replace=False)
            locs = np.concatenate([v[0][idx] for v in views], axis=1)
            tans2d = np.concatenate([v[1][idx] for v in views], axis=1)
            break
        pool *= 2
    if locs is None:
        raise RuntimeError(f"view {view_index}: too few visible edgels")
    if noise_px > 0:
        locs = locs + rng.normal(0, noise_px / FOCAL_PX, locs.shape)
    n_out = int(round(outlier_ratio * num_edgels))
    if n_out:
        bad = rng.choice(num_edgels, n_out, replace=False)
        # Rotate the random pick so every outlier's views 2/3 come from
        # another edgel.
        src = np.roll(bad, 1) if n_out > 1 else (bad + 1) % num_edgels
        locs[bad, 2:] = locs[src, 2:]
        tans2d[bad, 2:] = tans2d[src, 2:]

    def pose(r, t):
        return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)

    return RansacView(
        edge_locations=locs.astype(np.float32),
        edge_tangents=tans2d.astype(np.float32),
        gt_pose21=pose(*poses[0]),
        gt_pose31=pose(*poses[1]),
    )
