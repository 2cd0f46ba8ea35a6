"""Loaders for the problem start system, Jacobian index tables, and the
synthcurves RANSAC dataset.

Equivalent of the reference Data_Reader (magmaHC/Data_Reader.cpp), re-designed
as pure functions returning numpy arrays. File formats (all plain text):

  start_params.txt   33 lines "re im"            (Data_Reader.cpp:104-121)
  start_sols.txt     312*30 lines "re im"        (Data_Reader.cpp:37-60)
  dHdx_indx.txt      30*8*5 rows x 30 cols ints  (Data_Reader.cpp:123-144)
  dHdt_indx.txt      16*6 rows x 30 cols ints    (Data_Reader.cpp:146-165)
  Intrinsic_Matrix.txt            3x3 floats     (Data_Reader.cpp:254-270)
  GT_Poses21/GT_Poses21_%03d.txt  3x4 floats     (Data_Reader.cpp:191-252)
  Triplet_Edgels/Triplet_Edgels_%03d.txt  N x 12 floats
       = (x,y,tx,ty) per view, metric coords     (Data_Reader.cpp:272-338)

Index-table semantics (decoded from
gpu-idx-evals/dev-eval-indxing-trifocal_2op1p_30x30_LimUnroll_L2Cache.cuh):
the Hx table is [var v][term j][part k][eq e] with parts
(int coeff, param_idx, param_idx, var_idx, var_idx); the Ht/H table is
[term j][part k][eq e] with parts (coeff, p1, p2, v1, v2, v3). Param index 33
addresses a constant-1 slot (34 param slots total); var index 30 addresses the
homogeneous-1 slot (31 var slots). The last axis is the equation index: MAGMA
thread tx owns Jacobian ROW tx (dev-cgesv-batched-small.cuh:41-50), and
eval_Jacobian_Hx fills r_cgesvA[v] from table entry [v,...,tx].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import native


def _load_floats(path: str, cols: int) -> np.ndarray:
    """Whitespace-numeric file -> (rows, cols) float64.

    Uses the native strtod parser (native/fastio.c, the Data_Reader.cpp
    equivalent) when a C compiler is available; numpy otherwise."""
    a = native.parse_floats(path)
    return a.reshape(-1, cols)


def _load_complex(path: str) -> np.ndarray:
    a = _load_floats(path, 2)
    return (a[:, 0] + 1j * a[:, 1]).astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Start system + index tables for one minimal problem."""

    start_params: np.ndarray  # complex64 (num_params,)
    start_sols: np.ndarray    # complex64 (num_tracks, num_vars)
    hx_table: np.ndarray      # int32 (num_vars, hx_terms, hx_parts, num_eqs)
    ht_table: np.ndarray      # int32 (ht_terms, ht_parts, num_eqs)


def load_problem_data(
    problem_dir: str,
    num_vars: int = 30,
    num_tracks: int = 312,
    hx_terms: int = 8,
    hx_parts: int = 5,
    ht_terms: int = 16,
    ht_parts: int = 6,
) -> ProblemData:
    start_params = _load_complex(os.path.join(problem_dir, "start_params.txt"))
    assert start_params.shape[0] == 33 or start_params.shape[0] > 0
    sols = _load_complex(os.path.join(problem_dir, "start_sols.txt"))
    start_sols = sols.reshape(num_tracks, num_vars)
    hx = native.parse_floats(
        os.path.join(problem_dir, "dHdx_indx.txt")
    ).astype(np.int32)
    hx_table = hx.reshape(num_vars, hx_terms, hx_parts, num_vars)
    ht = native.parse_floats(
        os.path.join(problem_dir, "dHdt_indx.txt")
    ).astype(np.int32)
    ht_table = ht.reshape(ht_terms, ht_parts, num_vars)
    return ProblemData(start_params, start_sols, hx_table, ht_table)


@dataclasses.dataclass(frozen=True)
class RansacView:
    """One view-triplet of the RANSAC dataset."""

    edge_locations: np.ndarray  # float32 (N, 6) = (x1,y1,x2,y2,x3,y3) metric
    edge_tangents: np.ndarray   # float32 (N, 6)
    gt_pose21: np.ndarray       # float32 (3, 4) [R | t]
    gt_pose31: np.ndarray       # float32 (3, 4)


def _padded_index(i: int) -> str:
    return f"{i:03d}"


def load_intrinsic_matrix(dataset_dir: str) -> np.ndarray:
    k = _load_floats(os.path.join(dataset_dir, "Intrinsic_Matrix.txt"), 3)
    return k.reshape(3, 3).astype(np.float32)


def load_ransac_view(dataset_dir: str, view_index: int) -> RansacView:
    idx = _padded_index(view_index)
    edgels = _load_floats(
        os.path.join(dataset_dir, "Triplet_Edgels", f"Triplet_Edgels_{idx}.txt"),
        12,
    ).astype(np.float32)
    # Columns: (x,y,tx,ty) x 3 views -> locations (x,y) x 3, tangents (tx,ty) x 3.
    locations = edgels[:, [0, 1, 4, 5, 8, 9]]
    tangents = edgels[:, [2, 3, 6, 7, 10, 11]]
    # GT pose files hold 4 rows x 3 cols: rows 0-2 = R (row-major), row 3 = t
    # (Evaluations.hpp:114-115 splits the flat 12 floats as [0:9]=R, [9:12]=t).
    # Repack as the conventional (3, 4) [R | t].
    def _load_pose(subdir: str, stem: str) -> np.ndarray:
        a = native.parse_floats(
            os.path.join(dataset_dir, subdir, f"{stem}_{idx}.txt")
        ).reshape(4, 3)
        return np.concatenate([a[:3, :], a[3, :][:, None]], axis=1).astype(np.float32)

    pose21 = _load_pose("GT_Poses21", "GT_Poses21")
    pose31 = _load_pose("GT_Poses31", "GT_Poses31")
    return RansacView(locations, tangents, pose21, pose31)


def num_ransac_views(dataset_dir: str) -> int:
    d = os.path.join(dataset_dir, "Triplet_Edgels")
    return len([f for f in os.listdir(d) if f.startswith("Triplet_Edgels_")])


def load_view(cfg, view_index: int) -> RansacView:
    """View triplet ``view_index`` of the configured dataset: the reference
    tree under cfg.data_root, else the seeded synthetic dataset."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        config,
        synthcurves,
    )

    d = config.ransac_data_dir(cfg)
    if d is None:
        return synthcurves.generate_view(view_index)
    return load_ransac_view(d, view_index)


def load_intrinsics(cfg) -> np.ndarray:
    """The configured dataset's intrinsic matrix (3, 3) float32."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        config,
        synthcurves,
    )

    d = config.ransac_data_dir(cfg)
    if d is None:
        return synthcurves.intrinsics()
    return load_intrinsic_matrix(d)
