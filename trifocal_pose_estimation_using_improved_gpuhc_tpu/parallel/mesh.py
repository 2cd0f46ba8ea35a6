"""Hypothesis-axis data parallelism over a device mesh.

The reference shards RANSAC iterations statically across <= 8 GPUs with zero
inter-GPU communication and host-side result stacking
(GPU_HC_Solver.cpp:84-88, 494-506).  Here: a 1-D ``jax.sharding.Mesh`` over
a "hyp" axis and ``shard_map`` of the whole production tracking program
(ops/segmented.py) -- each device owns a contiguous block of hypotheses
(all 312 paths of a hypothesis stay on one device, the 30-var system is never
split) and runs its own segment loop.  Tracking itself is
communication-free; with TrunRANSAC abort the found-flag is all-reduced
(max) across the mesh at every segment boundary and the best pose is chosen
by all_gather+argmax -- stronger than the reference, whose abort flag never
crosses GPUs (...TrunRANSAC.cu:152, SURVEY.md section 2.4).  The mesh is
flat: the cards of one host reach each other at the same rate.

Multi-host: the same mesh spans processes via jax.distributed; the only
cross-device traffic is the per-segment scalar found-flag all-reduce.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import segmented
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
    HCConfig,
    RansacConfig,
)


def make_mesh(n_devices: Optional[int] = None, axis: str = "hyp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_sharded_track_fn(
    problem: TrifocalProblem,
    cfg: HCConfig,
    mesh: Mesh,
    axis: str = "hyp",
    ransac_cfg: Optional[RansacConfig] = None,
):
    """Build the multi-device tracking function.

    Returned ``track(x0, tgt, diff, edgels=None, intrinsics=None,
    n_edgels=None)`` -> segmented.SegmentedResult, with the path batch
    (hypotheses x tracks) sharded over the mesh axis; the batch must divide
    evenly by the mesh size (pad hypotheses to a multiple of the device
    count).  ``track.jitted`` has the single-device contract of
    ops/segmented.make_segmented_track_fn.
    """
    spec = P(axis)
    seg_track = segmented.make_segmented_track_fn(
        problem, cfg, ransac_cfg, axis_name=axis,
    )
    jitted = jax.jit(jax.shard_map(
        seg_track.jitted,
        mesh=mesh,
        in_specs=(spec,) * 6 + (P(), P(), P()),
        out_specs=(spec,) * 6 + (P(), P(), P(), P()),
        check_vma=False,
    ))

    def track(x0, target_params, diff_params, edgels=None,
              intrinsics=None, n_edgels=None) -> segmented.SegmentedResult:
        return segmented.run_planes(jitted, x0, target_params, diff_params,
                                    edgels, intrinsics, n_edgels)

    track.jitted = jitted
    return track
