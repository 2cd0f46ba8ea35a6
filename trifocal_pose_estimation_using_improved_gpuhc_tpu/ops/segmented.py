"""Segmented path tracking: survivor compaction + RANSAC early abort.

The production path tracker.  The reference exploits divergent path
lifetimes implicitly: CUDA blocks whose path converged/pruned retire and
free their SM, and with TrunRANSAC every block polls a global found-flag and
skips its whole loop once any block finds a >=90%-support pose
(kernel_GPUHC_..._TrunRANSAC.cu:152, dev-trifocal_2op1p-eval.cuh:235-246).
Here the whole batch advances together, so the equivalent is restructured:

* Tracking runs in SEGMENTS of ``segment_steps`` masked HC steps (the plain
  XLA step of ops/tracker.make_segment_fn).
* Between segments, surviving (active) paths are COMPACTED to the front of
  the batch with a stable sort, ordered by tracking progress.  In a plain
  XLA step a retired path costs as much as a live one, so compaction buys
  no time until a step runs only the live prefix; it is kept because it
  leaves every per-path result unchanged.
* With abort enabled, paths that converged during the segment are scored
  on-device: pose-component-imaginary gate (IMAG_PART_TOL), Cayley ->
  rotation, reprojection-inlier counts over every edgel for both view
  pairs, pass iff both ratios >= 0.90 (dev-trifocal_2op1p-eval.cuh:46-246
  semantics, vectorised as one (candidates x edgels) broadcast).  A hit
  stops the whole batch at the next segment boundary.

* Under ``axis_name`` (hypothesis-sharded multi-device execution through
  parallel/mesh.py), the found-flag is all-reduced (max) across devices at
  every segment boundary, so one device's hit stops EVERY device --
  *stronger* than the reference, whose abort flag never crosses GPUs
  (...TrunRANSAC.cu:152 polls a per-GPU global; SURVEY.md section 2.4) --
  and the best-support pose is selected with an all_gather + argmax
  instead of the reference's host stacking loop (Evaluations.cpp:382-504).
  The segment loop runs while ANY device has active paths, keeping the trip
  count uniform so the in-loop collective is legal.

Everything (segments, scoring, compaction, the while loop) lives in one
jitted program; nothing returns to the host until tracking finishes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as tfm,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops.tracker import (
    TrackResult,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
    HCConfig,
    RansacConfig,
)

# Converged candidates scored per segment.  Paths that converge in a
# segment where the slots overflow stay marked un-scored and are picked up
# at the next segment boundary, so no candidate is ever silently skipped.
_SCORE_SLOTS = 128


class SegmentedResult(NamedTuple):
    """TrackResult fields + TrunRANSAC outputs."""

    track: TrackResult
    found: bool            # a >=90%-support pose was found on-device
    found_path: int        # global path index of the first found pose (-1)
    best_support: int      # best min(n21, n31) among scored candidates (-1)
    best_path: int         # global path index of that candidate (-1)


def _take(tree, idx):
    """Gather every per-path (leading-axis) leaf of a pytree."""
    return jax.tree_util.tree_map(
        lambda a: jnp.take(a, idx, axis=0) if a.ndim else a, tree
    )


def make_segmented_track_fn(
    problem: tfm.TrifocalProblem,
    cfg: HCConfig,
    ransac_cfg: Optional[RansacConfig] = None,
    axis_name: Optional[str] = None,
):
    """Build the segmented tracking function.

    Returned ``track(x0, tgt, diff, edgels=None, intrinsics=None)`` ->
    SegmentedResult.  ``track.jitted`` takes f32 planes plus (edgels
    (E, 6), intrinsics (3, 3), num_edgels ()) and returns the plane tuple
    + (found, found_path, best_support, best_path); edgel scoring runs only
    when ``ransac_cfg`` has abort_by_good_sol set.

    axis_name: when the function runs per-shard under shard_map
    (parallel/mesh.py), the name of the hypothesis mesh axis -- enables the
    cross-device abort all-reduce and global best-pose selection.
    """
    seg = max(1, cfg.segment_steps)
    n_segments = -(-(cfg.max_steps + 1) // seg)
    run = tracker.make_segment_fn(problem, cfg)
    abort = bool(ransac_cfg and ransac_cfg.abort_by_good_sol)
    imag_tol = ransac_cfg.imag_part_tol if ransac_cfg else 1e-5
    thresh_px = ransac_cfg.reproj_inlier_thresh_px if ransac_cfg else 2.0
    ratio = ransac_cfg.pass_inlier_support_ratio if ransac_cfg else 0.9

    def _score_new(s, scored, order, best_supp, best_path, edgels, kmat,
                   n_edgels):
        """Score newly-converged paths.

        Returns (found, found_path, scored, best_supp, best_path).
        Vectorised dev-trifocal_2op1p-eval.cuh:46-246: imag gate on the 12
        pose components, Cayley -> R (column-normalised), inlier counts
        over all edgels for view pairs 1-2 and 1-3, pass iff both ratios
        >= 0.90.  Only paths actually placed into the scoring slots are
        marked scored, so slot overflow defers (never drops) candidates.
        """
        newly = tracker._is_converged(s.t, cfg) & ~scored
        # Stable-sort newly-converged paths into the scoring slots.
        sidx = jnp.argsort(~newly, stable=True)[:_SCORE_SLOTS]
        valid = newly[sidx]
        scored = scored.at[sidx].max(valid)
        pose = s.x[sidx, tfm.POSE_SLICE]          # (S, 12)
        gate = jnp.max(jnp.abs(jnp.imag(pose)), axis=1) < imag_tol
        pr = jnp.real(pose)
        n21, n31 = ransac.count_inlier_support(
            tfm.cayley_to_rotation(pr[:, 6:9]),
            tfm.cayley_to_rotation(pr[:, 9:12]),
            pr[:, 0:3], pr[:, 3:6], edgels, kmat, thresh_px=thresh_px,
        )
        need = ratio * n_edgels
        hit = (
            valid & gate
            & (n21.astype(jnp.float32) >= need)
            & (n31.astype(jnp.float32) >= need)
        )
        found = jnp.any(hit)
        first = jnp.argmax(hit)
        found_path = jnp.where(found, order[sidx[first]], -1)
        # Running best-support candidate (on-device maximal-support
        # selection; host scoring stays the authoritative full gate).
        smin = jnp.where(valid & gate, jnp.minimum(n21, n31), -1)
        sbest = jnp.argmax(smin)
        better = smin[sbest] > best_supp
        best_supp = jnp.where(better, smin[sbest], best_supp)
        best_path = jnp.where(better, order[sidx[sbest]], best_path)
        return found, found_path, scored, best_supp, best_path

    def _track_planes(x0_re, x0_im, tgt_re, tgt_im, diff_re, diff_im,
                      edgels, kmat, n_edgels):
        # Trace every product at full float32 (no TF32 on the GPU).
        with jax.default_matmul_precision("highest"):
            return _track(x0_re, x0_im, tgt_re, tgt_im, diff_re, diff_im,
                          edgels, kmat, n_edgels)

    def _track(x0_re, x0_im, tgt_re, tgt_im, diff_re, diff_im,
               edgels, kmat, n_edgels):
        x0 = jax.lax.complex(x0_re, x0_im)
        B = x0.shape[0]
        paths = (
            tracker.init_state(x0, cfg),
            tracker.init_extras(x0, cfg),
            jax.lax.complex(tgt_re, tgt_im),
            jax.lax.complex(diff_re, diff_im),
            jnp.arange(B, dtype=jnp.int32),   # original index of each row
            jnp.zeros((B,), bool),            # scored by the abort test
        )
        found = jnp.array(False)
        found_path = jnp.array(-1, jnp.int32)
        best_supp = jnp.array(-1, jnp.int32)
        best_path = jnp.array(-1, jnp.int32)

        def cond(carry):
            si, paths = carry[:2]
            found = carry[2]
            keep = jnp.any(tracker._active(paths[0], cfg)) & (si < n_segments)
            if axis_name is None:
                if abort:
                    keep = keep & (~found)
                return keep
            # Cross-device TrunRANSAC: one all-reduce(max) per segment
            # boundary carries [any-device-still-active, any-device-found];
            # the loop keeps a uniform trip count across the mesh and one
            # device's hit stops every device (stronger than the
            # reference's per-GPU flag, ...TrunRANSAC.cu:152).
            packed = jnp.stack(
                [keep.astype(jnp.int32),
                 (found if abort else jnp.array(False)).astype(jnp.int32)]
            )
            packed = jax.lax.pmax(packed, axis_name)
            keep_g = packed[0] > 0
            if abort:
                keep_g = keep_g & (packed[1] == 0)
            return keep_g

        def body(carry):
            si, paths, found, found_path, best_supp, best_path = carry
            s, extras, tgt, diff, order, scored = paths
            remaining = jnp.minimum(cfg.max_steps + 1 - si * seg, seg)
            s, extras = run(s, extras, tgt, diff, remaining)
            if abort:
                f2, fp2, scored, best_supp, best_path = _score_new(
                    s, scored, order, best_supp, best_path, edgels, kmat,
                    n_edgels,
                )
                found_path = jnp.where(found, found_path, fp2)
                found = found | f2
            paths = (s, extras, tgt, diff, order, scored)
            if cfg.compact_survivors:
                # Active paths first, higher-t paths grouped together.
                key = jnp.where(tracker._active(s, cfg), 1.0 - s.t, 2.0)
                paths = _take(paths, jnp.argsort(key, stable=True))
            return (si + 1, paths, found, found_path, best_supp, best_path)

        carry = (jnp.zeros((), jnp.int32), paths, found, found_path,
                 best_supp, best_path)
        _, paths, found, found_path, best_supp, best_path = (
            jax.lax.while_loop(cond, body, carry)
        )
        s, order = paths[0], paths[4]
        # Undo compaction.
        s = _take(s, jnp.argsort(order))

        if axis_name is not None:
            # Global result selection (replaces the reference's host-side
            # result stacking + scan, GPU_HC_Solver.cpp:494-506 +
            # Evaluations.cpp:382-504): local path ids become global via
            # the shard offset, then an all_gather + argmax picks the
            # first finder and the maximal-support candidate.
            ai = jax.lax.axis_index(axis_name)
            off = ai.astype(jnp.int32) * jnp.int32(B)
            gfp = jnp.where(found_path >= 0, found_path + off, -1)
            gbp = jnp.where(best_path >= 0, best_path + off, -1)
            founds = jax.lax.all_gather(found, axis_name)
            fps = jax.lax.all_gather(gfp, axis_name)
            supps = jax.lax.all_gather(best_supp, axis_name)
            bps = jax.lax.all_gather(gbp, axis_name)
            fdev = jnp.argmax(founds)
            found = jnp.any(founds)
            found_path = jnp.where(found, fps[fdev], -1)
            bdev = jnp.argmax(supps)
            best_supp = supps[bdev]
            best_path = bps[bdev]

        return tracker.result_planes(s, cfg) + (
            found, found_path, best_supp, best_path
        )

    if axis_name is None:
        _track_planes = jax.jit(_track_planes)

    def track(x0, target_params, diff_params, edgels=None,
              intrinsics=None, n_edgels=None) -> SegmentedResult:
        return run_planes(_track_planes, x0, target_params, diff_params,
                          edgels, intrinsics, n_edgels)

    track.jitted = _track_planes
    return track


def run_planes(jitted, x0, target_params, diff_params, edgels=None,
               intrinsics=None, n_edgels=None) -> SegmentedResult:
    """Call a segmented planes program on host arrays -> SegmentedResult."""
    x0 = np.asarray(x0)
    tgt = np.asarray(target_params)
    diff = np.asarray(diff_params)
    f32 = np.float32
    if edgels is None:
        edgels = np.full((8, 6), 1e3, f32)
        intrinsics = np.eye(3, dtype=f32)
        n_edgels = 8
    out = jitted(
        x0.real.astype(f32), x0.imag.astype(f32),
        tgt.real.astype(f32), tgt.imag.astype(f32),
        diff.real.astype(f32), diff.imag.astype(f32),
        np.asarray(edgels, f32), np.asarray(intrinsics, f32),
        np.float32(n_edgels if n_edgels is not None else len(edgels)),
    )
    (xr, xi, conv, inf, pruned, steps,
     found, found_path, best_supp, best_path) = out
    x = np.asarray(xr) + 1j * np.asarray(xi)
    return SegmentedResult(
        track=TrackResult(
            x=x.astype(np.complex64),
            converged=np.asarray(conv),
            inf_fail=np.asarray(inf),
            pruned=np.asarray(pruned),
            num_steps=np.asarray(steps),
        ),
        found=bool(np.asarray(found)),
        found_path=int(np.asarray(found_path)),
        best_support=int(np.asarray(best_supp)),
        best_path=int(np.asarray(best_path)),
    )
