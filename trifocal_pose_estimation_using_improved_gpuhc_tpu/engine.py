"""End-to-end trifocal pose estimation engine: RANSAC over HC path tracking.

Orchestrator equivalent of the reference GPU_HC_Solver lifecycle
(GPU_HC_Solver.hpp:103-113: Allocate / Read_Problem_Data / Read_RANSAC_Data /
Prepare_Target_Params / Data_Transfer / Solve) plus the evaluation tail of
cmd/magmaHC-main.cpp:24-116 -- re-designed around jitted JAX programs instead
of explicit allocation/transfer phases: arrays are built host-side as f32
planes, one compiled program tracks all tracks x hypotheses paths
(ops/segmented.py, the same on every platform), and a second scores
candidate poses against all edgels.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac,
    segmented,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import evaluation as evl
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
    EngineConfig,
)

# Fixed padding caps so jit programs are compiled once across rounds/views.
_CANDIDATE_CAP = 512
_EDGEL_PAD = 1024


def _pad_to(a: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


@dataclasses.dataclass
class RoundResult:
    """One RANSAC round on one view triplet."""

    stats: evl.SolutionStats
    track_ms: float          # path-tracking wall clock (the reference's timed span)
    total_ms: float          # tracking + candidate scoring + selection
    num_candidates: int
    best_support21: int
    best_support31: int
    num_edgels: int
    found_pose: bool          # >= 0.9 support on both pairs (TrunRANSAC criterion)
    pose_errors: Optional[evl.PoseErrors]
    best_pose: Optional[tuple]  # (R21, R31, t21, t31) numpy
    num_steps: np.ndarray     # per-path HC step counts
    # HC step counts of the maximal-support solutions: the union of the
    # candidates tying max support on pair 1-2 and on pair 1-3
    # (Evaluations.cpp:506-521 semantics, via get_Solution_with_Maximal_Support).
    actual_sol_steps: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    # Fundamental matrices of the candidate poses (Evaluations.cpp:298-358
    # collects F21/F31 per converged candidate): (n_cand, 3, 3) each.
    cand_f21: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 3), np.float32)
    )
    cand_f31: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 3), np.float32)
    )
    # Min residual over ALL candidate poses, independently per component,
    # and whether any single pose had all four within tolerance
    # (Evaluations.cpp:545-583 Measure_Relative_Pose_Error_from_All_Real_Sols;
    # host-scoring rounds only -- None when scoring stayed on device).
    min_residuals: Optional[evl.PoseErrors] = None
    any_within_gt: bool = False


class TrifocalPoseEngine:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.problem = trifocal.TrifocalProblem.load(cfg)
        self._ndev = cfg.num_devices or 1
        if self._ndev > 1:
            # Hypothesis data parallelism over a device mesh: the exact
            # integration point of the reference's multi-GPU sharding
            # (GPU_HC_Solver.cpp:84-88); see parallel/mesh.py.
            from trifocal_pose_estimation_using_improved_gpuhc_tpu.parallel import (
                mesh as pmesh,
            )

            if self._ndev > len(jax.devices()):
                raise ValueError(
                    f"num_devices={self._ndev} > visible devices "
                    f"{len(jax.devices())}"
                )
            self.track = pmesh.make_sharded_track_fn(
                self.problem, cfg.hc, pmesh.make_mesh(self._ndev),
                ransac_cfg=cfg.ransac,
            )
        else:
            self.track = segmented.make_segmented_track_fn(
                self.problem, cfg.hc, cfg.ransac
            )
        self._pose_fn = jax.jit(
            lambda xr: trifocal.solution_to_pose(xr.astype(jnp.float32))
        )
        self._score_fn = jax.jit(
            lambda r21, r31, t21, t31, edgels, k: ransac.count_inlier_support(
                r21, r31, t21, t31, edgels, k,
                thresh_px=cfg.ransac.reproj_inlier_thresh_px,
            )
        )
        self._intrinsics = data_io.load_intrinsics(cfg)
        self._device_score = self._build_device_score()
        # Device-side hypothesis expansion: stage only the (H, P+1) target
        # planes and repeat to (H*T, P+1) on device -- the host link then
        # carries ~0.3 MB per round instead of ~25 MB (start solutions are
        # staged once and reused; the reference re-uploads everything per
        # round, GPU_HC_Solver.cpp:335-362).
        T = self.problem.num_tracks

        def _expand(x0r, x0i, tr, ti, dr, di, edg, k, ne):
            return self.track.jitted(
                x0r, x0i,
                jnp.repeat(tr, T, axis=0), jnp.repeat(ti, T, axis=0),
                jnp.repeat(dr, T, axis=0), jnp.repeat(di, T, axis=0),
                edg, k, ne,
            )

        self._track_expand = jax.jit(_expand)
        self._x0_planes = None  # staged lazily per hypothesis count
        self._oracle = None     # plain tracker, built on first oracle_round
        # One-round-trip staging fence: a tiny jitted reduction over the
        # first element of every staged array; reading its result forces
        # all transfers to complete with a single d2h round trip.
        self._fence = jax.jit(
            lambda *xs: sum(x.reshape(-1)[0].astype(jnp.float32) for x in xs)
        )

    def _build_device_score(self):
        """Jitted on-device candidate scoring over the WHOLE batch.

        The reference downloads every solution and scores on the host
        (GPU_HC_Solver.cpp:449-460 D2H + Evaluations.cpp:382-504); here the
        statistics, the candidate gate (Evaluations.cpp:330-343) and the
        reprojection-support counts stay on device and only per-path
        support integers come back (~0.4 MB instead of ~22 MB per round).  Support
        scoring runs in 1024-path chunks so the (paths x edgels) broadcast
        never materialises at full size.
        """
        rc = self.cfg.ransac
        CH = 1024

        @jax.jit
        def score(xr, xi, conv, inf, edgels, kmat):
            B = xr.shape[0]
            real = conv & (jnp.abs(xi) <= rc.zero_imag_part_tol).all(axis=1)
            cand = (
                conv
                & (jnp.abs(xi[:, 24:30]) < rc.imag_part_tol).all(axis=1)
                & (xr[:, 0:8] >= 0).all(axis=1)
            )
            pad = -B % CH
            pose = jnp.pad(xr[:, 18:30], ((0, pad), (0, 0)))
            candp = jnp.pad(cand, (0, pad))

            def chunk_fn(args):
                pose_c, cand_c = args
                r21 = trifocal.cayley_to_rotation(pose_c[:, 6:9])
                r31 = trifocal.cayley_to_rotation(pose_c[:, 9:12])
                n21, n31 = ransac.count_inlier_support(
                    r21, r31, pose_c[:, 0:3], pose_c[:, 3:6], edgels, kmat,
                    thresh_px=rc.reproj_inlier_thresh_px,
                )
                n21 = jnp.where(cand_c, n21, -1)
                n31 = jnp.where(cand_c, n31, -1)
                return n21.astype(jnp.int32), n31.astype(jnp.int32)

            n21, n31 = jax.lax.map(
                chunk_fn,
                (pose.reshape(-1, CH, 12), candp.reshape(-1, CH)),
            )
            # Per-path masks rather than device-side sums: callers count on
            # the host AFTER slicing away hypothesis padding, so device/
            # chunk pad duplicates never inflate the statistics.
            return real, cand, n21.reshape(-1)[:B], n31.reshape(-1)[:B]

        return score

    def _build_device_select(self, n_paths: int):
        """Jitted on-device best-pose SELECTION for the serving loop.

        Statistics sums, the support argmax and the winning solution row
        all stay on device; one (39,) f32 vector crosses d2h per view
        (156 bytes vs the ~0.9 MB per-path mask pack, and no second round
        trip for the winner's solution row).  n_paths statically slices away hypothesis padding
        so pad duplicates never inflate the statistics (the reference
        downloads every solution and selects on the host,
        Evaluations.cpp:382-504).

        Output layout: [num_conv, num_inf, num_real, num_cand, best21,
        best31, steps_of_best, n_actual, steps_actual_sum] + x_real[best]
        (30,).
        """
        N = n_paths

        @jax.jit
        def select(xr, conv, inf, real, cand, n21, n31, num_steps):
            conv = conv[:N]
            inf = inf[:N]
            real = real[:N]
            cand = cand[:N]
            n21 = n21[:N]
            n31 = n31[:N]
            steps = num_steps[:N].astype(jnp.float32)
            bi = jnp.argmax(jnp.minimum(n21, n31))
            head = jnp.stack([
                conv.sum().astype(jnp.float32),
                inf.sum().astype(jnp.float32),
                real.sum().astype(jnp.float32),
                cand.sum().astype(jnp.float32),
                n21[bi].astype(jnp.float32),
                n31[bi].astype(jnp.float32),
                steps[bi],
                # Steps of "actual solutions" (max-support ties, union of
                # both pairs, Evaluations.cpp:457-515): count + mean keep
                # the serving payload O(1).
                jnp.where((n21 == n21.max()) | (n31 == n31.max()),
                          1.0, 0.0).sum(),
                jnp.where((n21 == n21.max()) | (n31 == n31.max()),
                          steps, 0.0).sum(),
            ])
            return jnp.concatenate([head, xr[bi].astype(jnp.float32)])

        return select

    @staticmethod
    def _pose_np(x_real: np.ndarray):
        """Host pose extraction for ONE solution row (30,) real parts."""

        def cay(r):
            r1, r2, r3 = r
            m = np.array([
                [1 + r1 * r1 - r2 * r2 - r3 * r3, 2 * (r1 * r2 - r3),
                 2 * (r1 * r3 + r2)],
                [2 * (r1 * r2 + r3), 1 + r2 * r2 - r1 * r1 - r3 * r3,
                 2 * (r2 * r3 - r1)],
                [2 * (r1 * r3 - r2), 2 * (r2 * r3 + r1),
                 1 + r3 * r3 - r1 * r1 - r2 * r2],
            ], np.float32)
            return m / np.linalg.norm(m, axis=0, keepdims=True)

        return (cay(x_real[24:27]), cay(x_real[27:30]),
                x_real[18:21].astype(np.float32),
                x_real[21:24].astype(np.float32))

    def _post_from_support(self, view, n21, n31, num_steps, best_x_real,
                           counts):
        """Host tail of device scoring: best-pose selection + residuals.

        counts = (num_converged, num_infinity, num_real, n_cand), already
        sliced to the real hypothesis set by the caller."""
        n_edgels = view.edge_locations.shape[0]
        num_conv, num_inf, num_real, n_cand = counts
        stats = evl.SolutionStats(
            num_converged=num_conv, num_infinity=num_inf,
            num_real=num_real, num_paths=len(n21),
        )
        best21 = best31 = 0
        found = False
        pose_errors = None
        best_pose = None
        actual_steps = np.zeros(0, np.int32)
        if n_cand:
            bi = int(np.argmax(np.minimum(n21, n31)))
            best21, best31 = int(n21[bi]), int(n31[bi])
            ratio = self.cfg.ransac.pass_inlier_support_ratio
            found = (best21 >= ratio * n_edgels
                     and best31 >= ratio * n_edgels)
            best_pose = self._pose_np(best_x_real(bi))
            pose_errors = evl.measure_pose_error(
                *best_pose, view.gt_pose21, view.gt_pose31
            )
            actual = np.union1d(
                np.nonzero(n21 == n21.max())[0],
                np.nonzero(n31 == n31.max())[0],
            )
            actual_steps = num_steps[actual].astype(np.int32)
        return (stats, best21, best31, found, best_pose, pose_errors,
                actual_steps)

    # -- data ---------------------------------------------------------------
    def load_view(self, view_index: int) -> data_io.RansacView:
        return data_io.load_view(self.cfg, view_index)

    # -- one RANSAC round ---------------------------------------------------
    def run_round(
        self,
        view: data_io.RansacView,
        seed: int,
        num_hypotheses: Optional[int] = None,
        collect_solutions: bool = False,
    ) -> RoundResult:
        cfg = self.cfg
        H = num_hypotheses or cfg.ransac.num_iterations
        # Hypotheses pad up to the device count so every mesh shard owns
        # whole hypotheses (the reference's static per-GPU split,
        # GPU_HC_Solver.cpp:84-88); extras are real samples, sliced away
        # after tracking.
        Hp = -(-H // self._ndev) * self._ndev
        T = self.problem.num_tracks
        n_edgels = view.edge_locations.shape[0]

        samples = ransac.sample_edgel_triplets(seed, n_edgels, Hp)
        tgt = ransac.build_target_params(
            view.edge_locations, view.edge_tangents, samples
        )

        # Host sampling + H2D staging are outside the timed span, matching
        # the reference: Prepare_Target_Params and the data transfer are
        # separate phases and magma_wtime only brackets kernel launch+sync
        # (GPU_HC_Solver.cpp:335-362, :384-446).
        f32 = np.float32
        edgels_padded = _pad_to(
            view.edge_locations.astype(f32),
            _EDGEL_PAD * -(-n_edgels // _EDGEL_PAD),
            1e3,
        )

        if cfg.ransac.abort_by_good_sol:
            # TrunRANSAC chunking: hypotheses launch in chunks; once one
            # chunk reports a >=90%-support pose, the rest are skipped
            # entirely (the explicit form of the reference's serialised
            # late blocks seeing the abort flag, ...TrunRANSAC.cu:152).
            # Only the small per-chunk target planes are staged; the x312
            # path expansion happens on device (see _track_expand).
            chunk_h = min(cfg.ransac.abort_chunk, Hp)
            chunk_h = -(-chunk_h // self._ndev) * self._ndev
            n_chunks = -(-Hp // chunk_h)
            per = chunk_h * T
            x0r_c, x0i_c = self._staged_x0(chunk_h)
            diff = tgt - self.problem.start_params
            seg_dev = (jax.device_put(edgels_padded),
                       jax.device_put(self._intrinsics.astype(f32)),
                       np.float32(n_edgels))
            chunks = []
            for ci in range(n_chunks):
                lo, hi = ci * chunk_h, min((ci + 1) * chunk_h, Hp)
                sl = [tgt.real[lo:hi], tgt.imag[lo:hi],
                      diff.real[lo:hi], diff.imag[lo:hi]]
                if hi - lo < chunk_h:  # ragged tail: pad with first hyps
                    sl = [np.concatenate([a, a[: chunk_h - (hi - lo)]])
                          for a in sl]
                chunks.append([jax.device_put(a.astype(f32)) for a in sl])
            # Force staging completion with ONE round trip over all
            # chunks, so the timed span provably excludes H2D staging.
            np.asarray(self._fence(x0r_c, *[ch[0] for ch in chunks]))

            t_start = time.perf_counter()
            # Speculative pipeline: dispatch chunk i+1 before reading chunk
            # i's found flag, so the flag's d2h round trip overlaps the next
            # chunk's compute (dispatch is async; a hit wastes at most one
            # chunk of speculative work -- the reference wastes the same in
            # blocks already resident when its flag flips).
            t_track = None

            def launch(ci):
                return self._track_expand(
                    x0r_c, x0i_c, *chunks[ci], *seg_dev
                )

            outs, done_chunks = [], 0
            pending = launch(0)
            for ci in range(n_chunks):
                outs.append(pending)
                done_chunks += 1
                if ci + 1 < n_chunks:
                    nxt = launch(ci + 1)
                else:
                    nxt = None
                if bool(np.asarray(pending[6])):
                    break
                pending = nxt
            t_track = time.perf_counter()

            def cat_host(arrs, fill, dtype):
                done = np.concatenate(arrs, axis=0)[: done_chunks * per]
                if done.shape[0] < H * T:
                    pad_shape = (H * T - done.shape[0],) + done.shape[1:]
                    done = np.concatenate(
                        [done, np.full(pad_shape, fill, dtype)]
                    )
                return done[: H * T]  # ragged/device padding sliced away

            def cat(i, fill):
                return cat_host([np.asarray(o[i]) for o in outs], fill,
                                np.asarray(outs[0][i]).dtype)

            if not collect_solutions:
                # On-device scoring per dispatched chunk (skipped chunks
                # scored implicitly as no-candidates); outputs concatenate
                # ON DEVICE into one packed int32 array so the whole
                # result costs a single d2h round trip.
                scs = [
                    self._device_score(
                        o[0], o[1], o[2], o[3], seg_dev[0], seg_dev[1]
                    )
                    for o in outs
                ]
                packed = np.asarray(jnp.stack([
                    jnp.concatenate(
                        [o[idx].astype(jnp.int32) for o in outs]
                    ) if src == "o" else jnp.concatenate(
                        [sc[idx].astype(jnp.int32) for sc in scs]
                    )
                    for src, idx in (("o", 2), ("o", 3), ("sc", 0),
                                     ("sc", 1), ("sc", 2), ("sc", 3),
                                     ("o", 5))
                ]))
                rows = [cat_host([r], 0 if i < 6 else 0, np.int32)
                        for i, r in enumerate(packed)]
                conv_m, inf_m, real_m, cand_m = [
                    r.astype(bool) for r in rows[:4]
                ]
                n21, n31, num_steps = rows[4], rows[5], rows[6]
                n21 = np.where(cand_m, n21, -1)
                n31 = np.where(cand_m, n31, -1)
                counts = (int(conv_m.sum()), int(inf_m.sum()),
                          int(real_m.sum()), int(cand_m.sum()))

                def best_x_real(bi):
                    ci, off = divmod(bi, per)
                    return np.asarray(outs[ci][0][off])

                (stats, best21, best31, found, best_pose, pose_errors,
                 actual_steps) = self._post_from_support(
                    view, n21, n31, num_steps, best_x_real, counts,
                )
                t_end = time.perf_counter()
                return RoundResult(
                    stats=stats,
                    track_ms=(t_track - t_start) * 1e3,
                    total_ms=(t_end - t_start) * 1e3,
                    num_candidates=counts[3],
                    best_support21=best21,
                    best_support31=best31,
                    num_edgels=n_edgels,
                    found_pose=found,
                    pose_errors=pose_errors,
                    best_pose=best_pose,
                    num_steps=num_steps,
                    actual_sol_steps=actual_steps,
                )

            res = tracker.TrackResult(
                x=(cat(0, 0.0) + 1j * cat(1, 0.0)).astype(np.complex64),
                converged=cat(2, False),
                inf_fail=cat(3, False),
                pruned=cat(4, False),
                num_steps=cat(5, 0),
            )
        else:
            # Stage only the small (Hp, P+1) target planes; hypothesis
            # expansion happens on device (self._track_expand).
            x0r, x0i = self._staged_x0(Hp)
            small = [jax.device_put(a) for a in (
                tgt.real.astype(f32), tgt.imag.astype(f32),
                (tgt - self.problem.start_params).real.astype(f32),
                (tgt - self.problem.start_params).imag.astype(f32),
            )]
            seg_args = [jax.device_put(edgels_padded),
                        jax.device_put(self._intrinsics.astype(f32)),
                        np.float32(n_edgels)]
            np.asarray(self._fence(x0r, *small))  # staging fence

            t_start = time.perf_counter()
            out = self._track_expand(x0r, x0i, *small, *seg_args)
            if not collect_solutions:
                # On-device scoring: dispatch the scorer behind the
                # tracker, then fence; only support integers come back.
                sc = self._device_score(
                    out[0], out[1], out[2], out[3], seg_args[0], seg_args[1]
                )
                jax.block_until_ready(out)
                t_track = time.perf_counter()
                nHT = H * T
                packed = np.asarray(jnp.stack([
                    a.astype(jnp.int32)
                    for a in (out[2], out[3], sc[0], sc[1], sc[2], sc[3],
                              out[5])
                ]))[:, :nHT]
                conv_m, inf_m, real_m, cand_m = (
                    packed[0].astype(bool), packed[1].astype(bool),
                    packed[2].astype(bool), packed[3].astype(bool),
                )
                counts = (int(conv_m.sum()), int(inf_m.sum()),
                          int(real_m.sum()), int(cand_m.sum()))
                n21, n31, num_steps = packed[4], packed[5], packed[6]
                (stats, best21, best31, found, best_pose, pose_errors,
                 actual_steps) = self._post_from_support(
                    view, n21, n31, num_steps,
                    lambda bi: np.asarray(out[0][bi]), counts,
                )
                t_end = time.perf_counter()
                return RoundResult(
                    stats=stats,
                    track_ms=(t_track - t_start) * 1e3,
                    total_ms=(t_end - t_start) * 1e3,
                    num_candidates=counts[3],
                    best_support21=best21,
                    best_support31=best31,
                    num_edgels=n_edgels,
                    found_pose=found,
                    pose_errors=pose_errors,
                    best_pose=best_pose,
                    num_steps=num_steps,
                    actual_sol_steps=actual_steps,
                )
            jax.block_until_ready(out)
            t_track = time.perf_counter()

            xr, xi, conv, inf, pruned, steps = out[:6]
            res = tracker.TrackResult(
                x=(np.asarray(xr) + 1j * np.asarray(xi)).astype(
                    np.complex64
                )[: H * T],
                converged=np.asarray(conv)[: H * T],
                inf_fail=np.asarray(inf)[: H * T],
                pruned=np.asarray(pruned)[: H * T],
                num_steps=np.asarray(steps)[: H * T],
            )

        (stats, n_cand, best21, best31, found, best_pose,
         pose_errors, actual_steps, f21s, f31s, min_res,
         any_gt) = self._score_round(view, res)
        t_end = time.perf_counter()

        rr = RoundResult(
            stats=stats,
            track_ms=(t_track - t_start) * 1e3,
            total_ms=(t_end - t_start) * 1e3,
            num_candidates=n_cand,
            best_support21=best21,
            best_support31=best31,
            num_edgels=n_edgels,
            found_pose=found,
            pose_errors=pose_errors,
            best_pose=best_pose,
            num_steps=res.num_steps,
            actual_sol_steps=actual_steps,
            cand_f21=f21s,
            cand_f31=f31s,
            min_residuals=min_res,
            any_within_gt=any_gt,
        )
        if collect_solutions:
            rr.solutions = res  # type: ignore[attr-defined]
        return rr

    def _score_round(self, view: data_io.RansacView, res: tracker.TrackResult):
        """Candidate gating + inlier scoring + best-pose selection.

        Candidate gate (Evaluations.cpp:330-343): converged, rotation
        components real within IMAG_PART_TOL, all depths non-negative;
        then maximal joint support selection (Evaluations.cpp:382-504).
        """
        cfg = self.cfg
        n_edgels = view.edge_locations.shape[0]
        stats = evl.collect_stats(
            res.x, res.converged, res.inf_fail, cfg.ransac
        )
        cand = (
            res.converged
            & (np.abs(res.x[:, 24:30].imag)
               < cfg.ransac.imag_part_tol).all(axis=1)
            & (res.x[:, 0:8].real >= 0).all(axis=1)
        )
        cand_idx = np.nonzero(cand)[0]
        n_cand = int(cand_idx.size)
        best21 = best31 = 0
        found = False
        pose_errors = None
        best_pose = None
        actual_steps = np.zeros(0, np.int32)
        f21s = f31s = np.zeros((0, 3, 3), np.float32)
        min_residuals = None
        any_within_gt = False
        if n_cand:
            edgels = _pad_to(
                view.edge_locations,
                _EDGEL_PAD * -(-n_edgels // _EDGEL_PAD), 1e3,
            )
            xs_all = res.x[cand_idx].real.astype(np.float32)
            # Score in fixed-size chunks: the jit programs stay compiled
            # once (shape _CANDIDATE_CAP) while EVERY candidate is scored
            # -- an earlier cap silently dropped candidates beyond 512,
            # which TrunPaths-off ablation rounds can exceed by 20x.
            parts = [[] for _ in range(6)]  # r21 r31 t21 t31 n21 n31
            for lo in range(0, n_cand, _CANDIDATE_CAP):
                take = min(_CANDIDATE_CAP, n_cand - lo)
                xs = _pad_to(xs_all[lo:lo + _CANDIDATE_CAP], _CANDIDATE_CAP)
                r21c, r31c, t21c, t31c = map(np.asarray, self._pose_fn(xs))
                n21c, n31c = self._score_fn(
                    r21c, r31c, t21c, t31c, edgels, self._intrinsics
                )
                for lst, a in zip(parts, (r21c, r31c, t21c, t31c,
                                          np.asarray(n21c),
                                          np.asarray(n31c))):
                    lst.append(a[:take])
            r21, r31, t21, t31, n21, n31 = (
                np.concatenate(p) for p in parts
            )
            bi = int(np.argmax(np.minimum(n21, n31)))
            best21, best31 = int(n21[bi]), int(n31[bi])
            ratio = cfg.ransac.pass_inlier_support_ratio
            found = (best21 >= ratio * n_edgels
                     and best31 >= ratio * n_edgels)
            best_pose = (r21[bi], r31[bi], t21[bi], t31[bi])
            pose_errors = evl.measure_pose_error(
                r21[bi], r31[bi], t21[bi], t31[bi],
                view.gt_pose21, view.gt_pose31,
            )
            # Min residuals over ALL candidate poses + any-within-tol flag
            # (Evaluations.cpp:545-583, the success_flag the reference's
            # accuracy tables are built from).
            min_residuals, any_within_gt = evl.min_residuals_over_sols(
                r21, r31, t21, t31, view.gt_pose21, view.gt_pose31,
                cfg.ransac,
            )
            # "Actual solutions": candidates tying the maximal support on
            # either view pair (Evaluations.cpp:457-504 index vectors,
            # union at :512-515); their HC step counts feed the
            # *HC_Steps_of_Actual_Solutions.txt writer.
            actual = np.union1d(
                cand_idx[n21 == n21.max()], cand_idx[n31 == n31.max()]
            )
            actual_steps = res.num_steps[actual].astype(np.int32)
            # Host numpy: 3x3 work on the candidates (eager device ops
            # would cost one dispatch each).
            kinv = np.linalg.inv(self._intrinsics)

            def _fmats(r, t):
                sk = np.zeros((len(t), 3, 3), np.float32)
                sk[:, 0, 1], sk[:, 0, 2] = -t[:, 2], t[:, 1]
                sk[:, 1, 0], sk[:, 1, 2] = t[:, 2], -t[:, 0]
                sk[:, 2, 0], sk[:, 2, 1] = -t[:, 1], t[:, 0]
                return kinv.T @ (sk @ r) @ kinv

            f21s = _fmats(r21, t21)
            f31s = _fmats(r31, t31)
        return (stats, n_cand, best21, best31, found, best_pose,
                pose_errors, actual_steps, f21s, f31s, min_residuals,
                any_within_gt)

    def oracle_round(self, view: data_io.RansacView, seed: int,
                     num_hypotheses: int) -> RoundResult:
        """The same round through the plain oracle (ops/tracker.py): one
        while_loop over the full step budget with the elimination solve,
        then host scoring.  Runs on JAX's default device, so a
        ``jax.default_device`` context picks the device.  The result
        carries ``solutions`` (TrackResult)."""
        H = num_hypotheses
        T = self.problem.num_tracks
        samples = ransac.sample_edgel_triplets(
            seed, view.edge_locations.shape[0], H
        )
        tgt = np.repeat(ransac.build_target_params(
            view.edge_locations, view.edge_tangents, samples
        ), T, axis=0)
        x0 = np.tile(np.asarray(self.problem.start_sols), (H, 1))
        if self._oracle is None:
            self._oracle = tracker.make_track_fn(self.problem, self.cfg.hc)
        t_start = time.perf_counter()
        res = self._oracle(x0, tgt, tgt - self.problem.start_params)
        t_track = time.perf_counter()
        (stats, n_cand, best21, best31, found, best_pose, pose_errors,
         actual_steps, f21s, f31s, min_res, any_gt) = self._score_round(
            view, res)
        rr = RoundResult(
            stats=stats, track_ms=(t_track - t_start) * 1e3,
            total_ms=(time.perf_counter() - t_start) * 1e3,
            num_candidates=n_cand, best_support21=best21,
            best_support31=best31,
            num_edgels=view.edge_locations.shape[0], found_pose=found,
            pose_errors=pose_errors, best_pose=best_pose,
            num_steps=res.num_steps, actual_sol_steps=actual_steps,
            cand_f21=f21s, cand_f31=f31s, min_residuals=min_res,
            any_within_gt=any_gt,
        )
        rr.solutions = res  # type: ignore[attr-defined]
        return rr

    def _staged_x0(self, Hp: int):
        """Device-resident start-solution planes, staged once per H."""
        if self._x0_planes is None or self._x0_planes[0] != Hp:
            x0 = np.tile(np.asarray(self.problem.start_sols), (Hp, 1))
            self._x0_planes = (
                Hp,
                jax.device_put(x0.real.astype(np.float32)),
                jax.device_put(x0.imag.astype(np.float32)),
            )
        return self._x0_planes[1], self._x0_planes[2]

    def _run_stream_abort(self, view_indices, H: int, seed: int):
        """Streamed recovery with TrunRANSAC abort: chunk-granular pipeline.

        Serving analogue of run_round's abort path, restructured for
        throughput across a view STREAM: hypotheses dispatch in chunks
        (cfg.ransac.stream_abort_chunk, like ...TrunRANSAC.cu's serialized
        block waves) and the scheduler keeps two chunks in flight -- but unlike
        run_round, the speculative slot is filled CROSS-VIEW.  A view's
        later chunks are enqueued only after an earlier chunk's result has
        been read as a miss, so when chunk (v, c) hits, the in-flight
        speculative chunk is the NEXT view's work, not a doomed sibling:
        a hit wastes no device time at all (run_round's same-view
        speculation wastes up to one chunk per hit, which is the right
        trade for single-view latency but not for stream throughput).
        Each chunk additionally stops early on device at the first segment
        boundary holding a >=90%-support pose (ops/segmented.py).  Scoring
        + selection stay on device; one (39,) f32 vector per CHUNK crosses
        d2h, read only after the next dispatch is in flight.
        """
        cfg = self.cfg
        T = self.problem.num_tracks
        Hp = -(-H // self._ndev) * self._ndev
        chunk_h = min(cfg.ransac.stream_abort_chunk, Hp)
        chunk_h = -(-chunk_h // self._ndev) * self._ndev
        n_chunks = -(-Hp // chunk_h)
        x0r, x0i = self._staged_x0(chunk_h)
        k_dev = jax.device_put(self._intrinsics.astype(np.float32))
        f32 = np.float32
        ratio = cfg.ransac.pass_inlier_support_ratio
        selects = {}  # real paths in chunk -> jitted device select

        def real_h(ci: int) -> int:
            # Real (non-pad) hypotheses in chunk ci: device padding (Hp>H)
            # and the ragged-tail duplicates must not inflate statistics.
            return max(0, min(H - ci * chunk_h, chunk_h))

        nv = len(view_indices)
        views: list = [None] * nv
        prep: list = [None] * nv

        def prep_view(i: int):
            view = self.load_view(view_indices[i])
            views[i] = view
            n_e = view.edge_locations.shape[0]
            samples = ransac.sample_edgel_triplets(seed, n_e, Hp)
            tgt = ransac.build_target_params(
                view.edge_locations, view.edge_tangents, samples
            )
            diff = tgt - self.problem.start_params
            chs = []
            for ci in range(n_chunks):
                lo, hi = ci * chunk_h, min((ci + 1) * chunk_h, Hp)
                sl = [tgt.real[lo:hi], tgt.imag[lo:hi],
                      diff.real[lo:hi], diff.imag[lo:hi]]
                if hi - lo < chunk_h:  # ragged tail: pad with first hyps
                    sl = [np.concatenate([a, a[: chunk_h - (hi - lo)]])
                          for a in sl]
                chs.append([jax.device_put(a.astype(f32)) for a in sl])
            edg = jax.device_put(_pad_to(
                view.edge_locations.astype(f32),
                _EDGEL_PAD * -(-n_e // _EDGEL_PAD), 1e3,
            ))
            prep[i] = (chs, edg, np.float32(n_e))

        def dispatch(i: int, ci: int):
            chs, edg, ne = prep[i]
            out = self._track_expand(x0r, x0i, *chs[ci], edg, k_dev, ne)
            sc = self._device_score(out[0], out[1], out[2], out[3],
                                    edg, k_dev)
            n = real_h(ci) * T
            if n not in selects:
                selects[n] = self._build_device_select(n)
            return selects[n](out[0], out[2], out[3], sc[0], sc[1],
                              sc[2], sc[3], out[5])

        # Warm the chunk-shaped programs outside the timed span (the
        # full-round warmup compiles the round shapes, not these).
        # dispatch(0, 0) warms the track/score programs and the
        # full-chunk select; a ragged tail (H % chunk_h != 0) has its
        # OWN select shape, which would otherwise compile mid-stream on
        # the first chunk-exhausted view -- a multi-second stall inside
        # the timed span.
        prep_view(0)
        np.asarray(dispatch(0, 0))
        if real_h(n_chunks - 1) * T not in selects and real_h(n_chunks - 1) > 0:
            np.asarray(dispatch(0, n_chunks - 1))

        queue = deque((i, 0) for i in range(nv))
        inflight: deque = deque()
        sums = np.zeros((nv, 4), np.int64)      # conv / inf / real / cand
        best = [None] * nv                       # best chunk sel per view
        decided = [False] * nv
        t_first = [0.0] * nv
        t_done = [0.0] * nv

        t0 = time.perf_counter()

        def pump():
            while len(inflight) < 2 and queue:
                i, ci = queue.popleft()
                if decided[i]:
                    continue
                if prep[i] is None:
                    prep_view(i)
                if ci == 0:
                    t_first[i] = time.perf_counter()
                inflight.append((i, ci, dispatch(i, ci)))

        pump()
        while inflight:
            i, ci, sel_dev = inflight.popleft()
            pump()  # next dispatch rides the device while we block on d2h
            sel = np.asarray(sel_dev)  # the chunk's ONLY d2h: 156 bytes
            sums[i] += sel[:4].astype(np.int64)
            if best[i] is None or (min(sel[4], sel[5])
                                   > min(best[i][4], best[i][5])):
                best[i] = sel
            n_e = views[i].edge_locations.shape[0]
            hit = (sel[3] > 0 and sel[4] >= ratio * n_e
                   and sel[5] >= ratio * n_e)
            if hit or ci + 1 >= n_chunks or real_h(ci + 1) == 0:
                decided[i] = True
                t_done[i] = time.perf_counter()
            else:
                # Missed: the view's next chunk goes to the FRONT so its
                # latency stays close to run_round's; throughput is
                # unaffected (the device never idles either way).
                queue.appendleft((i, ci + 1))
            pump()

        results = []
        for i in range(nv):
            view = views[i]
            n_e = view.edge_locations.shape[0]
            sel = best[i]
            # num_paths = the full H*T workload, matching run_round's abort
            # path (and the reference: skipped blocks count as
            # unconverged); the conv/inf/real sums cover dispatched
            # chunks only.
            stats = evl.SolutionStats(
                num_converged=int(sums[i][0]), num_infinity=int(sums[i][1]),
                num_real=int(sums[i][2]), num_paths=H * T,
            )
            n_cand = int(sums[i][3])
            b21 = b31 = 0
            found = False
            pose = perr = None
            actual_steps = np.zeros(0, np.int32)
            if n_cand and sel is not None and sel[3] > 0:
                b21, b31 = int(sel[4]), int(sel[5])
                found = b21 >= ratio * n_e and b31 >= ratio * n_e
                pose = self._pose_np(sel[9:39])
                perr = evl.measure_pose_error(
                    *pose, view.gt_pose21, view.gt_pose31
                )
                actual_steps = np.array([int(sel[6])], np.int32)
            results.append(RoundResult(
                stats=stats,
                track_ms=(t_done[i] - t_first[i]) * 1e3,
                total_ms=(t_done[i] - t_first[i]) * 1e3,
                num_candidates=n_cand, best_support21=b21,
                best_support31=b31, num_edgels=n_e,
                found_pose=found, pose_errors=perr, best_pose=pose,
                num_steps=np.zeros(0, np.int32),
                actual_sol_steps=actual_steps,
            ))
        total_s = time.perf_counter() - t0
        return results, nv / total_s

    def run_stream(self, view_indices, num_hypotheses: Optional[int] = None,
                   seed: int = 0):
        """Streamed tracking-loss recovery over a sequence of views.

        The production serving loop: while the device tracks view i, the
        host loads + samples + stages view i+1 and dispatches it behind the
        current work, then scores view i -- host prep and d2h of one view
        overlap device tracking of the next.  Scoring AND best-pose
        selection run on device (_build_device_select): one (39,) f32
        vector (156 bytes) crosses the link per view.  Per-path step
        counts therefore stay on device; RoundResult.num_steps is empty
        in stream mode (the step writers are a CLI-round feature).
        Returns (results, views/s).  (The reference processes views
        strictly serially, cmd/magmaHC-main.cpp:24-75.)

        With TrunRANSAC abort enabled (cfg.ransac.abort_by_good_sol), the
        stream switches to the chunk-granular abort pipeline
        (_run_stream_abort): hypothesis chunks + device-side early stop +
        cross-view speculation.
        """
        cfg = self.cfg
        H = num_hypotheses or cfg.ransac.num_iterations
        if cfg.ransac.abort_by_good_sol:
            return self._run_stream_abort(view_indices, H, seed)
        T = self.problem.num_tracks
        views = [self.load_view(vi) for vi in view_indices[:1]]

        k_dev = jax.device_put(self._intrinsics.astype(np.float32))

        Hp = -(-H // self._ndev) * self._ndev
        x0r, x0i = self._staged_x0(Hp)
        select = self._build_device_select(H * T)

        def dispatch(view, s):
            n_e = view.edge_locations.shape[0]
            samples = ransac.sample_edgel_triplets(s, n_e, Hp)
            tgt = ransac.build_target_params(
                view.edge_locations, view.edge_tangents, samples
            )
            diff = tgt - self.problem.start_params
            f32 = np.float32
            small = [jax.device_put(a) for a in (
                tgt.real.astype(f32), tgt.imag.astype(f32),
                diff.real.astype(f32), diff.imag.astype(f32),
            )]
            edg0 = jax.device_put(_pad_to(
                view.edge_locations.astype(f32),
                _EDGEL_PAD * -(-n_e // _EDGEL_PAD), 1e3,
            ))
            out = self._track_expand(
                x0r, x0i, *small, edg0, k_dev, np.float32(n_e)
            )
            # Chain the on-device scorer behind the tracker so only
            # support integers cross the d2h link per view.
            sc = self._device_score(
                out[0], out[1], out[2], out[3], edg0, k_dev
            )
            sel = select(out[0], out[2], out[3], sc[0], sc[1], sc[2],
                         sc[3], out[5])
            return sel, time.perf_counter()

        t0 = time.perf_counter()
        results = []
        pending, t_disp = dispatch(views[0], seed)
        for i, vi in enumerate(view_indices):
            view = views[i]
            if i + 1 < len(view_indices):
                views.append(self.load_view(view_indices[i + 1]))
                nxt = dispatch(views[i + 1], seed)
            else:
                nxt = None
            sel = np.asarray(pending)  # the view's ONLY d2h: 156 bytes
            t_done = time.perf_counter()
            n_edgels = view.edge_locations.shape[0]
            stats = evl.SolutionStats(
                num_converged=int(sel[0]), num_infinity=int(sel[1]),
                num_real=int(sel[2]), num_paths=H * T,
            )
            n_cand = int(sel[3])
            b21, b31 = int(sel[4]), int(sel[5])
            found = False
            pose = perr = None
            actual_steps = np.zeros(0, np.int32)
            if n_cand:
                ratio = cfg.ransac.pass_inlier_support_ratio
                found = (b21 >= ratio * n_edgels
                         and b31 >= ratio * n_edgels)
                pose = self._pose_np(sel[9:39])
                perr = evl.measure_pose_error(
                    *pose, view.gt_pose21, view.gt_pose31
                )
                actual_steps = np.array([int(sel[6])], np.int32)
            else:
                b21 = b31 = 0
            # Pipeline latency of this view: dispatch -> results on host
            # (overlaps the next view's tracking by design).
            view_ms = (t_done - t_disp) * 1e3
            results.append(RoundResult(
                stats=stats, track_ms=view_ms,
                total_ms=(time.perf_counter() - t_disp) * 1e3,
                num_candidates=n_cand, best_support21=b21,
                best_support31=b31,
                num_edgels=n_edgels,
                found_pose=found, pose_errors=perr, best_pose=pose,
                num_steps=np.zeros(0, np.int32),
                actual_sol_steps=actual_steps,
            ))
            if nxt is not None:
                pending, t_disp = nxt
        total_s = time.perf_counter() - t0
        return results, len(view_indices) / total_s

    def warmup(self, num_hypotheses: Optional[int] = None) -> None:
        """Compile the tracking/scoring programs on a tiny synthetic round."""
        view = self.load_view(0)
        self.run_round(view, seed=0, num_hypotheses=num_hypotheses)
