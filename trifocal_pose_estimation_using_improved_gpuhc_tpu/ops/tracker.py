"""Batched homotopy-continuation path tracker (RK4 predictor + Newton corrector).

Data-parallel re-design of the reference HC kernel
(gpu-kernels/kernel_GPUHC_trifocal_2op1p_30x30_PH_CodeOpt_TrunPaths.cu:66-290).
The reference runs one CUDA warp per path with divergent per-path control
flow; here ALL paths (num_tracks x num_hypotheses) advance together through a
single masked ``lax.while_loop`` -- per-path adaptive state (t, delta_t,
success counters, prune/convergence flags) lives in vectors, and every branch
of the reference's control flow becomes a ``jnp.where``.

Step semantics replicated exactly:

* RK4 predictor with the reference's t-advance order: eval at t, t + dt/2
  (twice), then (t + dt/2) + dt/2; the kernel's "Loopy Runge-Kutta" bit-shift
  accumulation (...TrunPaths.cu:170-207) is algebraically the classic
  x + dt/6 (k1 + 2 k2 + 2 k3 + k4), which is what we compute.
* Newton corrector, <= max_correction_steps iterations, success when
  ||dx||^2 < 1e-6 ||x||^2, infinity-fail when ||x||^2 > 1e14 (:216-250).
* Adaptive dt: halve + rollback to last success on corrector failure; double
  after steps_to_increase_delta_t consecutive successes (:257-275).
* End-zone clamping: dt <= |1 - t| inside |1 - t| <= 0.0500001, else
  dt <= |0.95 - t| so every path lands exactly on t = 0.95 (:157-162).
* TrunPaths depth-sign pruning: a path that has never shown all-positive
  depth real parts (x[0:8]) at some t > 0 is truncated once t > 0.95
  (:149-154).

Convergence: t >= 1 or 1 - t <= 1e-7 (:283).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import linalg
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import HCConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrackerState:
    """Per-path tracker state (all leading dim B = paths)."""

    x: jnp.ndarray            # (B, V) complex64 current solution (s_track)
    x_last: jnp.ndarray       # (B, V) last successful solution
    t: jnp.ndarray            # (B,) float32
    dt: jnp.ndarray           # (B,) float32
    succ_count: jnp.ndarray   # (B,) int32 consecutive corrector successes
    end_zone: jnp.ndarray     # (B,) bool
    check_depths: jnp.ndarray  # (B,) bool -- still watching for all-positive depths
    inf_fail: jnp.ndarray     # (B,) bool
    pruned: jnp.ndarray       # (B,) bool (TrunPaths truncation)
    num_steps: jnp.ndarray    # (B,) int32 HC steps consumed while active
    step: jnp.ndarray         # () int32 global step counter


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrackResult:
    x: jnp.ndarray           # (B, V) complex64 final solutions
    converged: jnp.ndarray   # (B,) bool
    inf_fail: jnp.ndarray    # (B,) bool
    pruned: jnp.ndarray      # (B,) bool
    num_steps: jnp.ndarray   # (B,) int32


def init_state(x0: jnp.ndarray, cfg: HCConfig) -> TrackerState:
    B = x0.shape[0]
    # Real dtype follows the solution dtype: f32 for the production
    # complex64 path, f64 under the float64 oracle (tools/f64_reconcile.py).
    f32 = jnp.float64 if x0.dtype == jnp.complex128 else jnp.float32
    return TrackerState(
        x=x0,
        x_last=x0,
        t=jnp.zeros((B,), f32),
        dt=jnp.full((B,), cfg.init_delta_t, f32),
        succ_count=jnp.zeros((B,), jnp.int32),
        end_zone=jnp.zeros((B,), bool),
        check_depths=jnp.full((B,), cfg.truncate_paths, bool),
        inf_fail=jnp.zeros((B,), bool),
        pruned=jnp.zeros((B,), bool),
        num_steps=jnp.zeros((B,), jnp.int32),
        step=jnp.zeros((), jnp.int32),
    )


def _is_converged(t: jnp.ndarray, cfg: HCConfig) -> jnp.ndarray:
    return (t >= 1.0) | (1.0 - t <= cfg.t_converged_eps)


def _active(s: TrackerState, cfg: HCConfig) -> jnp.ndarray:
    return ~_is_converged(s.t, cfg) & ~s.inf_fail & ~s.pruned


def make_step_fn(
    problem: TrifocalProblem,
    cfg: HCConfig,
    dynamic_start: bool = False,
) -> Callable[[TrackerState, jnp.ndarray, jnp.ndarray], TrackerState]:
    """Build one masked HC step over the whole path batch.

    target_params / diff_params: (B, P+1) complex64 per path.
    dynamic_start: derive each path's start system as target - diff
    (monodromy legs) instead of the problem's static start parameters.
    """
    solve = linalg.solve

    def evaluate(x, t, target_params, diff_params, need_h, need_ht):
        start = (
            target_params - diff_params if dynamic_start
            else problem.start_params
        )
        p = ev.param_homotopy(t, start, target_params)
        return ev.eval_all_factored(
            problem, x, p, diff_params, need_h=need_h, need_ht=need_ht
        )

    cph = bool(cfg.predictor_handoff)

    def step_fn(
        s: TrackerState, target_params: jnp.ndarray, diff_params: jnp.ndarray,
        extras=None,
    ):
        """One masked HC step.  With cfg.predictor_handoff, ``extras`` is
        (hx_save (B, n, n), hov ()) -- the corrector factorization saved by
        the previous step and whether EVERY lane advanced (the kernel's
        tile-granular condition, applied batch-wide here) -- and the
        return value is (state', extras')."""
        active = _active(s, cfg)

        # --- end-zone flag (...TrunPaths.cu:147) ---
        end_zone = s.end_zone | (jnp.abs(1.0 - s.t) <= cfg.end_zone_factor)

        # --- TrunPaths depth-sign pruning (:149-154) ---
        if cfg.truncate_paths:
            depths_ok = jnp.all(jnp.real(s.x[:, 0:8]) > 0, axis=-1)
            check = jnp.where(
                s.check_depths & (s.t > 0), ~depths_ok, s.check_depths
            )
            pruned = s.pruned | (active & (s.t > 0.95) & check)
        else:
            check = s.check_depths
            pruned = s.pruned
        active = active & ~pruned

        # --- dt clamping (:157-162) ---
        dt = jnp.where(
            end_zone,
            jnp.minimum(s.dt, jnp.abs(1.0 - s.t)),
            jnp.minimum(s.dt, jnp.abs(0.95 - s.t)),
        )

        # --- RK4 predictor (:170-211) ---
        x0 = s.x
        half = 0.5 * dt
        dtc = dt.astype(x0.dtype)[:, None]
        halfc = half.astype(x0.dtype)[:, None]

        t_a = s.t
        hx, _, mht = evaluate(x0, t_a, target_params, diff_params, False, True)
        if cph:
            # (CPH, HCConfig.predictor_handoff) stage 1 reuses the previous
            # step's corrector factorization when every lane advanced; the
            # kernel replays the saved factorization on the fresh -Ht rhs,
            # the oracle equivalently solves against the saved Hx matrix.
            hx_save, hov = extras
            hx = jnp.where(hov, hx_save, hx)
        k1 = solve(hx, mht)
        t_b = t_a + half
        t_c = t_b + half
        x_b = x0 + halfc * k1
        hx, _, mht = evaluate(x_b, t_b, target_params, diff_params, False, True)
        k2 = solve(hx, mht)
        if cfg.predictor == "rk2":
            # Midpoint method: one evaluate+solve fewer than RK3.
            x_pred = x0 + dtc * k2
        elif cfg.predictor == "rk3":
            # Kutta's third-order rule (see HCConfig.predictor).
            x_e = x0 - dtc * k1 + 2.0 * dtc * k2
            hx, _, mht = evaluate(
                x_e, t_c, target_params, diff_params, False, True
            )
            k3 = solve(hx, mht)
            x_pred = x0 + dtc / 6.0 * (k1 + 4.0 * k2 + k3)
        else:
            x_c = x0 + halfc * k2
            hx, _, mht = evaluate(
                x_c, t_b, target_params, diff_params, False, True
            )
            k3 = solve(hx, mht)
            x_d = x0 + dtc * k3
            hx, _, mht = evaluate(
                x_d, t_c, target_params, diff_params, False, True
            )
            k4 = solve(hx, mht)
            x_pred = x0 + dtc / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

        # --- Newton corrector (:216-250), param homotopy frozen at t_c ---
        start = (
            target_params - diff_params if dynamic_start
            else problem.start_params
        )
        p_corr = ev.param_homotopy(t_c, start, target_params)

        cjr = int(cfg.corrector_jacobian_reuse)
        track_hx = bool(cjr) or cph

        def corr_body(i, carry):
            # The Hx carry exists only under CJR/CPH: a dead (B, n, n) loop
            # carry is real memory traffic on the CPU tracker otherwise.
            if track_hx:
                x, success, inf, done, hx0 = carry
            else:
                x, success, inf, done = carry
            hx, h, _ = ev.eval_all_factored(
                problem, x, p_corr, diff_params, need_h=True, need_ht=False
            )
            if cjr:
                # Modified Newton (strategy CJR, HCConfig): freeze Hx
                # after the k-th full corrector iterate -- the same map
                # as the fused kernel's saved-factorization replay
                # (ops/fused._resolve_rhs / _reduce_resolve_rhs).
                hx = jnp.where(i < cjr, hx, hx0)
            dx = solve(hx, h)
            x_new = jnp.where(done[:, None], x, x - dx)
            sq_dx = jnp.sum(
                jnp.real(dx) ** 2 + jnp.imag(dx) ** 2, axis=-1
            )
            sq_x = jnp.sum(
                jnp.real(x_new) ** 2 + jnp.imag(x_new) ** 2, axis=-1
            )
            succ_i = sq_dx < cfg.corrector_tol_sq * sq_x
            inf_i = sq_x > cfg.infinity_norm_sq
            success = jnp.where(done, success, succ_i)
            inf = jnp.where(done, inf, inf_i)
            done = done | success | inf
            out = (x_new, success, inf, done)
            return out + (hx,) if track_hx else out

        nv = x0.shape[1]
        flags0 = (
            jnp.zeros(x0.shape[:1], bool),
            jnp.zeros(x0.shape[:1], bool),
            jnp.zeros(x0.shape[:1], bool),
        )
        carry0 = (x_pred,) + flags0 + (
            (jnp.zeros((x0.shape[0], nv, nv), x0.dtype),) if track_hx else ()
        )
        corr_out = jax.lax.fori_loop(
            0, cfg.max_correction_steps, corr_body, carry0
        )
        x_corr, success, inf_now = corr_out[:3]

        # --- outcome bookkeeping (:252-276) ---
        inf_fail = s.inf_fail | (active & inf_now)
        ok = active & ~inf_now
        fail = ok & ~success
        good = ok & success

        new_x = jnp.where(
            good[:, None], x_corr, jnp.where(fail[:, None], s.x_last, s.x)
        )
        # Infinity-failed paths keep their current (diverged) solution, like
        # d_track[tx] = s_track[tx] at kernel exit.
        new_x = jnp.where((active & inf_now)[:, None], x_corr, new_x)
        new_x_last = jnp.where(good[:, None], x_corr, s.x_last)
        new_t = jnp.where(good | (active & inf_now), t_c, s.t)
        succ_count = jnp.where(
            good, s.succ_count + 1, jnp.where(fail, 0, s.succ_count)
        )
        bump = good & (succ_count >= cfg.steps_to_increase_delta_t)
        new_dt = jnp.where(fail, dt * 0.5, jnp.where(bump, dt * 2.0, dt))
        new_dt = jnp.where(active, new_dt, s.dt)
        succ_count = jnp.where(bump, 0, succ_count)

        new_s = TrackerState(
            x=new_x,
            x_last=new_x_last,
            t=new_t,
            dt=new_dt,
            succ_count=jnp.where(active, succ_count, s.succ_count),
            end_zone=end_zone,
            check_depths=check,
            inf_fail=inf_fail,
            pruned=pruned,
            num_steps=s.num_steps + active.astype(jnp.int32),
            step=s.step + 1,
        )
        if cph:
            # Handoff validity: NO lane rolled back this step (the kernel's
            # tile-wide max(failf) == 0; infinity-failed lanes go inactive
            # and do not block).  The saved Hx is the last corrector
            # iteration's evaluation point -- lanes done earlier keep x
            # frozen, so their entry equals the factorization at their
            # final x exactly, matching the kernel's last-executed save.
            return new_s, (corr_out[4], ~jnp.any(fail))
        return new_s

    return step_fn


def init_extras(x0: jnp.ndarray, cfg: HCConfig):
    """Loop-carried predictor-handoff state (HCConfig.predictor_handoff):
    the saved corrector Jacobian and whether every path advanced; () when
    the option is off."""
    if not cfg.predictor_handoff:
        return ()
    nv = x0.shape[1]
    return (jnp.zeros((x0.shape[0], nv, nv), x0.dtype), jnp.zeros((), bool))


def make_segment_fn(problem: TrifocalProblem, cfg: HCConfig,
                    dynamic_start: bool = False):
    """Build ``run(s, extras, tgt, diff, n) -> (s, extras)``: at most ``n``
    masked HC steps over the whole batch, stopping early once no path is
    active.  Steps on inactive paths change nothing, so splitting a track
    into segments (ops/segmented.py) leaves every per-path result as it
    is."""
    step_fn = make_step_fn(problem, cfg, dynamic_start=dynamic_start)

    def run(s: TrackerState, extras, target_params, diff_params, n):
        def cond(c):
            return (c[0] < n) & jnp.any(_active(c[1], cfg))

        def body(c):
            i, s, ex = c
            if cfg.predictor_handoff:
                s, ex = step_fn(s, target_params, diff_params, ex)
            else:
                s = step_fn(s, target_params, diff_params)
            return i + 1, s, ex

        _, s, extras = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), s, extras)
        )
        return s, extras

    return run


def make_track_fn(problem: TrifocalProblem, cfg: HCConfig,
                  dynamic_start: bool = False, dtype=np.float32):
    """Build the jitted path-tracking function for a problem: the plain
    oracle, one masked while_loop over the full step budget.

    Returned fn(x0 (B, V) c64, target_params (B, P+1), diff_params (B, P+1))
    -> TrackResult (host numpy). Equivalent of one kernel_GPUHC_... launch
    over B = tracks x hypotheses.  ``track.jitted`` takes and returns
    float32 real/imag planes.
    """
    run = make_segment_fn(problem, cfg, dynamic_start=dynamic_start)

    @jax.jit
    def _track_planes(x0_re, x0_im, tgt_re, tgt_im, diff_re, diff_im):
        x0 = jax.lax.complex(x0_re, x0_im)
        target_params = jax.lax.complex(tgt_re, tgt_im)
        diff_params = jax.lax.complex(diff_re, diff_im)
        s, _ = run(init_state(x0, cfg), init_extras(x0, cfg), target_params,
                   diff_params, cfg.max_steps + 1)
        return result_planes(s, cfg)

    def track(x0, target_params, diff_params) -> TrackResult:
        x0 = np.asarray(x0)
        tgt = np.asarray(target_params)
        diff = np.asarray(diff_params)
        f32 = dtype
        xr, xi, conv, inf, pruned, steps = _track_planes(
            x0.real.astype(f32),
            x0.imag.astype(f32),
            tgt.real.astype(f32),
            tgt.imag.astype(f32),
            diff.real.astype(f32),
            diff.imag.astype(f32),
        )
        x = np.asarray(xr) + 1j * np.asarray(xi)
        return TrackResult(
            x=x.astype(np.complex128 if dtype == np.float64 else np.complex64),
            converged=np.asarray(conv),
            inf_fail=np.asarray(inf),
            pruned=np.asarray(pruned),
            num_steps=np.asarray(steps),
        )

    track.jitted = _track_planes
    return track


def result_planes(s: TrackerState, cfg: HCConfig):
    """(x real, x imag, converged, inf_fail, pruned, num_steps).

    Parity note: the reference sets the converge flag from t alone
    (...TrunPaths.cu:283), independently of the infinity flag."""
    return (jnp.real(s.x), jnp.imag(s.x), _is_converged(s.t, cfg),
            s.inf_fail, s.pruned, s.num_steps)
