#!/usr/bin/env python
"""Float64 oracle experiment: how float32 rounding moves the statistics.

A solution is "real" when every |imag(x_v)| <= 1e-4 after convergence
(Evaluations.cpp:152-166, ZERO_IMAG_PART_TOL_FOR_SP) -- a cliff that f32
rounding noise can straddle.  This tool tracks the IDENTICAL workload (view
0, the reference's glibc srand(0) sampling, TrunPaths off) through the
plain oracle tracker at float32 and float64 (jax x64, CPU backend; partial
pivoting like LAPACK cgesv), then reports:

  * converged / infinity counts per precision,
  * the "real" count under a tolerance sweep (1e-5 .. 1e-2),
  * quantiles of max|imag| over converged solutions (how close the
    population sits to the 1e-4 cliff),
  * f32-vs-f64 endpoint agreement and real-status flips.

The bracketed reference figures apply only to the reference's own dataset
(--data-root).

Usage: PYTHONPATH=. python tools/f64_reconcile.py [--hypotheses 100] [--chunk 10]
           [--data-root DIR]
"""

import argparse
import dataclasses
import time

import numpy as np

TOLS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2)


def real_counts(x, conv, tols=TOLS):
    mi = np.abs(x.imag).max(axis=-1)
    return {t: int((conv & (mi <= t)).sum()) for t in tols}


def q(v, ps=(10, 50, 90, 99)):
    return {p: float(np.percentile(v, p)) for p in ps} if v.size else {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--data-root", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
        ransac,
        tracker,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
    )

    cfg = EngineConfig(data_root=args.data_root)
    cfg = dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, truncate_paths=False)
    )
    eng = TrifocalPoseEngine(cfg)
    view = eng.load_view(0)
    problem = eng.problem
    T = problem.num_tracks
    H = args.hypotheses
    n_edgels = view.edge_locations.shape[0]
    samples = ransac.sample_edgel_triplets_reference(0, n_edgels, H)
    tgt = ransac.build_target_params(
        view.edge_locations, view.edge_tangents, samples
    )

    results = {}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        track = tracker.make_track_fn(problem, cfg.hc, dtype=dtype)
        xs, convs, infs = [], [], []
        t0 = time.time()
        for h0 in range(0, H, args.chunk):
            hs = slice(h0, min(h0 + args.chunk, H))
            tgt_b = np.repeat(tgt[hs], T, axis=0)
            diff_b = tgt_b - problem.start_params
            x0 = np.tile(np.asarray(problem.start_sols),
                         (tgt[hs].shape[0], 1))
            res = track(x0, tgt_b, diff_b)
            xs.append(res.x)
            convs.append(res.converged)
            infs.append(res.inf_fail)
            print(f"{name}: hypotheses {h0}..{hs.stop} done "
                  f"({time.time() - t0:.0f}s)", flush=True)
        x = np.concatenate(xs)
        conv = np.concatenate(convs)
        inf = np.concatenate(infs)
        results[name] = (x, conv, inf)
        mi = np.abs(x.imag).max(axis=-1)[conv]
        print(f"\n== {name}: conv {int(conv.sum())} inf {int(inf.sum())} "
              f"of {H * T}  [reference CPU sample: 11098 conv / 6577 inf]")
        print(f"   real count by tol: {real_counts(x, conv)} "
              f"[reference CPU at 1e-4: 521]")
        print(f"   max|imag| over converged, percentiles: {q(mi)}\n",
              flush=True)

    x32, c32, _ = results["f32"]
    x64, c64, _ = results["f64"]
    both = c32 & c64
    d = np.abs(x32[both] - x64[both]).max(axis=-1)
    print(f"== f32 vs f64: both-converged {int(both.sum())}; "
          f"endpoint |x32-x64| percentiles {q(d)}")
    r32 = np.abs(x32.imag).max(axis=-1) <= 1e-4
    r64 = np.abs(x64.imag).max(axis=-1) <= 1e-4
    print(f"   real@1e-4 flips among both-converged: "
          f"f32-only {int((both & r32 & ~r64).sum())}, "
          f"f64-only {int((both & ~r32 & r64).sum())}, "
          f"agree-real {int((both & r32 & r64).sum())}")


if __name__ == "__main__":
    main()
