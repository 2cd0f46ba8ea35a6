#!/usr/bin/env python
"""Statistical reconciliation against the reference's committed sample run.

Reproduces the reference's EXACT workload -- view 0, srand(0) glibc
sampling with its duplicate-check quirk, 100 hypotheses x 312 paths -- and
compares our tracker's converged / real / infinity counts to the committed
outputs (note both reference writers swap the real and infinity columns at
collection time, GPU_HC_Solver.cpp:522-524 / CPU_HC_Solver.cpp:261-263, so
the files read as [converged, real, infinity]):

  GPU_Sols_Statistics.txt: 272 / 5 / 495      (TrunPaths GPU kernel)
  CPU_Sols_Statistics.txt: 11098 / 521 / 6577 (CPU solver, NO TrunPaths)

Needs the reference's data tree (--data-root): the comparison targets are
its committed outputs on its own dataset.

Usage: PYTHONPATH=. python tools/reconcile_stats.py --data-root DIR [--platform cpu]
"""

import argparse
import dataclasses

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=[None, "cpu"])
    ap.add_argument("--data-root", required=True,
                    help="reference-layout tree (problems/, RANSAC_Data/)")
    ap.add_argument("--hypotheses", type=int, default=100)
    args = ap.parse_args()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        evaluation as evl,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
    )

    H = args.hypotheses
    for trun in (False, True):
        cfg = EngineConfig(data_root=args.data_root)
        cfg = dataclasses.replace(
            cfg, hc=dataclasses.replace(cfg.hc, truncate_paths=trun)
        )
        eng = TrifocalPoseEngine(cfg)
        view = eng.load_view(0)
        T = eng.problem.num_tracks
        n_edgels = view.edge_locations.shape[0]
        samples = ransac.sample_edgel_triplets_reference(0, n_edgels, H)
        tgt = ransac.build_target_params(
            view.edge_locations, view.edge_tangents, samples
        )
        tgt_b = np.repeat(tgt, T, axis=0)
        diff_b = tgt_b - eng.problem.start_params
        x0 = np.tile(np.asarray(eng.problem.start_sols), (H, 1))
        res = eng.track(x0, tgt_b, diff_b).track
        stats = evl.collect_stats(
            res.x, res.converged, res.inf_fail, cfg.ransac
        )
        which = "TrunPaths ON (GPU kernel mode) " if trun else \
                "TrunPaths OFF (CPU solver mode)"
        refv = "272 / 5 / 495" if trun else "11098 / 521 / 6577"
        print(f"{which}: conv {stats.num_converged} real {stats.num_real} "
              f"inf {stats.num_infinity} pruned {int(res.pruned.sum())} "
              f"of {H * T} steps {int(res.num_steps.sum())}   "
              f"[reference sample: {refv}]")
        # Residue diagnostics for the 31-vs-521 "real"-count question
        # (tools/f64_reconcile.py found the f32 ORACLE counts 659 real
        # at the 1e-4 cliff -- in line with the reference CPU's 521 --
        # so any deficit here is kernel numerics, not the cliff itself):
        # where do this tracker's converged solutions sit vs the cliff?
        conv = np.asarray(res.converged).astype(bool)
        mi = np.abs(np.asarray(res.x).imag).max(axis=-1)
        tols = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2)
        counts = {t: int((conv & (mi <= t)).sum()) for t in tols}
        print(f"  real-count by imag tol: {counts}")
        # A handful of converged-flag paths hold non-finite coordinates
        # (diverged then t-converged paths) -- drop them and say so.
        vals = mi[conv]
        finite = vals[np.isfinite(vals)]
        if finite.size:
            q = np.percentile(finite, [10, 25, 50, 75, 90])
            print(f"  max|imag| over converged ({finite.size} finite of "
                  f"{vals.size}), p10/25/50/75/90: "
                  + " ".join(f"{v:.3g}" for v in q))


if __name__ == "__main__":
    main()
