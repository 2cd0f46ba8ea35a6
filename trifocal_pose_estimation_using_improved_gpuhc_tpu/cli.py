"""CLI driver: run HC path tracking (and optionally the CPU-HC cross-check)
over RANSAC rounds and write the reference-format output files.

Equivalent of cmd/magmaHC-main.cpp: `-p/--problem` selects the problem folder,
each round runs NUM_OF_RANSAC_ITERATIONS hypotheses, and the driver reports
avg/max/min/sigma wall-clock plus solution statistics
(cmd/magmaHC-main.cpp:24-116,124-195).

Usage:
  python -m trifocal_pose_estimation_using_improved_gpuhc_tpu.cli \
      -p trifocal_2op1p_30x30 [--views 1] [--hypotheses 100] [--times 1] \
      [--platform gpu|cpu] [--cross-check]

Without --data-root the problem data is the committed start system and the
dataset is the seeded synthetic one (utils/synthcurves.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-p", "--problem", default="trifocal_2op1p_30x30")
    ap.add_argument("--views", type=int, default=1, help="number of dataset views")
    ap.add_argument("--start-view", type=int, default=0)
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="RANSAC iterations per round (default: config, 100)")
    ap.add_argument("--times", type=int, default=1,
                    help="TEST_RANSAC_TIMES: repeat rounds for timing stats")
    ap.add_argument("--platform", default=None, choices=[None, "gpu", "cpu"],
                    help="force a JAX platform (default: environment)")
    ap.add_argument("--cross-check", action="store_true",
                    help="also run the CPU-HC oracle and compare statistics")
    ap.add_argument("--cross-check-full", action="store_true",
                    help="run the FULL hypothesis workload through the "
                         "CPU-HC oracle (minutes; the reference runs this "
                         "every invocation, cmd/magmaHC-main.cpp:124-195) "
                         "and assert statistics reconcile")
    ap.add_argument("--dedup-mode", default="batch",
                    choices=["batch", "reference"],
                    help="unique-solution semantics: 'batch' dedups all "
                         "H x 312 solutions; 'reference' reproduces "
                         "Find_Unique_Sols exactly (RANSAC iteration 0 "
                         "only, Evaluations.cpp:184-233)")
    ap.add_argument("--abort", action="store_true",
                    help="Abort_RANSAC_by_Good_Sol: stop once a pose with "
                         ">=90%% inlier support is found on-device")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard hypotheses over the first N devices of the "
                         "mesh (default: YAML Num_Of_GPUs, else 1)")
    ap.add_argument("--data-root", default=None,
                    help="reference-layout data tree (problems/ and "
                         "RANSAC_Data/); default: committed problem files "
                         "and the seeded synthetic dataset")
    ap.add_argument("--output-dir", default="Output_Write_Files")
    ap.add_argument("--ablation", action="store_true",
                    help="emit the strategy-ablation timing table "
                         "(PH vs +TrunPaths vs +compaction vs "
                         "+TrunRANSAC), the arxived_GPU_code ladder")
    ap.add_argument("--stream", action="store_true",
                    help="streamed recovery: pipeline host prep/scoring of "
                         "one view with device tracking of the next")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace of the timed "
                         "rounds into DIR (view with tensorboard/xprof)")
    ap.add_argument("--debug-gt-deviation", action="store_true",
                    help="print the best pose's GT-deviation report per "
                         "round (Check_Deviations_of_Veridical_Sol_from_GT, "
                         "Evaluations.cpp:267-296)")
    args = ap.parse_args(argv)

    import jax

    if args.platform is not None:
        jax.config.update("jax_platforms",
                          "cuda" if args.platform == "gpu" else "cpu")
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import runtime

    runtime.enable_compile_cache()

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import evaluation as evl
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
        ProblemConfig,
        load_problem_yaml,
    )

    # Load the reference-format per-problem YAML when the problem folder
    # carries one (cmd/magmaHC-main.cpp:243 does the same); CLI flags
    # override its settings.
    yaml_path = os.path.join(
        args.data_root or "", "problems", args.problem, "gpuhc_settings.yaml",
    )
    if args.data_root and os.path.exists(yaml_path):
        cfg = load_problem_yaml(yaml_path)
    else:
        cfg = EngineConfig(problem=ProblemConfig(name=args.problem))
    if args.devices is not None:
        cfg = dataclasses.replace(
            cfg, num_devices=args.devices if args.devices > 1 else None
        )
    if args.abort:
        cfg = dataclasses.replace(
            cfg,
            ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True),
        )
    if args.data_root:
        cfg = dataclasses.replace(cfg, data_root=args.data_root)
    os.makedirs(args.output_dir, exist_ok=True)

    if args.ablation:
        return run_ablation(cfg, args)

    engine = TrifocalPoseEngine(cfg)
    print(f"[hc] {jax.default_backend()}: problem {args.problem}, "
          f"{engine.problem.num_tracks} tracks x "
          f"{args.hypotheses or cfg.ransac.num_iterations} hypotheses"
          + (f" over {cfg.num_devices} devices"
             if (cfg.num_devices or 1) > 1 else ""))

    timings, all_stats, found_count, err_lines = [], [], 0, []
    view0 = engine.load_view(args.start_view)
    engine.run_round(view0, seed=0, num_hypotheses=args.hypotheses)  # compile

    if args.stream:
        # Stream mode keeps scoring + selection on device (one 156 B d2h
        # per view); per-path HC step counts never come back to the host,
        # so the *HC_Steps_of_Actual_Solutions.txt writers have nothing to
        # serve (engine.py RoundResult.num_steps is empty under stream).
        print("[stream] note: per-path HC step counts stay on device in "
              "stream mode; HC-steps output files will be empty (use a "
              "non-stream run for them)")
        vis = list(range(args.start_view, args.start_view + args.views))
        results, vps = engine.run_stream(vis, num_hypotheses=args.hypotheses)
        ok = sum(1 for r in results
                 if r.pose_errors is not None and r.pose_errors.within(cfg.ransac))
        print(f"[stream] {len(vis)} views at {vps:.2f} views/s; "
              f"found {sum(r.found_pose for r in results)}/{len(vis)}; "
              f"within GT tolerance {ok}/{len(vis)}")
        evl.write_sols_statistics(
            os.path.join(args.output_dir, "GPU_Sols_Statistics.txt"),
            [r.stats for r in results],
        )
        return 0

    import contextlib

    prof_ctx = contextlib.nullcontext()
    if args.profile:
        import jax

        prof_ctx = jax.profiler.trace(args.profile)
    last_rr = None
    with prof_ctx:
        for vi in range(args.start_view, args.start_view + args.views):
            view = engine.load_view(vi)
            for ti in range(args.times):
                rr = engine.run_round(
                    view, seed=ti, num_hypotheses=args.hypotheses,
                    collect_solutions=True,
                )
                last_rr = rr
                timings.append(rr.track_ms)
                all_stats.append(rr.stats)
                if rr.found_pose:
                    found_count += 1
                pe = rr.pose_errors
                status = "FOUND" if rr.found_pose else "no-pass"
                line = (
                    f"view {vi:03d} round {ti}: track {rr.track_ms:8.2f} ms, "
                    f"conv {rr.stats.num_converged}, cand {rr.num_candidates}, "
                    f"support {rr.best_support21}/{rr.best_support31} of {rr.num_edgels} "
                    f"[{status}]"
                )
                if pe is not None:
                    line += (
                        f" rot ({pe.rot21:.4f}, {pe.rot31:.4f})"
                        f" transl ({pe.transl21:.4f}, {pe.transl31:.4f})"
                    )
                    err_lines.append(pe)
                print(line)
                if args.debug_gt_deviation and rr.best_pose is not None:
                    print(evl.format_gt_deviation(
                        *rr.best_pose, view.gt_pose21, view.gt_pose31))

    ts = evl.timing_summary(timings)
    n_rounds = len(timings)
    print(f"\n## {n_rounds} round(s) of RANSAC (path tracking wall-clock):")
    print(f" - [Average Computation Time] {ts['avg_ms']:9.2f} (ms)")
    print(f" - [Maximal Computation Time] {ts['max_ms']:9.2f} (ms)")
    print(f" - [Minimal Computation Time] {ts['min_ms']:9.2f} (ms)")
    print(f" - [Std dev Computation Time] {ts['std_ms']:9.2f} (ms)")
    print(f" - Poses with >=90% inlier support: {found_count}/{n_rounds}")
    if err_lines:
        ok = sum(1 for p in err_lines if p.within(cfg.ransac))
        print(f" - Best poses within GT tolerance (rot/transl < 0.1): {ok}/{len(err_lines)}")

    evl.write_timings(os.path.join(args.output_dir, "GPU_Timings.txt"), timings)
    evl.write_sols_statistics(
        os.path.join(args.output_dir, "GPU_Sols_Statistics.txt"), all_stats
    )
    # Converged tracks + HC-steps files for the final round (the reference
    # writes these inside its active flow: GPU_HC_Solver.cpp:510 and
    # cmd/magmaHC-main.cpp:106-116 -> Evaluations.cpp:120-143, :506-521).
    if last_rr is not None:
        sols = last_rr.solutions
        evl.write_converged_sols(
            os.path.join(args.output_dir, "GPU_Converged_HC_tracks.txt"),
            sols.x, sols.converged, engine.problem.num_tracks,
        )
        evl.write_hc_steps(
            os.path.join(args.output_dir,
                         "GPUHC_Steps_of_Actual_Solutions.txt"),
            last_rr.actual_sol_steps,
        )
        if args.dedup_mode == "reference":
            uniq = evl.find_unique_solutions_reference(
                sols.x, sols.converged, engine.problem.num_tracks,
                tol=cfg.ransac.duplicate_sol_tol,
            )
        else:
            uniq = evl.find_unique_solutions(
                sols.x, sols.converged, tol=cfg.ransac.duplicate_sol_tol
            )
        print(f" - Unique converged solutions (final round, "
              f"{args.dedup_mode} mode): {uniq.size}"
              f" of {int(sols.converged.sum())}")
        # Percentage_Of_* statistics (Evaluations.hpp:78-81) + min
        # residuals over all candidate poses (Evaluations.cpp:545-583).
        st = dataclasses.replace(last_rr.stats, num_unique=int(uniq.size))
        print(f" - Percentage of convergence {st.pct_converged:.4f}, "
              f"infinity {st.pct_infinity:.4f}, real {st.pct_real:.4f}, "
              f"unique {st.pct_unique:.4f}")
        if last_rr.min_residuals is not None:
            mr = last_rr.min_residuals
            print(f" - Min residuals over all candidate sols: "
                  f"rot ({mr.rot21:.4f}, {mr.rot31:.4f}) "
                  f"transl ({mr.transl21:.4f}, {mr.transl31:.4f}); "
                  f"any pose within GT tolerance: {last_rr.any_within_gt}")

    if args.cross_check or args.cross_check_full:
        return run_cross_check(engine, cfg, args, view0,
                               full=args.cross_check_full)
    return 0


# Cross-check agreement bands, from measured float noise.  The device
# path and the CPU-HC oracle run the same step arithmetic on identical
# inputs, but the GPU's batched LU and LAPACK's round differently, and
# ill-conditioned Jacobians along some paths amplify that into different
# corrector outcomes.  Measured on an H100 (400 W limit) against the CPU
# oracle at H=2: 57 converged-flag flips in 6,240 paths over 10 rounds
# (0.91%, at most 10/624 in one round); the band is 3x the mean rate,
# floor 3.  Best supports were equal whenever either side found a pose
# (>= 90% support); when neither does, the best junk candidate can differ
# completely (125/140 vs 3218/3035 once), so supports are compared only
# when a pose was found.
_CC_FLIP_FRAC = 0.03
_CC_SUP_FRAC = 0.002


def run_cross_check(engine, cfg, args, view0, full: bool) -> int:
    """Dual-solver agreement gate (the reference's correctness story,
    SURVEY.md section 4: every invocation runs the same workload through
    GPU-HC and CPU-HC, cmd/magmaHC-main.cpp:124-195).

    Fast tier (--cross-check): 2 hypotheses through the plain oracle
    (ops/tracker.py) on the CPU.  Full tier (--cross-check-full): the
    ENTIRE hypothesis workload -- the reference's per-invocation
    comparison, opt-in here because the CPU oracle runs the full 80-step
    budget on every path.
    """
    import jax

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        evaluation as evl,
    )

    if full:
        h_cc = args.hypotheses or cfg.ransac.num_iterations
    else:
        h_cc = min(args.hypotheses or 2, 2)
    print(f"\n[cross-check] re-running round 0 ({h_cc} hypotheses) through "
          "the CPU-HC oracle ...")
    rr_dev = engine.run_round(view0, seed=0, num_hypotheses=h_cc,
                              collect_solutions=True)
    with jax.default_device(jax.devices("cpu")[0]):
        rr = engine.oracle_round(view0, seed=0, num_hypotheses=h_cc)
    ok, report = compare_rounds(rr_dev, rr, engine.problem.num_tracks * h_cc)
    print(
        f"cpu-hc: conv {rr.stats.num_converged}, cand {rr.num_candidates}, "
        f"support {rr.best_support21}/{rr.best_support31} of {rr.num_edgels}"
    )
    evl.write_sols_statistics(
        os.path.join(args.output_dir, "CPU_Sols_Statistics.txt"), [rr.stats]
    )
    evl.write_converged_sols(
        os.path.join(args.output_dir, "CPU_Converged_HC_tracks.txt"),
        rr.solutions.x, rr.solutions.converged, engine.problem.num_tracks,
    )
    print(f"[cross-check] {report} -> {'AGREE' if ok else 'MISMATCH'}")
    if not ok:
        print("[cross-check] FAILED: device and CPU-HC results diverge")
        return 1
    return 0


def compare_rounds(rr_a, rr_b, n_paths: int):
    """(ok, report) of two rounds of one workload under the cross-check
    bands (both rounds must carry ``solutions``)."""
    dis = int((rr_a.solutions.converged != rr_b.solutions.converged).sum())
    tol_paths = max(3, int(_CC_FLIP_FRAC * n_paths))
    sup_tol = max(5, int(_CC_SUP_FRAC * rr_b.num_edgels))
    supports_ok = (
        abs(rr_a.best_support21 - rr_b.best_support21) <= sup_tol
        and abs(rr_a.best_support31 - rr_b.best_support31) <= sup_tol
    ) or not (rr_a.found_pose or rr_b.found_pose)
    ok = (
        dis <= tol_paths
        and abs(rr_a.stats.num_converged - rr_b.stats.num_converged)
        <= tol_paths
        and rr_a.found_pose == rr_b.found_pose
        and supports_ok
    )
    report = (
        f"converged-flag disagreements: {dis}/{n_paths} (tol {tol_paths}); "
        f"conv totals {rr_a.stats.num_converged} vs "
        f"{rr_b.stats.num_converged}; support "
        f"{rr_a.best_support21}/{rr_a.best_support31} vs "
        f"{rr_b.best_support21}/{rr_b.best_support31} (tol {sup_tol})"
    )
    return ok, report


def run_ablation(cfg, args) -> int:
    """The reference's incremental-optimization ladder, one invocation.

    Reproduces the PH rungs of arxived_GPU_code/README_arxived_GPU_code.md:4-9
    on the production path: every strategy runs as a config variant of ONE
    tracker (the reference archived five separate CUDA kernels).  Timing
    span = path tracking only, like the reference.
    """
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )

    H = args.hypotheses or cfg.ransac.num_iterations
    variants = [
        ("PH (direct parameter homotopy)",
         dict(truncate_paths=False, compact_survivors=False), dict()),
        ("PH + TrunPaths (depth pruning)",
         dict(truncate_paths=True, compact_survivors=False), dict()),
        ("PH + TrunPaths + compaction (production)",
         dict(truncate_paths=True, compact_survivors=True), dict()),
        ("PH + TrunPaths + compaction + TrunRANSAC",
         dict(truncate_paths=True, compact_survivors=True),
         dict(abort_by_good_sol=True)),
    ]
    print(f"## Strategy ablation: view {args.start_view}, {H} hypotheses "
          f"x {cfg.problem.num_tracks} paths "
          f"(last row times to the accepted pose)")
    print(f"{'variant':44s} {'best ms':>9} {'conv':>6} {'found':>6}")
    rows = []
    for name, hc_over, rc_over in variants:
        vcfg = dataclasses.replace(
            cfg,
            hc=dataclasses.replace(cfg.hc, **hc_over),
            ransac=dataclasses.replace(cfg.ransac, **rc_over),
        )
        eng = TrifocalPoseEngine(vcfg)
        view = eng.load_view(args.start_view)
        eng.run_round(view, seed=0, num_hypotheses=H)  # compile
        best, conv, found = 1e30, 0, False
        for seed in range(max(2, args.times)):
            rr = eng.run_round(view, seed=seed, num_hypotheses=H)
            if rr.track_ms < best:
                best, conv, found = (rr.track_ms, rr.stats.num_converged,
                                     rr.found_pose)
        rows.append((name, best, conv, found))
        print(f"{name:44s} {best:9.1f} {conv:6d} {str(found):>6}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
