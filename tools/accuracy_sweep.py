#!/usr/bin/env python
"""Full-dataset accuracy sweep with multi-seed RANSAC retry.

For every synthcurves view: run RANSAC rounds (TrunRANSAC abort mode) with
fresh seeds until a >=90%-support pose is found or the retry budget runs
out.  Views that still miss get an exhaustive high-hypothesis sweep to
establish the best support ANY sampled hypothesis can reach -- separating
"solver failure" from "no sampled minimal set satisfies the reference's
acceptance rule on this data" (definitions.hpp:18).

Also records the wall-clock-to-accepted-pose distribution over all views
(the reference's serving metric; its committed sample runs one full round
in 149.575 ms, BASELINE.md) -- both the first-attempt round time and the
cumulative time across retries until a pose is accepted.

Usage: PYTHONPATH=. python tools/accuracy_sweep.py [--views 100] [--hypotheses 100]
           [--retries 4] [--exhaustive 2000]
"""

import argparse
import dataclasses
import json
import time


def _dist(ms):
    """min/median/mean/p90/max summary of a list of millisecond timings."""
    if not ms:
        return {}
    s = sorted(ms)
    n = len(s)
    return {
        "n": n,
        "min": round(s[0], 1),
        "median": round(s[n // 2], 1),
        "mean": round(sum(s) / n, 1),
        "p90": round(s[min(n - 1, int(0.9 * n))], 1),
        "max": round(s[-1], 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--retries", type=int, default=4)
    ap.add_argument("--exhaustive", type=int, default=2000)
    args = ap.parse_args()

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
    )

    cfg = EngineConfig()
    cfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True)
    )
    eng = TrifocalPoseEngine(cfg)
    eng.warmup(num_hypotheses=args.hypotheses)

    t0 = time.time()
    found, within, misses = 0, 0, []
    attempts_hist = {}
    first_ms, cum_ms = [], []  # per recovered view: 1st round / total-to-pose
    for vi in range(args.views):
        view = eng.load_view(vi)
        rr = None
        view_ms = 0.0
        for attempt in range(1 + args.retries):
            rr = eng.run_round(
                view, seed=attempt, num_hypotheses=args.hypotheses
            )
            view_ms += rr.total_ms
            if attempt == 0:
                view_first_ms = rr.total_ms
            if rr.found_pose:
                break
        attempts_hist[attempt] = attempts_hist.get(attempt, 0) + 1
        if rr.found_pose:
            found += 1
            first_ms.append(view_first_ms)
            cum_ms.append(view_ms)
            if rr.pose_errors is not None and rr.pose_errors.within(cfg.ransac):
                within += 1
        else:
            misses.append((vi, rr.best_support21, rr.best_support31,
                           rr.num_edgels))
        print(f"view {vi:03d}: attempts {attempt + 1}, "
              f"{'FOUND' if rr.found_pose else 'miss'} "
              f"support {rr.best_support21}/{rr.best_support31} "
              f"of {rr.num_edgels} wall {view_ms:.0f}ms", flush=True)

    dt = time.time() - t0
    print(f"\n## {found}/{args.views} views recovered "
          f"({within} within GT tolerance) with <= {args.retries} retries "
          f"at H={args.hypotheses}; {dt:.1f}s total "
          f"({args.views / dt:.2f} views/s)")
    print(f"attempt histogram: {dict(sorted(attempts_hist.items()))}")
    # Serving-metric distribution vs the reference's 149.575 ms sample round
    # (GPU_Timings.txt:1): first-round time and cumulative wall-to-pose.
    print("wall-to-pose ms (first round, recovered views): "
          + json.dumps(_dist(first_ms)))
    print("wall-to-pose ms (cumulative over retries):      "
          + json.dumps(_dist(cum_ms)))

    if misses and args.exhaustive:
        print(f"\n## Exhaustive sweep on misses (H={args.exhaustive}):")
        for vi, *_ in misses:
            view = eng.load_view(vi)
            best21 = best31 = 0
            for seed in range(args.exhaustive // args.hypotheses):
                rr = eng.run_round(
                    view, seed=1000 + seed, num_hypotheses=args.hypotheses
                )
                best21 = max(best21, rr.best_support21)
                best31 = max(best31, rr.best_support31)
                if rr.found_pose:
                    break
            need = int(0.9 * rr.num_edgels)
            print(f"view {vi:03d}: best support {best21}/{best31} "
                  f"of {rr.num_edgels} (need {need}) over "
                  f"{args.exhaustive} hypotheses -> "
                  f"{'recoverable' if rr.found_pose else 'below criterion'}",
                  flush=True)


if __name__ == "__main__":
    main()
