#!/usr/bin/env python
"""Benchmark: HC path-tracking throughput of one full RANSAC round on one GPU.

One process.  Runs view 0 of the seeded synthetic dataset at H = 100
hypotheses x 312 paths after a warm-up round, over 3 seeds, and prints ONE
JSON line with the median round and the device it ran on:
{"metric", "value", "unit", "round_ms", "round_paths", "device", "card"}.
Exits non-zero without a GPU or on any failure.
"""

import json
import statistics
import sys

H = 100


def main() -> int:
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import runtime

    runtime.enable_compile_cache()
    devs = runtime.require_gpu()
    card = runtime.gpu_card_line()

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
    )

    engine = TrifocalPoseEngine(EngineConfig())
    view = engine.load_view(0)
    engine.run_round(view, seed=0, num_hypotheses=H)  # compile + warm up
    times = [engine.run_round(view, seed=s, num_hypotheses=H).track_ms
             for s in range(3)]
    round_ms = statistics.median(times)
    n_paths = H * engine.problem.num_tracks
    print(json.dumps({
        "metric": "HC paths/s",
        "value": n_paths / (round_ms / 1e3),
        "unit": "paths/s",
        "round_ms": round_ms,
        "round_ms_all": times,
        "round_paths": n_paths,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
