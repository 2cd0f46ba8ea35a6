#!/usr/bin/env python
"""Hypotheses/s vs device count on the hypothesis mesh.

On several GPUs this measures the scaling of the production sharded
tracker; on virtual CPU devices (JAX_PLATFORMS=cpu +
--xla_force_host_platform_device_count=N) it demonstrates functional
scaling of the same program (virtual devices share host cores, so
wall-clock speedups are bounded by the core count).

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           PYTHONPATH=. python tools/scaling_table.py [--hypotheses 16] [--steps 20]
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hypotheses", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tracks", type=int, default=64)
    args = ap.parse_args()

    import dataclasses

    import jax

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
        TrifocalProblem,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.parallel import (
        mesh as pmesh,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
    )

    cfg = EngineConfig()
    hc = dataclasses.replace(cfg.hc, max_steps=args.steps)
    problem = TrifocalProblem.load(cfg)
    view = data_io.load_view(cfg, 0)
    H, T = args.hypotheses, args.tracks
    samples = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], H)
    tgt = ransac.build_target_params(
        view.edge_locations, view.edge_tangents, samples
    )
    tgt_b = np.repeat(tgt, T, axis=0)
    diff_b = (tgt_b - problem.start_params).astype(np.complex64)
    x0 = np.tile(np.asarray(problem.start_sols)[:T], (H, 1))
    f32 = np.float32
    planes = (
        x0.real.astype(f32), x0.imag.astype(f32),
        tgt_b.real.astype(f32), tgt_b.imag.astype(f32),
        diff_b.real.astype(f32), diff_b.imag.astype(f32),
        np.full((8, 6), 1e3, f32), np.eye(3, dtype=f32), f32(8),
    )

    n_all = len(jax.devices())
    print(f"# {H} hypotheses x {T} tracks x "
          f"{args.steps} steps, platform={jax.default_backend()}")
    print(f"{'devices':>8} {'time_ms':>10} {'hyp/s':>10} {'speedup':>8}")
    base = None
    nd = 1
    while nd <= n_all and H % nd == 0:
        m = pmesh.make_mesh(nd)
        track = pmesh.make_sharded_track_fn(problem, hc, m)
        out = track.jitted(*planes)
        np.asarray(out[2])  # compile + sync
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = track.jitted(*planes)
            np.asarray(out[2][0])
            times.append(time.perf_counter() - t0)
        best = min(times)
        if base is None:
            base = best
        print(f"{nd:>8} {best * 1e3:>10.1f} {H / best:>10.1f} "
              f"{base / best:>8.2f}")
        nd *= 2


if __name__ == "__main__":
    main()
