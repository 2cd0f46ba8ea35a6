#!/usr/bin/env python
"""Smoke run of the RANSAC pose pipeline on one GPU, at deployment size.

Drives the production path through ``TrifocalPoseEngine`` on view 0 of the
seeded synthetic dataset with H = 100 hypotheses x 312 paths (31,200 paths
per round, at most 80 HC steps, 5,117 edgels per view triplet), in phases:

1. device: the JAX backend is a GPU; prints the card's name and power limit;
2. start system: H(start_sols, p0) ~ 0, evaluated on the device;
3. full round (compaction on, abort off): the pose is found within the
   ground-truth tolerances;
4. the same 31,200 paths through the plain oracle tracker (ops/tracker.py)
   on the same card -- converged flags, endpoints and best supports agree
   -- and the CPU cross-check at H = 2 under the CLI's bands;
5. abort round (abort_by_good_sol): the pose is found; time to pose;
6. run_stream with abort over 5 views: every view is found; views/s.

    python chip_smoke.py              # one GPU, all six phases
    python chip_smoke.py --devices 4  # only: the hypothesis-sharded round
                                      # on four GPUs against one GPU

Each phase prints its numbers and seconds.  The last line of a successful
run is one JSON object with the device as JAX reports it; any failed check
exits non-zero without it, as does a host without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

H = 100            # hypotheses per round (the reference's deployment)
STREAM_VIEWS = 5
FLIP_FRAC = 0.005  # converged-flag disagreements allowed vs the oracle
ENDPOINT_RTOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class Phase:
    """Prints a phase's name on entry and its seconds on exit."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"   {self.name}: ok in "
                  f"{time.perf_counter() - self.t0:.1f} s", flush=True)
        return False


def phase_start_system(problem) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as ev

    x0 = jnp.asarray(problem.start_sols)
    p0 = jnp.broadcast_to(jnp.asarray(problem.start_params),
                          (x0.shape[0],) + problem.start_params.shape)
    h = jax.jit(lambda x, p: ev.eval_H_direct(problem, x, p))(x0, p0)
    check(h.devices() == {jax.devices()[0]}, "H not evaluated on the GPU")
    resid = float(np.abs(np.asarray(h)).max())
    print(f"   {problem.num_tracks} start roots, max |H(x0, p0)| = "
          f"{resid:.3g} on {list(h.devices())[0]}")
    check(resid < 5e-4, f"start system residual {resid:.3g} >= 5e-4")


def pose_ok(rr, rc) -> bool:
    return (rr.found_pose and rr.pose_errors is not None
            and rr.pose_errors.within(rc))


def describe(rr) -> str:
    pe = rr.pose_errors
    err = ("" if pe is None else
           f", rot ({pe.rot21:.2e}, {pe.rot31:.2e}) transl "
           f"({pe.transl21:.2e}, {pe.transl31:.2e})")
    return (f"track_ms {rr.track_ms:.1f}, converged {rr.stats.num_converged},"
            f" real {rr.stats.num_real}, candidates {rr.num_candidates},"
            f" support {rr.best_support21}/{rr.best_support31} of "
            f"{rr.num_edgels}, found {rr.found_pose}{err}")


def phase_compare(engine, view, rr_prod, h: int) -> None:
    """Production round vs the plain oracle on the same paths and card."""
    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_tpu import cli

    rr_o = engine.oracle_round(view, seed=0, num_hypotheses=h)
    a, b = rr_prod.solutions, rr_o.solutions
    n = a.converged.shape[0]
    dis = int((a.converged != b.converged).sum())
    both = a.converged & b.converged
    rel = (np.abs(a.x[both] - b.x[both]).max(axis=1)
           / np.maximum(np.abs(b.x[both]).max(axis=1), 1e-30))
    worst = float(rel.max()) if rel.size else 0.0
    print(f"   oracle: {describe(rr_o)}")
    print(f"   converged-flag disagreements {dis}/{n} "
          f"({100.0 * dis / n:.3f} %), jointly converged {int(both.sum())}, "
          f"worst endpoint rel. inf-norm {worst:.3g} "
          f"(paths above {ENDPOINT_RTOL:g}: {int((rel > ENDPOINT_RTOL).sum())})")
    check(dis <= FLIP_FRAC * n, f"{dis} converged-flag disagreements")
    check(worst <= ENDPOINT_RTOL, f"endpoint disagreement {worst:.3g}")
    check((rr_prod.best_support21, rr_prod.best_support31)
          == (rr_o.best_support21, rr_o.best_support31),
          "best supports differ from the oracle")

    import jax

    rr_dev = engine.run_round(view, seed=0, num_hypotheses=2,
                              collect_solutions=True)
    with jax.default_device(jax.devices("cpu")[0]):
        rr_cpu = engine.oracle_round(view, seed=0, num_hypotheses=2)
    ok, report = cli.compare_rounds(rr_dev, rr_cpu,
                                    2 * engine.problem.num_tracks)
    print(f"   CPU cross-check (H=2): {report}")
    check(ok, "CPU cross-check outside its bands")


def one_device(cfg, h: int = H) -> None:
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )

    with Phase("start system"):
        engine = TrifocalPoseEngine(cfg)
        phase_start_system(engine.problem)
    view = engine.load_view(0)

    with Phase(f"full round, H={h}, compaction on, abort off"):
        t0 = time.perf_counter()
        engine.run_round(view, seed=0, num_hypotheses=h)
        print(f"   first round (compile + run) {time.perf_counter() - t0:.1f} s")
        rr = engine.run_round(view, seed=0, num_hypotheses=h)
        print(f"   {describe(rr)}")
        check(pose_ok(rr, cfg.ransac), "pose not found within tolerance")

    with Phase("plain oracle on the same paths"):
        rr_full = engine.run_round(view, seed=0, num_hypotheses=h,
                                   collect_solutions=True)
        phase_compare(engine, view, rr_full, h)

    acfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True))
    aengine = TrifocalPoseEngine(acfg)
    with Phase("abort round"):
        aengine.run_round(view, seed=0, num_hypotheses=h)
        rr = aengine.run_round(view, seed=0, num_hypotheses=h)
        print(f"   time to pose {rr.track_ms:.1f} ms; {describe(rr)}")
        check(pose_ok(rr, acfg.ransac), "abort round found no pose")

    with Phase(f"stream with abort, {STREAM_VIEWS} views"):
        results, vps = aengine.run_stream(list(range(STREAM_VIEWS)),
                                          num_hypotheses=h)
        for i, r in enumerate(results):
            print(f"   view {i}: {r.track_ms:.1f} ms, found {r.found_pose}")
        print(f"   {vps:.3f} views/s")
        check(all(r.found_pose for r in results), "a stream view not found")


def four_devices(cfg, n_dev: int, h: int = H) -> None:
    """The hypothesis-sharded round on n_dev GPUs against one GPU."""
    import jax
    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac

    check(len(jax.devices()) >= n_dev, f"{len(jax.devices())} GPUs visible")
    for abort in (False, True):
        rcfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac,
                                            abort_by_good_sol=abort))
        with Phase(f"sharded round on {n_dev} GPUs, abort {abort}"):
            e1 = TrifocalPoseEngine(rcfg)
            en = TrifocalPoseEngine(dataclasses.replace(rcfg,
                                                        num_devices=n_dev))
            view = e1.load_view(0)
            out = {}
            for name, eng in (("1 GPU", e1), (f"{n_dev} GPUs", en)):
                eng.run_round(view, seed=0, num_hypotheses=h)
                rr = eng.run_round(view, seed=0, num_hypotheses=h)
                out[name] = rr
                print(f"   {name}: {describe(rr)}")
            r1, rn = out.values()
            check((r1.best_support21, r1.best_support31, r1.found_pose)
                  == (rn.best_support21, rn.best_support31, rn.found_pose),
                  "sharded and one-GPU rounds differ")
            if not abort:
                # Where the shards live: one block of hypotheses per GPU.
                T = en.problem.num_tracks
                s = ransac.sample_edgel_triplets(
                    0, view.edge_locations.shape[0], h)
                tgt = np.repeat(ransac.build_target_params(
                    view.edge_locations, view.edge_tangents, s), T, axis=0)
                x0 = np.tile(en.problem.start_sols, (h, 1))
                f32 = np.float32
                res = en.track.jitted(
                    x0.real.astype(f32), x0.imag.astype(f32),
                    tgt.real.astype(f32), tgt.imag.astype(f32),
                    (tgt - en.problem.start_params).real.astype(f32),
                    (tgt - en.problem.start_params).imag.astype(f32),
                    view.edge_locations.astype(f32),
                    e1._intrinsics, f32(view.edge_locations.shape[0]),
                )
                for sh in res[2].addressable_shards:
                    sl = sh.index[0]
                    print(f"   paths {sl.start}:{sl.stop} on {sh.device}")
                check(len({sh.device for sh in res[2].addressable_shards})
                      == n_dev, "shards not spread over the GPUs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the hypothesis-sharded round on four "
                         "GPUs and its one-GPU comparison")
    args = ap.parse_args(argv)
    try:
        from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
            runtime,
        )
        from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
            EngineConfig,
        )
    except ImportError as e:
        print(f"chip_smoke: the package is not importable here ({e})",
              file=sys.stderr)
        return 2
    runtime.enable_compile_cache()
    import jax

    try:
        with Phase("device"):
            try:
                devs = runtime.require_gpu()
            except RuntimeError as e:
                raise SmokeFailure(str(e)) from None
            card = runtime.gpu_card_line()
            print(f"   {len(devs)} x {devs[0].device_kind} "
                  f"({devs[0].platform}), jax {jax.__version__}")
        if args.devices > 1:
            four_devices(EngineConfig(), args.devices)
        else:
            one_device(EngineConfig())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
