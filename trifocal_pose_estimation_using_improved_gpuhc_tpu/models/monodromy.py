"""Monodromy start-system generation, powered by the framework's own tracker.

The reference regenerates its start system offline with Julia's
HomotopyContinuation.jl ``monodromy_solve``
(problems/trifocal_2op1p_30x30/trifocal_2op1p_30x30_monodromySolve.jl:1-94).
This module is the native equivalent: given a parameter point p0 with a
(possibly partial) set of known solutions, it discovers the remaining
solutions of the 312-path trifocal system by tracking monodromy loops
p0 -> p1 -> p2 -> p0 through random complex parameter points with the plain
HC tracker (ops/tracker.py, ``dynamic_start=True``).  Solutions permute
around each loop; landing points that are not already known are new roots.
The loop repeats until the solution count closes (no growth for
``patience`` consecutive loops) or ``target_count`` is reached.

``main`` builds the committed start system from a seed alone:

1. draw a real view triplet (utils/synthcurves.py) and take the exact root
   of one sampled triplet from its ground-truth pose
   (models/system.root_from_view);
2. track that root to a random complex parameter point p0;
3. grow the root set from that one root by monodromy, Newton-polishing
   every landing point in complex128 (models/system.newton_polish) and
   dropping the landings where a Cayley matrix loses rank
   (models/system.is_degenerate): they solve the polynomial system but
   are no pose, and the trifocal problem's 312 roots are the others.

    python -m trifocal_pose_estimation_using_improved_gpuhc_tpu.models.monodromy \\
        --rng-seed 0
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import system
from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
    HCConfig,
)

# Largest max|H| at p0 accepted for a polished root (complex128 Newton
# reaches ~1e-12 on true roots; end-zone error of unconverged landings
# stays far above).
RESIDUAL_TOL = 1e-8


@dataclasses.dataclass
class MonodromyResult:
    params: np.ndarray      # (P+1,) complex parameter point
    solutions: np.ndarray   # (N, V) complex128 distinct roots at params
    loops_run: int
    history: list           # solution count after each loop


def _dedup(sols: np.ndarray, new: np.ndarray, tol: float) -> np.ndarray:
    """Append rows of ``new`` not already present in ``sols``.

    Relative inf-norm distance (duplicate-solution test of
    Evaluations.cpp:184-233 with a scale-aware tolerance)."""
    out = sols
    for row in new:
        if out.size == 0:
            out = row[None]
            continue
        scale = max(1.0, float(np.abs(row).max()))
        if np.min(np.max(np.abs(out - row[None]), axis=1)) > tol * scale:
            out = np.concatenate([out, row[None]])
    return out


def monodromy_solve(
    problem: TrifocalProblem,
    track_fn,
    seed_sols: np.ndarray,
    target_count: Optional[int] = None,
    max_loops: int = 30,
    patience: int = 3,
    rng_seed: int = 0,
    dedup_tol: float = 1e-6,
    perturb_scale: float = 1.0,
    leg_batch: Optional[int] = None,
) -> MonodromyResult:
    """Grow a solution set at the problem's start parameters via monodromy.

    seed_sols: known roots at problem.start_params.  track_fn: a
    ``track(x0, tgt, diff)`` built with ``dynamic_start=True`` and
    truncate_paths off (ops/tracker.make_track_fn).
    """
    p0 = np.asarray(problem.start_params).astype(np.complex128)
    npar = p0.shape[0] - 1  # last slot is the constant 1
    sols = np.asarray(seed_sols, np.complex128).copy()
    if target_count is None:
        target_count = problem.num_tracks
    rng = np.random.default_rng(rng_seed)
    history = []
    stagnant = 0
    loops = 0

    # Fixed leg batch size: one compiled program serves every loop even as
    # the solution set grows (pad by repeating the first root).
    if leg_batch is None:
        leg_batch = max(target_count, problem.num_tracks)

    def leg(x_from: np.ndarray, p_from: np.ndarray, p_to: np.ndarray):
        B = x_from.shape[0]
        Bp = -(-B // leg_batch) * leg_batch
        if Bp != B:
            x_from = np.concatenate(
                [x_from, np.broadcast_to(x_from[:1], (Bp - B,) + x_from.shape[1:])]
            )
        tgt = np.broadcast_to(p_to, (Bp, p0.shape[0])).astype(np.complex64)
        diff = (p_to - p_from)[None].repeat(Bp, axis=0).astype(np.complex64)
        res = track_fn(x_from.astype(np.complex64), tgt, diff)
        return res.x[:B], res.converged[:B]

    for loops in range(1, max_loops + 1):
        # Random complex waypoints around the seed point (the monodromy
        # group acts transitively on the trifocal roots).
        way = []
        for _ in range(2):
            z = p0.copy()
            z[:npar] = z[:npar] + perturb_scale * (
                rng.standard_normal(npar) + 1j * rng.standard_normal(npar)
            )
            way.append(z)

        x, ok = leg(sols, p0, way[0])
        x, ok2 = leg(x, way[0], way[1])
        x, ok3 = leg(x, way[1], p0)
        good = ok & ok2 & ok3
        # Newton-polish the landing points at p0 and accept only true
        # roots; unpolished end-zone error defeats duplicate detection.
        cand, res = system.newton_polish(
            problem.hx_table, problem.ht_table, x[good], p0
        )
        cand = cand[(res < RESIDUAL_TOL) & ~system.is_degenerate(cand)]
        before = sols.shape[0]
        sols = _dedup(sols, cand, dedup_tol)
        history.append(int(sols.shape[0]))
        print(f"monodromy loop {loops}: {sols.shape[0]} roots", flush=True)
        stagnant = stagnant + 1 if sols.shape[0] == before else 0
        if sols.shape[0] >= target_count or stagnant >= patience:
            break

    # A canonical order, so a rebuild that finds the same roots writes the
    # same files.
    sols = sols[np.lexsort((sols[:, 0].imag, sols[:, 0].real))]
    return MonodromyResult(
        params=p0, solutions=sols, loops_run=loops, history=history
    )


def write_start_system(
    path_params: str, path_sols: str, result: MonodromyResult
) -> None:
    """Write start_params.txt / start_sols.txt in the reference format:
    one "re im" pair per line, num_params lines / num_tracks*num_vars lines
    (Data_Reader.cpp:37-60,104-121; utils/data_io.py round-trips them)."""
    with open(path_params, "w") as f:
        for z in result.params[:-1]:  # constant-1 slot is implicit
            f.write(f"{z.real:.17g}\t{z.imag:.17g}\n")
    with open(path_sols, "w") as f:
        for row in result.solutions:
            for z in row:
                f.write(f"{z.real:.17g}\t{z.imag:.17g}\n")


def seed_root(rng_seed: int):
    """A real parameter point (P+1,) and its exact root (V,), from a seed."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        synthcurves,
    )

    view = synthcurves.generate_view(0, seed=rng_seed, outlier_ratio=0.0)
    sample = ransac.sample_edgel_triplets(
        rng_seed, view.edge_locations.shape[0], 1
    )
    params = ransac.build_target_params(
        view.edge_locations, view.edge_tangents, sample
    )[0].astype(np.complex128)
    poses = [(p[:, :3].astype(np.float64), p[:, 3].astype(np.float64))
             for p in (view.gt_pose21, view.gt_pose31)]
    return params, system.root_from_view(params.real, poses)


def generate_start_system(rng_seed: int = 0, num_roots: int = 312,
                          max_loops: int = 60):
    """Build the start system: (hx_table, ht_table, MonodromyResult)."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import tracker

    hx, ht = system.build_tables()
    p_real, x_real = seed_root(rng_seed)
    rng = np.random.default_rng(rng_seed)
    npar = p_real.shape[0] - 1
    p0 = np.ones(npar + 1, np.complex128)
    p0[:npar] = (rng.standard_normal(npar)
                 + 1j * rng.standard_normal(npar)) / np.sqrt(2)

    problem = TrifocalProblem.from_arrays(
        p0[:npar].astype(np.complex64), np.zeros((num_roots, 30)), hx, ht
    )
    # Random complex legs: every root is complex, so depth-sign pruning
    # (a real-geometry heuristic) stays off; generous step budget.
    hc = HCConfig(truncate_paths=False, max_steps=400)
    track = tracker.make_track_fn(problem, hc, dynamic_start=True)
    x = np.broadcast_to(x_real.astype(np.complex64), (8, 30))
    res = track(x, np.broadcast_to(p0, (8, npar + 1)).astype(np.complex64),
                np.broadcast_to(p0 - p_real, (8, npar + 1)).astype(np.complex64))
    if not res.converged[0]:
        raise RuntimeError("seed root did not reach p0; try another seed")
    root, resid = system.newton_polish(hx, ht, res.x[:1], p0)
    if resid[0] >= RESIDUAL_TOL:
        raise RuntimeError(f"seed root residual {resid[0]:.3g} at p0")
    result = monodromy_solve(
        problem, track, root, target_count=num_roots, max_loops=max_loops,
        patience=6, rng_seed=rng_seed + 1,
    )
    return hx, ht, result


def main(argv=None) -> int:
    """Regenerate the committed start system and index tables."""
    import argparse

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        PACKAGE_PROBLEMS_DIR,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rng-seed", type=int, default=0)
    ap.add_argument("--max-loops", type=int, default=60)
    ap.add_argument("--out-dir", default=os.path.join(
        PACKAGE_PROBLEMS_DIR, "trifocal_2op1p_30x30"))
    args = ap.parse_args(argv)

    hx, ht, res = generate_start_system(args.rng_seed, max_loops=args.max_loops)
    print(f"monodromy: {res.loops_run} loops, growth {res.history}")
    print(f"solutions: {res.solutions.shape[0]}")
    os.makedirs(args.out_dir, exist_ok=True)
    system.write_tables(args.out_dir)
    write_start_system(
        os.path.join(args.out_dir, "start_params.txt"),
        os.path.join(args.out_dir, "start_sols.txt"),
        res,
    )
    print(f"wrote start system and tables to {args.out_dir}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
