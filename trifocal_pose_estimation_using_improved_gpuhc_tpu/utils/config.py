"""Typed configuration for the HC solver and RANSAC engine.

Collapses the reference's two config tiers -- per-problem YAML
(problems/trifocal_2op1p_30x30/gpuhc_settings.yaml) and compile-time macros
(magmaHC/definitions.hpp:5-44) -- into one
runtime-typed config. Nothing here requires recompilation: everything is a
jit-static dataclass field.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# The committed problem data (start system + index tables), one folder per
# problem, generated by models/system.py and models/monodromy.py.
PACKAGE_PROBLEMS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "problems"
)


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Static problem dimensions (reference gpuhc_settings.yaml:16-25)."""

    name: str = "trifocal_2op1p_30x30"
    num_vars: int = 30
    num_params: int = 33
    num_tracks: int = 312
    hx_max_terms: int = 8
    hx_max_parts: int = 5
    ht_max_terms: int = 16
    ht_max_parts: int = 6
    max_order_of_t: int = 2


@dataclasses.dataclass(frozen=True)
class HCConfig:
    """Path-tracker hyper-parameters (reference gpuhc_settings.yaml:12-14 and
    kernel constants in kernel_GPUHC_trifocal_2op1p_30x30_PH_CodeOpt_TrunPaths.cu)."""

    max_steps: int = 80                 # GPUHC_Max_Steps
    max_correction_steps: int = 3       # GPUHC_Max_Correction_Steps
    steps_to_increase_delta_t: int = 4  # GPUHC_Num_Of_Steps_to_Increase_Delta_t
    init_delta_t: float = 0.01          # kernel ...TrunPaths.cu:79 (delta_t = 0.01)
    end_zone_factor: float = 0.0500001  # ...TrunPaths.cu:147 (end-zone radius)
    t_converged_eps: float = 1e-7       # convergence test 1-t <= 1e-7 (:283)
    corrector_tol_sq: float = 1e-6      # ||dx||^2 < 1e-6 ||x||^2 (:241)
    infinity_norm_sq: float = 1e14      # ||x||^2 > 1e14 -> infinity fail (:242)
    truncate_paths: bool = True         # TrunPaths: depth-sign pruning (:149-154)
    # Optimisation knobs beyond the reference (ablation ladder additions):
    compact_survivors: bool = True      # compact active paths between segments
    # HC steps per segment of the segmented driver (ops/segmented.py):
    # compaction and abort scoring run between segments.  Pure scheduling:
    # per-path step counts and flags do not depend on it.
    segment_steps: int = 8
    # Predictor order ("rk4" | "rk3" | "rk2"): the reference always runs
    # classic RK4 (...TrunPaths.cu:170-211).  Lower orders drop one
    # evaluate+solve per stage; the corrector polishes to the same
    # tolerance, so only failure rates and step counts can shift.
    predictor: str = "rk4"
    # (CJR) modified-Newton corrector: run k full Newton iterations, then
    # reuse the last iteration's Jacobian for the remaining ones.  0 (the
    # reference semantics) re-evaluates the Jacobian every iteration.
    # Measured on the CPU oracle (view 0, H=16, reference dataset): k=1
    # degrades convergence badly (1634 -> 1196 converged).
    corrector_jacobian_reuse: int = 0
    # (CPH) corrector->predictor handoff: when every path advanced in the
    # previous HC step, RK stage 1 reuses the corrector's last Jacobian
    # instead of a fresh one.  Off is the reference's exact semantics.
    predictor_handoff: bool = False


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC loop settings (reference definitions.hpp:12-19 and yaml:28-31)."""

    num_iterations: int = 100            # NUM_OF_RANSAC_ITERATIONS
    imag_part_tol: float = 1e-5          # IMAG_PART_TOL
    rot_residual_tol: float = 1e-1       # ROT_RESIDUAL_TOL
    transl_residual_tol: float = 1e-1    # TRANSL_RESIDUAL_TOL
    reproj_inlier_thresh_px: float = 2.0  # REPROJ_ERROR_INLIER_THRESH
    pass_inlier_support_ratio: float = 0.90  # PASS_RANSAC_INLIER_SUPPORT_RATIO
    abort_by_good_sol: bool = False      # Abort_RANSAC_by_Good_Sol (yaml:28)
    # Hypotheses tracked per launch under abort mode.  The reference's
    # abort saves time because CUDA serialises excess blocks, so late
    # blocks see the flag before doing work (...TrunRANSAC.cu:152); here
    # hypotheses run in chunks and the remaining chunks are skipped once a
    # chunk reports a >=90%-support pose.  Not yet tuned on the GPU.
    abort_chunk: int = 12
    # Hypotheses per chunk in the stream abort pipeline
    # (engine._run_stream_abort).  Not yet tuned on the GPU.
    stream_abort_chunk: int = 10
    feed_random_seed: bool = False       # FEED_RANDOM_SEED: false => seed = round idx
    test_ransac_times: int = 1           # TEST_RANSAC_TIMES
    dataset: str = "Synthetic"           # RANSAC_Dataset (yaml:31)
    zero_imag_part_tol: float = 1e-4     # ZERO_IMAG_PART_TOL_FOR_SP (real-sol count)
    duplicate_sol_tol: float = 1e-4      # DUPLICATE_SOL_DIFF_TOL (unique-sol dedup)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    problem: ProblemConfig = ProblemConfig()
    hc: HCConfig = HCConfig()
    ransac: RansacConfig = RansacConfig()
    # A reference-layout data tree (problems/<name>/ and
    # RANSAC_Data/<name>/<dataset>/).  None: the committed problem files
    # and the seeded synthetic dataset (utils/synthcurves.py).
    data_root: Optional[str] = None
    output_dir: str = "Output_Write_Files"
    num_devices: Optional[int] = None  # None = all visible devices
    # Num_Of_Cores (gpuhc_settings.yaml:34): the reference pins its CPU-HC
    # OpenMP thread count (CPU_HC_Solver.cpp); here the CPU oracle is a
    # single jitted XLA program whose thread pool is managed by the XLA CPU
    # runtime, so the key is parsed for config parity and recorded, but the
    # degree of parallelism is XLA's. None = "not set in the YAML".
    num_cpu_cores: Optional[int] = None


def problem_dir(cfg: EngineConfig) -> str:
    if cfg.data_root is None:
        return os.path.join(PACKAGE_PROBLEMS_DIR, cfg.problem.name)
    return os.path.join(cfg.data_root, "problems", cfg.problem.name)


def ransac_data_dir(cfg: EngineConfig) -> Optional[str]:
    """The dataset directory, or None for the seeded synthetic dataset."""
    if cfg.data_root is None:
        return None
    return os.path.join(
        cfg.data_root, "RANSAC_Data", cfg.problem.name, cfg.ransac.dataset
    )


def load_problem_yaml(path: str) -> EngineConfig:
    """Load a reference-format gpuhc_settings.yaml into an EngineConfig.

    Accepts the exact key set of the reference YAML
    (problems/trifocal_2op1p_30x30/gpuhc_settings.yaml:5-34) so existing
    problem folders work unmodified.
    """
    import yaml

    with open(path) as f:
        text = f.read()
    # The reference files start with the OpenCV-style "%YAML:1.0" directive,
    # which PyYAML rejects; strip any %-directives.
    lines = [ln for ln in text.splitlines() if not ln.startswith("%")]
    doc = yaml.safe_load("\n".join(lines)) or {}

    prob = ProblemConfig(
        name=doc.get("problem_name", "trifocal_2op1p_30x30"),
        num_vars=int(doc.get("Num_Of_Vars", 30)),
        num_params=int(doc.get("Num_Of_Params", 33)),
        num_tracks=int(doc.get("Num_Of_Tracks", 312)),
        hx_max_terms=int(doc.get("dHdx_Max_Terms", 8)),
        hx_max_parts=int(doc.get("dHdx_Max_Parts", 5)),
        ht_max_terms=int(doc.get("dHdt_Max_Terms", 16)),
        ht_max_parts=int(doc.get("dHdt_Max_Parts", 6)),
        max_order_of_t=int(doc.get("Max_Order_Of_T", 2)),
    )
    hc = HCConfig(
        max_steps=int(doc.get("GPUHC_Max_Steps", 80)),
        max_correction_steps=int(doc.get("GPUHC_Max_Correction_Steps", 3)),
        steps_to_increase_delta_t=int(
            doc.get("GPUHC_Num_Of_Steps_to_Increase_Delta_t", 4)
        ),
    )
    ransac = RansacConfig(
        abort_by_good_sol=bool(doc.get("Abort_RANSAC_by_Good_Sol", False)),
        dataset=str(doc.get("RANSAC_Dataset", "Synthetic")),
    )
    # Num_Of_GPUs (gpuhc_settings.yaml:9) maps to the hypothesis-mesh device
    # count (parallel/mesh.py); 1 keeps the single-chip path.
    ndev = int(doc.get("Num_Of_GPUs", 1))
    cores = doc.get("Num_Of_Cores")
    return EngineConfig(
        problem=prob, hc=hc, ransac=ransac,
        num_devices=ndev if ndev > 1 else None,
        num_cpu_cores=int(cores) if cores is not None else None,
    )
