"""The trifocal 2op1p 30x30 minimal problem, compiled to evaluator constants.

The reference evaluates the homotopy H(x,t), its Jacobian Hx = dH/dx and
Ht = dH/dt via data-driven index tables gathered per term inside the CUDA
kernel (gpu-idx-evals/dev-eval-indxing-trifocal_2op1p_30x30_LimUnroll_L2Cache.cuh:57-148).
Here the tables are *compiled* at load time into a factored monomial form:

  H(x, t)  = C3^T . (P(t)_q  * X3_m)      over K3 distinct (param-pair, var-triple)
  Ht(x, t) = C3^T . (P'(t)_q * X3_m)      same combos, derivative of the pair
  Hx(x, t) = scatter( C2^T . (P(t)_q * X2_m) )   over K2 distinct combos

where X2/X3 are the distinct quadratic/cubic variable monomials (47 and 115
for this problem), P the distinct parameter-pair products (38), and C2/C3
small constant integer matrices. Since the parameter homotopy
p(t) = (1-t) * start + t * target is affine in t (max_order_of_t == 2,
gpuhc_settings.yaml:24), the per-path t lives entirely in the cheap P(t)
vector, and the heavy lifting becomes small dense matmuls. This is the
analogue of the reference's "(PH) direct parameter homotopy evaluation"
strategy (README.md:5).  models/system.py builds the tables symbolically.

Solution layout (trifocal 2op1p 30x30, dev-trifocal_2op1p-eval.cuh:46-98 and
Evaluations.cpp:240-268): x[0:8] depths, x[8:18] tangent unknowns, x[18:21]
T21, x[21:24] T31, x[24:27] Cayley(R21), x[27:30] Cayley(R31); var index 30
= homogeneous 1; param index 33 = constant 1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
    EngineConfig,
    problem_dir,
)

# Solution-vector slices (see module docstring).
DEPTH_SLICE = slice(0, 8)
T21_SLICE = slice(18, 21)
T31_SLICE = slice(21, 24)
CAY21_SLICE = slice(24, 27)
CAY31_SLICE = slice(27, 30)
POSE_SLICE = slice(18, 30)

# Full float32 products: on the GPU a float32 matmul may otherwise run in
# TF32, which keeps about three decimal digits.
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class FactoredSystem:
    """Monomial-factored evaluation structure (all numpy, device-agnostic)."""

    # Distinct quadratic variable monomials X2_m = x[a] * x[b].
    qm_a: np.ndarray  # int32 (M2,)
    qm_b: np.ndarray
    # Distinct cubic variable monomials X3_m = x[a] * x[b] * x[c].
    cm_a: np.ndarray  # int32 (M3,)
    cm_b: np.ndarray
    cm_c: np.ndarray
    # Distinct parameter pairs P_q = p[a] * p[b].
    pp_a: np.ndarray  # int32 (Q,)
    pp_b: np.ndarray
    # Hx: K2 distinct (q, m2) combos with integer weights into nnz entries.
    hx_q: np.ndarray       # int32 (K2,) index into P
    hx_m: np.ndarray       # int32 (K2,) index into X2
    hx_C: np.ndarray       # float32 (K2, NNZ) combo -> nonzero Hx entry weights
    hx_scatter: np.ndarray  # int32 (num_eqs * num_vars,) index into [NNZ]+zero slot
    # H / Ht: K3 distinct (q, m3) combos.
    ht_q: np.ndarray   # int32 (K3,)
    ht_m: np.ndarray   # int32 (K3,)
    ht_C: np.ndarray   # float32 (K3, num_eqs)


def _factor_tables(hx_table: np.ndarray, ht_table: np.ndarray) -> FactoredSystem:
    n_vars = hx_table.shape[0]
    n_eqs = hx_table.shape[-1]

    # ---- Hx ----
    c = hx_table[:, :, 0, :].astype(np.int64)   # (v, j, e)
    p1 = hx_table[:, :, 1, :]
    p2 = hx_table[:, :, 2, :]
    v1 = hx_table[:, :, 3, :]
    v2 = hx_table[:, :, 4, :]
    nz = np.nonzero(c)
    terms = np.stack(
        [
            c[nz],
            np.minimum(p1[nz], p2[nz]),
            np.maximum(p1[nz], p2[nz]),
            np.minimum(v1[nz], v2[nz]),
            np.maximum(v1[nz], v2[nz]),
            nz[2] * n_vars + nz[0],  # flat Hx entry index: eq * n_vars + var
        ],
        axis=1,
    )

    # ---- H / Ht ----
    ct = ht_table[:, 0, :].astype(np.int64)
    tp1 = ht_table[:, 1, :]
    tp2 = ht_table[:, 2, :]
    tv = np.sort(ht_table[:, 3:6, :], axis=1)  # canonicalise the triple
    nzt = np.nonzero(ct)
    terms_t = np.stack(
        [
            ct[nzt],
            np.minimum(tp1[nzt], tp2[nzt]),
            np.maximum(tp1[nzt], tp2[nzt]),
            tv[:, 0, :][nzt],
            tv[:, 1, :][nzt],
            tv[:, 2, :][nzt],
            nzt[1],  # equation index
        ],
        axis=1,
    )

    # Distinct param pairs across both tables.
    pairs = np.unique(
        np.concatenate([terms[:, 1:3], terms_t[:, 1:3]], axis=0), axis=0
    )
    pair_lut = {tuple(p): i for i, p in enumerate(pairs)}

    # Distinct quadratic monomials (Hx only).
    qms = np.unique(terms[:, 3:5], axis=0)
    qm_lut = {tuple(m): i for i, m in enumerate(qms)}

    # Distinct cubic monomials (H/Ht only).
    cms = np.unique(terms_t[:, 3:6], axis=0)
    cm_lut = {tuple(m): i for i, m in enumerate(cms)}

    # Hx combos: distinct (q, m2); weights scatter into the nonzero entries.
    combo_lut: dict = {}
    entry_lut: dict = {}
    combo_rows = []
    for coeff, pa, pb, va, vb, entry in terms:
        key = (pair_lut[(pa, pb)], qm_lut[(va, vb)])
        k = combo_lut.setdefault(key, len(combo_lut))
        e = entry_lut.setdefault(entry, len(entry_lut))
        combo_rows.append((k, e, coeff))
    K2, NNZ = len(combo_lut), len(entry_lut)
    hx_C = np.zeros((K2, NNZ), dtype=np.float32)
    for k, e, coeff in combo_rows:
        hx_C[k, e] += coeff
    combos = sorted(combo_lut.items(), key=lambda kv: kv[1])
    hx_q = np.array([q for (q, _), _ in combos], dtype=np.int32)
    hx_m = np.array([m for (_, m), _ in combos], dtype=np.int32)
    # Dense scatter map: flat (eq, var) entry -> nnz slot, or NNZ (zero slot).
    hx_scatter = np.full((n_eqs * n_vars,), NNZ, dtype=np.int32)
    for entry, e in entry_lut.items():
        hx_scatter[entry] = e

    # H/Ht combos.
    combo_lut_t: dict = {}
    rows_t = []
    for coeff, pa, pb, va, vb, vc, eq in terms_t:
        key = (pair_lut[(pa, pb)], cm_lut[(va, vb, vc)])
        k = combo_lut_t.setdefault(key, len(combo_lut_t))
        rows_t.append((k, eq, coeff))
    K3 = len(combo_lut_t)
    ht_C = np.zeros((K3, n_eqs), dtype=np.float32)
    for k, eq, coeff in rows_t:
        ht_C[k, eq] += coeff
    combos_t = sorted(combo_lut_t.items(), key=lambda kv: kv[1])
    ht_q = np.array([q for (q, _), _ in combos_t], dtype=np.int32)
    ht_m = np.array([m for (_, m), _ in combos_t], dtype=np.int32)

    return FactoredSystem(
        qm_a=qms[:, 0].astype(np.int32),
        qm_b=qms[:, 1].astype(np.int32),
        cm_a=cms[:, 0].astype(np.int32),
        cm_b=cms[:, 1].astype(np.int32),
        cm_c=cms[:, 2].astype(np.int32),
        pp_a=pairs[:, 0].astype(np.int32),
        pp_b=pairs[:, 1].astype(np.int32),
        hx_q=hx_q,
        hx_m=hx_m,
        hx_C=hx_C,
        hx_scatter=hx_scatter,
        ht_q=ht_q,
        ht_m=ht_m,
        ht_C=ht_C,
    )


@dataclasses.dataclass(frozen=True)
class TrifocalProblem:
    """Compile-time constants for the trifocal 2op1p 30x30 problem.

    All arrays are host numpy and get embedded as literals at trace time.
    """

    num_vars: int
    num_params: int
    num_tracks: int
    start_params: np.ndarray  # complex64 (num_params + 1,) with constant-1 slot
    start_sols: np.ndarray    # complex64 (num_tracks, num_vars)
    # Raw index tables (oracle / cross-check evaluator).
    hx_table: np.ndarray      # int32 (v, j, 5, e)
    ht_table: np.ndarray      # int32 (j, 6, e)
    factored: FactoredSystem  # numpy constants, closed over at trace time

    @classmethod
    def load(cls, cfg: EngineConfig) -> "TrifocalProblem":
        pd = data_io.load_problem_data(
            problem_dir(cfg),
            num_vars=cfg.problem.num_vars,
            num_tracks=cfg.problem.num_tracks,
            hx_terms=cfg.problem.hx_max_terms,
            hx_parts=cfg.problem.hx_max_parts,
            ht_terms=cfg.problem.ht_max_terms,
            ht_parts=cfg.problem.ht_max_parts,
        )
        return cls.from_arrays(pd.start_params, pd.start_sols, pd.hx_table,
                               pd.ht_table)

    @classmethod
    def from_arrays(cls, start_params, start_sols, hx_table, ht_table
                    ) -> "TrifocalProblem":
        """start_params (P,) without the constant slot; start_sols (N, V)."""
        start_params = np.concatenate(
            [np.asarray(start_params), np.ones((1,), np.complex64)]
        )
        start_sols = np.asarray(start_sols, np.complex64)
        return cls(
            num_vars=hx_table.shape[0],
            num_params=start_params.shape[0] - 1,
            num_tracks=start_sols.shape[0],
            start_params=start_params.astype(np.complex64),
            start_sols=start_sols,
            hx_table=np.asarray(hx_table),
            ht_table=np.asarray(ht_table),
            factored=_factor_tables(hx_table, ht_table),
        )


def pad_params(p: jnp.ndarray) -> jnp.ndarray:
    """Append the constant-1 parameter slot (index num_params)."""
    ones = jnp.ones(p.shape[:-1] + (1,), dtype=p.dtype)
    return jnp.concatenate([p, ones], axis=-1)


def pad_vars(x: jnp.ndarray) -> jnp.ndarray:
    """Append the homogeneous-1 variable slot (index num_vars)."""
    ones = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
    return jnp.concatenate([x, ones], axis=-1)


def cayley_to_rotation(r: jnp.ndarray) -> jnp.ndarray:
    """Cayley parameters (..., 3) -> rotation matrix (..., 3, 3).

    The unnormalised form (util.hpp:31-43) followed by column normalisation
    (util.hpp:47-67); every column norm equals 1 + |r|^2 so this is the exact
    Cayley transform.
    """
    r1, r2, r3 = r[..., 0], r[..., 1], r[..., 2]
    one = jnp.ones_like(r1)
    m = jnp.stack(
        [
            one + r1 * r1 - (r2 * r2 + r3 * r3),
            2 * (r1 * r2 - r3),
            2 * (r1 * r3 + r2),
            2 * (r1 * r2 + r3),
            one + r2 * r2 - (r1 * r1 + r3 * r3),
            2 * (r2 * r3 - r1),
            2 * (r1 * r3 - r2),
            2 * (r2 * r3 + r1),
            one + r3 * r3 - (r1 * r1 + r2 * r2),
        ],
        axis=-1,
    ).reshape(r.shape[:-1] + (3, 3))
    col_norm = jnp.linalg.norm(m, axis=-2, keepdims=True)
    return m / col_norm


def skew_symmetric(t: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric cross-product matrix [t]_x (..., 3) -> (..., 3, 3)
    (util.hpp:155-166)."""
    z = jnp.zeros_like(t[..., 0])
    return jnp.stack(
        [
            z, -t[..., 2], t[..., 1],
            t[..., 2], z, -t[..., 0],
            -t[..., 1], t[..., 0], z,
        ],
        axis=-1,
    ).reshape(t.shape[:-1] + (3, 3))


def essential_matrix(r: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """E = [t]_x R (util.hpp:211-215); broadcasts over leading dims."""
    return jnp.matmul(skew_symmetric(t), r, precision=_HIGHEST)


def fundamental_matrix(
    r: jnp.ndarray, t: jnp.ndarray, k: jnp.ndarray
) -> jnp.ndarray:
    """F = K^-T E K^-1 (util.hpp:217-228)."""
    kinv = jnp.linalg.inv(k)
    e = essential_matrix(r, t)
    return jnp.matmul(jnp.matmul(jnp.swapaxes(kinv, -1, -2), e,
                                 precision=_HIGHEST), kinv, precision=_HIGHEST)


def solution_to_pose(
    x: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Solution vector (..., 30) real parts -> (R21, R31, t21, t31).

    Translations are NOT normalised here (the on-device evaluator uses them
    raw, dev-trifocal_2op1p-eval.cuh:100-104); rotations come from the Cayley
    parameters at x[24:27] / x[27:30].
    """
    xr = jnp.real(x)
    r21 = cayley_to_rotation(xr[..., CAY21_SLICE])
    r31 = cayley_to_rotation(xr[..., CAY31_SLICE])
    t21 = xr[..., T21_SLICE]
    t31 = xr[..., T31_SLICE]
    return r21, r31, t21, t31
