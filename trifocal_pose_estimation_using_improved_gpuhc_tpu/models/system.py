"""Symbolic builder of the trifocal 2op1p 30x30 polynomial system.

Builds the 30 equations of trifocal relative pose from two oriented points
(points with tangents) and one point, seen in three views, and writes them
as the index tables the evaluators read (``dHdx_indx.txt`` /
``dHdt_indx.txt``, format in utils/data_io.py).  With the unnormalised
Cayley matrix M(r) = (1 + |r|^2) R(r) (models/trifocal.cayley_to_rotation):

* point equations, points i = 1..3, views j = 2, 3 (18 equations):
      a_ij X_ij = M(r_j) a_i1 X_i1 + T_j,          X = (x, y, 1)
* tangent equations, tangents i = 1, 2, views j = 2, 3 (12 equations):
      u_ij X_ij + e_ij D_ij = M(r_j) (u_i1 X_i1 + e_i1 D_i1),   D = (tx, ty, 0)

Unknowns (30): x[0:8] the depths a12 a13 a21 a22 a23 a31 a32 a33 (a11 is a
gauge parameter), x[8:12] e12 e13 e22 e23, x[12:18] u11 u12 u13 u21 u22
u23, x[18:21] T21, x[21:24] T31, x[24:27] r21, x[27:30] r31.

Parameters (33, ops/ransac.build_target_params): p[6i + 2j + c] the image
location of point i in view j (c = x, y), p[18 + 6i + 2j + c] the image
tangent of tangent i in view j, p[30:33] the gauges a11, e11, e21.
Parameter slot 33 is the constant 1 and variable slot 30 the homogeneous 1.

Run as a module to rewrite the committed tables:
    python -m trifocal_pose_estimation_using_improved_gpuhc_tpu.models.system
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

NUM_VARS = 30
NUM_PARAMS = 33
P_ONE = NUM_PARAMS  # constant-1 parameter slot
V_ONE = NUM_VARS    # homogeneous-1 variable slot
HX_TERMS, HX_PARTS = 8, 5
HT_TERMS, HT_PARTS = 16, 6

# Monomial key: (sorted parameter indices, sorted variable indices).
Key = Tuple[Tuple[int, ...], Tuple[int, ...]]


class Poly:
    """Sparse polynomial in parameters and variables, integer coefficients."""

    def __init__(self, terms: Dict[Key, int] = None):
        self.terms = {k: c for k, c in (terms or {}).items() if c}

    @staticmethod
    def const(c: int) -> "Poly":
        return Poly({((), ()): c})

    @staticmethod
    def param(i: int) -> "Poly":
        return Poly({((i,), ()): 1})

    @staticmethod
    def var(i: int) -> "Poly":
        return Poly({((), (i,)): 1})

    def __add__(self, other: "Poly") -> "Poly":
        out = defaultdict(int, self.terms)
        for k, c in other.terms.items():
            out[k] += c
        return Poly(out)

    def __neg__(self) -> "Poly":
        return Poly({k: -c for k, c in self.terms.items()})

    def __sub__(self, other: "Poly") -> "Poly":
        return self + (-other)

    def __mul__(self, other) -> "Poly":
        if isinstance(other, int):
            return Poly({k: c * other for k, c in self.terms.items()})
        out = defaultdict(int)
        for (pa, va), ca in self.terms.items():
            for (pb, vb), cb in other.terms.items():
                out[(tuple(sorted(pa + pb)), tuple(sorted(va + vb)))] += ca * cb
        return Poly(out)

    __rmul__ = __mul__

    def diff(self, v: int) -> "Poly":
        """d/dx_v."""
        out = defaultdict(int)
        for (p, vs), c in self.terms.items():
            n = vs.count(v)
            if n:
                rest = list(vs)
                rest.remove(v)
                out[(p, tuple(rest))] += c * n
        return Poly(out)


def _cayley_matrix(r):
    """Unnormalised Cayley matrix M(r), rows of Polys (util.hpp:31-43)."""
    r1, r2, r3 = r
    one = Poly.const(1)
    return [
        [one + r1 * r1 - r2 * r2 - r3 * r3, 2 * (r1 * r2 - r3),
         2 * (r1 * r3 + r2)],
        [2 * (r1 * r2 + r3), one + r2 * r2 - r1 * r1 - r3 * r3,
         2 * (r2 * r3 - r1)],
        [2 * (r1 * r3 - r2), 2 * (r2 * r3 + r1),
         one + r3 * r3 - r1 * r1 - r2 * r2],
    ]


def loc_param(i: int, j: int, c: int) -> int:
    """Parameter index of image coordinate c of point i in view j (0-based)."""
    return 6 * i + 2 * j + c


def tan_param(i: int, j: int, c: int) -> int:
    """Parameter index of tangent coordinate c of tangent i in view j."""
    return 18 + 6 * i + 2 * j + c


def depth_var(i: int, j: int) -> int:
    """Variable index of depth a_ij (0-based; a_00 is the gauge a11)."""
    return 3 * i + j - 1


def e_var(i: int, j: int) -> int:
    return 8 + 2 * i + (j - 1)


def u_var(i: int, j: int) -> int:
    return 12 + 3 * i + j


A11, E11, E21 = 30, 31, 32  # gauge parameters


def build_equations():
    """The 30 equations as Polys, point equations first."""
    one = Poly.const(1)

    def X(i, j):
        return [Poly.param(loc_param(i, j, 0)), Poly.param(loc_param(i, j, 1)),
                one]

    def D(i, j):
        return [Poly.param(tan_param(i, j, 0)), Poly.param(tan_param(i, j, 1)),
                Poly.const(0)]

    def a(i, j):
        return Poly.param(A11) if (i, j) == (0, 0) else Poly.var(depth_var(i, j))

    def e(i, j):
        if j == 0:
            return Poly.param(E11 if i == 0 else E21)
        return Poly.var(e_var(i, j))

    def u(i, j):
        return Poly.var(u_var(i, j))

    T = {1: [Poly.var(18 + k) for k in range(3)],
         2: [Poly.var(21 + k) for k in range(3)]}
    M = {1: _cayley_matrix([Poly.var(24 + k) for k in range(3)]),
         2: _cayley_matrix([Poly.var(27 + k) for k in range(3)])}

    eqs = []
    for i in range(3):
        for j in (1, 2):
            xj, x1 = X(i, j), X(i, 0)
            for k in range(3):
                rhs = T[j][k]
                for m in range(3):
                    rhs = rhs + M[j][k][m] * a(i, 0) * x1[m]
                eqs.append(a(i, j) * xj[k] - rhs)
    for i in range(2):
        w1 = [u(i, 0) * X(i, 0)[m] + e(i, 0) * D(i, 0)[m] for m in range(3)]
        for j in (1, 2):
            xj, dj = X(i, j), D(i, j)
            for k in range(3):
                rhs = Poly()
                for m in range(3):
                    rhs = rhs + M[j][k][m] * w1[m]
                eqs.append(u(i, j) * xj[k] + e(i, j) * dj[k] - rhs)
    assert len(eqs) == NUM_VARS
    return eqs


def _pad(idx: Tuple[int, ...], n: int, fill: int) -> list:
    return list(idx) + [fill] * (n - len(idx))


def build_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(hx_table (30, 8, 5, 30), ht_table (16, 6, 30)), int32.

    Term parts: Hx (coeff, p1, p2, v1, v2); H (coeff, p1, p2, v1, v2, v3).
    Unused term slots carry coefficient 0 and point at the constant slots.
    """
    eqs = build_equations()
    ht = np.zeros((HT_TERMS, HT_PARTS, NUM_VARS), np.int32)
    ht[:, 1:3, :] = P_ONE
    ht[:, 3:6, :] = V_ONE
    hx = np.zeros((NUM_VARS, HX_TERMS, HX_PARTS, NUM_VARS), np.int32)
    hx[:, :, 1:3, :] = P_ONE
    hx[:, :, 3:5, :] = V_ONE
    for e, eq in enumerate(eqs):
        terms = sorted(eq.terms.items())
        if len(terms) > HT_TERMS:
            raise ValueError(f"equation {e} has {len(terms)} H terms")
        for j, ((ps, vs), c) in enumerate(terms):
            ht[j, :, e] = [c] + _pad(ps, 2, P_ONE) + _pad(vs, 3, V_ONE)
        for v in range(NUM_VARS):
            dterms = sorted(eq.diff(v).terms.items())
            if len(dterms) > HX_TERMS:
                raise ValueError(f"dH{e}/dx{v} has {len(dterms)} terms")
            for j, ((ps, vs), c) in enumerate(dterms):
                hx[v, j, :, e] = [c] + _pad(ps, 2, P_ONE) + _pad(vs, 2, V_ONE)
    return hx, ht


def rotation_to_cayley(r: np.ndarray) -> np.ndarray:
    """Inverse Cayley map: S = (R - I)(R + I)^-1, r = vee(S)."""
    s = (r - np.eye(3)) @ np.linalg.inv(r + np.eye(3))
    return np.array([s[2, 1], s[0, 2], s[1, 0]])


def root_from_view(params: np.ndarray, poses) -> np.ndarray:
    """The root (30,) of the system at a real parameter point, from the pose.

    params: (>= 33,) real parameters of one sampled triplet (locations,
    tangents, gauges; ops/ransac.build_target_params); poses: ((R21, t21),
    (R31, t31)) with view_j = R view_1 + t.  The correspondences must be
    exact (noise-free inliers): depths are triangulated, the tangent
    unknowns come from the 3D tangent direction in each view.
    """
    p = np.asarray(params, np.float64).real
    x = np.zeros(NUM_VARS)

    def X(i, j):
        return np.array([p[loc_param(i, j, 0)], p[loc_param(i, j, 1)], 1.0])

    def D(i, j):
        return np.array([p[tan_param(i, j, 0)], p[tan_param(i, j, 1)], 0.0])

    cays = [rotation_to_cayley(r) for r, _ in poses]
    s = [1.0 + c @ c for c in cays]
    # Depths in view 1 from view 2 (d_i2 X_i2 - d_i1 R X_i1 = t), then the
    # global scale fixed by the gauge a11.
    r21, t21 = poses[0]
    d1 = np.array([
        np.linalg.lstsq(np.stack([-(r21 @ X(i, 0)), X(i, 1)], axis=1), t21,
                        rcond=None)[0][0]
        for i in range(3)
    ])
    lam = p[A11] / d1[0]
    for i in range(1, 3):
        x[depth_var(i, 0)] = lam * d1[i]
    for j, ((r, t), cay, sj) in enumerate(zip(poses, cays, s), start=1):
        x[24 + 3 * (j - 1):27 + 3 * (j - 1)] = cay
        x[18 + 3 * (j - 1):21 + 3 * (j - 1)] = sj * lam * t
        for i in range(3):
            x[depth_var(i, j)] = sj * lam * (r @ (d1[i] * X(i, 0)) + t)[2]
    for i, e1 in enumerate((p[E11], p[E21])):
        # 3D tangent w = u X + e D in view 1, with e the gauge, chosen so
        # that R21 w lies in view 2's plane spanned by X_i2 and D_i2.
        n = np.cross(X(i, 1), D(i, 1))
        u1 = -e1 * (r21 @ D(i, 0)) @ n / ((r21 @ X(i, 0)) @ n)
        x[u_var(i, 0)] = u1
        w = u1 * X(i, 0) + e1 * D(i, 0)
        for j, ((r, _), sj) in enumerate(zip(poses, s), start=1):
            coef = np.linalg.lstsq(np.stack([X(i, j), D(i, j)], axis=1),
                                   sj * (r @ w), rcond=None)[0]
            x[u_var(i, j)] = coef[0]
            x[e_var(i, j)] = coef[1]
    return x


def is_degenerate(x: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """(B,) mask of roots where a Cayley matrix loses rank (1 + r.r = 0).

    Such points solve the polynomial system, since M(r) = (1 + |r|^2) R(r)
    is then no scaled rotation, but they are no pose: the 312 roots of the
    trifocal problem are the others.
    """
    x = np.asarray(x)
    s21 = 1 + np.sum(x[:, 24:27] ** 2, axis=1)
    s31 = 1 + np.sum(x[:, 27:30] ** 2, axis=1)
    return (np.abs(s21) < tol) | (np.abs(s31) < tol)


def evaluate_np(hx_table: np.ndarray, ht_table: np.ndarray, x: np.ndarray,
                p: np.ndarray):
    """(H (B, E), Hx (B, E, V)) in the dtype of x, from the index tables.

    Plain numpy mirror of ops/eval.eval_H_direct / eval_Hx_direct, used
    where float64 is wanted (start-system polishing).  x: (B, V); p: (B,
    P+1) with the constant-1 slot.
    """
    xp = np.concatenate([x, np.ones(x.shape[:-1] + (1,), x.dtype)], axis=-1)
    c = ht_table[:, 0, :]
    h = np.einsum("te,bte->be", c, p[:, ht_table[:, 1, :]]
                  * p[:, ht_table[:, 2, :]] * xp[:, ht_table[:, 3, :]]
                  * xp[:, ht_table[:, 4, :]] * xp[:, ht_table[:, 5, :]])
    cx = hx_table[:, :, 0, :]
    hx = np.einsum("vje,bvje->bev", cx, p[:, hx_table[:, :, 1, :]]
                   * p[:, hx_table[:, :, 2, :]] * xp[:, hx_table[:, :, 3, :]]
                   * xp[:, hx_table[:, :, 4, :]])
    return h, hx


def newton_polish(hx_table, ht_table, x: np.ndarray, p: np.ndarray,
                  iters: int = 6):
    """Newton-refine roots (B, V) at parameters p (P+1,) in complex128.

    Returns (x, residual (B,)), the residual being max |H|."""
    x = np.asarray(x, np.complex128)
    pb = np.broadcast_to(np.asarray(p, np.complex128), (x.shape[0],) + p.shape)
    for _ in range(iters):
        h, hx = evaluate_np(hx_table, ht_table, x, pb)
        x = x - np.linalg.solve(hx, h[..., None])[..., 0]
    h, _ = evaluate_np(hx_table, ht_table, x, pb)
    return x, np.abs(h).max(axis=-1)


def write_tables(out_dir: str) -> None:
    """Write dHdx_indx.txt / dHdt_indx.txt (rows of 30 ints, one column per
    equation; utils/data_io.load_problem_data reads them back)."""
    hx, ht = build_tables()
    os.makedirs(out_dir, exist_ok=True)
    for name, tab in (("dHdx_indx.txt", hx), ("dHdt_indx.txt", ht)):
        rows = tab.reshape(-1, NUM_VARS)
        with open(os.path.join(out_dir, name), "w") as f:
            for row in rows:
                f.write("\t".join(str(int(v)) for v in row) + "\n")


def main(argv=None) -> int:
    import argparse

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        PACKAGE_PROBLEMS_DIR,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(
        PACKAGE_PROBLEMS_DIR, "trifocal_2op1p_30x30"))
    args = ap.parse_args(argv)
    write_tables(args.out_dir)
    print(f"wrote index tables to {args.out_dir}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
