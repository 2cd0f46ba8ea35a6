"""Batched evaluators for the homotopy H, Jacobian Hx, and -Ht.

Two implementations with identical semantics:

* ``eval_*_direct`` -- straight re-expression of the reference's indexed
  evaluation (gpu-idx-evals/dev-eval-indxing-...LimUnroll_L2Cache.cuh:57-148)
  as jnp gathers + einsum over the term axis. Used as the oracle and in tests.

* ``eval_all_factored`` -- the production path: monomial-factored form (see
  models/trifocal.py docstring) where the term contraction becomes small
  real matmuls. Hx, H and -Ht share the monomial/parameter-product
  vectors, so the three evaluations are fused into one call.

Conventions (matching the reference):
  x:   (B, num_vars) complex64 current solutions (homogeneous slot appended
       internally; var index num_vars reads 1).
  p:   (B, num_params + 1) complex64 parameter-homotopy values p(t) with the
       constant-1 slot at index num_params.
  Hx[b, e, v] = dH_e/dx_v;  minus_ht = -dH/dt (the sign the RK solve wants:
  dx/dt = Hx^{-1} . (-Ht), eval_Jacobian_Ht accumulates negated,
  ...LimUnroll_L2Cache.cuh:109-118).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
    TrifocalProblem,
    pad_vars,
)


def param_homotopy(
    t: jnp.ndarray, start_params: jnp.ndarray, target_params: jnp.ndarray
) -> jnp.ndarray:
    """p(t) = t * target + (1 - t) * start, per path.

    Mirrors compute_param_homotopy (...LimUnroll_L2Cache.cuh:40-54); the
    constant-1 slot stays 1 because both inputs carry it.

    t: (B,) float32; start: (P+1,); target: (B, P+1) -> (B, P+1) complex64.
    """
    # Promote t to the parameter dtype so the float64 oracle (jax x64 on
    # CPU, tools/f64_reconcile.py) keeps full precision end to end.
    tc = t.astype(jnp.result_type(t.dtype, target_params.dtype))[..., None]
    return target_params * tc + start_params * (1.0 - tc)


def eval_H_direct(problem: TrifocalProblem, x: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """H(x, t): (B, num_eqs). Reference eval_Homotopy (...cuh:121-148)."""
    tbl = problem.ht_table
    xp = pad_vars(x)
    c = tbl[:, 0, :].astype(jnp.float32)
    pp = jnp.take(p, tbl[:, 1, :], axis=-1) * jnp.take(p, tbl[:, 2, :], axis=-1)
    xx = (
        jnp.take(xp, tbl[:, 3, :], axis=-1)
        * jnp.take(xp, tbl[:, 4, :], axis=-1)
        * jnp.take(xp, tbl[:, 5, :], axis=-1)
    )
    return jnp.einsum("te,bte->be", c.astype(pp.dtype), pp * xx, precision=jax.lax.Precision.HIGHEST)


def eval_minus_Ht_direct(
    problem: TrifocalProblem, x: jnp.ndarray, p: jnp.ndarray, diff_params: jnp.ndarray
) -> jnp.ndarray:
    """-dH/dt: (B, num_eqs). Reference eval_Jacobian_Ht (...cuh:92-119).

    diff_params = target - start per path (B, P+1); its constant slot is 0, so
    product-rule terms touching the constant vanish.
    """
    tbl = problem.ht_table
    xp = pad_vars(x)
    c = tbl[:, 0, :].astype(jnp.float32)
    i1, i2 = tbl[:, 1, :], tbl[:, 2, :]
    dpp = jnp.take(diff_params, i1, axis=-1) * jnp.take(p, i2, axis=-1) + jnp.take(
        diff_params, i2, axis=-1
    ) * jnp.take(p, i1, axis=-1)
    xx = (
        jnp.take(xp, tbl[:, 3, :], axis=-1)
        * jnp.take(xp, tbl[:, 4, :], axis=-1)
        * jnp.take(xp, tbl[:, 5, :], axis=-1)
    )
    return -jnp.einsum("te,bte->be", c.astype(dpp.dtype), dpp * xx, precision=jax.lax.Precision.HIGHEST)


def eval_Hx_direct(problem: TrifocalProblem, x: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Hx(x, t): (B, num_eqs, num_vars). Reference eval_Jacobian_Hx (...cuh:57-88)."""
    tbl = problem.hx_table
    xp = pad_vars(x)
    c = tbl[:, :, 0, :].astype(jnp.float32)
    pp = jnp.take(p, tbl[:, :, 1, :], axis=-1) * jnp.take(p, tbl[:, :, 2, :], axis=-1)
    xx = jnp.take(xp, tbl[:, :, 3, :], axis=-1) * jnp.take(xp, tbl[:, :, 4, :], axis=-1)
    return jnp.einsum("vje,bvje->bev", c.astype(pp.dtype), pp * xx, precision=jax.lax.Precision.HIGHEST)


def _complex_matmul_real(z: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """(B, K) complex @ (K, N) real -> (B, N) complex, as two real matmuls."""
    # HIGHEST: a float32 matmul may otherwise run in TF32 on the GPU,
    # which destroys the Newton corrector's 1e-6 relative tolerance.
    re = jnp.dot(jnp.real(z), c, precision=jax.lax.Precision.HIGHEST)
    im = jnp.dot(jnp.imag(z), c, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.complex(re, im)


def eval_all_factored(
    problem: TrifocalProblem,
    x: jnp.ndarray,
    p: jnp.ndarray,
    diff_params: jnp.ndarray,
    need_h: bool = True,
    need_ht: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused (Hx, H, -Ht) in the monomial-factored form.

    Returns Hx (B, E, V) always; H and -Ht (B, E) or None per the flags.
    """
    f = problem.factored
    n = problem.num_vars
    xp = pad_vars(x)

    # Parameter-pair products and, if needed, their t-derivatives.
    pa = jnp.take(p, f.pp_a, axis=-1)
    pb = jnp.take(p, f.pp_b, axis=-1)
    P = pa * pb  # (B, Q)

    # Quadratic variable monomials -> Hx.
    X2 = jnp.take(xp, f.qm_a, axis=-1) * jnp.take(xp, f.qm_b, axis=-1)  # (B, M2)
    PX2 = jnp.take(P, f.hx_q, axis=-1) * jnp.take(X2, f.hx_m, axis=-1)  # (B, K2)
    hx_nz = _complex_matmul_real(PX2, f.hx_C)  # (B, NNZ)
    zero = jnp.zeros(hx_nz.shape[:-1] + (1,), dtype=hx_nz.dtype)
    hx_padded = jnp.concatenate([hx_nz, zero], axis=-1)
    hx = jnp.take(hx_padded, f.hx_scatter, axis=-1).reshape(x.shape[0], n, n)

    h = mht = None
    if need_h or need_ht:
        X3 = (
            jnp.take(xp, f.cm_a, axis=-1)
            * jnp.take(xp, f.cm_b, axis=-1)
            * jnp.take(xp, f.cm_c, axis=-1)
        )  # (B, M3)
        X3g = jnp.take(X3, f.ht_m, axis=-1)  # (B, K3)
        if need_h:
            PX3 = jnp.take(P, f.ht_q, axis=-1) * X3g
            h = _complex_matmul_real(PX3, f.ht_C)
        if need_ht:
            da = jnp.take(diff_params, f.pp_a, axis=-1)
            db = jnp.take(diff_params, f.pp_b, axis=-1)
            dP = da * pb + db * pa  # product rule on the pair
            dPX3 = jnp.take(dP, f.ht_q, axis=-1) * X3g
            mht = -_complex_matmul_real(dPX3, f.ht_C)
    return hx, h, mht
