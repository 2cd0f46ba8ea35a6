"""Golden tests for the homotopy evaluators.

Validates the decoded index-table semantics against mathematical ground truth:
H(start_sols, t=0) = 0 (the start system is solved by the start solutions),
Hx = dH/dx and -Ht = -dH/dt via jax autodiff, and the factored (matmul) evaluator
against the direct (oracle) one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
    pad_params,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as ev


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def _random_targets(problem, rng, n):
    # Random complex perturbations of the start params as fake targets.
    base = np.asarray(problem.start_params)
    tgt = base[None, :] + 0.3 * (
        rng.standard_normal((n, base.shape[0]))
        + 1j * rng.standard_normal((n, base.shape[0]))
    ).astype(np.complex64)
    tgt[:, -1] = 1.0  # constant slot
    return jnp.asarray(tgt)


def test_start_system_solves_to_zero(problem):
    x0 = problem.start_sols  # (312, 30)
    p0 = jnp.broadcast_to(problem.start_params, (x0.shape[0],) + problem.start_params.shape)
    h = ev.eval_H_direct(problem, x0, p0)
    assert jnp.max(jnp.abs(h)) < 5e-4  # complex64 roundoff on O(1) terms


def test_hx_matches_autodiff(problem, rng):
    x = problem.start_sols[:4] + 0.1 * jnp.asarray(
        rng.standard_normal((4, 30)) + 1j * rng.standard_normal((4, 30)),
        dtype=jnp.complex64,
    )
    p = _random_targets(problem, rng, 4)

    def h_single(xi, pi):
        return ev.eval_H_direct(problem, xi[None], pi[None])[0]

    jac = jax.vmap(jax.jacfwd(h_single, argnums=0, holomorphic=True))(x, p)
    hx = ev.eval_Hx_direct(problem, x, p)
    np.testing.assert_allclose(np.asarray(jac), np.asarray(hx), rtol=2e-3, atol=2e-3)


def test_minus_ht_matches_autodiff(problem, rng):
    x = problem.start_sols[:4]
    tgt = _random_targets(problem, rng, 4)
    diff = tgt - problem.start_params
    t = jnp.asarray([0.1, 0.4, 0.7, 0.95], jnp.float32)

    def h_of_t(ti, xi, tgti):
        pi = ev.param_homotopy(ti[None], problem.start_params, tgti[None])
        return ev.eval_H_direct(problem, xi[None], pi)[0]

    # d/dt via complex-step-free finite difference in float64-ish tolerance.
    eps = 1e-3
    fd = jax.vmap(
        lambda ti, xi, tgti: (h_of_t(ti + eps, xi, tgti) - h_of_t(ti - eps, xi, tgti))
        / (2 * eps)
    )(t, x, tgt)
    p = ev.param_homotopy(t, problem.start_params, tgt)
    mht = ev.eval_minus_Ht_direct(problem, x, p, diff)
    np.testing.assert_allclose(np.asarray(-fd), np.asarray(mht), rtol=5e-2, atol=5e-3)


def test_factored_matches_direct(problem, rng):
    n = 8
    x = problem.start_sols[:n] + 0.05 * jnp.asarray(
        rng.standard_normal((n, 30)) + 1j * rng.standard_normal((n, 30)),
        dtype=jnp.complex64,
    )
    tgt = _random_targets(problem, rng, n)
    diff = tgt - problem.start_params
    t = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    p = ev.param_homotopy(t, problem.start_params, tgt)

    hx_f, h_f, mht_f = ev.eval_all_factored(problem, x, p, diff)
    hx_d = ev.eval_Hx_direct(problem, x, p)
    h_d = ev.eval_H_direct(problem, x, p)
    mht_d = ev.eval_minus_Ht_direct(problem, x, p, diff)

    np.testing.assert_allclose(np.asarray(hx_f), np.asarray(hx_d), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(h_f), np.asarray(h_d), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(mht_f), np.asarray(mht_d), rtol=1e-4, atol=1e-4)


def test_factored_structure_counts(problem):
    f = problem.factored
    # 170 / 47 / 115 equal the reference tables' structure (SURVEY.md
    # 2.2-D2).  The generated formulation (models/system.py) needs 34
    # parameter pairs and 258 (pair, quad) combos where the reference's
    # Julia-generated tables listed 38 and 288.  These two counts only size
    # the evaluator's constant matrices; the 312 distinct start roots
    # (tests/test_system.py) are the check that the system is the same.
    assert f.hx_C.shape[1] == 170  # nonzero Hx entries of 900
    assert len(f.qm_a) == 47       # distinct quadratic monomials
    assert len(f.cm_a) == 115      # distinct cubic monomials
    assert len(f.pp_a) == 34       # distinct parameter pairs
    assert f.hx_C.shape[0] == 258  # distinct (pair, quad) combos
