"""Framework generality: the evaluator/solver pipeline is table-driven.

The trifocal 2op1p system is the shipped problem, but nothing in
models/trifocal.py or the evaluators is specific to it: any minimal problem
expressed in the reference's index-table format (dHdx: [coeff, p1, p2, v1,
v2], dHdt: [coeff, p1, p2, v1, v2, v3], Data_Reader.cpp:123-189) flows
through the same factoring and evaluation machinery.  These tests build a
RANDOM synthetic problem and check internal consistency end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as ev


def _random_problem(rng, n_vars=6, n_params=5, ht_terms=4, hx_terms=3):
    """Random H as a term list, with hx tables derived symbolically."""
    n_eqs = n_vars
    # H terms: coeff * p[a] * p[b] * x[u] * x[v] * x[w]  (v3 may be the
    # homogeneous slot n_vars, like the reference's padding).
    ht = np.zeros((ht_terms, 6, n_eqs), np.int64)
    for e in range(n_eqs):
        for t in range(ht_terms):
            c = rng.integers(-3, 4)
            ht[t, 0, e] = c
            ht[t, 1, e] = rng.integers(0, n_params + 1)  # may hit const slot
            ht[t, 2, e] = rng.integers(0, n_params + 1)
            ht[t, 3, e] = rng.integers(0, n_vars + 1)
            ht[t, 4, e] = rng.integers(0, n_vars + 1)
            ht[t, 5, e] = rng.integers(0, n_vars + 1)
    # Derive dHdx symbolically from the product rule on the var triples.
    hx = np.zeros((n_vars, hx_terms * 3, 5, n_eqs), np.int64)
    counts = np.zeros((n_vars, n_eqs), np.int64)
    for e in range(n_eqs):
        for t in range(ht_terms):
            c = ht[t, 0, e]
            if c == 0:
                continue
            tri = [ht[t, 3, e], ht[t, 4, e], ht[t, 5, e]]
            for k in range(3):
                v = tri[k]
                if v >= n_vars:  # homogeneous slot: derivative is zero
                    continue
                rest = [tri[j] for j in range(3) if j != k]
                slot = counts[v, e]
                hx[v, slot, 0, e] = c
                hx[v, slot, 1, e] = ht[t, 1, e]
                hx[v, slot, 2, e] = ht[t, 2, e]
                hx[v, slot, 3, e] = rest[0]
                hx[v, slot, 4, e] = rest[1]
                counts[v, e] += 1
    max_terms = int(counts.max())
    hx = hx[:, :max_terms]
    # Zero-coefficient padding terms point at the constant slots, like the
    # reference tables.
    return hx.astype(np.int32), ht.astype(np.int32), n_vars, n_params


def _mk_problem(hx, ht, n_vars, n_params):
    start_params = (
        np.random.default_rng(0).standard_normal(n_params)
        + 1j * np.random.default_rng(1).standard_normal(n_params)
    ).astype(np.complex64)
    start_params = np.concatenate([start_params, np.ones(1, np.complex64)])
    return trifocal.TrifocalProblem(
        num_vars=n_vars,
        num_params=n_params,
        num_tracks=4,
        start_params=start_params,
        start_sols=np.zeros((4, n_vars), np.complex64),
        hx_table=hx,
        ht_table=ht,
        factored=trifocal._factor_tables(hx, ht),
    )


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(42)
    hx, ht, nv, npar = _random_problem(rng)
    return _mk_problem(hx, ht, nv, npar), nv, npar


def test_factored_matches_direct_on_random_tables(synth):
    problem, nv, npar = synth
    rng = np.random.default_rng(7)
    B = 5
    x = (rng.standard_normal((B, nv)) + 1j * rng.standard_normal((B, nv))).astype(np.complex64)
    p = (rng.standard_normal((B, npar + 1)) + 1j * rng.standard_normal((B, npar + 1))).astype(np.complex64)
    p[:, npar] = 1.0
    d = (rng.standard_normal((B, npar + 1)) + 1j * rng.standard_normal((B, npar + 1))).astype(np.complex64)
    d[:, npar] = 0.0
    hx_f, h_f, mht_f = ev.eval_all_factored(
        problem, jnp.asarray(x), jnp.asarray(p), jnp.asarray(d)
    )
    np.testing.assert_allclose(
        np.asarray(h_f), np.asarray(ev.eval_H_direct(problem, x, p)),
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(hx_f), np.asarray(ev.eval_Hx_direct(problem, x, p)),
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(mht_f),
        np.asarray(ev.eval_minus_Ht_direct(problem, x, p, d)),
        rtol=2e-4, atol=2e-4,
    )


def test_hx_is_jacobian_of_h_on_random_tables(synth):
    """Symbolic dHdx tables == autodiff of the H evaluator."""
    problem, nv, npar = synth
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(nv) + 1j * rng.standard_normal(nv)).astype(np.complex64)
    p = (rng.standard_normal(npar + 1) + 1j * rng.standard_normal(npar + 1)).astype(np.complex64)
    p[npar] = 1.0

    def h_of_x(xv):
        return ev.eval_H_direct(problem, xv[None], jnp.asarray(p)[None])[0]

    jac = jax.jacfwd(h_of_x, holomorphic=True)(jnp.asarray(x))
    hx = ev.eval_Hx_direct(problem, x[None], p[None])[0]
    np.testing.assert_allclose(np.asarray(hx), np.asarray(jac), rtol=2e-4, atol=2e-4)
