"""Tests for the batched pivoted complex solver."""

import jax
import jax.numpy as jnp
import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import linalg


def test_solve_matches_numpy():
    rng = np.random.default_rng(1)
    B, N = 16, 30
    a = (rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))).astype(
        np.complex64
    )
    b = (rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N))).astype(
        np.complex64
    )
    x = np.asarray(linalg.solve(jnp.asarray(a), jnp.asarray(b)))
    ref = np.linalg.solve(a.astype(np.complex128), b.astype(np.complex128)[..., None])[..., 0]
    np.testing.assert_allclose(x, ref.astype(np.complex64), rtol=2e-3, atol=2e-4)


def test_solve_needs_pivoting():
    # Zero on the leading diagonal forces a row swap.
    a = np.array(
        [[[0.0, 1.0], [1.0, 0.0]], [[1e-8, 1.0], [1.0, 1.0]]], dtype=np.complex64
    )
    b = np.array([[2.0, 3.0], [1.0, 2.0]], dtype=np.complex64)
    x = np.asarray(linalg.solve(jnp.asarray(a), jnp.asarray(b)))
    ref = np.linalg.solve(a.astype(np.complex128), b.astype(np.complex128)[..., None])[..., 0]
    np.testing.assert_allclose(x, ref.astype(np.complex64), rtol=1e-4, atol=1e-5)


def test_lu_pivots_on_reference_metric():
    """XLA's LU pivots on |Re| + |Im| like the reference's solve
    (dev-cgesv-batched-small.cuh:55), not on the modulus: in column 0,
    2+2j (metric 4, modulus 2.83) beats 3 (metric 3, modulus 3)."""
    a = np.array([[3.0, 1.0], [2.0 + 2.0j, 1.0]], np.complex64)
    _, pivots, _ = jax.lax.linalg.lu(jnp.asarray(a))
    assert int(pivots[0]) == 1
