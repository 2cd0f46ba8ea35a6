"""Batched small complex linear solves, vectorised over the path batch.

Plain replacement for MAGMA's warp-cooperative 30x30 complex LU
(dev-cgesv-batched-small.cuh:38-107), which keeps one matrix per warp with
rows in registers: XLA's batched LU with partial pivoting, which on the GPU
is the CUDA libraries' batched getrf/getrs and on the CPU LAPACK's.  Both
pivot on |Re| + |Im| (icamax), the reference's metric
(dev-cgesv-batched-small.cuh:55).
"""

from __future__ import annotations

import jax.numpy as jnp


def solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a[i] @ x[i] = b[i] for each batch element.

    a: (B, N, N), b: (B, N) -> (B, N).  A singular matrix gives inf/NaN
    entries; the tracker rejects such a step like any failed corrector
    (ops/tracker.py), so they never reach the path state.
    """
    return jnp.linalg.solve(a, b[..., None])[..., 0]
