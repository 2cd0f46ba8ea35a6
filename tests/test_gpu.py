"""Checks that need a GPU; they skip elsewhere (see conftest.py).

chip_smoke.py runs the same checks at deployment size."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_gpu_lu_pivots_on_reference_metric(gpu):
    """The CUDA libraries' batched LU pivots on |Re| + |Im| as well."""
    import jax
    import jax.numpy as jnp

    a = np.array([[3.0, 1.0], [2.0 + 2.0j, 1.0]], np.complex64)
    _, pivots, _ = jax.jit(jax.lax.linalg.lu)(jnp.asarray(a))
    assert int(pivots[0]) == 1


def test_gpu_round_agrees_with_cpu_oracle(gpu, cfg):
    """Two hypotheses on the card vs the plain oracle on the CPU, under
    the CLI cross-check bands."""
    import jax

    from trifocal_pose_estimation_using_improved_gpuhc_tpu import cli
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.engine import (
        TrifocalPoseEngine,
    )

    engine = TrifocalPoseEngine(cfg)
    view = engine.load_view(0)
    rr = engine.run_round(view, seed=0, num_hypotheses=2,
                          collect_solutions=True)
    with jax.default_device(jax.devices("cpu")[0]):
        ro = engine.oracle_round(view, seed=0, num_hypotheses=2)
    ok, report = cli.compare_rounds(rr, ro, 2 * engine.problem.num_tracks)
    assert ok, report
