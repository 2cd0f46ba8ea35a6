"""The symbolic system builder and the committed start system."""

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    monodromy,
    system,
    trifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import ransac
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import data_io


@pytest.fixture(scope="module")
def tables():
    return system.build_tables()


def test_builder_reproduces_committed_tables(problem, tables):
    hx, ht = tables
    np.testing.assert_array_equal(hx, problem.hx_table)
    np.testing.assert_array_equal(ht, problem.ht_table)


def test_builder_structure_pins(tables):
    """The evaluator sizes of ProblemConfig (reference gpuhc_settings.yaml)
    bound the generated tables, and the factored structure keeps the
    reference tables' 170 Jacobian nonzeros and 47/115 monomials."""
    hx, ht = tables
    assert hx.shape == (30, 8, 5, 30) and ht.shape == (16, 6, 30)
    assert (ht[:, 0, :] != 0).sum(axis=0).max() == 16
    assert (hx[:, :, 0, :] != 0).sum(axis=1).max() == 8
    f = trifocal._factor_tables(hx, ht)
    assert f.hx_C.shape[1] == 170
    assert (len(f.qm_a), len(f.cm_a)) == (47, 115)


def test_write_tables_roundtrip(tables, tmp_path):
    system.write_tables(str(tmp_path))
    hx = np.loadtxt(tmp_path / "dHdx_indx.txt").astype(np.int32)
    ht = np.loadtxt(tmp_path / "dHdt_indx.txt").astype(np.int32)
    np.testing.assert_array_equal(hx.reshape(30, 8, 5, 30), tables[0])
    np.testing.assert_array_equal(ht.reshape(16, 6, 30), tables[1])


@pytest.mark.parametrize("view_index", [0, 7])
def test_ground_truth_root_solves_system(cfg, tables, view_index):
    """At a real parameter point from exact inlier edgels, the root built
    from the ground-truth pose satisfies all 30 equations and has positive
    depths (the TrunPaths / candidate-gate convention)."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
        synthcurves,
    )

    view = synthcurves.generate_view(view_index, outlier_ratio=0.0)
    s = ransac.sample_edgel_triplets(view_index, view.edge_locations.shape[0],
                                     3)
    params = ransac.build_target_params(
        view.edge_locations.astype(np.float64),
        view.edge_tangents.astype(np.float64), s).astype(np.complex128)
    poses = [(p[:, :3].astype(np.float64), p[:, 3].astype(np.float64))
             for p in (view.gt_pose21, view.gt_pose31)]
    for p in params:
        x = system.root_from_view(p.real, poses)
        h, _ = system.evaluate_np(*tables, x[None].astype(np.complex128),
                                  p[None])
        assert np.abs(h).max() < 1e-5
        assert (x[0:8] > 0).all()


def test_committed_roots_distinct_and_solve_start_system(problem):
    """312 distinct roots; each solves H(x, p0) = 0 in complex128 and
    Newton leaves it where it is."""
    sols = np.asarray(problem.start_sols, np.complex128)
    assert sols.shape == (312, 30)
    p0 = np.asarray(problem.start_params, np.complex128)
    x, res = system.newton_polish(problem.hx_table, problem.ht_table, sols,
                                  p0, iters=2)
    assert res.max() < monodromy.RESIDUAL_TOL
    scale = np.maximum(1.0, np.abs(x).max(axis=1))
    assert (np.abs(x - sols).max(axis=1) < 1e-5 * scale).all()
    d = np.abs(x[:, None, :] - x[None, :, :]).max(axis=-1)
    d[np.arange(312), np.arange(312)] = np.inf
    assert d.min() > 1e-3


def test_committed_start_params_are_generic(problem):
    """The start point is complex: real parameters would make roots
    collide in conjugate pairs and tracking non-generic."""
    p0 = np.asarray(problem.start_params)[:-1]
    assert p0.shape == (33,)
    assert (np.abs(p0.imag) > 1e-3).mean() > 0.9


def test_problem_data_loads_from_reference_layout(problem, tmp_path):
    """--data-root trees keep the reference layout: the loader reads the
    committed files back unchanged from problems/<name>/."""
    res = monodromy.MonodromyResult(
        params=np.asarray(problem.start_params),
        solutions=np.asarray(problem.start_sols),
        loops_run=0, history=[],
    )
    d = tmp_path / "problems" / "trifocal_2op1p_30x30"
    d.mkdir(parents=True)
    monodromy.write_start_system(str(d / "start_params.txt"),
                                 str(d / "start_sols.txt"), res)
    system.write_tables(str(d))
    pd = data_io.load_problem_data(str(d))
    np.testing.assert_array_equal(pd.start_sols, problem.start_sols)
    np.testing.assert_array_equal(pd.hx_table, problem.hx_table)
