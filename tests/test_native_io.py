"""Native data-plane parser (native/fastio.c) vs the numpy path."""

import numpy as np

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
    data_io,
    native,
)


def test_parse_floats_matches_numpy(cfg, tmp_path):
    """A view triplet written in the reference's Triplet_Edgels format
    (x y tx ty per view, 12 floats a line) parses exactly as numpy does."""
    view = data_io.load_view(cfg, 0)
    rows = np.concatenate(
        [np.concatenate([view.edge_locations[:, 2 * v:2 * v + 2],
                         view.edge_tangents[:, 2 * v:2 * v + 2]], axis=1)
         for v in range(3)], axis=1)
    p = tmp_path / "Triplet_Edgels_000.txt"
    np.savetxt(p, rows, fmt="%.9g")
    a = native.parse_floats(str(p))
    b = np.loadtxt(p).reshape(-1)
    np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_parse_floats_fallback(monkeypatch, tmp_path):
    f = tmp_path / "x.txt"
    f.write_text("1.5 -2  3e4\n\t7.25\n")
    # Force the numpy fallback path.
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_allclose(
        native.parse_floats(str(f)), [1.5, -2.0, 3e4, 7.25]
    )
    monkeypatch.undo()
    # And whichever path is active by default handles ragged rows too.
    np.testing.assert_allclose(
        native.parse_floats(str(f)), [1.5, -2.0, 3e4, 7.25]
    )
