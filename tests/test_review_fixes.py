"""Regression tests for code-review findings."""

import numpy as np
import pytest

from cmtci.geometry import alpha_shape
from cmtci.maps import qc
from cmtci.stats.spectral import reconstruct_low_modes
from cmtci.transport.sinkhorn import entropic_argmax_match


def test_pinch_vertex_face_walk_separates_triangles():
    # two triangles sharing exactly one vertex (bowtie): the boundary walk
    # must yield two 3-vertex loops, not one merged self-intersecting walk
    pts = np.array([
        [0.0, 0.0],      # 0: pinch vertex V
        [-2.0, 0.35],    # 1
        [-2.0, 0.05],    # 2
        [2.0, 0.105],    # 3
        [1.0, 1.8],      # 4
    ])
    for kept in (np.array([[0, 1, 2], [0, 3, 4]]),
                 np.array([[0, 2, 4], [0, 3, 1]])):
        loops = alpha_shape.directed_boundary_loops(pts, kept)
        assert len(loops) == 2, loops
        assert sorted(len(l) for l in loops) == [3, 3]
        got = {frozenset(l) for l in loops}
        want = {frozenset(t.tolist()) for t in kept}
        assert got == want


def test_matcher_handles_unequal_xy_arrays(rng):
    x = rng.normal(size=(100, 2))
    y = rng.normal(size=(50, 2))
    my, mx = entropic_argmax_match(x, y, rng=np.random.RandomState(0))
    assert my.shape == (50, 2) and mx.shape == (50, 2)
    my2, mx2 = entropic_argmax_match(y, x, rng=np.random.RandomState(0))
    assert my2.shape == (50, 2)


def test_blocked_mean_matches_full(rng):
    import jax.numpy as jnp

    from cmtci.transport.sinkhorn import _blocked_mean_dist, _pairwise_dist

    a = rng.normal(size=(300, 2))
    b = rng.normal(size=(200, 2))
    got = float(_blocked_mean_dist(jnp.asarray(a), jnp.asarray(b), chunk=64))
    ref = float(np.mean(np.asarray(_pairwise_dist(jnp.asarray(a), jnp.asarray(b)))))
    assert got == pytest.approx(ref, rel=1e-12)


def test_reconstruct_single_mode_is_dc_only(rng):
    z = rng.normal(size=32) + 1j * rng.normal(size=32)
    f = np.fft.fft(z)
    rec = reconstruct_low_modes(f, 1)
    np.testing.assert_allclose(rec, np.full(32, z.mean()), atol=1e-12)


def test_triangle_gradients_tiny_negative_det():
    pts = np.array([[0.0, 0.0], [1.0, 1e-31], [1.0, 0.0]])
    tris = np.array([[0, 1, 2]])
    g = qc.triangle_gradients(pts, tris, np.array([0.0, 1.0, 2.0]))
    assert np.all(np.isfinite(g))


# --- round-2 review findings ---


def test_sparser_n1_falls_back_to_horner():
    """The closed-form identity assumes c_2=0 exists (n>=2); n=1 must fall
    back to the generic Horner and still match LAPACK."""
    from cmtci.kernels import companion

    from scipy.optimize import linear_sum_assignment

    zr, zi, valid = companion.eigvals_batched([1, 2, 5], "sparser_gap_1_0_1_then_ones")
    z = np.asarray(zr) + 1j * np.asarray(zi)
    for b, n in enumerate([1, 2, 5]):
        ref = np.linalg.eigvals(
            companion.companion_matrix(companion.family_top_row("sparser_gap_1_0_1_then_ones", n)))
        got = z[b][np.asarray(valid)[b]]
        cost = np.abs(got[:, None] - ref[None, :])
        r, c = linear_sum_assignment(cost)
        assert cost[r, c].max() < 1e-8


def test_fft_reconstruction_plot_odd_modes(tmp_path):
    """Odd/short mode lists must not overflow the subplot grid."""
    from cmtci.io import plots

    t = np.linspace(0, 2 * np.pi, 80, endpoint=False)
    pts = np.column_stack([np.cos(t), np.sin(t)])
    for modes in ((5,), (5, 10), (5, 10, 30)):
        plots.plot_fft_reconstructions(pts, pts * 0.9,
                                       str(tmp_path / f"fft{len(modes)}.png"),
                                       modes=modes)


def test_lucas_boundary_cached_path_writes_meta(tmp_path):
    import os

    from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary

    cfg = LucasBoundaryConfig(n_max=25, n_boundary=100)
    out = str(tmp_path / "lp.npy")
    export_lucas_boundary(cfg, out, cache_dir=str(tmp_path / "cache"))
    assert os.path.exists(f"{out}_meta.txt")
