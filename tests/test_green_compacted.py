"""Compaction-staged Green potential: exact parity with the plain kernel."""

import numpy as np

from cmtci.kernels import mandelbrot as mb


def test_compacted_exactly_equals_plain(rng):
    pts = rng.uniform(-2.1, 1.0, 700) + 1j * rng.uniform(-1.6, 1.6, 700)
    g1, k1, p1 = mb.green_potential_compacted(pts, max_iter=1500, stage_iters=128)
    g0, k0, pr, pi = mb.green_potential(pts.real, pts.imag, max_iter=1500)
    g0, k0 = np.asarray(g0), np.asarray(k0)
    p0 = np.asarray(pr) + 1j * np.asarray(pi)
    np.testing.assert_array_equal(g1, g0)
    np.testing.assert_array_equal(k1, k0)
    m = np.isfinite(p0)
    np.testing.assert_array_equal(np.isfinite(p1), m)
    # phi epilogue (exp/cos/sin) runs in numpy vs XLA: last-ulp differences
    np.testing.assert_allclose(p1[m], p0[m], rtol=1e-13)


def test_compacted_stage_boundary_offsets(rng):
    # escape iterations straddling stage boundaries must keep exact k offsets
    pts = rng.uniform(-2.1, 1.0, 300) + 1j * rng.uniform(-1.6, 1.6, 300)
    for stage in (7, 64, 1000):
        g, k, p = mb.green_potential_compacted(pts, max_iter=600, stage_iters=stage)
        g0, k0, pr, pi = mb.green_potential(pts.real, pts.imag, max_iter=600)
        np.testing.assert_array_equal(k, np.asarray(k0))
        np.testing.assert_array_equal(g, np.asarray(g0))
