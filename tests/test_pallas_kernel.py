"""Pallas escape kernel semantics vs the f64 XLA kernels (interpret on CPU)."""

import numpy as np
import pytest

from cmtci.kernels import mandelbrot as mb
from cmtci.kernels.mandelbrot_pallas import mandelbrot_field_pallas

DOM = (-2.1, 0.9, -1.5, 1.5)
#: two block shapes of the Triton-route heads: the default and a wide one
TILES = [(16, 32), (32, 128)]


@pytest.mark.parametrize("tile", TILES)
def test_dwell_matches_f64(tile):
    d32 = np.asarray(mandelbrot_field_pallas(DOM, 256, 64, max_iter=100, kind="dwell", tile=tile))
    cr, ci = mb.complex_grid(DOM, 256, 64)
    ref = np.asarray(mb.dwell_grid(np.asarray(cr), np.asarray(ci), max_iter=100))
    # f32 orbits diverge from f64 near the boundary; >=99% of pixels exact
    assert (d32 == ref).mean() > 0.99
    assert d32.dtype == np.float32


@pytest.mark.parametrize("tile", TILES)
def test_green_matches_f64(tile):
    g32 = np.asarray(mandelbrot_field_pallas(DOM, 256, 64, max_iter=60, kind="green", escape_r=4.0, tile=tile))
    cr, ci = mb.complex_grid(DOM, 256, 64)
    ref = np.asarray(mb.escape_potential_grid(np.asarray(cr), np.asarray(ci), max_iter=60, escape_r=4.0, normalization="two_pow_n"))
    close = np.isclose(g32, ref, rtol=1e-4, atol=1e-7)
    assert close.mean() > 0.99


@pytest.mark.parametrize("tile", TILES)
def test_de_matches_f64(tile):
    d32 = np.asarray(mandelbrot_field_pallas(DOM, 256, 64, max_iter=80, kind="de", escape_r=4.0, tile=tile))
    cr, ci = mb.complex_grid(DOM, 256, 64)
    esc, ref, _, _ = mb.de_field_std(np.asarray(cr), np.asarray(ci), max_iter=80, escape_r=4.0)
    ref = np.asarray(ref)
    close = np.isclose(d32, ref, rtol=1e-3, atol=1e-9)
    assert close.mean() > 0.98


def test_padding_crop_at_non_multiple_grid():
    """A grid that is no block multiple is padded at its own spacing and
    cropped: the result is the top-left corner of a larger grid with the
    same pixel spacing, and still matches the f64 kernel."""
    ny, nx = 37, 100  # neither a multiple of 16 nor of 32
    d = np.asarray(mandelbrot_field_pallas(DOM, nx, ny, max_iter=80))
    assert d.shape == (ny, nx)
    dx = (DOM[1] - DOM[0]) / (nx - 1)
    dy = (DOM[3] - DOM[2]) / (ny - 1)
    big = (DOM[0], DOM[0] + 127 * dx, DOM[2], DOM[2] + 63 * dy)
    full = np.asarray(mandelbrot_field_pallas(big, 128, 64, max_iter=80))
    np.testing.assert_array_equal(d, full[:ny, :nx])
    cr, ci = mb.complex_grid(DOM, nx, ny)
    ref = np.asarray(mb.dwell_grid(np.asarray(cr), np.asarray(ci), max_iter=80))
    assert (d == ref).mean() > 0.99


def test_bucket_shape_is_a_block_multiple_power_of_two():
    from cmtci.kernels.mandelbrot_pallas import _bucket_shape

    for grid_n, tile, want in ((600, (16, 32), (1024, 1024)),
                               (912, (16, 32), (1024, 1024)),
                               (1025, (16, 32), (2048, 2048)),
                               (5, (16, 32), (16, 32))):
        ny, nx = _bucket_shape(grid_n, tile)
        assert (ny, nx) == want
        assert ny % tile[0] == 0 and nx % tile[1] == 0


def test_tile_mismatch_raises():
    # Triton blocks are powers of two
    with pytest.raises(ValueError, match="powers of two"):
        mandelbrot_field_pallas(DOM, 100, 100, kind="dwell", tile=(24, 100))


TCI_DOM = (-2.2, 1.2, -1.6, 1.6)


def test_tci_head_matches_f64_selection():
    """Pallas TCI head (non-latched dz overflow) vs the f64 XLA path.

    The tracker's boundary sampler keeps escaped & d <= q25(d[esc]); the f32
    head must reproduce that selection statistically (VERDICT item 3): f32 dz
    overflows earlier, reclassifying a few late escapers into d == 0.
    """
    from cmtci.kernels.mandelbrot_pallas import tci_de_field_pallas

    esc32, d32 = tci_de_field_pallas(TCI_DOM, 128, max_iter=60, tile=(8, 128), inner=8)
    esc32, d32 = np.asarray(esc32), np.asarray(d32)
    cr, ci = mb.complex_grid(TCI_DOM, 128, 128)
    esc, d, _, _ = mb.de_field_tci(np.asarray(cr), np.asarray(ci), max_iter=60)
    esc, d = np.asarray(esc), np.asarray(d)
    # escape classification near-exact (f32 boundary noise only)
    assert (esc32 == esc).mean() > 0.995
    # overflow semantics: most escaped pixels carry d == 0 in both paths
    assert (d32[esc32] == 0).mean() > 0.5
    assert abs((d32[esc32] == 0).mean() - (d[esc] == 0).mean()) < 0.02
    # the selected boundary-proxy sets overlap almost completely (Jaccard)
    q32 = np.quantile(d32[esc32], 0.25)
    q64 = np.quantile(d[esc], 0.25)
    s32 = esc32 & (d32 <= q32)
    s64 = esc & (d <= q64)
    jac = (s32 & s64).sum() / (s32 | s64).sum()
    assert jac > 0.97


def test_tci_head_via_sampler():
    rng = np.random.RandomState(7)
    pts = mb.sample_boundary_quantile(TCI_DOM, 128, 200, max_iter=60, rng=rng,
                                      impl="pallas")
    assert pts.shape == (200,)
    pts64 = mb.sample_boundary_quantile(TCI_DOM, 128, 200, max_iter=60,
                                        rng=np.random.RandomState(7))
    pts64b = mb.sample_boundary_quantile(TCI_DOM, 128, 200, max_iter=60,
                                         rng=np.random.RandomState(8))
    # statistical equivalence: pallas-vs-f64 TV within the f64 seed-to-seed
    # sampling spread (the 200-point subsample dominates both)
    from cmtci.transport import histogram as hg

    p32 = np.asarray(hg.mollified_histogram(pts, 16, TCI_DOM, 1.0))
    p64 = np.asarray(hg.mollified_histogram(pts64, 16, TCI_DOM, 1.0))
    p64b = np.asarray(hg.mollified_histogram(pts64b, 16, TCI_DOM, 1.0))
    seed_spread = hg.tv_distance(p64, p64b)
    assert hg.tv_distance(p32, p64) < 1.25 * seed_spread


def test_tci_boundary_sample_device_fetch():
    """VERDICT r2 item 5: the pallas sampler fetches O(n_samples) indices;
    every sampled point must lie in the device-selected quantile band, the
    draw is deterministic per seed, and a small band returns all its points."""
    from cmtci.kernels.mandelbrot_pallas import (
        tci_boundary_sample, tci_boundary_selection)

    sel, cnt = tci_boundary_selection(TCI_DOM, 128, max_iter=60)
    band = set()
    xs = np.linspace(TCI_DOM[0], TCI_DOM[1], 128)
    ys = np.linspace(TCI_DOM[2], TCI_DOM[3], 128)
    iy, ix = np.nonzero(sel)
    band = set(zip(xs[ix], ys[iy]))

    pts = tci_boundary_sample(TCI_DOM, 128, 200, seed=3, max_iter=60)
    assert pts.shape == (200,)
    assert len(set(pts)) == 200  # without replacement
    assert all((p.real, p.imag) in band for p in pts)
    # deterministic per seed
    pts2 = tci_boundary_sample(TCI_DOM, 128, 200, seed=3, max_iter=60)
    np.testing.assert_array_equal(pts, pts2)
    # band smaller than n_samples -> all band points, reference's keep-all
    pts_all = tci_boundary_sample(TCI_DOM, 128, len(band) + 500, seed=3,
                                  max_iter=60)
    assert pts_all.shape == (len(band),)
    assert set(zip(pts_all.real, pts_all.imag)) == band


def test_sampler_pallas_guards():
    """ADVICE r2 low: non-default eps and mesh combinations must raise, not
    silently diverge from the jax path."""
    import pytest

    with pytest.raises(ValueError, match="1e-12"):
        mb.sample_boundary_quantile(TCI_DOM, 64, 50, max_iter=30,
                                    impl="pallas", eps=1e-10)
    with pytest.raises(ValueError, match="mesh"):
        mb.sample_boundary_quantile(TCI_DOM, 64, 50, max_iter=30,
                                    impl="pallas", mesh=object())


def test_green_cloud_f32_vs_f64():
    """f32 cloud-green head (round 3): identical escape set, k exact for
    nearly all points, g within f32 trajectory noise, deep escapers keep
    their tiny-but-positive f64-scaled g (no 2^-k underflow)."""
    from cmtci.kernels.mandelbrot_pallas import green_cloud_f32

    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.2, 1.2, 400) + 1j * rng.uniform(-1.6, 1.6, 400)
    # deep escapers near the cardioid cusp (k ~ 200-360 >> the f32 exp range)
    pts = np.concatenate([pts, [0.25 + (np.pi / 200) ** 2, 0.2501,
                                -0.7501 + 0.001j]])
    g64, k64, p64 = mb.green_potential_compacted(pts, max_iter=2000,
                                                 escape_r=2.0)
    g32, k32, p32 = green_cloud_f32(pts, max_iter=2000, escape_r=2.0,
                                    stage_iters=512)
    esc64 = k64 < 2000
    np.testing.assert_array_equal(esc64, k32 < 2000)
    same_k = k64[esc64] == k32[esc64]
    assert same_k.mean() > 0.99
    m = esc64.copy()
    m[esc64] &= same_k
    rel = np.abs(g32[m] - g64[m]) / np.maximum(g64[m], 1e-300)
    assert np.median(rel) < 1e-6
    # the deep escapers: k exact and g positive in the f32-underflow region
    deep = esc64 & (k64 > 126)
    assert deep.sum() >= 3
    assert (g32[deep] > 0).all()
    # g = log|z_k| * 2^-k with |z_k| in (R, ~R^2+|c|) => log2 g + k in (~-1, ~2)
    assert np.all(np.abs(np.log2(g32[deep]) + k32[deep]) < 2.0)
    # phi matches where escaped; nan where not (non-escape semantics)
    assert np.nanmax(np.abs(p32[esc64] - p64[esc64])) < 1e-5
    assert np.isnan(p32[~esc64]).all()
    # interior points short-circuit with the exact non-escape record
    inside = np.array([0.0 + 0.0j, -1.0 + 0.05j, 0.2 + 0.1j])
    gi, ki, pi_ = green_cloud_f32(inside, max_iter=64)
    assert (gi == 0).all() and (ki == 64).all() and np.isnan(pi_).all()


def test_equipotential_f32_potential_path():
    """Pipeline-level: potential_dtype='float32' tracks the f64 summary."""
    from cmtci.pipelines.equipotential import (EquipotentialConfig,
                                               run_equipotential)

    cfg64 = EquipotentialConfig(n_min=2, n_max=30, max_iter=500,
                                run_family_comparison=False)
    cfg32 = EquipotentialConfig(n_min=2, n_max=30, max_iter=500,
                                run_family_comparison=False,
                                potential_dtype="float32")
    o64 = run_equipotential(cfg64, None, with_per_n=False)
    o32 = run_equipotential(cfg32, None, with_per_n=False)
    assert o32["summary"]["escaped"] == o64["summary"]["escaped"]
    for key in ("g_median", "g_mean", "g_p90"):
        assert abs(o32["summary"][key] - o64["summary"][key]) < 1e-5
