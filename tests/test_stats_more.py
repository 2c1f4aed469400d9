"""Variograms, multifractal, embeddings, symmetry, laws, field correlations."""

import numpy as np
import pytest

from cmtci.stats import embeddings, fields, laws, multifractal, symmetry, variogram


class TestVariogram:
    def test_constant_field_gamma_zero(self, rng):
        gx, gy = np.meshgrid(np.linspace(0, 1, 20), np.linspace(0, 1, 20))
        f = np.full((20, 20), 3.7)
        r_bins = np.linspace(0, 1.0, 11)
        _, gamma, counts = variogram.grid_semivariogram(f, gx, gy, r_bins, rng=rng)
        assert counts.sum() > 0
        np.testing.assert_allclose(gamma, 0.0, atol=1e-20)

    def test_matches_uncapped_bruteforce(self, rng):
        gx, gy = np.meshgrid(np.linspace(0, 1, 12), np.linspace(0, 1, 12))
        f = rng.normal(size=(12, 12))
        r_bins = np.linspace(0, 0.8, 9)
        rc, gamma, counts = variogram.grid_semivariogram(
            f, gx, gy, r_bins, m_target=144, rng=np.random.RandomState(0)
        )
        coords = np.column_stack([gx.ravel(), gy.ravel()])
        vals = f.ravel()
        i, j = np.triu_indices(len(coords), k=1)
        d = np.linalg.norm(coords[i] - coords[j], axis=1)
        dv2 = (vals[i] - vals[j]) ** 2
        for k in range(8):
            m = (d >= r_bins[k]) & (d < r_bins[k + 1])
            if m.any():
                assert gamma[k] == pytest.approx(0.5 * dv2[m].mean(), rel=1e-10)
                assert counts[k] == m.sum()

    def test_cross_variogram_identical_fields(self, rng):
        gx, gy = np.meshgrid(np.linspace(0, 1, 15), np.linspace(0, 1, 15))
        f = rng.normal(size=(15, 15))
        r_bins = np.linspace(0, 0.8, 9)
        rc, g12, _ = variogram.cross_semivariogram(
            f, f, gx, gy, r_bins, m_target=225, rng=np.random.RandomState(1)
        )
        assert np.all(np.isfinite(g12[1:]))

    def test_point_variogram_reference_loop(self, rng):
        locs = rng.uniform(size=(60, 2))
        vals = rng.normal(size=60)
        c, g, n = variogram.point_variogram(locs, vals, max_dist=0.7, nbins=10)
        # reference loop
        from scipy.spatial.distance import pdist

        i, j = np.triu_indices(60, k=1)
        d = np.linalg.norm(locs[i] - locs[j], axis=1)
        sq = (vals[i] - vals[j]) ** 2
        bins = np.linspace(0, 0.7, 11)
        for k in range(10):
            m = (d >= bins[k]) & (d < bins[k + 1])
            if m.any():
                assert g[k] == pytest.approx(0.5 * sq[m].mean(), rel=1e-12)

    def test_cross_variogram_from_matches(self, rng):
        c = rng.normal(size=(80, 2))
        m = rng.normal(size=(60, 2))
        ci = np.arange(80)
        mi = rng.integers(0, 60, 80)
        centers, gamma, counts = variogram.cross_variogram_from_matches(c, m, ci, mi, nbins=8)
        assert counts.sum() > 0
        # faithful check on one bin
        mags = np.linalg.norm(c[ci] - m[mi], axis=1)
        sq = np.sum((c[ci] - m[mi]) ** 2, axis=1)
        bins = np.linspace(0.0, mags.max(), 9)
        k = 3
        mask = (np.digitize(mags, bins) - 1) == k
        if mask.any():
            assert gamma[k] == pytest.approx(0.5 * sq[mask].mean(), rel=1e-12)

    def test_range_estimator(self):
        lags = np.linspace(0.05, 1.0, 20)
        gamma = 1.0 - np.exp(-lags / 0.2)
        a = variogram.variogram_range(lags, gamma, pct=0.9)
        assert 0.3 < a < 0.7  # 90% of max of this curve

    def test_exponential_fit_recovers(self, rng):
        r = np.linspace(0.02, 2.0, 40)
        g = 0.1 + 0.8 * (1 - np.exp(-r / 0.4)) + 0.002 * rng.normal(size=40)
        fit = variogram.fit_exponential_variogram(r, g)
        # the reference's fixed-step (0.05) coordinate search is crude:
        # parameters land within ~0.15 of truth, and the fitted curve is close
        assert fit["a"] == pytest.approx(0.4, abs=0.2)
        assert fit["sill"] + fit["nugget"] == pytest.approx(0.9, abs=0.1)
        resid = g - fit["model"](r)
        assert np.abs(resid).mean() < 0.02

    def test_detrend_removes_quadratic(self, rng):
        gx, gy = np.meshgrid(np.linspace(-1, 1, 25), np.linspace(-1, 1, 25))
        trend = 1 + 2 * gx - 0.5 * gy + 0.3 * gx * gy + gx**2
        noise = 0.01 * rng.normal(size=gx.shape)
        resid, fit = variogram.detrend_poly2d(trend + noise, gx, gy, deg=2)
        assert np.abs(resid).max() < 0.05


class TestMultifractal:
    def test_uniform_square_dq_two(self, rng):
        pts = rng.uniform(size=(30000, 2))
        # scales where boxes are well-populated (the reference's default
        # 0.002 lower scale undersamples 30k points and biases D(q) low)
        scales = np.logspace(np.log10(0.04), np.log10(0.5), 8)
        res = multifractal.multifractal_spectrum(pts, scales=scales)
        q = res["q"]
        dq = res["Dq"]
        m = (q >= -2) & (q <= 2) & np.isfinite(dq)
        assert np.nanmean(dq[m]) == pytest.approx(2.0, abs=0.25)

    def test_line_dq_one(self, rng):
        t = rng.uniform(size=20000)
        pts = np.column_stack([t, 0.5 * t])
        res = multifractal.multifractal_spectrum(pts)
        m = (res["q"] >= 0) & np.isfinite(res["Dq"])
        assert np.nanmean(res["Dq"][m]) == pytest.approx(1.0, abs=0.2)

    def test_falpha_legendre_identity(self, rng):
        pts = rng.uniform(size=(5000, 2))
        res = multifractal.multifractal_spectrum(pts)
        np.testing.assert_allclose(
            res["f_alpha"], res["q"] * res["alpha"] - res["tau"], rtol=1e-12
        )

    def test_device_backend_matches_host(self, rng):
        """VERDICT r3 item 8: the fixed-shape device count grid reproduces
        the host integer-key box partition exactly (f64 CPU device)."""
        pts = rng.uniform(size=(4000, 2))
        res_h = multifractal.multifractal_spectrum(pts)
        res_d = multifractal.multifractal_spectrum(pts, backend="device", grid=512)
        np.testing.assert_allclose(res_d["Z"], res_h["Z"], rtol=1e-12)
        np.testing.assert_allclose(res_d["tau"], res_h["tau"], rtol=1e-10)

    def test_device_backend_grid_guard(self, rng):
        pts = rng.uniform(size=(100, 2))
        with pytest.raises(ValueError, match="too small"):
            multifractal.multifractal_spectrum(pts, backend="device", grid=16,
                                               scales=np.array([1e-4, 0.5]))

    def test_device_backend_grid_guard_exact_fit(self, rng):
        """need == grid must be rejected: the max-coordinate point keys to
        index floor(range/eps) == grid in the host partition, and the old
        `need > grid` guard let the device clip alias it into the edge box
        (review r4: 18/54 Z entries drifted up to 1.6e-3)."""
        pts = np.vstack([rng.uniform(size=(500, 2)), [[0.0, 0.0], [1.0, 1.0]]])
        with pytest.raises(ValueError, match="too small"):
            multifractal.multifractal_spectrum(
                pts, backend="device", grid=64,
                scales=np.array([1.0 / 64, 0.25, 0.5]))

    def test_device_backend_extreme_q_no_overflow(self, rng):
        """The device path carries log Z (log-sum-exp) and exponentiates in
        f64 on the host: raw f32 Σ p^q overflows for strongly negative q
        (a singleton box contributes n^|q|), which silently NaN'd tau on
        the advertised beyond-reference-scale clouds (review r4)."""
        import jax.numpy as jnp

        pts = rng.uniform(size=(3000, 2))
        q = np.array([-40.0, -5.0, 0.0, 2.0])
        scales = np.array([0.01, 0.05, 0.2])
        # q=-40 with singleton boxes: p^q ~ 3000^40 ≈ 1e139 — far beyond
        # f32 max (3.4e38); the host f64 reference handles it directly
        res_h = multifractal.multifractal_spectrum(pts, q_values=q, scales=scales)
        res_d = multifractal.multifractal_spectrum(pts, q_values=q, scales=scales,
                                                   backend="device", grid=512,
                                                   dtype=jnp.float32)
        assert np.isfinite(res_d["Z"]).all()
        # f32 log-p noise is amplified by |q|; compare in log space
        np.testing.assert_allclose(np.log(res_d["Z"]), np.log(res_h["Z"]),
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(res_d["tau"], res_h["tau"], rtol=5e-3)


class TestEmbeddings:
    def test_identical_clouds_zero_distance(self, rng):
        pts = rng.normal(size=(300, 2))
        va, _, _ = embeddings.diffusion_map(pts, k=10, n_eigs=6)
        vb, _, _ = embeddings.diffusion_map(pts.copy(), k=10, n_eigs=6)
        assert embeddings.embedding_spectral_distance(va, vb) == pytest.approx(0.0, abs=1e-10)

    def test_top_eigenvalue_near_one(self, rng):
        pts = rng.normal(size=(400, 2))
        vals, vecs, sigma = embeddings.diffusion_map(pts, k=15, n_eigs=6)
        assert sigma > 0
        assert vals[0] == pytest.approx(1.0, abs=0.2)  # symmetrized Markov
        assert np.all(np.diff(vals) <= 1e-12)

    def test_device_lanczos_matches_eigsh(self, rng):
        """VERDICT r3 item 6: the device dense-Lanczos eigenpairs agree with
        the scipy eigsh oracle to <=1e-8 (f64 on the CPU device)."""
        pts = rng.normal(size=(600, 2))
        kmat, _ = embeddings.build_sparse_kernel(pts, k=12)
        p = embeddings.markov_from_kernel(kmat)
        vals_ref, vecs_ref = embeddings.spectral_embedding(p, n_eigs=6)
        vals_dev, vecs_dev = embeddings.spectral_embedding(p, n_eigs=6,
                                                           backend="device")
        np.testing.assert_allclose(vals_dev, vals_ref, atol=1e-8)
        # eigenvectors agree up to sign
        for j in range(vecs_ref.shape[1]):
            dot = abs(float(vecs_dev[:, j] @ vecs_ref[:, j]))
            assert dot > 1 - 1e-6, (j, dot)

    def test_device_lanczos_full_pipeline(self, rng):
        pts = rng.normal(size=(400, 2))
        va, _, _ = embeddings.diffusion_map(pts, k=10, n_eigs=5)
        vd, _, _ = embeddings.diffusion_map(pts, k=10, n_eigs=5,
                                            eig_backend="device")
        np.testing.assert_allclose(vd, va, atol=1e-8)

    def test_knn_matches_ckdtree(self, rng):
        from scipy.spatial import cKDTree

        pts = rng.normal(size=(500, 2))
        import jax.numpy as jnp

        d, idx = embeddings._knn(jnp.asarray(pts), 8)
        dref, iref = cKDTree(pts).query(pts, k=9)
        np.testing.assert_allclose(np.sort(np.asarray(d), axis=1), dref[:, 1:], rtol=1e-10)


class TestSymmetry:
    def test_reflection_is_involution(self, rng):
        pts = rng.normal(size=(100, 2))
        r1 = symmetry.reflect_across_line(pts, 0.7, origin=np.array([0.1, -0.2]))
        r2 = symmetry.reflect_across_line(r1, 0.7, origin=np.array([0.1, -0.2]))
        np.testing.assert_allclose(r2, pts, atol=1e-12)

    def test_xaxis_symmetric_cloud(self, rng):
        t = rng.uniform(0, np.pi, 500)
        pts = np.concatenate([
            np.column_stack([np.cos(t), np.sin(t)]),
            np.column_stack([np.cos(t), -np.sin(t)]),
        ])
        frac, _ = symmetry.preservation_fraction(pts, "reflect_x", tol=1e-9)
        assert frac == 1.0

    def test_best_axis_finds_symmetry(self, rng):
        # ellipse rotated by 30 degrees: best reflection axis at 30 or 120 deg
        t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
        e = np.column_stack([2 * np.cos(t), 0.5 * np.sin(t)])
        ang = np.pi / 6
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        pts = e @ rot.T
        res = symmetry.best_reflection_axis(pts, pts, tol=0.02)
        got = res["angle"] % (np.pi / 2)
        assert min(abs(got - ang % (np.pi / 2)), abs(got - ang % (np.pi / 2) - np.pi / 2)) < 0.03
        assert res["frac_a"] > 0.95


class TestLaws:
    def test_uniform_law_wins_for_uniform_g(self, rng):
        g = rng.uniform(0, 0.5, 5000)
        out = laws.compare_reference_laws(g)
        assert out["ks_uniform_0_gmax"] < out["ks_exponential"]
        assert out["ks_uniform_0_gmax"] < 0.03

    def test_exponential_law_wins_for_exp_g(self, rng):
        g = rng.exponential(0.1, 5000)
        out = laws.compare_reference_laws(g)
        assert out["ks_exponential"] < out["ks_uniform_0_gmax"]

    def test_too_few_points_returns_none(self):
        assert laws.compare_reference_laws(np.ones(10)) is None

    def test_summarize_g(self):
        g = np.array([0.0, 0.0, 1.0, 2.0])
        s = laws.summarize_g(g)
        assert s["escaped"] == 2
        assert s["g_mean"] == pytest.approx(1.5)


class TestFields:
    def test_laplacian_of_harmonic_small(self):
        xs = np.linspace(0, 1, 50)
        gx, gy = np.meshgrid(xs, xs)
        u = gx**2 - gy**2  # harmonic
        h = xs[1] - xs[0]
        lap = np.asarray(fields.laplacian5(u, h))
        assert np.abs(lap[2:-2, 2:-2]).max() < 1e-8

    def test_local_correlation_matches_bruteforce(self, rng):
        from scipy.stats import pearsonr

        u1 = rng.normal(size=(30, 30))
        u2 = 0.5 * u1 + rng.normal(size=(30, 30))
        win = 5
        got = fields.local_correlation(u1, u2, win=win)
        for iy, ix in [(7, 9), (15, 15), (20, 8)]:
            a = u1[iy - win : iy + win, ix - win : ix + win].ravel()
            b = u2[iy - win : iy + win, ix - win : ix + win].ravel()
            ref = pearsonr(a, b)[0]
            assert got[iy, ix] == pytest.approx(ref, rel=1e-9)
        assert np.isnan(got[0, 0])

    def test_pearson_global(self, rng):
        a = rng.normal(size=(20, 20))
        assert fields.pearson_global(a, a) == pytest.approx(1.0)


def test_semivariogram_f32_close_to_f64(rng):
    """dtype=float32 (the device fast path) tracks f64 within the documented
    ~1e-3 relative budget on identical location subsamples."""
    import jax.numpy as jnp

    from cmtci.stats import variogram as vg

    gx, gy = np.meshgrid(np.linspace(0, 1, 48), np.linspace(0, 1, 48))
    f = np.log1p(gx**2 + gy**2) + 0.05 * rng.normal(size=(48, 48))
    r_bins = np.linspace(0, 0.9, 16)
    _, g64, c64 = vg.grid_semivariogram(f, gx, gy, r_bins, m_target=800,
                                        rng=np.random.RandomState(0))
    _, g32, c32 = vg.grid_semivariogram(f, gx, gy, r_bins, m_target=800,
                                        rng=np.random.RandomState(0),
                                        dtype=jnp.float32)
    nz = c64 > 0
    rel = np.abs(g32[nz] - g64[nz]) / np.maximum(np.abs(g64[nz]), 1e-30)
    assert rel.max() < 5e-3
    assert np.abs(c32 - c64).max() <= max(5, 0.001 * c64.max())


def test_three_semivariograms_fused_matches_sequential(rng):
    """The fused one-call variogram path (f32 device) equals the three
    sequential calls exactly: same RNG draw order, same kernels."""
    import jax.numpy as jnp

    from cmtci.stats import variogram as vg

    gx, gy = np.meshgrid(np.linspace(0, 1, 40), np.linspace(0, 1, 40))
    fc = np.log1p(gx**2 + gy**2) + 0.05 * rng.normal(size=(40, 40))
    fm = np.sqrt(gx + gy) + 0.05 * rng.normal(size=(40, 40))
    r_bins = np.linspace(0, 0.9, 12)
    rs = np.random.RandomState(3)
    _, gc1, _ = vg.grid_semivariogram(fc, gx, gy, r_bins, 500, rs, dtype=jnp.float32)
    _, gm1, _ = vg.grid_semivariogram(fm, gx, gy, r_bins, 500, rs, dtype=jnp.float32)
    _, gx1, _ = vg.cross_semivariogram(fc, fm, gx, gy, r_bins, 500, rs, dtype=jnp.float32)
    rs2 = np.random.RandomState(3)
    _, gc2, gm2, gx2, _, _, _ = vg.three_semivariograms(
        fc, fm, gx, gy, r_bins, 500, rs2, dtype=jnp.float32)
    np.testing.assert_array_equal(gc2, gc1)
    np.testing.assert_array_equal(gm2, gm1)
    np.testing.assert_array_equal(gx2, gx1)
    # f64 fallback path delegates to the sequential functions
    rs3 = np.random.RandomState(3)
    _, gc3, gm3, gx3, _, _, _ = vg.three_semivariograms(
        fc, fm, gx, gy, r_bins, 500, rs3, dtype=None)
    assert np.all(np.isfinite(gc3[1:])) and np.all(np.isfinite(gm3[1:]))


def test_binned_masked_matches_scatter_semantics(rng):
    """The scatter-free device binning (round 3) bins identically to the
    searchsorted/scatter kernel: exact counts, sums to reduction-order
    tolerance, at f64 (where both are well-conditioned)."""
    import jax.numpy as jnp

    from cmtci.stats.variogram import _binned_sq_diff, _binned_sq_diff_masked

    c = jnp.asarray(rng.uniform(-2, 2, (700, 2)))
    v = jnp.asarray(rng.normal(size=700))
    edges = jnp.asarray(np.linspace(0.0, 1.3, 36))
    for upper in (True, False):
        s0, n0 = _binned_sq_diff(c, v, c, v, edges, 35, 256, upper)
        s1, n1 = _binned_sq_diff_masked(c, v, c, v, edges, 35, 256, upper)
        np.testing.assert_array_equal(np.asarray(n0), np.asarray(n1))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s0),
                                   rtol=1e-12, atol=1e-12)


def test_symmetry_scan_f32_close_to_f64(rng):
    """The f32 device angle scan tracks the f64 scores (1e-7 NN noise vs a
    0.05 tolerance) and picks an equivalent best axis."""
    import jax.numpy as jnp

    pts = rng.normal(size=(300, 2))
    pts = np.vstack([pts, pts @ np.array([[1, 0], [0, -1.0]])])  # x-symmetric
    b64 = symmetry.best_reflection_axis(pts, pts, tol=0.05, n_angles=91)
    b32 = symmetry.best_reflection_axis(pts, pts, tol=0.05, n_angles=91,
                                        dtype=jnp.float32)
    np.testing.assert_allclose(b32["scan_score"], b64["scan_score"], atol=0.02)
    assert abs(b32["frac_a"] - b64["frac_a"]) < 0.02


def test_knn_f32_hilo_matches_f64_on_near_duplicates():
    """knn_dtype=float32 must reproduce the f64 neighbor GRAPH even on
    clouds with sub-f32-resolution spacings (the inverse-eigenvalue clouds
    carry ~1e-11 near-duplicates): plain-f32 coordinates collapse such
    clusters (measured: kernel edges differ at weight 1.0, eigenvalues
    shift ~0.1); the hi/lo two-float search + f64 re-rank matches the f64
    kernel to ~1e-15."""
    import jax.numpy as jnp

    from cmtci.stats import embeddings as em

    rng = np.random.default_rng(7)
    base = rng.normal(size=(120, 2))
    # 5 near-duplicates of each point at 1e-11 spacing — invisible in f32
    pts = np.concatenate([base + rng.normal(size=(120, 2)) * 1e-11
                          for _ in range(5)])
    k64, s64 = em.build_sparse_kernel(pts, k=10)
    k32, s32 = em.build_sparse_kernel(pts, k=10, dtype=jnp.float32)
    assert abs(s64 - s32) / s64 < 1e-9
    diff = (k64 - k32).tocoo()
    assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-12
    p64 = em.markov_from_kernel(k64)
    p32 = em.markov_from_kernel(k32)
    v64, _ = em.spectral_embedding(p64, 6)
    v32, _ = em.spectral_embedding(p32, 6)
    np.testing.assert_allclose(np.abs(v64), np.abs(v32), rtol=0, atol=1e-10)


def test_best_axis_final_fracs_ride_scan_dtype(rng):
    """Review r4c: under dtype=f32 the returned frac_a/frac_b must come from
    the same f32 scan path (previously two O(n²) f64 host scans per report
    — the stage wall at 5k+ buses, and a precision mismatch per row)."""
    import jax.numpy as jnp

    pts = rng.normal(size=(200, 2))
    pts = np.vstack([pts, pts @ np.array([[1, 0], [0, -1.0]])])
    b32 = symmetry.best_reflection_axis(pts, pts, tol=0.05, n_angles=61,
                                        refine=False, dtype=jnp.float32)
    f_direct, _ = symmetry.preservation_fraction(
        pts, "reflect_angle", 0.05, angle=b32["angle"], dtype=jnp.float32)
    assert b32["frac_a"] == f_direct == b32["frac_b"]


def test_preservation_fraction_explicit_f64_matches_default(rng):
    """Review r4c: an explicit dtype=float64 routes through the shared
    device policy — values identical to the default on any backend."""
    import jax.numpy as jnp

    pts = rng.normal(size=(150, 2))
    f_def, d_def = symmetry.preservation_fraction(pts, "rot_pi", 0.05)
    f_64, d_64 = symmetry.preservation_fraction(pts, "rot_pi", 0.05,
                                                dtype=jnp.float64)
    assert f_def == f_64
    np.testing.assert_array_equal(d_def, d_64)


def test_build_sparse_kernel_mesh_plus_dtype_is_loud(rng):
    """Review r4c: mesh silently won over knn_dtype (a caller 'benchmarking'
    the f32 device kNN on a meshed session measured the sharded f64 path)."""
    import jax.numpy as jnp
    import pytest

    from cmtci.parallel.sharded import device_mesh
    from cmtci.stats import embeddings as em

    pts = rng.normal(size=(60, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        em.build_sparse_kernel(pts, k=5, mesh=device_mesh(2),
                               dtype=jnp.float32)


def test_best_axis_device_grid_refine_matches_scipy(rng):
    """The f32 device path refines by two batched 128-angle grid stages
    (final resolution ~2.2e-5 rad) instead of scipy's ~25 sequential
    scalar dispatches per report at the 6x bus.
    On a cloud symmetric about a known axis, both land on that axis
    within the host path's own xatol, and refinement never scores below
    the coarse scan."""
    import jax.numpy as jnp

    theta = 0.31  # ground-truth axis angle
    c, s = np.cos(2 * theta), np.sin(2 * theta)
    pts = rng.normal(size=(250, 2))
    pts = np.vstack([pts, pts @ np.array([[c, s], [s, -c]]).T])
    b64 = symmetry.best_reflection_axis(pts, pts, tol=0.05, n_angles=91)
    b32 = symmetry.best_reflection_axis(pts, pts, tol=0.05, n_angles=91,
                                        dtype=jnp.float32)
    assert abs(b64["angle"] - theta) < 5e-3
    assert abs(b32["angle"] - b64["angle"]) < 5e-3
    coarse = b32["scan_score"].max()
    refined = b32["frac_a"] + b32["frac_b"]
    assert refined >= coarse - 1e-9


def test_preservation_fractions_batched_matches_per_op(rng):
    """The batched op-table scan (one dispatch per cloud) returns exactly
    the per-op preservation_fraction values and distances, on both the
    f64 host and f32 device policies."""
    import jax.numpy as jnp

    pts = rng.normal(size=(180, 2))
    ops = ("identity", "reflect_x", "reflect_y", "rot_pi")
    for dt in (None, jnp.float32):
        fracs, dists = symmetry.preservation_fractions(pts, ops, 0.05, dtype=dt)
        for i, op in enumerate(ops):
            f_ref, d_ref = symmetry.preservation_fraction(pts, op, 0.05, dtype=dt)
            assert fracs[i] == f_ref
            np.testing.assert_array_equal(dists[i], d_ref)
