"""Regression tests for the round-4 stats/transport review findings.

Each test pins one concrete failure mode found by the high-effort review of
cmtci/stats + cmtci/transport (NOTES.md round-4): silent f32 count
saturation, dead complex-input branches, missing NaN masking, min_steps=0
semantics, O(N^2) memory, and missing no-fit guards.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cmtci.stats import curvature, fields, multifractal, spectral
from cmtci.stats import variogram as vg
from cmtci.transport import giflow


def test_multifractal_complex_input_matches_xy(rng):
    xy = rng.uniform(size=(2000, 2))
    zc = xy[:, 0] + 1j * xy[:, 1]
    res_xy = multifractal.multifractal_spectrum(xy)
    res_c = multifractal.multifractal_spectrum(zc)  # used to ComplexWarning
    np.testing.assert_array_equal(res_c["Z"], res_xy["Z"])
    np.testing.assert_array_equal(res_c["Dq"], res_xy["Dq"])
    res_cd = multifractal.multifractal_spectrum(zc, backend="device", grid=512)
    np.testing.assert_allclose(res_cd["Dq"], res_xy["Dq"], rtol=1e-6)


def test_device_box_counts_exact_beyond_f32_mantissa():
    # one box holding > 2^24 points: the f32 scatter-add used to saturate
    # at 16,777,216, biasing p (and hence every Z/tau/Dq). With int32
    # accumulation, sum_boxes p = 1 exactly, so log Z(q=1) == log 1 = 0
    # up to the f32 log round-off.
    n_big = (1 << 24) + (1 << 20)  # 17.8M points in box 0
    x = np.zeros(n_big + 1, dtype=np.float32)
    y = np.zeros(n_big + 1, dtype=np.float32)
    x[-1] = 0.9  # a second, singleton box
    logz, nonempty = multifractal._z_device(
        jnp.asarray(x), jnp.asarray(y),
        jnp.asarray([0.5], jnp.float32), jnp.asarray([1.0], jnp.float32), 8)
    assert int(nonempty[0]) == 2
    # f32 saturation gave log((2^24 + 1)/n) ~= -0.0607; exact counts give ~0
    assert abs(float(logz[0, 0])) < 1e-5


def test_fused_variogram_counts_exact_beyond_f32_mantissa(rng):
    # one broad bin with >2^24 pairs: the packed f32 count row used to
    # round to multiples of 2; the bitcast path keeps int32 counts exact
    m = 6000  # upper-triangle self pairs: 6000*5999/2 = 17,997,000 > 2^24
    gx, gy = np.meshgrid(np.linspace(0, 1, 80), np.linspace(0, 1, 80))
    fc = rng.normal(size=(80, 80))
    fm = rng.normal(size=(80, 80))
    r_bins = np.array([0.0, 2.0])  # everything lands in the single bin
    rs = np.random.RandomState(0)
    _, _, _, _, n_c, n_m, n_x = vg.three_semivariograms(
        fc, fm, gx, gy, r_bins, m, rs, dtype=jnp.float32)
    expect_self = m * (m - 1) // 2
    assert n_c.dtype.kind == "i"
    assert int(n_c[0]) == expect_self
    assert int(n_m[0]) == expect_self
    assert int(n_x[0]) == m * m  # full rectangle, incl. i==j


def test_local_correlation_masks_nan_like_reference(rng):
    from scipy.stats import pearsonr

    u1 = rng.normal(size=(26, 26))
    u2 = 0.4 * u1 + rng.normal(size=(26, 26))
    u1[8:11, 9:12] = np.nan  # a NaN blob inside the valid frame
    u2[14, 14] = np.nan
    win = 5
    got = fields.local_correlation(u1, u2, win=win)
    for iy, ix in [(9, 9), (13, 13), (18, 7)]:
        a = u1[iy - win: iy + win, ix - win: ix + win].ravel()
        b = u2[iy - win: iy + win, ix - win: ix + win].ravel()
        mask = ~(np.isnan(a) | np.isnan(b))
        ref = pearsonr(a[mask], b[mask])[0] if mask.sum() > 5 else np.nan
        assert got[iy, ix] == pytest.approx(ref, rel=1e-9)
    # a window with <= 5 jointly-valid pixels stays NaN
    u3 = np.full((26, 26), np.nan)
    u3[12, 12:15] = 1.0
    got3 = fields.local_correlation(u3, u3 + 1.0, win=win)
    assert np.isnan(got3[12, 12])


def test_gi_flow_min_steps_zero_still_steps_once():
    # the reference's for-loop (gi_assumption_tracker_v3.py:137-148) always
    # advances X once before checking t >= min_steps
    p = np.array([[0.7, 0.3]])
    x0 = np.array([[0.7, 0.3]])  # KL(p, x0) = 0 <= threshold immediately
    for host in (False, True):
        x, t, kl0, klv = giflow.gi_flow_to_threshold(
            p, x0, alpha=0.2, kl_threshold=1e-6, max_steps=50, min_steps=0,
            host_numpy=host)
        assert t == 1, (host, t)
    # max_steps=0 still short-circuits to zero steps like range(1, 1)
    x, t, _, _ = giflow.gi_flow_to_threshold(
        p, x0, alpha=0.2, kl_threshold=1e-6, max_steps=0, min_steps=0,
        host_numpy=True)
    assert t == 0


def test_pca_ecc_chunked_matches_dense(rng):
    xy = rng.normal(size=(300, 2))
    k = 6
    # dense one-shot oracle (the pre-review formulation)
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    neigh = xy[idx]
    z = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", z, z) / (k - 1)
    a, b, d = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    s = np.sqrt(np.maximum(0.25 * (a - d) ** 2 + b * b, 0.0))
    oracle = (0.5 * (a + d) - s) / np.maximum(a + d, 1e-300)
    got = curvature.pca_eccentricity(xy, k=k)
    np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-12)
    # chunking must not change results (rows are independent)
    got_small = np.asarray(curvature._pca_ecc(jnp.asarray(xy), k, 64))
    np.testing.assert_array_equal(got, got_small)


def test_fit_slope_bootstrap_empty_range_returns_nan():
    freqs = np.array([1.0, 2.0, 3.0, 4.0])
    spec = np.array([1.0, 0.5, 0.33, 0.25])
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # mean-of-empty would raise here
        slope, r2, (lo, hi) = spectral.fit_slope_bootstrap(
            freqs, spec, fmin=100.0, fmax=200.0)
    assert np.isnan(slope) and np.isnan(r2) and np.isnan(lo) and np.isnan(hi)
    # >= 2 points still fit (the reference's phase4b has no minimum-count
    # skip, unlike spectral_decay_exponent's < 5 guard)
    slope2, r2_2, _ = spectral.fit_slope_bootstrap(freqs, spec, 1.0, 2.0)
    assert np.isfinite(slope2)


def test_spectral_distance_small_oracle(rng):
    # value check vs a direct numpy eigvalsh oracle (also exercises the
    # new host-CPU pin path)
    x = rng.normal(size=(40, 2))
    y = rng.normal(size=(40, 2))
    sigma, top_k = 0.5, 10

    def eigs(p):
        d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        w = np.linalg.eigvalsh(np.exp(-d2 / (2 * sigma * sigma)))
        return w[-top_k:]

    ref = np.linalg.norm(eigs(x) - eigs(y)) / np.sqrt(top_k)
    assert spectral.spectral_distance(x, y, top_k, sigma) == pytest.approx(ref, rel=1e-9)


def test_point_variogram_device_matches_host():
    """point_variogram_device: same bin semantics as the host pdist path
    (Iterative_Variogram_Laplacian.py:53-87) — counts exactly equal in f64,
    gamma at accumulation-error level, centers from the same 0.5*d.max()
    default. f32 realization: counts may flip only at bin edges (none at
    this size/seed — pinned), gamma within ~1e-4 relative."""
    import jax.numpy as jnp

    from cmtci.stats import variogram as vg

    rng = np.random.default_rng(3)
    locs = rng.normal(size=(737, 2))
    vals = rng.normal(size=737)
    for values in (vals, None):
        for md in (None, 1.7):
            ch, gh, nh = vg.point_variogram(locs, values, max_dist=md, nbins=37)
            cd, gd, nd = vg.point_variogram_device(locs, values, max_dist=md,
                                                   nbins=37)
            c3, g3, n3 = vg.point_variogram_device(locs, values, max_dist=md,
                                                   nbins=37, dtype=jnp.float32)
            np.testing.assert_array_equal(nh, nd)
            np.testing.assert_array_equal(nh, n3)
            np.testing.assert_array_equal(np.isnan(gh), np.isnan(gd))
            ok = nh > 0
            assert np.nanmax(np.abs(gd[ok] - gh[ok]) / np.abs(gh[ok])) < 1e-12
            assert np.nanmax(np.abs(g3[ok] - gh[ok]) / np.abs(gh[ok])) < 2e-4
            np.testing.assert_allclose(cd, ch, rtol=0, atol=1e-12)
            np.testing.assert_allclose(c3, ch, rtol=1e-6, atol=1e-6)


def test_coupling_vario_dtype_float32_realization():
    """vario_dtype='float32' moves the point variogram to the device; the
    trajectory is a realization (a_est feeds the nudge) that at smooth
    configs coincides with f64's bin choice — rows stay finite and close."""
    from cmtci.pipelines.coupling import CouplingConfig, run_coupling

    rng = np.random.default_rng(5)
    t = rng.uniform(0, 2 * np.pi, 300)
    c = np.column_stack([0.4 * np.cos(t), 0.4 * np.sin(t)])
    m = np.column_stack([0.5 * np.cos(t), 0.5 * np.sin(t)]) + 0.01
    matches = np.arange(300)
    base = dict(n_iter=2, grid_res=80, max_iter_mb=60, win_local_corr=6)
    rows64, c64 = run_coupling(c, m, matches, CouplingConfig(**base))
    rows32, c32 = run_coupling(
        c, m, matches, CouplingConfig(**base, field_dtype="float32",
                                      vario_dtype="float32"))
    assert np.max(np.abs(c64 - c32)) < 1e-5  # same bin realization here
    for r64, r32 in zip(rows64, rows32):
        assert abs(r64["vario_range_a"] - r32["vario_range_a"]) < 1e-5
        assert abs(r64["d_mean"] - r32["d_mean"]) < 1e-6
        assert np.isfinite(r32["corr_pot"]) and np.isfinite(r32["corr_lap"])


def test_three_semivariograms_zero_count_tripwire(monkeypatch):
    """A corrupt device fetch (zero counts WITH
    nonzero dv² sums) must raise, not return empty-bin gammas that pass
    finiteness asserts downstream. All-zero rows (legitimately empty bins,
    e.g. r_bins off the distance support) must NOT trip it."""
    from cmtci.stats import variogram as vg

    def fake(*a, **k):
        out = jnp.zeros((6, 5), jnp.float32)
        return out.at[0].set(1.0)  # sums nonzero, counts zero = corrupt

    monkeypatch.setattr(vg, "_binned_three_masked", fake)
    rng = np.random.default_rng(0)
    f = rng.normal(size=(16, 16))
    gx, gy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    with pytest.raises(RuntimeError, match="corrupt device fetch"):
        vg.three_semivariograms(f, f + 1, gx, gy, np.linspace(0, 1, 6),
                                m_target=50, rng=np.random.default_rng(1),
                                dtype=jnp.float32)
    monkeypatch.setattr(vg, "_binned_three_masked",
                        lambda *a, **k: jnp.zeros((6, 5), jnp.float32))
    out = vg.three_semivariograms(f, f + 1, gx, gy, np.linspace(0, 1, 6),
                                  m_target=50, rng=np.random.default_rng(1),
                                  dtype=jnp.float32)
    assert (out[4] == 0).all()  # legitimately-empty bins pass through


def test_point_variogram_device_signed_int32_guard():
    """The per-bin counts are SIGNED int32: n(n-1)/2 wraps at 2^31-1, i.e.
    n = 65536 is the last safe size. The old guard (92000, the unsigned
    threshold) let an 80k-point concentrated cloud wrap negative and return
    silent NaN gammas instead of the promised loud error."""
    from cmtci.stats import variogram as vg2

    with pytest.raises(ValueError, match="signed int32"):
        vg2.point_variogram_device(np.zeros((65537, 2)), None)


def test_point_variogram_device_zero_count_tripwire(monkeypatch):
    """Same corrupt-fetch tripwire as three_semivariograms (zero counts
    WITH nonzero dv² sums must raise; both-zero —
    legitimately empty bins — must not)."""
    from cmtci.stats import variogram as vg2

    def fake_corrupt(*a, **k):
        return (jnp.zeros((2, 5), jnp.float32).at[0].set(1.0),
                jnp.zeros(5, jnp.int32))

    monkeypatch.setattr(vg2, "_point_binned_masked", fake_corrupt)
    locs = np.random.default_rng(0).normal(size=(40, 2))
    with pytest.raises(RuntimeError, match="corrupt device fetch"):
        vg2.point_variogram_device(locs, None, nbins=5, dtype=jnp.float32)

    monkeypatch.setattr(
        vg2, "_point_binned_masked",
        lambda *a, **k: (jnp.zeros((2, 5), jnp.float32), jnp.zeros(5, jnp.int32)))
    c, g, n = vg2.point_variogram_device(locs, None, nbins=5, dtype=jnp.float32)
    assert np.isnan(g).all() and (n == 0).all()  # empty bins pass through


def test_triu_pairs_cache_capped():
    """_triu_pairs only caches up to ~4M pairs: one 20k-point host call used
    to pin ~3.2 GB of int64 indices in a module global for the process
    lifetime. Values are identical cached or not."""
    from cmtci.stats import variogram as vg2

    i, j = vg2._triu_pairs(2900)  # 4.2M pairs: above the cap, NOT cached
    assert 2900 not in vg2._TRIU_CACHE
    ri, rj = np.triu_indices(2900, k=1)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(j, rj)
    i2, j2 = vg2._triu_pairs(200)  # under the cap: cached (LRU-1)
    assert 200 in vg2._TRIU_CACHE
    np.testing.assert_array_equal(i2, np.triu_indices(200, k=1)[0])


def test_best_reflection_axis_rejects_mesh_plus_dtype():
    """mesh (sharded f64 scan) and dtype (single-device f32 scan) are
    mutually exclusive — mixing them picked the angle at f64 but reported
    f32 fractions (same guard class as build_sparse_kernel)."""
    from cmtci.stats import symmetry

    pts = np.random.default_rng(1).normal(size=(30, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        symmetry.best_reflection_axis(pts, pts, mesh=object(),
                                      dtype=jnp.float32)
