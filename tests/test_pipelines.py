"""End-to-end pipeline tests at reduced scale (CPU)."""

import json
import os

import numpy as np
import pytest

from cmtci.pipelines import analysis
from cmtci.pipelines.boundary import BoundaryConfig, run_boundary
from cmtci.pipelines.coupling import CouplingConfig, run_coupling
from cmtci.pipelines.curvature import CurvatureConfig, run_curvature
from cmtci.pipelines.equipotential import EquipotentialConfig, run_equipotential
from cmtci.pipelines.lucas_boundary import (
    ConstructBoundaryConfig, LucasBoundaryConfig, construct_boundary,
    export_lucas_boundary,
)
from cmtci.pipelines.spectral import SpectralConfig, run_spectral
from cmtci.pipelines.stage1 import Stage1Config, run_stage1
from cmtci.pipelines.uniformize_fem import FEMUniformizeConfig, run_level
from cmtci.pipelines.uniformize_green import GreenUniformizeConfig, run_green_uniformization
from cmtci.pipelines.variograms import VariogramConfig, run_variograms


@pytest.fixture(scope="module")
def bus(tmp_path_factory):
    """Small stage-1 file bus shared by analysis pipelines."""
    out = run_stage1(Stage1Config(max_n=25, nx=80, ny=60, boundary_samples=300,
                                  matcher="greedy"), None)
    return out


def test_boundary_pipeline(tmp_path):
    cfg = BoundaryConfig(res=300, max_iter=120, backend="xla")
    path, z = run_boundary(cfg, str(tmp_path / "mandel"))
    assert path.shape[0] > 100
    assert (tmp_path / "mandel_boundary.csv").exists()
    header = open(tmp_path / "mandel_boundary.csv").readline().strip()
    assert header == "x,y"
    # boundary points sit near the dwell transition: all within the domain
    assert path[:, 0].min() >= cfg.xlim[0] and path[:, 0].max() <= cfg.xlim[1]


def test_lucas_boundary_and_curvature(tmp_path):
    xy = export_lucas_boundary(
        LucasBoundaryConfig(n_min=2, n_max=40, n_boundary=400),
        str(tmp_path / "lucas_points.npy"),
    )
    assert xy.shape == (400, 2)
    kappa, ks, speed, aux, summary = run_curvature(
        xy, CurvatureConfig(neighbors=7, closed=True), str(tmp_path / "curv")
    )
    assert summary["n"] == 400
    assert np.isfinite(kappa).all()
    csv_header = open(tmp_path / "curv_curvature.csv").readline().strip()
    assert csv_header == "idx,x,y,curvature,kappa_signed,speed,xprime,yprime,x2,y2"


def test_construct_boundary_from_cloud(bus):
    b, closed = construct_boundary(bus["C"], ConstructBoundaryConfig(alpha=20.0, target_n=300))
    assert b.shape == (300, 2)


def test_stage1_writes_bus(tmp_path, bus):
    out = run_stage1(Stage1Config(max_n=15, nx=60, ny=40, boundary_samples=150,
                                  matcher="greedy"), str(tmp_path))
    for f in ("construct_points.csv", "mandel_boundary_sample.csv",
              "construct_aligned.csv", "matches_indices.csv"):
        assert (tmp_path / f).exists()
    assert len(out["matches"]) == len(out["C"])


def test_equipotential_small(tmp_path):
    cfg = EquipotentialConfig(n_min=2, n_max=30, max_iter=500,
                              run_family_comparison=True)
    out = run_equipotential(cfg, None, with_per_n=False)
    assert 0.3 < out["summary"]["escaped_frac"] < 1.0
    assert out["laws"] is not None
    assert len(out["family_summary"]) == 4


def test_equipotential_prefix_stats_exact():
    """per_n/cumulative rows from the single-extraction prefix path equal
    the naive per-row re-masking summarize_g EXACTLY — an escaped
    extraction of a prefix IS a prefix of the global escaped extraction."""
    from cmtci.pipelines import equipotential as eq
    from cmtci.stats import laws

    rng = np.random.default_rng(5)
    per_n_g = []
    for n in range(2, 40):
        g = rng.normal(0.001, 0.01, size=n)  # mixed escaped/interior
        g[rng.random(n) < 0.3] = 0.0
        per_n_g.append((n, g))
    cfg = EquipotentialConfig()
    pn = eq.per_n_stats(cfg, per_n_g=per_n_g)
    cu = eq.cumulative_stats(cfg, per_n_g=per_n_g)
    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            va, vb = a[k], b[k]
            if isinstance(va, float) and np.isnan(va):
                assert np.isnan(vb), k
            else:
                assert va == vb, k  # exact, not approx

    g_flat = np.concatenate([g for _, g in per_n_g])
    off = 0
    for i, (n, g) in enumerate(per_n_g):
        same(pn[i], {"n": n, **laws.summarize_g(g)})
        off += len(g)
        same(cu[i], {"N": n, **laws.summarize_g(g_flat[:off])})
    # all-interior group: NaN stats, zero escaped
    empty = laws.summarize_outside(np.array([]), 7)
    assert empty["escaped"] == 0 and np.isnan(empty["g_median"])


def test_equipotential_stored_curve(tmp_path):
    """--curve-npy analyzes a stored boundary polyline (reference section C,
    lucas_equipotential_test_v3.py:390-403): both (N,2) xy and complex
    layouts load, g_curve.npy is written, and the summary equals a direct
    batch_potential of the same points."""
    from cmtci.pipelines import equipotential as eq
    from cmtci.stats import laws

    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.2, 0.8, size=(40, 2))  # mixed interior/escaping
    np.save(tmp_path / "curve_xy.npy", pts)
    np.save(tmp_path / "curve_c.npy", pts[:, 0] + 1j * pts[:, 1])
    cfg = EquipotentialConfig(n_min=2, n_max=8, max_iter=300,
                              run_family_comparison=False,
                              curve_npy=str(tmp_path / "curve_xy.npy"))
    out = run_equipotential(cfg, str(tmp_path / "out"), with_per_n=False)
    g_direct, _, _ = eq.batch_potential(pts[:, 0] + 1j * pts[:, 1],
                                        cfg.max_iter, cfg.escape_radius)
    assert np.array_equal(out["curve_g"], g_direct)
    assert out["curve_summary"] == laws.summarize_g(g_direct)
    saved = np.load(tmp_path / "out" / "g_curve.npy")
    assert np.array_equal(saved, g_direct)
    # complex layout loads to the same cloud
    cfg2 = EquipotentialConfig(n_min=2, n_max=8, max_iter=300,
                               run_family_comparison=False,
                               curve_npy=str(tmp_path / "curve_c.npy"))
    out2 = run_equipotential(cfg2, None, with_per_n=False)
    assert np.array_equal(out2["curve_g"], g_direct)
    # a bad path must fail BEFORE the expensive stages (timer still empty)
    from cmtci.utils.artifacts import StageTimer

    timer = StageTimer()
    bad = EquipotentialConfig(curve_npy=str(tmp_path / "nope.npy"))
    with pytest.raises(FileNotFoundError):
        run_equipotential(bad, None, timer=timer)
    assert not timer.times  # no stage ran: nothing was computed then lost


def test_variograms_small(tmp_path):
    cfg = VariogramConfig(n_list=(30, 60), boundary_grid=120, boundary_max_iter=150,
                          grid_nx=64, grid_ny=64, potential_max_iter=150,
                          m_target=2000, fit_model=True)
    out = run_variograms(cfg, str(tmp_path / "v.csv"))
    assert np.isfinite(out["gamma_construct"][1:]).all()
    assert (tmp_path / "v.csv").exists()
    assert out["fit_construct"]["a"] > 0


def test_spectral_pipeline(bus, tmp_path):
    out = run_spectral(bus["C"], bus["M"], SpectralConfig(n_bootstrap=50),
                       str(tmp_path / "spec"))
    assert len(out["modes"]) == 10
    # percentile-bootstrap CIs are finite and ordered (they can exclude the
    # point estimate on short noisy ranges)
    for r in out["power_slopes_bootstrap"]:
        assert np.isfinite(r["slope"])
        assert (not np.isfinite(r["ci_lo"])) or r["ci_lo"] <= r["ci_hi"]


def test_analysis_pipelines(bus, tmp_path):
    mfout = analysis.run_multifractal(bus["C"], bus["M"],
                                      scales=np.logspace(np.log10(0.05), np.log10(0.5), 8))
    assert np.isfinite(mfout["construct"]["Dq"]).any()

    embout = analysis.run_embeddings(bus["C"], bus["M"], k_nn=10, n_eigs=5)
    assert embout["spectral_distance"] >= 0

    symout = analysis.run_symmetry(bus["C_aligned"], bus["M"], bus["matches"], tol=0.1)
    assert symout["rows"][-1]["op"] == "reflect_best_angle"

    stats = analysis.run_spatial_stats(bus["C_aligned"], bus["M"], r_max=0.8, dr=0.1)
    assert stats["hausdorff"] > 0

    row = analysis.run_report(bus["C"], bus["M"], bus["C_aligned"], bus["matches"],
                              str(tmp_path / "rep"))
    assert "hausdorff" in row and "match_median" in row


def test_tci_pipeline_small():
    from cmtci.pipelines.analysis import TCIConfig, run_tci

    cfg = TCIConfig(construct_ns=(20, 40, 60), mandelbrot_grid=150,
                    mandelbrot_samples=2000, grid_bins=32, t_steps=10)
    out, kls, traj = run_tci(cfg)
    assert out["KL_final"] < out["KL_initial"]
    assert np.all(np.diff(kls) <= 1e-12)
    assert np.isfinite(out["Hausdorff_before"])


def test_tci_pipeline_pallas_impl():
    """de_impl='pallas' (the BASELINE configs[4] 4x-grid fast path) is
    statistically equivalent to the f64 host path: same KL scale, same
    monotone GI-flow descent (the f32 head + device Gumbel subsample draw a
    different but equally-distributed boundary sample)."""
    from cmtci.pipelines.analysis import TCIConfig, run_tci

    base = dict(construct_ns=(20, 40, 60), mandelbrot_grid=96,
                mandelbrot_samples=800, grid_bins=32, t_steps=10)
    out_p, kls_p, _ = run_tci(TCIConfig(**base, de_impl="pallas"))
    out_j, kls_j, _ = run_tci(TCIConfig(**base, de_impl="jax"))
    assert np.all(np.diff(kls_p) <= 1e-12)
    assert out_p["KL_final"] < out_p["KL_initial"]
    # same histogram-KL scale between the two samplers (not bitwise: the
    # device sampler is a different RNG stream by design)
    assert abs(out_p["KL_initial"] - out_j["KL_initial"]) < 0.2 * out_j["KL_initial"]


def test_coupling_pipeline(bus):
    cfg = CouplingConfig(n_iter=2, grid_res=60, max_iter_mb=80, win_local_corr=6)
    rows, c_new = run_coupling(bus["C_aligned"], bus["M"], bus["matches"], cfg)
    assert len(rows) == 2
    # nudging moves the cloud toward the matches: mean distance decreases
    assert rows[1]["d_mean"] < rows[0]["d_mean"]


def test_fem_uniformization_level():
    cfg = FEMUniformizeConfig(n_min=2, n_max=30, theta_iters=3)
    res = run_level(cfg, h_l=0.12, h_c=0.1, boundary_h=0.08, tag="test")
    # at this toy mesh size roughly half the Lucas nodes land inside the
    # cardioid uv hull; the exact fraction sits near 0.5 and flips with
    # ulp-level changes in the eigensweep, so bound it loosely
    assert res["valid_frac"] > 0.4
    assert res["all"]["K_median"] >= 1.0
    assert np.isfinite(res["cr"]["cardioid"]["rel_med"])
    assert len(res["sweep"]) == 3


def test_fem_refinement_monotone():
    """Two refinement levels of the (factored-solve) v18 study: every
    headline diagnostic must improve with refinement — the reference's own
    acceptance criterion for the experiment (v18 results narrative)."""
    from cmtci.pipelines.uniformize_fem import run_fem_uniformization

    cfg = FEMUniformizeConfig(n_min=2, n_max=60)
    levels = (dict(name="A", h_L=0.09, h_C=0.07, boundary_h=0.045),
              dict(name="B", h_L=0.055, h_C=0.045, boundary_h=0.028))
    res = run_fem_uniformization(cfg, levels=levels)
    a, b = res
    assert b["all"]["K_median"] < a["all"]["K_median"]
    assert b["all"]["mu_L2"] < a["all"]["mu_L2"]
    assert b["valid_frac"] > a["valid_frac"]
    assert abs(b["period_mismatch"]["lucas"]) < abs(a["period_mismatch"]["lucas"])


def test_green_uniformization_small(tmp_path):
    xy = export_lucas_boundary(LucasBoundaryConfig(n_min=2, n_max=30, n_boundary=300))
    cfg = GreenUniformizeConfig(n_bdy=300, interior_n=1500)
    out = run_green_uniformization(xy, cfg, str(tmp_path))
    d = out["diagnostics"]
    # v40 self-check contracts
    assert abs(d["bdy_mod_median"] - 1.0) < 0.02
    assert d["inverse_err_median"] < 1e-10
    assert d["rad_clamped_max"] <= 0.995 + 1e-9
    assert (tmp_path / "diagnostics.csv").exists()
    assert (tmp_path / "map_state.npz").exists()


def test_cli_entrypoints(tmp_path):
    from cmtci.cli import main

    rc = main(["boundary", "--res", "200", "--max-iter", "80",
               "--out", str(tmp_path / "b")])
    assert rc == 0
    assert (tmp_path / "b_boundary.csv").exists()


def test_green_uniformization_f32_map_path(tmp_path):
    """VERDICT r2 item 4: the v40 f32 fast path is reachable end-to-end.

    map_dtype="float32" must run the full pipeline within the documented
    error budget relative to the f64 path (disk points within ~1e-4 here;
    the v40 self-check contracts still hold). The fit stays f64-host but
    takes the fast Cholesky normal-equations solve (σ within ~1e-8 of the
    parity lstsq — three orders below the boundary-residual budget).
    """
    xy = export_lucas_boundary(LucasBoundaryConfig(n_min=2, n_max=30, n_boundary=300))
    cfg64 = GreenUniformizeConfig(n_bdy=300, interior_n=1500)
    cfg32 = GreenUniformizeConfig(n_bdy=300, interior_n=1500, map_dtype="float32")
    o64 = run_green_uniformization(xy, cfg64)
    o32 = run_green_uniformization(xy, cfg32, str(tmp_path))
    d = o32["diagnostics"]
    assert abs(d["bdy_mod_median"] - 1.0) < 0.02
    assert d["inverse_err_median"] < 1e-10
    assert d["rad_clamped_max"] <= 0.995 + 1e-9
    # same interior point; σ within the Cholesky-vs-lstsq solver budget
    assert o32["map"].a == o64["map"].a
    np.testing.assert_allclose(o32["map"].sigma, o64["map"].sigma,
                               rtol=0, atol=1e-7)
    # the f32 path defers g_shift calibration into the fused phi_f_eval
    # call (median g(bdy-in) = 0 contract); it must land on the f64 path's
    # fit-time host calibration within the map error budget
    assert abs(o32["map"].g_shift - o64["map"].g_shift) < 1e-4
    w64, w32 = o64["disk"], o32["disk"]
    ok = np.isfinite(w64) & np.isfinite(w32)
    assert np.abs(w32[ok] - w64[ok]).max() < 1e-3
    assert (tmp_path / "diagnostics.csv").exists()


def test_cli_green_map_dtype_flag(tmp_path):
    from cmtci.cli import main

    rc = main(["uniformize-green", "--n-bdy", "200", "--interior-n", "500",
               "--map-dtype", "float32", "--out", str(tmp_path / "g")])
    assert rc == 0
    assert (tmp_path / "g" / "diagnostics.csv").exists()


def test_variograms_f32_field_path(tmp_path):
    """field_dtype='float32' (device DE proxy + potentials) tracks the f64
    gammas within the f32 grid-field noise."""
    cfg64 = VariogramConfig(n_list=(30, 60), boundary_grid=120,
                            boundary_max_iter=150, grid_nx=64, grid_ny=64,
                            potential_max_iter=150, m_target=2000)
    cfg32 = VariogramConfig(n_list=(30, 60), boundary_grid=120,
                            boundary_max_iter=150, grid_nx=64, grid_ny=64,
                            potential_max_iter=150, m_target=2000,
                            field_dtype="float32")
    o64 = run_variograms(cfg64)
    o32 = run_variograms(cfg32)
    a, b = np.asarray(o64["gamma_construct"]), np.asarray(o32["gamma_construct"])
    nz = np.abs(a) > 0
    assert np.max(np.abs(b[nz] - a[nz]) / np.abs(a[nz])) < 1e-3
    am, bm = np.asarray(o64["gamma_mandelbrot"]), np.asarray(o32["gamma_mandelbrot"])
    nz = np.abs(am) > 1e-12
    assert np.max(np.abs(bm[nz] - am[nz]) / np.abs(am[nz])) < 0.05
