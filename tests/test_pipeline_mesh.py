"""mesh= wiring through the analysis pipelines (8-device virtual CPU mesh).

Every run_* that fans out over a jax.sharding.Mesh must equal its
single-device path (SURVEY §5.8: data parallelism is a first-class
obligation of the rebuild, not a library appendix).
"""

import numpy as np
import pytest

from cmtci.parallel import sharded


@pytest.fixture(scope="module")
def mesh():
    return sharded.device_mesh()


class TestShardedHeads:
    def test_binned_sq_diff_matches_host(self, mesh, rng):
        from cmtci.stats.variogram import _binned_sq_diff

        import jax.numpy as jnp

        c = rng.uniform(size=(300, 2))
        v = rng.normal(size=300)
        edges = np.linspace(0, 1.2, 12)
        s_ref, n_ref = _binned_sq_diff(
            jnp.asarray(c), jnp.asarray(v), jnp.asarray(c), jnp.asarray(v),
            jnp.asarray(edges), 11, 128, upper=True)
        s, n = sharded.sharded_binned_sq_diff(c, v, c, v, edges, mesh,
                                              upper=True, chunk=16)
        np.testing.assert_array_equal(n, np.asarray(n_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-12)

    def test_binned_sq_diff_cross_matches_host(self, mesh, rng):
        from cmtci.stats.variogram import _binned_sq_diff

        import jax.numpy as jnp

        c1 = rng.uniform(size=(200, 2))
        v1 = rng.normal(size=200)
        c2 = rng.uniform(size=(150, 2))
        v2 = rng.normal(size=150)
        edges = np.linspace(0, 1.2, 9)
        s_ref, n_ref = _binned_sq_diff(
            jnp.asarray(c1), jnp.asarray(v1), jnp.asarray(c2), jnp.asarray(v2),
            jnp.asarray(edges), 8, 64, upper=False)
        s, n = sharded.sharded_binned_sq_diff(c1, v1, c2, v2, edges, mesh,
                                              upper=False, chunk=16)
        np.testing.assert_array_equal(n, np.asarray(n_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-12)

    def test_point_variogram_matches_host(self, mesh, rng):
        from cmtci.stats import variogram as vg

        locs = rng.uniform(size=(257, 2))
        vals = rng.normal(size=257)
        for values, max_dist in ((vals, None), (None, None), (vals, 0.7)):
            c_ref, g_ref, n_ref = vg.point_variogram(locs, values,
                                                     max_dist=max_dist,
                                                     nbins=14)
            c_got, g_got, n_got = sharded.sharded_point_variogram(
                locs, values, max_dist=max_dist, nbins=14, mesh=mesh,
                chunk=16)
            np.testing.assert_array_equal(n_got, n_ref)
            np.testing.assert_allclose(c_got, c_ref, rtol=1e-12)
            nz = n_ref > 0
            np.testing.assert_allclose(g_got[nz], g_ref[nz], rtol=1e-10)
            assert np.isnan(g_got[~nz]).all()

    def test_three_semivariograms_mesh_matches_host(self, mesh):
        from cmtci.stats import variogram as vg

        r1 = np.random.RandomState(7)
        r2 = np.random.RandomState(7)
        g = np.linspace(0, 1, 20)
        gx, gy = np.meshgrid(g, g)
        fc = np.sin(6 * gx) + 0.1 * gy
        fm = np.cos(5 * gy) - 0.2 * gx
        r_bins = np.linspace(0, 0.9, 10)
        ref = vg.three_semivariograms(fc, fm, gx, gy, r_bins, 250, r1)
        got = vg.three_semivariograms(fc, fm, gx, gy, r_bins, 250, r2,
                                      mesh=mesh)
        np.testing.assert_allclose(got[0], ref[0])
        for k in (1, 2, 3):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-10, atol=1e-14)
        for k in (4, 5, 6):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]))

    def test_shell_counts_mesh_routing(self, mesh, rng):
        from cmtci.stats import pointstats as ps

        pts = rng.uniform(size=(600, 2))
        ref = ps._shell_counts(pts, 0.8, 0.05)
        got = ps._shell_counts(pts, 0.8, 0.05, mesh=mesh)
        np.testing.assert_allclose(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] and np.isclose(got[3], ref[3])


class TestPipelinesWithMesh:
    def test_run_variograms(self, mesh):
        from cmtci.pipelines.variograms import VariogramConfig, run_variograms

        cfg = VariogramConfig(n_list=(10, 20, 30), boundary_grid=96,
                              grid_nx=48, grid_ny=48, boundary_max_iter=120,
                              potential_max_iter=120, m_target=400, nbins=8)
        ref = run_variograms(cfg)
        got = run_variograms(cfg, mesh=mesh)
        for k in ("gamma_construct", "gamma_mandelbrot", "gamma_cross"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-10, atol=1e-14)

    def test_run_spatial_stats(self, mesh, rng):
        from cmtci.pipelines.analysis import run_spatial_stats

        c = rng.uniform(size=(300, 2))
        m = rng.uniform(size=(280, 2))
        ref = run_spatial_stats(c, m, r_max=0.8, dr=0.1)
        got = run_spatial_stats(c, m, r_max=0.8, dr=0.1, mesh=mesh)
        for k in ("g_construct", "g_mandel", "K_construct", "K_mandel"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)
        assert got["hausdorff"] == ref["hausdorff"]

    def test_run_coupling(self, mesh, rng):
        from cmtci.pipelines.coupling import CouplingConfig, run_coupling

        c = rng.uniform(-0.8, 0.2, size=(150, 2))
        m = rng.uniform(-0.9, 0.3, size=(170, 2))
        matches = rng.integers(0, 170, size=150)
        cfg = CouplingConfig(n_iter=2, grid_res=48, max_iter_mb=60,
                             vario_bins=10)
        ref_rows, ref_c = run_coupling(c, m, matches, cfg)
        got_rows, got_c = run_coupling(c, m, matches, cfg, mesh=mesh)
        np.testing.assert_allclose(got_c, ref_c, rtol=1e-12)
        for rr, gr in zip(ref_rows, got_rows):
            for k in ("vario_range_a", "sigma_px", "corr_pot", "corr_lap",
                      "d_mean", "d_median"):
                np.testing.assert_allclose(gr[k], rr[k], rtol=1e-8,
                                           atol=1e-12, err_msg=k)

    def test_run_boundary(self, mesh):
        from cmtci.pipelines.boundary import BoundaryConfig, run_boundary

        cfg = BoundaryConfig(res=96, max_iter=80)
        ref_path, ref_z = run_boundary(cfg)
        got_path, got_z = run_boundary(cfg, mesh=mesh)
        # sharded_dwell_rows iterates the SAME f64 linspace nodes as the
        # single-device path, so the dwell field is bitwise identical on a
        # CPU mesh (the boundary CSV feeds the whole downstream bus — a
        # --devices run must not change it)
        np.testing.assert_array_equal(got_z, ref_z)
        np.testing.assert_allclose(got_path, ref_path)

    def test_run_equipotential(self, mesh):
        from cmtci.pipelines.equipotential import (
            EquipotentialConfig, run_equipotential,
        )

        cfg = EquipotentialConfig(n_min=2, n_max=15, max_iter=300,
                                  run_family_comparison=False)
        ref = run_equipotential(cfg, with_per_n=False)
        got = run_equipotential(cfg, with_per_n=False, mesh=mesh)
        # the sharded stage executor is bitwise per point
        for k, v in ref["summary"].items():
            np.testing.assert_allclose(got["summary"][k], v, rtol=0,
                                       atol=0, err_msg=k)


def test_cli_devices_flag(tmp_path):
    import os

    from cmtci.cli import main

    assert main(["boundary", "--res", "200", "--max-iter", "80",
                 "--devices", "2", "--out", f"{tmp_path}/m"]) == 0
    assert os.path.exists(f"{tmp_path}/m_boundary.csv")


def test_cli_devices_rejections(tmp_path):
    import pytest

    from cmtci.cli import main

    # a subcommand with no mesh-sharded stage must reject, not no-op
    with pytest.raises(SystemExit, match="no mesh-sharded stage"):
        main(["stage1", "--devices", "4", "--out", f"{tmp_path}/s"])
    # more devices than exist must reject, not silently shrink the mesh
    with pytest.raises(SystemExit, match="needs 99 devices"):
        main(["boundary", "--res", "64", "--max-iter", "30",
              "--devices", "99", "--out", f"{tmp_path}/m2"])


def test_platform_cpu_opts_out_of_accel_defaults():
    import argparse

    import jax

    import cmtci.cli as cli

    cli._apply_platform("cpu")
    assert jax.config.jax_platforms == "cpu"
    ns = argparse.Namespace(cmd="tracker", field_dtype=None, de_impl=None,
                            parity=False, platform="cpu")
    cli._resolve_platform_defaults(ns)
    # forced-CPU runs must not inherit the accel defaults (interpreted
    # Pallas on CPU is an effective hang)
    assert (ns.field_dtype, ns.de_impl) == ("float64", "jax")
