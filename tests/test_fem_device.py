"""Device-native FEM θ-iteration (cmtci.maps.fem_device) parity tests.

The device path replaces the host SuperLU solves of
lucas_to_cardioid_v18_periodic_theta_crbins_artifacts.py:726-727 with one
fused on-device Cholesky iteration; these tests pin it bitwise-close to the
host rebuild (cmtci.maps.fem) on the CPU backend, in both f64 (exact) and
f32+final-host-solve (GPU-session) configurations.
"""

import numpy as np
import pytest

from cmtci.geometry.mesh import boundary_vertices, polygon_to_mesh
from cmtci.geometry.polygon import Polygon
from cmtci.maps import fem
from cmtci.maps.fem_device import (
    DeviceSPDSolver,
    dispatch_theta_iteration_device,
)


def _blob_mesh(h=0.14):
    # deliberately non-circular: a wobbled ellipse so θ actually iterates
    t = np.linspace(0, 2 * np.pi, 500, endpoint=False)
    r = 1.0 + 0.18 * np.cos(3 * t) + 0.07 * np.sin(5 * t)
    poly = Polygon(np.column_stack([1.3 * r * np.cos(t), r * np.sin(t)]))
    pts, tris = polygon_to_mesh(poly, h=h, boundary_h=0.8 * h, seed=0)
    return poly, pts, tris


@pytest.fixture(scope="module")
def blob():
    return _blob_mesh()


class TestDeviceTheta:
    def test_f64_matches_host_spsolve(self, blob):
        poly, pts, tris = blob
        host = fem.theta_iteration(pts, tris, poly, iters=4)
        dev = fem.theta_iteration(pts, tris, poly, iters=4, method="device")
        np.testing.assert_allclose(dev[0], host[0], atol=1e-9)
        np.testing.assert_allclose(dev[1], host[1], atol=1e-9)
        assert abs(dev[2] - host[2]) < 1e-9
        assert abs(dev[3] - host[3]) < 1e-9
        assert abs(dev[4] - host[4]) < 1e-9

    def test_f64_matches_host_no_feedback(self, blob):
        # the reference's (dead-feedback) convention, v18:736-737
        poly, pts, tris = blob
        host = fem.theta_iteration(pts, tris, poly, iters=3, feedback=False)
        dev = fem.theta_iteration(pts, tris, poly, iters=3, feedback=False,
                                  method="device")
        np.testing.assert_allclose(dev[0], host[0], atol=1e-9)
        np.testing.assert_allclose(dev[1], host[1], atol=1e-9)
        assert abs(dev[4] - host[4]) < 1e-9

    def test_f32_final_host_solve(self, blob):
        # GPU-session configuration: f32 device iteration, final f64 host
        # solve at the converged θ. u/v must carry f64 solve accuracy: the
        # only deviation is the f32 θ trajectory (~1e-5 rad).
        import jax.numpy as jnp

        poly, pts, tris = blob
        host = fem.theta_iteration(pts, tris, poly, iters=4)
        handle = dispatch_theta_iteration_device(
            pts, tris, poly, iters=4, dtype=jnp.float32,
            final_host_solve=True)
        u, v, c, r, mis = handle.result()
        assert u.dtype == np.float64
        np.testing.assert_allclose(u, host[0], atol=5e-4)
        np.testing.assert_allclose(v, host[1], atol=5e-4)
        assert abs(mis - host[4]) < 5e-4
        # the disk image is still a unit circle on the boundary
        bnd = boundary_vertices(tris)
        assert np.median(np.abs(np.abs(u[bnd] + 1j * v[bnd]) - 1.0)) < 0.05

    def test_even_smooth_window_widens_like_host(self, blob):
        poly, pts, tris = blob
        host = fem.theta_iteration(pts, tris, poly, iters=2, smooth=6)
        dev = fem.theta_iteration(pts, tris, poly, iters=2, smooth=6,
                                  method="device")
        np.testing.assert_allclose(dev[0], host[0], atol=1e-9)


class TestDeviceSPDSolver:
    def test_dirichlet_device_matches_spsolve(self, blob):
        poly, pts, tris = blob
        k = fem.assemble_stiffness(pts, tris)
        bnd = boundary_vertices(tris)
        g = np.cos(3 * np.arctan2(pts[bnd, 1], pts[bnd, 0]))
        u_ref = fem.dirichlet_solve(k, bnd, g, method="spsolve")
        u_dev = fem.dirichlet_solve(k, bnd, g, method="device")
        np.testing.assert_allclose(u_dev, u_ref, atol=1e-9)

    def test_harmonic_conjugate_device(self, blob):
        poly, pts, tris = blob
        u = pts[:, 0]
        v_ref = fem.harmonic_conjugate(pts, tris, u, pin=0)
        v_dev = fem.harmonic_conjugate(pts, tris, u, pin=0, method="device")
        np.testing.assert_allclose(v_dev, v_ref, atol=1e-9)

    def test_f32_iterative_refinement_recovers_f64(self, blob):
        import jax.numpy as jnp

        poly, pts, tris = blob
        k = fem.assemble_stiffness(pts, tris)
        bnd = boundary_vertices(tris)
        free = np.ones(k.shape[0], dtype=bool)
        free[bnd] = False
        k_ff = k[free][:, free].tocsr()
        rng = np.random.default_rng(0)
        b = rng.standard_normal(k_ff.shape[0])
        from scipy.sparse.linalg import spsolve

        x_ref = spsolve(k_ff, b)
        x32 = DeviceSPDSolver(k_ff, dtype=jnp.float32).solve(b, refine=3)
        rel = np.linalg.norm(x32 - x_ref) / np.linalg.norm(x_ref)
        assert rel < 1e-7


class TestSliverCondensation:
    def test_schur_solve_matches_pinned_f64(self):
        # synthetic Neumann operator with two "sliver" nodes: a well-
        # conditioned graph Laplacian plus a weakly-attached pair whose
        # internal coupling is 1e11 (the alpha-shape sliver pathology:
        # raw pinned κ≈1e15, equilibrated still ~1e12).
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve

        from cmtci.maps.fem_device import _condense_slivers

        rng = np.random.default_rng(1)
        n = 40
        a = np.zeros((n, n))
        for i in range(n - 2):
            for j in rng.choice(n - 2, size=3, replace=False):
                if i != j:
                    w = rng.uniform(0.5, 2.0)
                    a[i, j] -= w
                    a[j, i] -= w
        # sliver pair (n-2, n-1): huge mutual stiffness, weak anchors
        a[n - 2, n - 1] = a[n - 1, n - 2] = -1e11
        a[n - 2, 0] = a[0, n - 2] = -1e-3
        a[n - 1, 1] = a[1, n - 1] = -2e-3
        np.fill_diagonal(a, 0.0)
        np.fill_diagonal(a, -a.sum(axis=1))
        k = sp.csr_matrix(a)

        r_idx, s_idx, s_red, kss_inv, w = _condense_slivers(k)
        assert set(s_idx) == {n - 2, n - 1}
        # compatible rhs (sums to zero, like the weak-form conjugate RHS)
        b = rng.standard_normal(n)
        b -= b.mean()
        free = np.ones(n, bool)
        free[0] = False
        v_ref = np.zeros(n)
        v_ref[free] = spsolve(k[free][:, free].tocsr(), b[free])
        # condensed solve in f64
        b_r = b[r_idx] - w.T @ b[s_idx]
        s_free = np.ones(len(r_idx), bool)
        s_free[np.searchsorted(r_idx, 0)] = False
        v_r = np.zeros(len(r_idx))
        v_r[s_free] = spsolve(s_red[s_free][:, s_free].tocsr(), b_r[s_free])
        v_s = kss_inv @ b[s_idx] - w @ v_r
        v = np.zeros(n)
        v[r_idx] = v_r
        v[s_idx] = v_s
        v -= v[0]
        np.testing.assert_allclose(v, v_ref, atol=1e-6)

    def test_neumann_solver_f32_on_sliver_system(self):
        # the public harmonic_conjugate(method='device') path must survive
        # an f32 GPU-session default on a sliver-bearing operator — the
        # weakly-pinned reduced system's f32 Cholesky is NOT positive-
        # definite (silent NaNs); DeviceNeumannSolver condenses + lifts.
        import jax.numpy as jnp
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve

        from cmtci.maps.fem_device import DeviceNeumannSolver

        rng = np.random.default_rng(2)
        n = 40
        a = np.zeros((n, n))
        for i in range(n - 2):
            for j in rng.choice(n - 2, size=3, replace=False):
                if i != j:
                    w = rng.uniform(0.5, 2.0)
                    a[i, j] -= w
                    a[j, i] -= w
        a[n - 2, n - 1] = a[n - 1, n - 2] = -1e11
        a[n - 2, 0] = a[0, n - 2] = -1e-3
        a[n - 1, 1] = a[1, n - 1] = -2e-3
        np.fill_diagonal(a, 0.0)
        np.fill_diagonal(a, -a.sum(axis=1))
        k = sp.csr_matrix(a)
        b = rng.standard_normal(n)
        b -= b.mean()
        free = np.ones(n, bool)
        free[0] = False
        v_ref = np.zeros(n)
        v_ref[free] = spsolve(k[free][:, free].tocsr(), b[free])
        # both dtypes sit at the lifted-vs-pinned distribution floor
        # (~5e-4 absolute at solution scale ~368, i.e. ~1.3e-6 relative)
        v32 = DeviceNeumannSolver(k, pin=0, dtype=jnp.float32).solve(b)
        assert np.isfinite(v32).all()
        np.testing.assert_allclose(v32, v_ref, atol=2e-3)
        v64 = DeviceNeumannSolver(k, pin=0, dtype=jnp.float64).solve(b)
        np.testing.assert_allclose(v64, v_ref, atol=2e-3)

    def test_no_slivers_passthrough(self):
        import scipy.sparse as sp

        from cmtci.maps.fem_device import _condense_slivers

        k = sp.csr_matrix(np.array([[2.0, -1, -1], [-1, 2, -1], [-1, -1, 2]]))
        r_idx, s_idx, s_red, kss_inv, w = _condense_slivers(k)
        assert len(s_idx) == 0 and len(r_idx) == 3
        assert (s_red != k).nnz == 0


class TestPipelineAsyncDispatch:
    def test_dispatch_finish_matches_run_level(self):
        from cmtci.pipelines.uniformize_fem import (
            FEMUniformizeConfig, dispatch_level, finish_level, run_level,
        )

        t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
        r = 1.0 + 0.15 * np.cos(4 * t)
        poly = Polygon(np.column_stack([r * np.cos(t), r * np.sin(t)]))

        cfg = FEMUniformizeConfig(solver="spsolve", theta_iters=3)
        ref = run_level(cfg, 0.15, 0.15, 0.12, "T", poly_l=poly)
        cfg_dev = FEMUniformizeConfig(solver="device", theta_iters=3)
        got = finish_level(
            cfg_dev, dispatch_level(cfg_dev, 0.15, 0.15, 0.12, "T", poly))
        assert got["tag"] == ref["tag"]
        for key in ("K_median", "mu_L2", "angle_median"):
            assert np.isclose(got["all"][key], ref["all"][key],
                              rtol=1e-7, atol=1e-10), key
        assert np.isclose(got["cr"]["lucas"]["abs_med"],
                          ref["cr"]["lucas"]["abs_med"], rtol=1e-7)
        assert np.isclose(got["period_mismatch"]["lucas"],
                          ref["period_mismatch"]["lucas"], atol=1e-9)

    def test_mesh_bundle_cache_hit(self):
        from cmtci.pipelines.uniformize_fem import _MESH_CACHE, _mesh_bundle

        t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
        poly = Polygon(np.column_stack([np.cos(t), np.sin(t)]))
        a = _mesh_bundle(poly, 0.3, 0.24)
        n0 = len(_MESH_CACHE)
        b = _mesh_bundle(poly, 0.3, 0.24)
        assert len(_MESH_CACHE) == n0
        assert a[0] is b[0]
