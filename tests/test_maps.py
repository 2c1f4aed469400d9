"""FEM solver, Riemann map, QC diagnostics tests against analytic solutions."""

import numpy as np
import pytest

from cmtci.geometry.mesh import polygon_to_mesh
from cmtci.geometry.polygon import Polygon, slightly_inside
from cmtci.maps import fem, qc, riemann


def _disk_mesh(h=0.12, n_ring=400):
    t = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    poly = Polygon(np.column_stack([np.cos(t), np.sin(t)]))
    pts, tris = polygon_to_mesh(poly, h=h, boundary_h=0.8 * h, seed=0)
    return poly, pts, tris


class TestFEM:
    def test_stiffness_matches_reference_loop(self, rng):
        pts = rng.uniform(size=(30, 2))
        from scipy.spatial import Delaunay

        tris = Delaunay(pts).simplices
        k = fem.assemble_stiffness(pts, tris).toarray()

        # reference per-triangle loop (v18:315-346 semantics)
        ref = np.zeros((30, 30))
        for t in tris:
            p0, p1, p2 = pts[t[0]], pts[t[1]], pts[t[2]]
            b = np.array([[p1[0] - p0[0], p2[0] - p0[0]], [p1[1] - p0[1], p2[1] - p0[1]]])
            det = np.linalg.det(b)
            area = 0.5 * abs(det)
            if area < 1e-14:
                continue
            inv_bt = np.linalg.inv(b).T
            g1 = inv_bt @ np.array([1.0, 0.0])
            g2 = inv_bt @ np.array([0.0, 1.0])
            g0 = -g1 - g2
            grads = np.vstack([g0, g1, g2])
            ke = area * (grads @ grads.T)
            for a in range(3):
                for bb in range(3):
                    ref[t[a], t[bb]] += ke[a, bb]
        np.testing.assert_allclose(k, ref, rtol=1e-10, atol=1e-12)

    def test_dirichlet_harmonic_extension(self):
        poly, pts, tris = _disk_mesh()
        k = fem.assemble_stiffness(pts, tris)
        from cmtci.geometry.mesh import boundary_vertices

        bnd = boundary_vertices(tris)
        u = fem.dirichlet_solve(k, bnd, pts[bnd, 0])  # g = x on boundary
        np.testing.assert_allclose(u, pts[:, 0], atol=5e-3)

    def test_cg_matches_spsolve(self):
        poly, pts, tris = _disk_mesh(h=0.2)
        k = fem.assemble_stiffness(pts, tris)
        from cmtci.geometry.mesh import boundary_vertices

        bnd = boundary_vertices(tris)
        g = np.cos(3 * np.arctan2(pts[bnd, 1], pts[bnd, 0]))
        u1 = fem.dirichlet_solve(k, bnd, g, method="spsolve")
        u2 = fem.dirichlet_solve(k, bnd, g, method="cg")
        np.testing.assert_allclose(u2, u1, atol=1e-8)

    def test_harmonic_conjugate_of_x_is_y(self):
        poly, pts, tris = _disk_mesh()
        u = pts[:, 0]
        v = fem.harmonic_conjugate(pts, tris, u, pin=0)
        v_expected = pts[:, 1] - pts[0, 1]  # pinned at node 0
        np.testing.assert_allclose(v, v_expected, atol=2e-2)

    def test_harmonic_extension_second_order(self):
        # convergence-ORDER assertion (VERDICT r4 item 7): the P1 Dirichlet
        # extension error for a smooth harmonic function must contract ~h²
        # between two resolutions — a size-tuned atol at one mesh cannot
        # distinguish a first-order (or subtly wrong) solve; the ratio can.
        from cmtci.geometry.mesh import boundary_vertices

        errs = {}
        for h in (0.2, 0.1):
            poly, pts, tris = _disk_mesh(h=h)
            k = fem.assemble_stiffness(pts, tris)
            bnd = boundary_vertices(tris)
            # u = Re(z²) = x²−y², a nontrivial harmonic polynomial
            g = pts[bnd, 0] ** 2 - pts[bnd, 1] ** 2
            u = fem.dirichlet_solve(k, bnd, g)
            exact = pts[:, 0] ** 2 - pts[:, 1] ** 2
            errs[h] = float(np.sqrt(np.mean((u - exact) ** 2)))
        ratio = errs[0.2] / errs[0.1]
        # exact h² contraction is ratio 4; unstructured meshing noise and
        # the curved-boundary approximation leave a margin
        assert ratio > 2.5, (errs, ratio)

    def test_theta_iteration_maps_disk_to_circle(self):
        poly, pts, tris = _disk_mesh(h=0.15)
        u, v, c, r, mis = fem.theta_iteration(pts, tris, poly, iters=4)
        from cmtci.geometry.mesh import boundary_vertices

        bnd = boundary_vertices(tris)
        wb = np.abs(u[bnd] + 1j * v[bnd])
        assert np.median(np.abs(wb - 1.0)) < 0.05
        assert abs(mis) < 0.5

    def test_moving_average_and_unwrap(self):
        x = np.linspace(-np.pi, np.pi, 50, endpoint=False)
        sm = fem.moving_average_periodic(np.cos(x), 7)
        assert sm.shape == (50,)
        th = fem.unwrap_theta(np.angle(np.exp(1j * np.linspace(0, 4 * np.pi, 100))))
        assert np.all(np.diff(th) > -1e-9)


class TestRiemann:
    def test_disk_identity_map(self):
        t = np.linspace(0, 2 * np.pi, 600, endpoint=False)
        poly = Polygon(np.column_stack([np.cos(t), np.sin(t)]))
        rm = riemann.fit_riemann_map(poly, n_bdy=400)
        assert abs(rm.a) < 1e-8  # centroid of the disk

        # g(z) should approximate -log|z| (Green function of the disk at 0)
        rr = np.array([0.3, 0.5, 0.7])
        z = rr * np.exp(1j * 1.1)
        g = rm.g_real(z)
        np.testing.assert_allclose(g, -np.log(rr), atol=5e-3)

        # |f(z)| = |z|; the v40 phase anchor (Im Φ = 0 at every ray start,
        # v40:231-234) makes Im Φ_raw vanish identically on a rotationally
        # symmetric domain — reproduced faithfully here.
        z_test = 0.6 * np.exp(1j * np.linspace(0, 2 * np.pi, 50, endpoint=False))
        f = rm.f(z_test)
        np.testing.assert_allclose(np.abs(f), 0.6, atol=5e-3)
        np.testing.assert_allclose(rm.phi_raw(z_test).imag, 0.0, atol=1e-6)

    def test_green_quadrature_convergence_order(self):
        # convergence-ORDER assertion (VERDICT r4 item 7): pin the boundary
        # quadrature's empirical order p in err ~ 1/n_bdy^p on an
        # ASYMMETRIC analytic domain (the disk is degenerate: rotational
        # symmetry cancels the quadrature error to machine eps at n=25).
        # Shift-corrected interior g differences self-converge against an
        # n=1600 reference at p ≈ 1 (measured 1.05e-4 → 1.05e-5 over 50 →
        # 400); p must stay ≥ 0.85 — a size-tuned atol at one n cannot see
        # a broken weight going O(1) or O(1/sqrt(n)), the slope can.
        t = np.linspace(0, 2 * np.pi, 4000, endpoint=False)
        r = 1.0 + 0.15 * np.cos(3 * t)
        poly = Polygon(np.column_stack([r * np.cos(t), r * np.sin(t)]))
        z = np.array([0.2 + 0.1j, -0.3 + 0.2j, 0.1 - 0.35j])

        def g_at(n_bdy):
            g = riemann.fit_riemann_map(poly, n_bdy=n_bdy).g_real(z)
            return g - g[0]  # the g_shift calibration is a pure constant

        g_ref = g_at(1600)
        ns = np.array([50.0, 100.0, 400.0])
        errs = np.array([float(np.max(np.abs(g_at(int(n)) - g_ref)))
                         for n in ns])
        assert (errs > 0).all(), errs
        p = -np.polyfit(np.log(ns), np.log(errs), 1)[0]
        assert p > 0.85, (errs, p)

    def test_boundary_contract(self):
        t = np.linspace(0, 2 * np.pi, 500, endpoint=False)
        xy = np.column_stack([(1 + 0.1 * np.cos(3 * t)) * np.cos(t),
                              (1 + 0.1 * np.cos(3 * t)) * np.sin(t)])
        poly = Polygon(xy)
        rm = riemann.fit_riemann_map(poly, n_bdy=500)
        z_in = slightly_inside(rm.bdy_z, rm.a, 1e-3)
        mod = np.abs(rm.f(z_in))
        # v40 self-check contract: |f| ≈ 1 on boundary-in points
        assert abs(np.median(mod) - 1.0) < 1e-3
        resid = rm.boundary_residual()
        assert np.quantile(np.abs(resid), 0.9) < 1e-2
        g_in = rm.g_real(z_in)
        assert abs(np.median(g_in)) < 1e-12  # g_shift calibration


class TestQC:
    def _mesh(self):
        _, pts, tris = _disk_mesh(h=0.25)
        return pts, tris

    def test_identity_map_is_conformal(self):
        pts, tris = self._mesh()
        phi = pts[:, 0] + 1j * pts[:, 1]
        valid = np.ones(len(pts), bool)
        mus, ks, used = qc.beltrami_mu_k(pts, tris, phi, valid)
        assert used > 0
        np.testing.assert_allclose(np.abs(mus), 0.0, atol=1e-10)
        np.testing.assert_allclose(ks, 1.0, atol=1e-10)
        ang = qc.angle_distortion(pts, tris, phi, valid)
        np.testing.assert_allclose(ang, 0.0, atol=1e-8)
        abs_def, rel_def = qc.cr_defect_metrics(pts, tris, phi.real, phi.imag)
        np.testing.assert_allclose(rel_def, 0.0, atol=1e-10)

    def test_affine_quasiconformal_k3(self):
        pts, tris = self._mesh()
        z = pts[:, 0] + 1j * pts[:, 1]
        phi = z + 0.5 * np.conj(z)  # mu = 0.5, K = 3
        valid = np.ones(len(pts), bool)
        mus, ks, used = qc.beltrami_mu_k(pts, tris, phi, valid)
        np.testing.assert_allclose(mus, 0.5, atol=1e-10)
        np.testing.assert_allclose(ks, 3.0, atol=1e-9)

    def test_antiholomorphic_dropped(self):
        pts, tris = self._mesh()
        phi = np.conj(pts[:, 0] + 1j * pts[:, 1])
        valid = np.ones(len(pts), bool)
        mus, ks, used = qc.beltrami_mu_k(pts, tris, phi, valid)
        assert used == 0  # f_z = 0 everywhere

    def test_triangle_gradients_linear_exact(self):
        pts, tris = self._mesh()
        vals = 2.0 * pts[:, 0] - 3.0 * pts[:, 1] + 1.0
        g = qc.triangle_gradients(pts, tris, vals)
        np.testing.assert_allclose(g[:, 0], 2.0, atol=1e-9)
        np.testing.assert_allclose(g[:, 1], -3.0, atol=1e-9)

    def test_binned_median(self):
        x = np.array([0.1, 0.2, 0.6, 0.7, 0.9])
        y = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
        out = qc.binned_median(x, y, np.array([0.0, 0.5, 1.0]))
        assert out[0][2] == 1.5 and out[0][3] == 2
        assert out[1][2] == 4.0 and out[1][3] == 3


def test_riemann_qr32_solver_matches_lstsq():
    """Device-f32 QR + f64-residual refinement (the f32 pipeline's fit)
    reproduces the reference lstsq fit within the σ error budget."""
    t = np.linspace(0, 2 * np.pi, 500, endpoint=False)
    xy = np.column_stack([(1 + 0.1 * np.cos(3 * t)) * np.cos(t),
                          (1 + 0.1 * np.cos(3 * t)) * np.sin(t)])
    poly = Polygon(xy)
    rm_ref = riemann.fit_riemann_map(poly, n_bdy=400, solver="lstsq")
    rm_qr = riemann.fit_riemann_map(poly, n_bdy=400, solver="qr32")
    assert np.abs(rm_qr.sigma - rm_ref.sigma).max() < 1e-5
    assert abs(rm_qr.c - rm_ref.c) < 1e-8
    assert abs(rm_qr.g_shift - rm_ref.g_shift) < 1e-8
    # the v40 self-check contract holds on the qr32 fit
    z_in = slightly_inside(rm_qr.bdy_z, rm_qr.a, 1e-3)
    assert abs(np.median(np.abs(rm_qr.f(z_in))) - 1.0) < 1e-3


def test_riemann_f32_eval_budget():
    """f32 evaluation path (the device fast path): Im Phi
    mod 2pi and |f| within the documented error budget vs f64."""
    import jax.numpy as jnp

    from cmtci.geometry.polygon import Polygon, sample_interior_points
    from cmtci.geometry.resample import enforce_ccw
    from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary

    pts = export_lucas_boundary(LucasBoundaryConfig(n_max=40, n_boundary=300))
    poly = Polygon(enforce_ccw(pts))
    rm = riemann.fit_riemann_map(poly, n_bdy=200)
    z_int, _ = sample_interior_points(poly, 500, 0, 200000)
    f64v = rm.f(z_int)
    f32v = rm.f(z_int, dtype=jnp.float32)
    dphase = np.angle(f32v / np.where(f64v == 0, 1.0, f64v))
    assert np.quantile(np.abs(dphase), 0.99) < 1e-3
    dmod = np.abs(np.abs(f32v) - np.abs(f64v))
    assert np.quantile(dmod, 0.99) < 1e-3
